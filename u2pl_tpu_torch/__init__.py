"""u2pl_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of u2pl_tpu.

The JAX package `u2pl_tpu` stays the reference; this package mirrors its
module names so each counterpart is easy to find, and is held against it by
the `tests/test_torch_*.py` parity tests.  Ported so far: the serving path
(`python -m u2pl_tpu_torch.serve`) in float32 — the eval-mode ResNet +
DeepLabv3(+) forward in NCHW, with the align-corners resizes as hand-written
CUDA kernels (`kernels/csrc/resize.cu`).

The package imports `torch` and never `jax`; of the JAX package it uses only
the jax-free `u2pl_tpu.config` and `u2pl_tpu.utils.convert_torch`.
"""

__version__ = "0.1.0"
