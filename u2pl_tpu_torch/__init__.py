"""u2pl_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of u2pl_tpu.

The JAX package `u2pl_tpu` stays the reference; this package mirrors its
module names so each counterpart is easy to find, and is held against it by
the `tests/test_torch_*.py` parity tests.  Ported so far, in float32 on one
card: serving (`python -m u2pl_tpu_torch.serve`), and the supervised and
semi-supervised trainers (`python -m u2pl_tpu_torch.train_sup`,
`train_semi`) with their data pipeline, validation and checkpoints, on the
VOC and Cityscapes configs; the JAX package's device functions are
hand-written CUDA kernels (`kernels/csrc/`).

The package imports `torch` and never `jax` or anything of `u2pl_tpu`.
"""

__version__ = "0.1.0"
