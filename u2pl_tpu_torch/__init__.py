"""u2pl_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of u2pl_tpu.

The JAX package `u2pl_tpu` stays the reference; this package mirrors its
module names so each counterpart is easy to find, and is held against it by
the `tests/test_torch_*.py` parity tests.  Ported: serving, eval and infer
(`python -m u2pl_tpu_torch.serve`, `.eval`, `.infer`), and the supervised
and semi-supervised trainers (`python -m u2pl_tpu_torch.train_sup`,
`train_semi`) with their data pipeline, validation and checkpoints, on the
VOC and Cityscapes configs, in float32 or bfloat16, on one card or
data-parallel on several (`dist.py`); the JAX package's device functions
are hand-written CUDA kernels (`kernels/csrc/`).

The package imports `torch` and never `jax` or anything of `u2pl_tpu`.
"""

__version__ = "0.1.0"
