"""Hand-written CUDA kernels of the port, bound with ctypes.

Nothing here touches nvcc, ctypes or a GPU at import time: `load()` builds
the library on first use (`kernels/build.py`) and binds the C entry points.
Each entry takes raw device pointers, ints and the CUDA stream, launches on
that stream and returns `cudaGetLastError()`; the Python wrappers in `ops/`
check the arguments, allocate the outputs and raise on a nonzero return.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=1)
def load():
    """The bound kernel library (built first if needed)."""
    import ctypes

    from u2pl_tpu_torch.kernels.build import build

    path, seconds, log = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    # (x, y, idx_h, w_h, idx_w, w_w, planes, H, W, OH, OW, stream)
    lib.u2pl_resize_bilinear_ac.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.u2pl_resize_bilinear_ac.restype = i
    # (x, out, idx_h, w_h, idx_w, w_w, C, H, W, OH, OW, stream)
    lib.u2pl_resize_argmax_ac.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.u2pl_resize_argmax_ac.restype = i
    lib.u2pl_error_string.argtypes = [i]
    lib.u2pl_error_string.restype = ctypes.c_char_p
    lib.build_seconds, lib.build_log = seconds, log
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.u2pl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
