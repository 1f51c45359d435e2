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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # (x, y, idx_h, w_h, idx_w, w_w, planes, H, W, OH, OW, stream)
        "u2pl_resize_bilinear_ac": [p] * 6 + [i] * 5 + [p],
        # (gy, gx, idx_h, w_h, rng_h, idx_w, w_w, rng_w, planes, H, W, OH, OW, stream)
        "u2pl_resize_bilinear_ac_bwd": [p] * 8 + [i] * 5 + [p],
        # (x, out, idx_h, w_h, idx_w, w_w, C, H, W, OH, OW, stream)
        "u2pl_resize_argmax_ac": [p] * 6 + [i] * 5 + [p],
        # (x, labels, cw, lse, part, stats, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, ignore, floor, stream)
        "u2pl_upsample_ce_fwd": [p] * 10 + [i] * 7 + [f, p],
        # (x, labels, cw, lse, stats, gout, gfull, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, ignore, floor, stream)
        "u2pl_upsample_ce_bwd": [p] * 11 + [i] * 7 + [f, p],
        # (x, maxprob, argmax, entropy, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, stream)
        "u2pl_upsample_softmax_stats": [p] * 8 + [i] * 6 + [p],
        # (values, mask, pct, out, state, n, K, stream)
        "u2pl_masked_percentiles": [p] * 5 + [i] * 2 + [p],
        # (img, lab, prob, boxes, img_out, lab_out, prob_out,
        #  B, CI, H, W, cutout, ignore, stream)
        "u2pl_unsup_mix_boxes": [p] * 7 + [i] * 6 + [p],
        "u2pl_upsample_ce_parts": [],
        "u2pl_quantile_max_queries": [],
        "u2pl_quantile_state_words": [],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.u2pl_error_string.argtypes = [i]
    lib.u2pl_error_string.restype = ctypes.c_char_p
    lib.build_seconds, lib.build_log = seconds, log
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.u2pl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
