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
        # (img, lab, prob, u, present, img_out, lab_out, prob_out, B, CI, H, W, C, stream)
        "u2pl_unsup_class_mix": [p] * 8 + [i] * 5 + [p],
        # (prob, labels, low, high, anchor, negative, low_valid, counts,
        #  B, B_l, C, HW, ignore, delta_p, delta_n, low_rank, high_rank, stream)
        "u2pl_contra_pixel_masks": [p] * 8 + [i] * 5 + [f] * 2 + [i] * 2 + [p],
        # (mask, pri, sel_idx, n_sel, state, C, N, K, stream)
        "u2pl_contra_select_keys": [p] * 5 + [i] * 3 + [p],
        # (mask, keys, idx, n_sel, state, C, N, K, stream)
        "u2pl_contra_select_keys_radix": [p] * 5 + [i] * 3 + [p],
        # (mask, a_j, u, idx, count, C, N, Q, stream)
        "u2pl_contra_sample_anchors": [p] * 5 + [i] * 3 + [p],
        # (rep, sel_idx, n_sel, keys, ptr, occ, sizes, B, F, HW, C, K, cap, dtype, stream)
        "u2pl_memobank_enqueue": [p] * 7 + [i] * 7 + [p],
        # (rep, anchor_idx, pos, keys, occ, b_j, u_neg, active, valid_seg, ce,
        #  gdir, loss, B, F, HW, C, Q, M, cap, dtype, temperature, stream)
        "u2pl_contra_infonce_fwd": [p] * 12 + [i] * 8 + [f, p],
        # (anchor_idx, active, valid_seg, gdir, g, grad_rep, B, F, HW, C, Q, stream)
        "u2pl_contra_infonce_bwd": [p] * 6 + [i] * 5 + [p],
        # (values, out, state, n, k, stream)
        "u2pl_kth_smallest": [p] * 3 + [i] * 2 + [p],
        # (x, labels, p_y, num_valid, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, ignore, stream)
        "u2pl_ohem_target_prob": [p] * 8 + [i] * 7 + [p],
        # (labels, p_y, kth, num_valid, out, n, thresh, min_kept, ignore, stream)
        "u2pl_ohem_keep_labels": [p] * 5 + [i, f, i, i, p],
        "u2pl_upsample_ce_parts": [],
        "u2pl_quantile_max_queries": [],
        "u2pl_quantile_state_words": [],
        "u2pl_select_keys_state_words": [i, i],
        "u2pl_select_keys_radix_state_words": [i],
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
