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
        # (x, y, idx_h, w_h, idx_w, w_w, taps_h, taps_w, planes, H, W, OH, OW,
        #  kernel, rows, bands, mode, stream)
        "u2pl_resize_bilinear_ac": [p] * 8 + [i] * 9 + [p],
        # (gy, gx, idx_h, w_h, rng_h, idx_w, w_w, rng_w, planes, H, W, OH, OW,
        #  kernel, rows, bands, wspan, mode, stream)
        "u2pl_resize_bilinear_ac_bwd": [p] * 8 + [i] * 10 + [p],
        # (x, out, idx_h, w_h, idx_w, w_w, C, H, W, OH, OW, dtype, stream)
        "u2pl_resize_argmax_ac": [p] * 6 + [i] * 6 + [p],
        # (x, labels, cw, lse, part, stats, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, ignore, floor, span, max_rows, spans, raw_bytes,
        #  dtype, stream)
        "u2pl_upsample_ce_fwd": [p] * 10 + [i] * 7 + [f] + [i] * 5 + [p],
        # (x, labels, cw, lse, stats, gout, gx, idx_h, w_h, rng_h, idx_w, w_w,
        #  rng_w, B, C, H, W, OH, OW, ignore, floor, groups, cls, rows, bands,
        #  chunk, threads, span, gs, ratio, dtype, stream)
        "u2pl_upsample_ce_bwd": [p] * 13 + [i] * 7 + [f] + [i] * 10 + [p],
        # (x, maxprob, argmax, entropy, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, span, max_rows, spans, raw_bytes, dtype, stream)
        "u2pl_upsample_softmax_stats": [p] * 8 + [i] * 11 + [p],
        # (values, mask, pct, out, state, n, K, grid, slice, cap, stream)
        "u2pl_masked_percentiles": [p] * 5 + [i] * 5 + [p],
        # (img, lab, prob, boxes, img_out, lab_out, prob_out,
        #  B, CI, H, W, cutout, ignore, stream)
        "u2pl_unsup_mix_boxes": [p] * 7 + [i] * 6 + [p],
        # (img, lab, prob, u, ticket, img_out, lab_out, prob_out, B, CI, H, W, C,
        #  grid, span, held, smem, stream)
        "u2pl_unsup_class_mix": [p] * 8 + [i] * 9 + [p],
        # (prob, labels, low, high, anchor, negative, low_valid, counts, ticket,
        #  B, B_l, C, HW, ignore, delta_p, delta_n, low_rank, high_rank,
        #  blocks, stream)
        "u2pl_contra_pixel_masks": [p] * 9 + [i] * 5 + [f] * 2 + [i] * 3 + [p],
        # (mask, pri, sel_idx, n_sel, C, N, K, slice, pixcap, smem, stream)
        "u2pl_contra_select_keys": [p] * 4 + [i] * 6 + [p],
        # (mask, keys, idx, n_sel, C, N, K, slice, held, smem, stream)
        "u2pl_contra_select_keys_radix": [p] * 4 + [i] * 6 + [p],
        # (mask, a_j, u, idx, count, C, N, Q, vec, slice, smem, stream)
        "u2pl_contra_sample_anchors": [p] * 5 + [i] * 6 + [p],
        # (rep, sel_idx, n_sel, keys, ptr, occ, sizes, ticket, B, F, HW, C, K,
        #  cap, dtype, rep_dtype, tile, stream)
        "u2pl_memobank_enqueue": [p] * 8 + [i] * 9 + [p],
        # (rep, sel_idx, n_sel, slab, B, F, HW, C, K, rep_dtype, tile, stream)
        "u2pl_memobank_gather": [p] * 4 + [i] * 7 + [p],
        # (slabs, counts, keys, ptr, occ, sizes, ticket, W, F, C, K, cap, dtype,
        #  slab_dtype, stream)
        "u2pl_memobank_enqueue_slabs": [p] * 7 + [i] * 7 + [p],
        # (rep, anchor_idx, pos, keys, occ, b_j, u_neg, active, valid_seg, ce,
        #  gdir, loss, ticket, B, F, HW, C, Q, M, cap, dtype, rep_dtype, group,
        #  pos_rows, temperature, stream)
        "u2pl_contra_infonce_fwd": [p] * 13 + [i] * 11 + [f, p],
        # (anchor_idx, active, valid_seg, gdir, g, sums, grad_rep, B, F, HW, C, Q,
        #  tile, rep_dtype, split, stream)
        "u2pl_contra_infonce_bwd": [p] * 7 + [i] * 8 + [p],
        # (values, out, state, n, k, grid, slice, cap, stream)
        "u2pl_kth_smallest": [p] * 3 + [i] * 5 + [p],
        # (x, labels, p_y, num_valid, ticket, idx_h, w_h, idx_w, w_w,
        #  B, C, H, W, OH, OW, ignore, span, max_rows, spans, raw_bytes, dtype,
        #  stream)
        "u2pl_ohem_target_prob": [p] * 9 + [i] * 12 + [p],
        # (labels, p_y, kth, num_valid, out, n, thresh, min_kept, ignore, stream)
        "u2pl_ohem_keep_labels": [p] * 5 + [i, f, i, i, p],
        "u2pl_quantile_max_queries": [],
        "u2pl_quantile_digit_bits": [],
        "u2pl_quantile_max_key_bytes": [],
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


# the words of `tickets`: one per kernel that sums or updates in its last
# block (K5's modes share one: launches on a stream run one after another); K7 prob's ticket is followed by the word its blocks count into,
# K4 masks' by the 2 x 32 words of its per-class counts, K3c's by the 64
# u64 presence words of its samples (8-aligned: the tensor is)
TICKET_INFONCE_FWD = 0
TICKET_MEMOBANK = 1
TICKET_OHEM_PROB = 2
TICKET_CONTRA_MASKS = 4
TICKET_CLASSMIX = TICKET_CONTRA_MASKS + 1 + 2 * 32
TICKET_WORDS = TICKET_CLASSMIX + 1 + 2 * 64


@functools.lru_cache(maxsize=None)
def tickets(device):
    """Zeroed uint32 words on `device`, one per kernel whose last block to
    finish takes over (TICKET_*): each block adds one with atomicInc, which
    wraps at the grid size, so a word is 0 again after every launch (and
    the last blocks of K7 prob, K4 masks and K3c take their count and
    presence words back to 0)."""
    import torch

    return torch.zeros(TICKET_WORDS, dtype=torch.int32, device=device)


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.u2pl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
