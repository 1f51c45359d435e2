"""Times kernel A and its adjoint A-bwd, K6's forward and backward, kernel
C's forward and backward, kernel D, K4's key selection, masks and anchor
draws, K5, OHEM's K7 prob and K7 kth, kernel E, K4r (radix key selection)
and K3c (ClassMix) of the u2pl_tpu_torch package in the checkout at
--root, on one card: run it once per checkout, in turns, to set two
versions of the kernels side by side in one call.

    python u2pl_tpu_torch/kernels/timing_ab.py --root <checkout> --label <name>

It is run by file path, not with -m, so that it imports the package of
--root (the older checkout need not have this file).  It prints one JSON
line: the card's name and power limit, and per kernel the device ms per
call (CUDA events around back-to-back calls queued behind a device sleep,
so the host's launch overhead does not count, and torch.profiler's mean
device time per call), the time of the PyTorch call that computes the same
function, and a sha256 of the result, equal across checkouts when the
results are bit-equal.  The inputs come from seeded generators on the card:

  A_logits   kernel A at the serving shape, (4, 21, 129²) -> 513²;
             library: F.interpolate(bilinear, align_corners=True);
  A_decoder  kernel A at the decoder's, (8, 256, 65²) -> 129² (the semi
             step's 4 + 4 images);
  K6_bwd     K6's backward as the package's autograd backward runs it (the
             gradient's allocation included) at the flagship: a
             (8, 256, 129, 129) rep, 21 positions x 256 draws, each
             position's drawn from its own 2000 random pixels, valid_seg 20,
             the last position inactive; library: torch.zeros of the (N, 256)
             rows, then index_add_ of the draws' rows;
  K6_bwd_no_draws  the same with every position inactive: the gradient's
             zero write alone, in the kernel's store layout; library:
             torch.zeros of the rep;
  C_bwd_voc  kernel C's backward through torch.autograd.grad, as the step
             runs it (the adjoint resize to the os4 logits included), at
             the VOC CE's (4, 21, 129²) -> 513², 10% of the labels ignored;
  C_bwd_city_main  the same at the Cityscapes main head, (2, 19, 193²) ->
             769², on OHEM's kept labels (thresh 0.7, min_kept 100000) with
             the OHEM class weight;
  C_bwd_city_aux   the aux head, (2, 19, 97²) -> 769², on its kept labels;
  D_voc_prob, D_voc_entropy  kernel D as the semi step calls it at VOC,
             (4, 21, 129²) -> 513²: max-prob + argmax (the pseudo-labels),
             then the entropy alone (a checkout whose wrapper has no output
             selection writes all three: its time is that call's, its hash
             the selected outputs');
  D_city_prob, D_city_entropy  the same at Cityscapes, (2, 19, 193²) -> 769²;
  K4_select  select_keys at the flagship, a (21, 133128) negative mask of
             ~0-30% density per class (one class empty) and uniform
             priorities, k 8192; library: torch.sort(stable=True) of the
             masked priorities;
  A_bwd_voc  kernel A-bwd as the decoder's backward runs it at VOC,
             (8, 256, 129²) -> 65²; library: aten upsample_bilinear2d_backward
             (F.interpolate's own backward);
  A_bwd_city the same at Cityscapes, (4, 256, 193²) -> 97²;
  C_fwd_voc  kernel C's forward (no grad) at the VOC CE's (4, 21, 129²) ->
             513², 10% of the labels ignored; its hash covers the loss and
             the gradient C's backward computes from that forward's saved
             lse, so a change in the lse bits shows;
  C_fwd_city_main  the same at the Cityscapes main head, (2, 19, 193²) ->
             769², on OHEM's kept labels with the OHEM class weight;
  C_fwd_city_aux   the aux head, (2, 19, 97²) -> 769², on its kept labels;
  C_fwd_city_unsup the unsupervised CE, (2, 19, 193²) -> 769², 20% of the
             pseudo-labels dropped (the entropy gate's share at the first
             semi epoch);
  K6_fwd_voc K6's forward (no grad) at the flagship: a (8, 256, 129²) rep,
             21 positions x 256 draws from 2000 random pixels each, 50 keys
             each from a full (21, 50000, 256) bf16 bank, the last position
             inactive; its hash covers the loss and the active positions'
             saved directions (the inactive ones' rows are never written);
  K6_fwd_voc_no_keys, K6_fwd_voc_one_pixel  the same with M = 0 (the
             anchors, the positive, the directions and the loss alone), and
             with every anchor on one pixel (its rows read from L2);
  K6_fwd_city  the same at Cityscapes: a (4, 256, 193²) rep, 19 positions,
             a (19, 50000, 256) bank;
  K5_voc     K5's ring write of VOC_N_SEL keys (chip_smoke.py's flagship
             selection counts) at random distinct pixels of a (8, 256, 129²)
             rep into a full (21, 50000, 256) bf16 bank whose rings wrap; its
             hash covers keys, ptr and occupancy after one call on a clone;
  K5_city    the same with CITY_N_SEL (a Cityscapes semi step's counts, k
             12288) from a (4, 256, 193²) rep into a (19, 50000, 256) bank;
  K7_prob_city_main  K7 prob, OHEM's target-class probability, at the
             Cityscapes main head, (2, 19, 193²) -> 769², labels of 8 x 8
             cells of the head's grid, 5% ignored (chip_smoke.py's
             ohem_case); its hash covers p_y and num_valid;
  K7_prob_city_aux   the same at the aux head, (2, 19, 97²) -> 769², 4 x 4
             cells;
  K7_kth_city  K7 kth, the 100,000-th smallest of the main head's 2 x 769²
             p_y; library: torch.kthvalue;
  E_voc_1    kernel E, one percentile (80.25) of a (4, 513²) map, ~85%
             valid, a quarter of it ties; library: torch.quantile of the
             masked values (linear);
  E_voc_3    the same with the contrastive step's three percents (80.25,
             19.75, 80.25: the drop percent and the low / high entropy
             percents at epoch 1 of 80);
  E_city_3   the contrastive step's call at Cityscapes, (2, 769²);
  A_decoder_city  kernel A at the Cityscapes decoder's upsample, (4, 256,
             97²) -> 193², with its bytes bound; library: F.interpolate;
  K4_masks_voc  contra_pixel_masks at the flagship: the os4 softmax of 4 + 4
             images (21 classes, softmax of 4 x randn), labels with class 0
             on ~60% of the pixels and ~5% ignored, low / high masks of ~70%
             / ~50% (the labeled images': their labeled pixels), the VOC
             `ours` config's ranks 3 / 20 and thresholds 0.3 / 1 (chip_smoke.py's
             mask_inputs); its hash covers anchor, negative, low_valid and
             counts;
  K4_masks_city  the same at Cityscapes, 2 + 2 images of 193², 19 classes;
  K4_anchors_voc  sample_anchors on the K4_masks_voc anchor mask, positions
             0..20 on their own class, 256 draws each (the largest below 1
             first); its hash covers idx and n;
  K4_anchors_city  the same on the K4_masks_city anchor mask, 19 positions;
  K4r_voc    select_keys_radix (`select_keys: radix`) at the flagship: a
             (21, 133128) mask like K4_select's (~0-30% density per class,
             the last class empty) with u32 keys, k 8192, 64 more masked keys
             of the class with the most candidates tied at its rank-k key and
             a masked key 0xFFFFFFFF in the next one (chip_smoke.py's
             radix_case); library: torch.topk(largest=False, sorted=False) of
             the masked keys as int64 (the same set up to ties, not in pixel
             order); its hash covers idx and n_sel;
  K4r_city   the same at the Cityscapes configs' (19, 148996), k 12288;
  K3c_voc    ClassMix (`apply_aug: classmix`) of (4, 3, 513²) images, their
             pseudo-labels (21 classes, ~5% 255, sample 1 a single class)
             and max-probs, (4, 21) draws with ties in sample 0 (chip_smoke.py's
             classmix_case); its hash covers image, label and max-prob;
  K3c_city   the same at Cityscapes, (2, 3, 769²), 19 classes;
  A_image_voc  kernel A at a served VOC request image, (1, 3, 375, 500) ->
             513², with its bytes bound; library: F.interpolate;
  A_image_city the same at a served Cityscapes image, (1, 3, 1024, 2048) ->
             769²;
  A_eval_voc_125  VOC eval's image resize at scale 1.25, (1, 3, 375, 500) ->
             (469, 625);
  K6_bwd_bf16  K6's backward on a bf16 rep at the flagship, as K6_bwd but with
             the directions' negatives' parts apart (a bf16 bank: a (2, 21,
             256, 256) gdir) and a bf16 gradient; library: torch.zeros of the
             bf16 (N, 256) rows, then index_add_ of bf16 rows; with its bytes
             bound;
  K6_bwd_bf16_no_draws  the same with every position inactive; library:
             torch.zeros of the bf16 rep;
  C_bwd_voc_bf16, C_bwd_city_main_bf16, C_bwd_city_aux_bf16  kernel C's
             backward in bf16 (the semi step's dtype), as the C_bwd rows:
             bf16 logits (3 x randn at VOC, the OHEM heads' logits), the
             gradient bf16; the hash covers the gradient's bits;
  A_decoder_bf16, A_decoder_city_bf16  kernel A's bf16 wide branch at the
             decoders' (8, 256, 65²) -> 129² and (4, 256, 97²) -> 193², with
             their bytes bound; library: F.interpolate on the bf16 input.
  K6_fwd_voc_bf16, K6_fwd_city_bf16  K6's forward as K6_fwd_voc / K6_fwd_city
             on a bf16 rep (the semi step's dtype), from a generator of their
             own (`new_rows`, after every older row); K6_fwd_voc_pq and
             K6_fwd_voc_pq_bf16 with a (21, 256, 256) f32 per-query positive
             (`anchor_ema`), f32 and bf16 rep; K6_fwd_voc_bf16_no_keys and
             K6_fwd_voc_bf16_one_pixel as the f32 rows' variants; each with
             its bytes bound;
  D_voc_prob_bf16, D_voc_entropy_bf16, D_city_prob_bf16, D_city_entropy_bf16
             kernel D's two semi-step calls on bf16 logits (3 x randn) at VOC
             and Cityscapes;
  C_fwd_voc_bf16, C_fwd_city_main_bf16, C_fwd_city_aux_bf16,
  C_fwd_city_unsup_bf16  C's forward on bf16 logits as the C_fwd rows (the
             hash covers the loss and C bwd's bf16 gradient);
  K7_prob_city_main_bf16, K7_prob_city_aux_bf16  K7 prob on bf16 logits as
             the K7_prob rows; the stats kernel's rows with their operations
             bound;
  A_bwd_voc_bf16, A_bwd_city_bf16  kernel A-bwd's bf16 wide branch (the
             decoders' exact 2x adjoint) at (8, 256, 129²) -> 65² and (4, 256,
             193²) -> 97², from a generator of their own (`adjoint_gather_rows`,
             after every older row); library: aten upsample_bilinear2d_backward
             on the bf16 gy; with their bytes bound;
  K5_gather_voc_bf16, K5_gather_voc  K5's gather (a rank's slab before the
             all_gather) of VOC_N_SEL rows at random distinct pixels of a
             (8, 256, 129²) bf16 / f32 rep into a (21, 8192, 256) slab; the
             hash covers the written rows; with their bytes bound and their
             NCHW sector bound (16 / 8 pixels a sector).
The K4r and K3c rows carry their bytes bound, as chip_smoke.py:bounds
counts it (each input read once, each output written once).
The K5 rows carry their NCHW sector bound: the distinct 32-byte sectors of
the rep that the written rows read, as chip_smoke.py:bounds counts them;
the K4 rows their bytes bound as chip_smoke.py:bounds counts it (K4 masks:
the bytes its inputs need, `masks_needed`).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F


# K5's per-class selection counts: chip_smoke.py's flagship case (phase 1,
# 18,051 keys) and a Cityscapes semi step's (phase 8, step 5: min(neg_cand,
# 12288)), read from a chip_smoke.py log on an NVIDIA H100 80GB HBM3
VOC_N_SEL = [8192, 475, 494, 479, 489, 510, 493, 507, 477, 473, 488, 484, 500, 459, 512,
             530, 514, 512, 506, 469, 488]
CITY_N_SEL = [0, 0, 0, 37, 0, 3053, 0, 66, 0, 1, 0, 5780, 16, 0, 0, 0, 150, 4, 1]
PEAK_BYTES_S = 3.35e12  # the H100 SXM's HBM rate, for the bounds written beside two rows


def masks_needed(prob, labels, low, high, b_l, cfg, ignore=255):
    """(bytes, compares) that contra_pixel_masks needs on these inputs: the
    (C, N) anchor, negative and low-valid outputs (6 bytes a value); every
    pixel's label and low bit, the unlabeled images' high bits; all C
    probabilities of an unlabeled pixel whose label rank decides its
    negative bit (a label in [0, C) other than `ignore`, high set, p[label]
    < the negative threshold), p[label] alone of every other such pixel
    with low set, or high set on an unlabeled image; C compares per ranked
    pixel.  chip_smoke.py:bounds and the K4_masks rows count with it."""
    b, c, h, w = prob.shape
    hw = h * w
    valid = (labels >= 0) & (labels < c) & (labels != ignore)
    unlabeled = torch.arange(b, device=labels.device)[:, None, None] >= b_l
    p_l = prob.gather(1, labels.clamp(0, c - 1).long()[:, None])[:, 0]
    ranked = valid & unlabeled & high & (p_l < cfg.current_class_negative_threshold)
    one = valid & ~ranked & (low | (unlabeled & high))
    n_ranked, n_one = int(ranked.sum()), int(one.sum())
    nbytes = c * b * hw * 6 + b * hw * 5 + (b - b_l) * hw + n_ranked * c * 4 + n_one * 4
    return nbytes, n_ranked * c


def rep_sectors(pix, hw, f, per):
    """The distinct 32-byte sectors of an NCHW (B, f, h, w) rep (hw = h * w
    pixels a plane) that reading every feature of the pixels `pix` (flat
    indices b * hw + y * w + x, an int64 tensor) touches, at `per` values a
    sector (8 float32, 16 bfloat16).  chip_smoke.py:bounds and the K5 rows
    count with it."""
    planes = (pix // hw * f)[:, None] + torch.arange(f, device=pix.device)
    return int(torch.unique((planes * hw + (pix % hw)[:, None]) // per).numel())


def cuda_ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # clock cycles: the host queues the calls meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, iters=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0  # each device op's mean duration (each runs once per call)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.count:
            us += (getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total) / ev.count
    return us / 1e3 if us > 0 else None


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def ohem_inputs(g, dev, hw, block):
    """OHEM logits at a Cityscapes head, (2, 19, hw²), whose label class
    leads at most pixels, and their 769² labels, 5% ignored."""
    from u2pl_tpu_torch.ops import resize as R

    cells = torch.randint(0, 19, (2, -(-hw // block), -(-hw // block)), device=dev,
                          generator=g, dtype=torch.int32)
    lab_s = R.resize_nearest(cells, (hw, hw))
    onehot = F.one_hot(lab_s.long(), 19).permute(0, 3, 1, 2).float()
    x = (8.0 * onehot - 4.0 + 0.3 * torch.randn(2, 19, hw, hw, device=dev, generator=g))
    lab = R.resize_nearest(lab_s, (769, 769)).contiguous()
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = 255
    return x.contiguous(), lab


PEAK_F32_FLOPS = 67e12  # the H100 SXM's float32 peak
PEAK_SFU_S = 16 * 132 * 1.98e9  # expf / logf: 16 per SM per clock at its 1.98 GHz


def bound_ms(nbytes, ops=0, sfu=0):
    """(bound ms, "bytes" or "operations"), as chip_smoke.py:bounds forms it."""
    t_b, t_o = nbytes / PEAK_BYTES_S, max(ops / PEAK_F32_FLOPS, sfu / PEAK_SFU_S)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def new_rows(out, dev):
    """K6's forward on a bf16 bank and the stats kernel's bf16 instance (D,
    C fwd, K7 prob) at the main path's shapes, from a generator of their
    own: the rows K6_fwd_voc_bf16 .. K7_prob_city_aux_bf16 of the module
    docstring, each with its bound (chip_smoke.py:bounds' counts)."""
    from u2pl_tpu_torch.losses import ce, ohem, unsup
    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.memobank import init_memobank

    g = torch.Generator(device=dev).manual_seed(22)
    bf, f, q, m = torch.bfloat16, 256, 256, 50
    for label, b, hw, c in (("voc", 8, 129, 21), ("city", 4, 193, 19)):
        n = b * hw * hw
        bank = init_memobank(c, f, dtype=bf, device=dev)
        for j in range(c):
            bank.keys[j].copy_(torch.randn(bank.keys.shape[1:], device=dev, generator=g))
        bank.occupancy.copy_(bank.sizes)
        rep = torch.randn(b, f, hw, hw, device=dev, generator=g)
        pools = torch.stack([torch.randperm(n, device=dev, generator=g)[:2000] for _ in range(c)])
        anchor_idx = pools.gather(1, torch.randint(0, 2000, (c, q), device=dev, generator=g))
        anchor_idx = anchor_idx.to(torch.int32).contiguous()
        active = torch.arange(c, device=dev) < c - 1
        rest = (bank, torch.randperm(c, device=dev, generator=g).to(torch.int32),
                torch.rand(c, q * m, device=dev, generator=g), active,
                torch.tensor(c - 1, dtype=torch.int32, device=dev), 0.5)
        per_class = torch.randn(c, f, device=dev, generator=g)
        per_query = torch.randn(c, q, f, device=dev, generator=g)
        act = int(active.sum())
        cases = [(f"K6_fwd_{label}_bf16", rep.to(bf), anchor_idx, per_class, rest, 2, f)]
        if label == "voc":
            cases += [("K6_fwd_voc_pq", rep, anchor_idx, per_query, rest, 4, q * f),
                      ("K6_fwd_voc_pq_bf16", rep.to(bf), anchor_idx, per_query, rest, 2, q * f),
                      ("K6_fwd_voc_bf16_no_keys", rep.to(bf), anchor_idx, per_class,
                       (rest[0], rest[1], rest[2][:, :0].contiguous(), *rest[3:]), 2, f),
                      ("K6_fwd_voc_bf16_one_pixel", rep.to(bf), torch.zeros_like(anchor_idx),
                       per_class, rest, 2, f)]
        for name, r, idx, pos, more, rbytes, pbytes in cases:
            mm = more[2].shape[1] // q
            fn = lambda: tc.contra_infonce(r, idx, pos, *more)  # noqa: E731
            with torch.no_grad():
                ms, prof = cuda_ms(fn, 20), profiled_ms(fn)
            loss = tc.contra_infonce(r.clone().requires_grad_(True), idx, pos, *more)
            gdir = loss.grad_fn.saved_tensors[3]
            out["kernels"][name] = {
                "ms": ms, "profiled_ms": prof, "library_ms": None,
                "sha256": digest(loss) + "-" + digest(gdir[..., active, :, :]),
                "bound": bound_ms(act * q * (f * rbytes + mm * (f * 2 + 4)) + act * pbytes * 4,
                                  act * q * (mm + 1) * f * 4)}
            del loss, gdir
        del bank, rep, per_query
    # the stats kernel in bf16: D's two calls, C's forward, K7 prob
    for label, b, c, hw, crop in (("voc", 4, 21, 129, 513), ("city", 2, 19, 193, 769)):
        x = (3 * torch.randn(b, c, hw, hw, device=dev, generator=g)).to(bf)
        lo, hi, px = b * c * hw * hw, b * c * crop * crop, b * crop * crop
        for outputs, keep, nb in (("prob", (0, 1), (lo * 2 + px * 8, hi * 12, hi + 2 * px)),
                                  ("entropy", (2,), (lo * 2 + px * 4, hi * 16, 2 * hi))):
            fn = lambda: unsup.upsample_softmax_stats(x, (crop, crop), outputs=outputs)  # noqa: E731
            res = fn()
            out["kernels"][f"D_{label}_{outputs}_bf16"] = {
                "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
                "sha256": "-".join(digest(res[i]) for i in keep), "bound": bound_ms(*nb)}
        del x
    x = (3 * torch.randn(4, 21, 129, 129, device=dev, generator=g)).to(bf)
    lab = torch.randint(0, 21, (4, 513, 513), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    xu = (3 * torch.randn(2, 19, 193, 193, device=dev, generator=g)).to(bf)
    labu = torch.randint(0, 19, (2, 769, 769), device=dev, generator=g, dtype=torch.int32)
    labu[torch.rand(labu.shape, device=dev, generator=g) < 0.2] = 255

    def head(hw, block):  # OHEM's kept labels of a bf16 head
        xh, labh = ohem_inputs(g, dev, hw, block)
        xh = xh.to(bf)
        return xh, ohem.ohem_kept_labels(xh, labh, 0.7, 100000)

    cpx = 2 * 769 * 769
    cases = {"C_fwd_voc_bf16": (x, lab, None),
             "C_fwd_city_main_bf16": (*head(193, 8), ohem._class_weight(True, dev)),
             "C_fwd_city_aux_bf16": (*head(97, 4), None),
             "C_fwd_city_unsup_bf16": (xu, labu, None)}
    for name, (xc, lc, cw) in cases.items():
        n_lo, n_hi, n_px = xc.numel(), xc.shape[0] * xc.shape[1] * lc.shape[1] * lc.shape[2], lc.numel()
        fn = lambda: ce.upsample_cross_entropy(xc, lc, 255, cw)  # noqa: E731
        with torch.no_grad():
            ms, prof = cuda_ms(fn), profiled_ms(fn)
        xg = xc.clone().requires_grad_(True)
        loss = ce.upsample_cross_entropy(xg, lc, 255, cw)
        (grad,) = torch.autograd.grad(loss, xg)
        out["kernels"][name] = {
            "ms": ms, "profiled_ms": prof, "library_ms": None,
            "sha256": digest(loss) + "-" + digest(grad.view(torch.int16)),
            "bound": bound_ms(n_lo * 2 + n_px * 8 + (0 if cw is None else 19 * 4),
                              n_hi * 11, n_hi + n_px)}
    for name, hw, block in (("K7_prob_city_main_bf16", 193, 8), ("K7_prob_city_aux_bf16", 97, 4)):
        xk, labk = ohem_inputs(g, dev, hw, block)
        xk = xk.to(bf)
        fn = lambda: ohem.ohem_target_prob(xk, labk)  # noqa: E731
        p_y, nv = fn()
        valid = int(nv)
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": digest(p_y) + "-" + digest(nv), "num_valid": valid,
            "bound": bound_ms(xk.numel() * 2 + cpx * 8, valid * 19 * 11, valid * 19)}


def adjoint_gather_rows(out, dev):
    """A-bwd's bf16 wide branch at the decoders' 2x and K5's gather at the
    flagship, from a generator of their own: the rows A_bwd_voc_bf16 ..
    K5_gather_voc of the module docstring, each with its bytes bound (the
    gathers also with their NCHW sector bound)."""
    from u2pl_tpu_torch import memobank as mb
    from u2pl_tpu_torch.ops import resize as R

    g = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    for name, shape, size in (("A_bwd_voc_bf16", (8, 256, 65, 65), (129, 129)),
                              ("A_bwd_city_bf16", (4, 256, 97, 97), (193, 193))):
        gy = (3 * torch.randn(shape[:2] + size, device=dev, generator=g)).to(bf)
        fn = lambda: R.resize_bilinear_bwd(gy, shape[2:])  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                gy, list(size), list(shape), True)),
            "sha256": digest(fn().view(torch.int16)),
            "bound": bound_ms(shape[0] * shape[1] * (size[0] * size[1] + shape[2] * shape[3]) * 2)}
        del gy
    b, hw, k, c = 8, 129 * 129, 8192, len(VOC_N_SEL)
    sel = torch.stack([torch.randperm(b * hw, device=dev, generator=g)[:k] for _ in range(c)])
    sel = sel.to(torch.int32).contiguous()
    n_sel = torch.tensor(VOC_N_SEL, dtype=torch.int32, device=dev)
    rows = torch.arange(k, device=dev)[None, :] < torch.clamp(n_sel, max=k)[:, None]
    pix, n_rows = sel[rows].long(), int(rows.sum())
    rep = torch.randn(b, 256, 129, 129, device=dev, generator=g)
    for name, r in (("K5_gather_voc_bf16", rep.to(bf)), ("K5_gather_voc", rep)):
        rb = r.element_size()
        fn = lambda: mb.memobank_gather(r, sel, n_sel)  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": digest(fn()[rows].view(torch.int16)), "rows": n_rows,
            "bound": bound_ms(n_rows * (4 + 2 * 256 * rb)),
            "sector_bound_ms": (rep_sectors(pix, hw, 256, 32 // rb) * 32
                                + n_rows * (4 + 256 * rb)) / PEAK_BYTES_S * 1e3}
        del r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose u2pl_tpu_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("timing_ab: no CUDA card", file=sys.stderr)
        return 1
    from u2pl_tpu_torch import kernels
    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.ops import resize as R

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = kernels.load()
    out = {"label": args.label, "root": args.root, "card": card, "kernels": {}}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, shape, size in (("A_logits", (4, 21, 129, 129), (513, 513)),
                              ("A_decoder", (8, 256, 65, 65), (129, 129))):
        x = torch.randn(*shape, device=dev, generator=g)
        fn = lambda: R.resize_bilinear(x, size)  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: F.interpolate(
                x, size=size, mode="bilinear", align_corners=True)),
            "sha256": digest(fn()),
        }
        del x

    b, f, hw, c, q = 8, 256, 129 * 129, 21, 256
    pools = torch.stack([torch.randperm(b * hw, device=dev, generator=g)[:2000] for _ in range(c)])
    anchor_idx = pools.gather(1, torch.randint(0, 2000, (c, q), device=dev, generator=g))
    anchor_idx = anchor_idx.to(torch.int32).contiguous()
    active = torch.arange(c, device=dev) < c - 1
    valid_seg = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    gdir = torch.randn(c, q, f, device=dev, generator=g)
    one = torch.ones((), device=dev)
    shape = (b, f, 129, 129)
    if hasattr(tc, "_infonce_bwd_cuda"):
        bwd = lambda: tc._infonce_bwd_cuda(anchor_idx, active, valid_seg, gdir, one, shape)  # noqa: E731
    else:  # the first design's backward: a zeroed gradient, then its kernel
        def bwd():
            grad = torch.zeros(shape, device=dev)
            tc._launch(lib, "u2pl_contra_infonce_bwd", "contra_infonce_bwd", dev,
                       anchor_idx.data_ptr(), active.data_ptr(), valid_seg.data_ptr(),
                       gdir.data_ptr(), one.data_ptr(), grad.data_ptr(), b, f, hw, c, q)
            return grad
    rows = anchor_idx.flatten().long()
    src = gdir.view(c * q, f)
    out["kernels"]["K6_bwd"] = {
        "ms": cuda_ms(bwd, 20), "profiled_ms": profiled_ms(bwd),
        "library_ms": cuda_ms(lambda: torch.zeros(b * hw, f, device=dev).index_add_(
            0, rows, src), 20),
        "sha256": digest(bwd()),
    }
    none = torch.zeros_like(active)
    if hasattr(tc, "_infonce_bwd_cuda"):
        empty = lambda: tc._infonce_bwd_cuda(anchor_idx, none, valid_seg, gdir, one, shape)  # noqa: E731
    else:
        active = none
        empty = bwd
    out["kernels"]["K6_bwd_no_draws"] = {
        "ms": cuda_ms(empty, 20), "profiled_ms": profiled_ms(empty),
        "library_ms": cuda_ms(lambda: torch.zeros(shape, device=dev), 20),
        "sha256": digest(empty()),
    }
    from u2pl_tpu_torch.losses import ce, ohem

    def ohem_head(hw, block):
        x, lab = ohem_inputs(g, dev, hw, block)
        return x, ohem.ohem_kept_labels(x, lab, 0.7, 100000)

    x = torch.randn(4, 21, 129, 129, device=dev, generator=g)
    lab = torch.randint(0, 21, (4, 513, 513), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    cases = {"C_bwd_voc": (x, lab, None),
             "C_bwd_city_main": (*ohem_head(193, 8), ohem._class_weight(True, dev)),
             "C_bwd_city_aux": (*ohem_head(97, 4), None)}
    for name, (x, lab, cw) in cases.items():
        x = x.requires_grad_(True)
        loss = ce.upsample_cross_entropy(x, lab, 255, cw)
        fn = lambda: torch.autograd.grad(loss, x, retain_graph=True)[0]  # noqa: E731
        out["kernels"][name] = {"ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
                                "library_ms": None, "sha256": digest(fn())}
    from u2pl_tpu_torch.losses import unsup

    selects = "outputs" in inspect.signature(unsup.upsample_softmax_stats).parameters
    for label, shape, size in (("voc", (4, 21, 129, 129), (513, 513)),
                               ("city", (2, 19, 193, 193), (769, 769))):
        x = torch.randn(*shape, device=dev, generator=g) * 3
        for outputs, keep in (("prob", (0, 1)), ("entropy", (2,))):
            if selects:
                fn = lambda: unsup.upsample_softmax_stats(x, size, outputs=outputs)  # noqa: E731
            else:
                fn = lambda: unsup.upsample_softmax_stats(x, size)  # noqa: E731
            res = fn()
            out["kernels"][f"D_{label}_{outputs}"] = {
                "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
                "sha256": "-".join(digest(res[i]) for i in keep)}
        del x
    c, n, k = 21, 8 * 129 * 129, 8192
    density = torch.rand(c, 1, device=dev, generator=g) * 0.3
    density[c - 1] = 0.0
    mask = torch.rand(c, n, device=dev, generator=g) < density
    pri = torch.rand(c, n, device=dev, generator=g)
    masked = torch.where(mask, pri, torch.full_like(pri, float("inf")))
    fn = lambda: tc.select_keys(mask, pri, k)  # noqa: E731
    idx, n_sel = fn()
    out["kernels"]["K4_select"] = {
        "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
        "library_ms": cuda_ms(lambda: torch.sort(masked, dim=1, stable=True)),
        "sha256": digest(idx) + "-" + digest(n_sel), "n_sel": n_sel.tolist()}
    for name, shape, size in (("A_bwd_voc", (8, 256, 65, 65), (129, 129)),
                              ("A_bwd_city", (4, 256, 97, 97), (193, 193))):
        gy = torch.randn(shape[:2] + size, device=dev, generator=g)
        fn = lambda: R.resize_bilinear_bwd(gy, shape[2:])  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                gy, list(size), list(shape), True)),
            "sha256": digest(fn())}
        del gy
    x = torch.randn(4, 21, 129, 129, device=dev, generator=g)
    lab = torch.randint(0, 21, (4, 513, 513), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    xu = torch.randn(2, 19, 193, 193, device=dev, generator=g)
    labu = torch.randint(0, 19, (2, 769, 769), device=dev, generator=g, dtype=torch.int32)
    labu[torch.rand(labu.shape, device=dev, generator=g) < 0.2] = 255
    cases = {"C_fwd_voc": (x, lab, None),
             "C_fwd_city_main": (*ohem_head(193, 8), ohem._class_weight(True, dev)),
             "C_fwd_city_aux": (*ohem_head(97, 4), None),
             "C_fwd_city_unsup": (xu, labu, None)}
    for name, (x, lab, cw) in cases.items():
        fn = lambda: ce.upsample_cross_entropy(x, lab, 255, cw)  # noqa: E731
        with torch.no_grad():
            ms, prof = cuda_ms(fn), profiled_ms(fn)
        xg = x.clone().requires_grad_(True)
        loss = ce.upsample_cross_entropy(xg, lab, 255, cw)
        (grad,) = torch.autograd.grad(loss, xg)
        out["kernels"][name] = {"ms": ms, "profiled_ms": prof, "library_ms": None,
                                "sha256": digest(loss) + "-" + digest(grad)}
    from u2pl_tpu_torch.memobank import clone_bank, init_memobank, memobank_enqueue

    def bank_digest(bank):
        return "-".join(digest(t) for t in (bank.keys.view(torch.int16), bank.ptr,
                                            bank.occupancy))

    for label, b, hw, n_sel, k in (("voc", 8, 129, VOC_N_SEL, 8192),
                                   ("city", 4, 193, CITY_N_SEL, 12288)):
        c, q, m = len(n_sel), 256, 50
        n = b * hw * hw
        bank = init_memobank(c, 256, dtype=torch.bfloat16, device=dev)
        for j in range(c):
            bank.keys[j].copy_(torch.randn(bank.keys.shape[1:], device=dev, generator=g))
        bank.occupancy.copy_(bank.sizes)
        bank.ptr.copy_(bank.sizes - k // 8)
        rep = torch.randn(b, 256, hw, hw, device=dev, generator=g)
        pools = torch.stack([torch.randperm(n, device=dev, generator=g)[:2000] for _ in range(c)])
        anchor_idx = pools.gather(1, torch.randint(0, 2000, (c, q), device=dev, generator=g))
        args = (anchor_idx.to(torch.int32).contiguous(),
                torch.randn(c, 256, device=dev, generator=g), bank,
                torch.randperm(c, device=dev, generator=g).to(torch.int32),
                torch.rand(c, q * m, device=dev, generator=g),
                torch.arange(c, device=dev) < c - 1,
                torch.tensor(c - 1, dtype=torch.int32, device=dev), 0.5)
        fn = lambda: tc.contra_infonce(rep, *args)  # noqa: E731
        with torch.no_grad():
            ms, prof = cuda_ms(fn, 20), profiled_ms(fn)
        loss = tc.contra_infonce(rep.clone().requires_grad_(True), *args)
        out["kernels"][f"K6_fwd_{label}"] = {
            "ms": ms, "profiled_ms": prof, "library_ms": None,
            "sha256": digest(loss) + "-" + digest(loss.grad_fn.saved_tensors[3][args[5]])}
        del loss
        if label == "voc":  # where the time goes: no keys; every anchor on one pixel
            for name, part in (("no_keys", (args[0], *args[1:4], args[4][:, :0].contiguous())),
                               ("one_pixel", (torch.zeros_like(args[0]), *args[1:5]))):
                part = part + args[5:]
                fn = lambda: tc.contra_infonce(rep, *part)  # noqa: E731
                with torch.no_grad():
                    out["kernels"][f"K6_fwd_voc_{name}"] = {
                        "ms": cuda_ms(fn, 20), "profiled_ms": None, "library_ms": None,
                        "sha256": digest(fn())}
        sel = torch.stack([torch.randperm(n, device=dev, generator=g)[:k] for _ in range(c)])
        enq = (rep, sel.to(torch.int32).contiguous(),
               torch.tensor(n_sel, dtype=torch.int32, device=dev))
        timed = clone_bank(bank)
        fn = lambda: memobank_enqueue(timed, *enq)  # noqa: E731
        # the NCHW sector bound (chip_smoke.py:bounds): the distinct 32-byte
        # sectors of the rep that the written rows' pixels touch, the
        # indices read and the bf16 rows written
        n_new = torch.clamp(enq[2], max=k).long()
        first = torch.clamp(n_new - bank.sizes.long(), min=0)
        rank = torch.arange(sel.shape[1], device=dev)
        pix = sel[(rank >= first[:, None]) & (rank < n_new[:, None])]
        sectors = rep_sectors(pix, hw * hw, 256, 8)
        out["kernels"][f"K5_{label}"] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": bank_digest(memobank_enqueue(clone_bank(bank), *enq)),
            "keys": sum(n_sel),
            "sector_bound_ms": (sectors * 32 + sum(n_sel) * (4 + 256 * 2)) / PEAK_BYTES_S * 1e3}
        del bank, timed, rep
    from u2pl_tpu_torch.ops import quantile

    for name, hw, block in (("K7_prob_city_main", 193, 8), ("K7_prob_city_aux", 97, 4)):
        x, lab = ohem_inputs(g, dev, hw, block)
        fn = lambda: ohem.ohem_target_prob(x, lab)  # noqa: E731
        p_y, nv = fn()
        out["kernels"][name] = {"ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
                                "library_ms": None,
                                "sha256": digest(p_y) + "-" + digest(nv), "num_valid": int(nv)}
        if name == "K7_prob_city_main":
            flat = p_y.reshape(-1)
            fn = lambda: quantile.kth_smallest(p_y, 100000)  # noqa: E731
            out["kernels"]["K7_kth_city"] = {
                "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
                "library_ms": cuda_ms(lambda: torch.kthvalue(flat, 100000)),
                "sha256": digest(fn())}
    for name, shape, pct in (("E_voc_1", (4, 513, 513), [80.25]),
                             ("E_voc_3", (4, 513, 513), [80.25, 19.75, 80.25]),
                             ("E_city_3", (2, 769, 769), [80.25, 19.75, 80.25])):
        v = torch.rand(shape, device=dev, generator=g) * 3
        v.view(-1)[: v.numel() // 4] = torch.randint(
            0, 9, (v.numel() // 4,), device=dev, generator=g).float() * 0.25
        m = torch.rand(shape, device=dev, generator=g) < 0.85
        q = torch.tensor(pct, device=dev)
        fn = lambda: quantile.masked_percentiles(v, m, q)  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            # numpy-'linear' percentiles of the masked values: the same function
            "library_ms": cuda_ms(lambda: torch.quantile(v[m], q / 100.0,
                                                         interpolation="linear")),
            "sha256": digest(fn())}
    # kernel A at the Cityscapes decoder's upsample, (4, 256, 97²) -> 193²
    x = torch.randn(4, 256, 97, 97, device=dev, generator=g)
    fn = lambda: R.resize_bilinear(x, (193, 193))  # noqa: E731
    out["kernels"]["A_decoder_city"] = {
        "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
        "library_ms": cuda_ms(lambda: F.interpolate(x, size=(193, 193), mode="bilinear",
                                                    align_corners=True)),
        "sha256": digest(fn()),
        "bound_ms": 4 * 256 * (97 * 97 + 193 * 193) * 4 / PEAK_BYTES_S * 1e3}
    from u2pl_tpu_torch.config import parse_config

    ccfg = parse_config({"trainer": {"contrastive": {
        "low_rank": 3, "high_rank": 20, "current_class_threshold": 0.3,
        "current_class_negative_threshold": 1}}}).trainer.contrastive
    for label, b_l, c, hw in (("voc", 4, 21, 129), ("city", 2, 19, 193)):
        b, q = 2 * b_l, 256
        n = b * hw * hw
        prob = torch.softmax(4 * torch.randn(b, c, hw, hw, device=dev, generator=g), dim=1)
        lab = torch.randint(0, c, (b, hw, hw), device=dev, generator=g, dtype=torch.int32)
        lab[torch.rand(lab.shape, device=dev, generator=g) < 0.6] = 0
        lab[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = 255
        low = torch.rand(lab.shape, device=dev, generator=g) < 0.7
        high = torch.rand(lab.shape, device=dev, generator=g) < 0.5
        low[:b_l] = high[:b_l] = lab[:b_l] != 255
        fn = lambda: tc.contra_pixel_masks(prob, lab, low, high, b_l, ccfg)  # noqa: E731
        res = fn()
        out["kernels"][f"K4_masks_{label}"] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": "-".join(digest(t) for t in res), "counts": res[3].tolist(),
            "bound_ms": masks_needed(prob, lab, low, high, b_l, ccfg)[0] / PEAK_BYTES_S * 1e3}
        a_j = torch.arange(c, dtype=torch.int32, device=dev)
        u = torch.rand(c, q, device=dev, generator=g)
        u[:, 0] = 0.99999994
        fn = lambda: tc.sample_anchors(res[0], a_j, u)  # noqa: E731
        idx, cnt = fn()
        out["kernels"][f"K4_anchors_{label}"] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": digest(idx) + "-" + digest(cnt), "n": cnt.tolist(),
            "bound_ms": (c * n + 2 * c * q * 4) / PEAK_BYTES_S * 1e3}
        del prob, lab, low, high, res
    for label, c, n, k in (("voc", 21, 8 * 129 * 129, 8192), ("city", 19, 4 * 193 * 193, 12288)):
        density = torch.rand(c, 1, device=dev, generator=g) * 0.3
        density[c - 1] = 0.0
        mask = torch.rand(c, n, device=dev, generator=g) < density
        keys = torch.randint(-2**31, 2**31, (c, n), device=dev, generator=g, dtype=torch.int64)
        u32 = keys & 0xFFFFFFFF
        tie, top = torch.argsort(mask.sum(1), descending=True)[:2].tolist()
        kv = torch.where(mask[tie], u32[tie], torch.full_like(u32[tie], 2**32 - 1))
        t = int(torch.kthvalue(kv, k).values)
        above = torch.nonzero(mask[tie] & (u32[tie] > t)).flatten()[:64]
        keys[tie, above] = t - 2**32 if t >= 2**31 else t
        keys[top, torch.nonzero(mask[top]).flatten()[0]] = -1
        keys = keys.to(torch.int32)
        masked = torch.where(mask, keys.to(torch.int64) & 0xFFFFFFFF,
                             torch.full((c, n), 2**32 - 1, dtype=torch.int64, device=dev))
        fn = lambda: tc.select_keys_radix(mask, keys, k)  # noqa: E731
        idx, n_sel = fn()
        out["kernels"][f"K4r_{label}"] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: torch.topk(masked, k, dim=1, largest=False,
                                                     sorted=False)),
            "sha256": digest(idx) + "-" + digest(n_sel), "n_sel": n_sel.tolist(),
            "bound_ms": (c * n * 5 + c * k * 4 + c * 4) / PEAK_BYTES_S * 1e3}
        del mask, keys, masked, kv
    from u2pl_tpu_torch.ops import mixing

    for label, b, c, hw in (("voc", 4, 21, 513), ("city", 2, 19, 769)):
        img = torch.randn(b, 3, hw, hw, device=dev, generator=g)
        lab = torch.randint(0, c, (b, hw, hw), device=dev, generator=g, dtype=torch.int32)
        lab[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = 255
        lab[1] = 7
        prob = torch.rand(b, hw, hw, device=dev, generator=g)
        u = torch.rand(b, c, device=dev, generator=g)
        u[0, 1::3] = u[0, 0]
        fn = lambda: mixing.generate_unsup_data(img, lab, prob, u, "classmix")  # noqa: E731
        out["kernels"][f"K3c_{label}"] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn), "library_ms": None,
            "sha256": "-".join(digest(t) for t in fn()),
            "bound_ms": (2 * b * hw * hw * (12 + 4 + 4) + b * c * 4) / PEAK_BYTES_S * 1e3}
        del img, lab, prob
    # kernel A at the 3-plane request images and an eval scale's image resize
    for name, shape, size in (("A_image_voc", (1, 3, 375, 500), (513, 513)),
                              ("A_image_city", (1, 3, 1024, 2048), (769, 769)),
                              ("A_eval_voc_125", (1, 3, 375, 500), (469, 625))):
        x = torch.randn(*shape, device=dev, generator=g)
        fn = lambda: R.resize_bilinear(x, size)  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn, 100), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: F.interpolate(x, size=size, mode="bilinear",
                                                        align_corners=True), 100),
            "sha256": digest(fn()),
            "bound_ms": 3 * (shape[2] * shape[3] + size[0] * size[1]) * 4 / PEAK_BYTES_S * 1e3}
        del x
    # K6's backward on a bf16 rep and a bf16 bank (the negatives' parts apart)
    b, f, hw, c, q = 8, 256, 129 * 129, 21, 256
    pools = torch.stack([torch.randperm(b * hw, device=dev, generator=g)[:2000] for _ in range(c)])
    anchor_idx = pools.gather(1, torch.randint(0, 2000, (c, q), device=dev, generator=g))
    anchor_idx = anchor_idx.to(torch.int32).contiguous()
    active = torch.arange(c, device=dev) < c - 1
    gdir = torch.randn(2, c, q, f, device=dev, generator=g)
    shape, bf = (b, f, 129, 129), torch.bfloat16
    rows = anchor_idx.flatten().long()
    src = torch.randn(c * q, f, device=dev, generator=g).to(bf)
    for name, act in (("K6_bwd_bf16", active), ("K6_bwd_bf16_no_draws", torch.zeros_like(active))):
        fn = lambda: tc._infonce_bwd_cuda(  # noqa: E731
            anchor_idx, act, valid_seg, gdir, one, shape, bf)
        lib_fn = ((lambda: torch.zeros(b * hw, f, device=dev, dtype=bf).index_add_(0, rows, src))
                  if act.any() else (lambda: torch.zeros(shape, device=dev, dtype=bf)))
        out["kernels"][name] = {
            "ms": cuda_ms(fn, 50), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lib_fn, 50), "sha256": digest(fn().view(torch.int16)),
            "bound_ms": (b * f * hw * 2 + int(act.sum()) * q * (2 * f * 4 + 4))
            / PEAK_BYTES_S * 1e3}
    # kernel C's backward and kernel A's wide branch in bf16
    bf = torch.bfloat16
    x = (3 * torch.randn(4, 21, 129, 129, device=dev, generator=g)).to(bf)
    lab = torch.randint(0, 21, (4, 513, 513), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255

    def ohem_head_bf16(hw, block):
        xh, labh = ohem_inputs(g, dev, hw, block)
        xh = xh.to(bf)
        return xh, ohem.ohem_kept_labels(xh, labh, 0.7, 100000)

    cases = {"C_bwd_voc_bf16": (x, lab, None),
             "C_bwd_city_main_bf16": (*ohem_head_bf16(193, 8), ohem._class_weight(True, dev)),
             "C_bwd_city_aux_bf16": (*ohem_head_bf16(97, 4), None)}
    for name, (x, lab, cw) in cases.items():
        x = x.requires_grad_(True)
        loss = ce.upsample_cross_entropy(x, lab, 255, cw)
        fn = lambda: torch.autograd.grad(loss, x, retain_graph=True)[0]  # noqa: E731
        out["kernels"][name] = {"ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
                                "library_ms": None, "sha256": digest(fn().view(torch.int16))}
    for name, shape, size in (("A_decoder_bf16", (8, 256, 65, 65), (129, 129)),
                              ("A_decoder_city_bf16", (4, 256, 97, 97), (193, 193))):
        x = (3 * torch.randn(*shape, device=dev, generator=g)).to(bf)
        fn = lambda: R.resize_bilinear(x, size)  # noqa: E731
        out["kernels"][name] = {
            "ms": cuda_ms(fn), "profiled_ms": profiled_ms(fn),
            "library_ms": cuda_ms(lambda: F.interpolate(x, size=size, mode="bilinear",
                                                        align_corners=True)),
            "sha256": digest(fn().view(torch.int16)),
            "bound_ms": shape[0] * shape[1] * (shape[2] * shape[3] + size[0] * size[1]) * 2
            / PEAK_BYTES_S * 1e3}
        del x
    new_rows(out, dev)
    adjoint_gather_rows(out, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
