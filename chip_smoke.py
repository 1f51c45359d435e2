#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (u2pl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit code:
  0. setup: the card's name and power limit, the kernels built from
     u2pl_tpu_torch/kernels/csrc with nvcc, and the yaml / PIL probe;
  1. each CUDA kernel against its plain PyTorch version at the serving and
     training paths' shapes, on the card; kernel A also bit-equal to the
     rounded H-then-W formula (`resize_bilinear_rounded`) at every A_SHAPES
     entry (the request images' and the Cityscapes eval crops' shapes
     among them) in every mode (f32, bf16 narrow or wide, bf16 -> f32),
     with its launch plan (the direct kernel at the 3-plane images),
     kernel B at identity sizes equal to argmax; kernel D at
     the VOC and Cityscapes steps' shapes, its max-prob +
     argmax and its entropy calls bit-equal to its all-outputs call; kernel
     E (one cooperative launch, one block per SM) bit-equal to the masked
     sort at 1 to 4 percents with ties, an empty mask, n = 1, n not a
     multiple of its grid, under its block count and past its shared
     memory;
  2. the slice: the full VOC model of experiments/pascal/1464/ours (ResNet-101
     + DeepLabv3+, 21 classes, float32 as serve.py's default) from seeded
     random weights, saved as a reference-format .pth, loaded by InferEngine
     and driven through run_server with six JPEG requests (each image
     uploaded, normalised and resized to 513² on the card by kernel A); the
     loaded images are checked against the numpy route, the served masks
     against the plain-version path (numpy load, plain resizes) and the
     kernels' launches per image and batch;
  3. timings: a request's load on the card beside the numpy route, the
     save per image, a request's latency at batch 1, forwards at batch 1
     and 4, each kernel beside its plain version, peak device memory;
     kernel A at the logits', the decoder's, the VOC and Cityscapes
     request images' and the Cityscapes eval crops' shapes beside
     F.interpolate, with torch.profiler's device time per call;
  4. the training slice: the same VOC config minus its `trainer.contrastive`
     block, full ResNet-101 student and EMA teacher from seeded random
     weights, 5 steps of 4 labeled + 4 unlabeled synthetic 513² images
     through `train.steps.run_steps` (2 warmup, 2 in the first semi epoch,
     1 in epoch 2), checked for finite losses, gradients reaching the ASPP
     and layer4, the teacher copy / EMA, teacher BN tracking and every
     training kernel's launch count (A-bwd once per step: the decoder's;
     the logits' adjoint resize is inside C's backward; D twice per semi
     step, once per output selection, and K4's masks, key selection and
     anchor draws once each where the contrastive branch runs: phases 6
     and 8 too); then step 5 again
     from a copy of the state, through the kernels and through the plain
     versions, compared;
  5. training timings: warmup and semi step medians, images/s, peak device
     memory, each training kernel beside its plain version (A-bwd at the
     VOC and Cityscapes decoders' shapes beside aten's own backward; C's
     backward, fused with its adjoint resize, with torch.profiler's device
     time; D's two calls of the semi step, max-prob + argmax and entropy,
     apart; E at one percentile and at the contrastive step's three);
  6. the contrastive slice: the full `ours` config WITH trainer.contrastive
     (a (21, 50000, 256) bf16 memory bank, 8192 keys per class and step,
     256 queries, 50 negatives), 5 steps through `run_steps` (2 warmup, 3
     semi), checked for finite losses, con_loss > 0 on every semi step, the
     bank's occupancy against the keys enqueued, a gradient reaching the
     representation head and every kernel's launch count; then step 5 again
     from a copy, through the kernels and through the plain versions,
     compared, and the contrastive loss on the step's own inputs, kernels
     against plain versions (the loss and gradient against the plain
     versions in float64), its selections and bank bit-equal;
  7. contrastive timings: the contrastive semi step's median, images/s and
     peak memory, and each K4-K6 kernel beside its plain version and, where
     one exists, a single PyTorch call for the same function; K6's backward
     timed as a plain call (`_infonce_bwd_cuda`, its gradient's allocation
     included), through torch.autograd.grad and in torch.profiler's trace;
  8. the Cityscapes slice: experiments/cityscapes/744/ours as it stands
     (ResNet-101 + DeepLabv3+ with the aux head, 19 classes, OHEM on both
     heads, the contrastive branch with 12288 keys per class and a (19,
     50000, 256) bf16 bank), float32, from seeded random weights, 5 semi
     steps (sup_only_epoch 0) of 2 labeled + 2 unlabeled synthetic 769²
     images through `run_steps`, checked for finite losses, con_loss > 0,
     gradients in the aux and representation heads, the bank's occupancy,
     the heads' strides and the OHEM kernels' launches on both heads of
     every step, with the kept-pixel count per head and step; step 5 again
     through the kernels and through the plain versions, compared; then 2
     steps of experiments/cityscapes/744/suponly through `make_sup_step`;
  9. Cityscapes timings: the semi step's median, images/s and peak memory,
     each OHEM kernel (K7; K7 prob at both heads) beside its plain version
     and a library call, and C's forward and backward at the main head
     (kept labels, the OHEM class weight) and the aux head (kept labels),
     C's forward at the unsupervised CE's, D's two calls, E's
     contrastive call and K4's masks and anchor draws (first held
     bit-equal to their plain versions) at the Cityscapes shape;
 10. the trainer CLIs: a synthetic VOC-layout workspace (16 labeled, 16
     unlabeled and 4 val JPEG / PNG pairs of 500x375, from SEED) and
     `u2pl_tpu_torch.train_semi.main` on experiments/pascal/1464/ours as it
     stands but for the data paths, n_sup 16, pool_size 32, 2 epochs and
     sup_only_epoch 1 (4 steps of 4 + 4 images at 513² per epoch, the
     contrastive branch on): two validations with per-class IoU, ckpt.pth
     and ckpt_best.pth, every kernel's launches (kernel B once per val
     image); then a rerun with epochs 3 and auto_resume, which must start
     at epoch 2, step 8 with the saved bank, and `train_sup` on suponly for
     one epoch; step time, data wait, checkpoint seconds and bytes;
 11. the variant: the same workspace with apply_aug classmix,
     contrastive.select_keys radix and sup_only_epoch 0, one epoch; the
     K3c and K4r kernels must launch; its last step again through the
     kernels and through the plain versions, compared;
 12. eval and infer: `u2pl_tpu_torch.eval` on phase 10's workspace (val
     images of four sizes) and ckpt_best.pth at scales 1.0 and 0.75 / 1.0
     / 1.25, `u2pl_tpu_torch.infer` at batch 1 and 3; then a Cityscapes
     workspace of two 1024x2048 images and the `ours` config at full width
     from seeded random weights, eval at base_size 2048, scale 1.0 (8
     crops of 769² in one forward) and infer at 769²; every run again
     through the plain versions and the numpy load, masks compared, with
     seconds per image, launches of A and B per image and the mIoU; the
     VOC evals once more with every shape seen.
 13. bfloat16: phases 1-12 pin net.dtype float32 (every experiment config
     says bfloat16: `load_f32`, F32_OVERRIDE); this phase holds each bf16
     kernel mode against its plain bf16 version at the paths' full shapes
     (A wide and narrow bit-equal to `resize_bilinear_rounded`, A-bwd, C
     bwd and K6 bwd equal but at bf16 rounding boundaries, C fwd, D and K7
     prob against the statistics of kernel A's rounded upsample, K5
     bit-equal) and times it beside its f32 mode (K6 bwd also with no
     draws, its zero write alone); then the VOC `ours`
     config as it stands, in bf16, 5 steps through `run_steps` with their
     launches, its semi step's time and peak memory, and step 5 again
     through the kernels, the plain versions and the kernels in f32 (the
     routes held within BF16_ROUTE_SHARE of that bf16-vs-f32 gap); then 2
     Cityscapes `ours` semi steps in bf16 (OHEM on both heads) and the
     step's time.
 14. bfloat16 serving, infer and eval (`--dtype bfloat16`): kernel B's
     bf16 mode against its f32 mode on the exact upcast at the VOC and
     Cityscapes serving shapes (labels equal at every pixel) and kernel
     A's bf16 -> f32 mode against its f32 mode at VOC eval's per-scale
     logits (bit-equal), A's narrow bf16 mode at VOC eval's decoder and
     logits shapes against its rounded formula (bit-equal), each timed
     beside its f32 mode; then
     `InferEngine(dtype="bfloat16")` on the VOC `ours` config at full
     width from seeded random weights: `run_server` on six JPEGs with its
     launches, the masks through the kernels against the plain versions
     on the same bf16 logits, batch-1 latency (p50, p99), masks/s at batch
     8 and peak memory beside a float32 engine, and the bf16-vs-f32 mask
     agreement (printed, not gated); `u2pl_tpu_torch.eval --dtype
     bfloat16` on phase 10's workspace at 1 and 3 scales (also through the
     plain versions on the kernel route's own bf16 logits, masks equal but
     at near-ties, then again with every size seen) and on phase 12's
     Cityscapes workspace (the same), with seconds per image, launches of each mode
     per image and the mIoU beside phase 12's f32 one; `u2pl_tpu_torch.infer
     --dtype bfloat16` at batch 3 and on Cityscapes.
 15. K5's modes for several ranks: the gather (each rank's (21, 8192,
     256) slab of keys from the teacher's NCHW rep) and the slab enqueue
     (the all-gathered (W, 21, 8192, 256) slabs into the (21, 50000, 256)
     bank) against their plain versions, in bf16 and f32, for 1, 2, 4 and
     8 ranks on rings that wrap; at 8 ranks class 0 takes more keys than
     its queue; rows, keys, ptr and occupancy bit-equal; each timed beside
     its plain version and the enqueue beside one `index_put_`, with its
     bytes bound;
 16. the data-parallel VOC bf16 contrastive semi step (the `ours` config
     as it stands) through `u2pl_tpu_torch.dist`: (a) 3 steps with no group
     and in a one-process NCCL group on the card, cuDNN deterministic,
     bit-equal after every step, ms per step of each; (b) 2 ranks, one
     process each (`--phase16-rank`): NCCL with one rank per card on a
     machine with two, else both on cuda:0 under gloo (NCCL takes one rank
     per device), 4 + 4 images a rank, SyncBN, the gradient mean and the
     bank's exchange; the ranks' states bit-equal after every step, each
     rank's step through the kernels and the plain versions held to phase
     13's bounds, ms per step and the bytes of the slab exchange;
 17. `contrastive.anchor_ema`: the VOC `ours` config as it stands (bf16)
     with `trainer.contrastive.anchor_ema: true` set in memory, 5 steps
     through `run_steps` (2 warmup, 3 semi): the prototype all zero into
     the first semi step, written after each at the active positions' bank-
     class slots and nowhere else, K6's per-query mode once a semi step,
     con_loss finite and > 0, the step's ms beside phase 13's; then step 5
     again through the kernels, the plain versions and the kernels in f32
     (phase 13's bounds, the new prototypes among them); then the same
     config in f32, 5 steps through `run_steps` with the counts set to 0
     just before them, the same checks: the f32 per-query mode's run.
Phase 1 also holds K6's forward with a (C, Q, F) positive (the anchor_ema
blend; its per-query mode) against the plain route in float64, with an f32
and a bf16 rep, each timed beside the per-class mode on the same inputs.
Phase 1 also holds the contrastive kernels (K4: pixel masks, key selection,
anchor draws; K5: the bank write; K6: the InfoNCE forward and backward)
against their plain versions at the flagship shapes, on a prefilled bank
that wraps, the OHEM kernels (K7: target-class probability, k-th
smallest, kept labels) at the Cityscapes heads' shapes, with the k-th value
above and below thresh, k = 1 and k = n, an all-ignored map and fewer valid
pixels than min_kept, and K3c (ClassMix) and K4r (radix key selection)
bit-equal at the flagship's shapes, with tied draws, a single-class
sample, keys tied at the threshold, valid 0xFFFFFFFF keys, a class under
the cap and an empty one.
Phases 4, 6, 8 and 11 compare a step through the two routes: the teacher's
pseudo-labels may differ between them only at near ties of the upsampled
logits, and the plain route then takes the kernel route's (`both_routes`).
Kernel times are CUDA events around back-to-back calls queued behind a
device sleep (`cuda_ms`), so they time the card, not the host's launches.
It prints a JSON line of kernels (each with its launches on the main paths,
its error against its plain version, its time beside the plain version's,
its bound and a library call's time; kernel A once per shape, the logits',
the decoder's, the VOC and Cityscapes request images' and the Cityscapes
eval crops'; K4 masks
and anchor draws at VOC and at Cityscapes; each bf16 mode with its f32
mode's time as `f32_ms`, each with its own path's launches; K5's gather
and slab modes with their launches on phase 16's runs and each world's
times in `by_world`), then one JSON line
{"ok": true, "device": {...}} as the last line of its output.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
VOC_CONFIG = os.path.join(ROOT, "experiments", "pascal", "1464", "ours", "config.yaml")
CITY_CONFIG = os.path.join(ROOT, "experiments", "cityscapes", "744", "ours", "config.yaml")
CITY_SUP_CONFIG = os.path.join(ROOT, "experiments", "cityscapes", "744", "suponly", "config.yaml")
VOC_SUP_CONFIG = os.path.join(ROOT, "experiments", "pascal", "1464", "suponly", "config.yaml")
SEED = 0

# phase 1 shapes: kernel A (B, C, H, W) -> (OH, OW); kernel B (C, H, W) -> (h, w)
A_IMAGE = ((1, 3, 375, 500), (513, 513))  # a served VOC request image -> the input scale
A_IMAGE_CITY = ((1, 3, 1024, 2048), (769, 769))  # a served Cityscapes request image
A_EVAL_CROP = ((8, 19, 193, 193), (769, 769))  # Cityscapes eval: 8 crops' os4 logits
A_SHAPES = [
    ((4, 21, 129, 129), (513, 513)),  # serving: os4 logits -> input scale
    ((8, 256, 65, 65), (129, 129)),  # decoder: os8 -> os4, the semi step's 4 + 4 images
    ((2, 3, 97, 65), (513, 513)),
    ((2, 3, 7, 9), (33, 17)),
    ((2, 3, 1, 5), (4, 10)),
    A_IMAGE,
    A_IMAGE_CITY,
    A_EVAL_CROP,
]
B_SHAPES = [
    ((21, 513, 513), (375, 500)),
    ((21, 513, 513), (500, 333)),
    ((21, 513, 513), (7, 9)),
    # identity sizes (eval's multi-scale total): the taps are exact, so B is argmax
    ((21, 375, 500), (375, 500)),
    ((19, 1024, 2048), (1024, 2048)),
]
# kernel A vs plain, max abs diff on randn inputs: the kernel rounds each
# product and sum, but the plain version's matmul may fuse and reorder them
# (against `resize_bilinear_rounded`, the same ops one by one: bit-equal)
A_TOL = 1e-5
FEATURES = 256  # the decoder's channels: kernel A's launches at 256 channels are its upsample
NEAR_TIE = 1e-5  # kernel B: labels may differ only where top-2 gap <= this (relative)
MIN_AGREEMENT = 0.999  # served mask vs plain-version path, per image
# six requests: one full batch of 4 and a partial batch of 2
IMAGE_SIZES = [(375, 500), (500, 333), (281, 500), (375, 500), (333, 500), (500, 375)]

# training slice: 4 labeled + 4 unlabeled 513² images per step, 5 steps at
# 2 steps per epoch (sup_only_epoch 1 in the config): 2 warmup, 2 in the
# first semi epoch, 1 in epoch 2
CROP = 513
B_L = B_U = 4
STEPS_PER_EPOCH = 2
TRAIN_STEPS = 5
# phase-1 bounds of the training kernels
A_BWD_TOL = 1e-4  # max abs diff / max |grad|
C_LOSS_TOL = 1e-5  # relative
C_GRAD_TOL = 1e-6  # max abs diff / max |grad|
D_TOL = 1e-5  # relative, max-prob and entropy
# step 5 through the kernels vs through the plain versions
STEP_LOSS_TOL = 1e-4  # relative: sup_loss, uns_loss, drop_thresh
STEP_UPDATE_TOL = 1e-2  # per tensor: L2 of the update difference / L2 of the update
# ... plus this RMS per element: the conv biases that feed a BN have a zero
# gradient in exact arithmetic, so their update is weight decay + rounding
# noise (~1e-9 per element at lr 1e-3), on any two routes
STEP_UPDATE_FLOOR = 1e-8
# contrastive slice: the flagship's os4 batch and the kernels' bounds
OS4 = 129
K6_LOSS_TOL = 1e-5  # relative
K6_GRAD_TOL = 1e-6  # max abs diff / max |grad|
CON_LOSS_TOL = 1e-4  # step 5, kernels vs plain versions, relative
# Cityscapes slice: 2 labeled + 2 unlabeled 769² images per step, the os4
# main head and the os8 aux head, 19 classes; OHEM's kernels' bounds
CITY_CROP = 769
CITY_B = 2
CITY_OS4, CITY_OS8 = 193, 97
CITY_SUP_STEPS = 2
# p_y, relative, per pixel: against the softmax of kernel A's upsample
# (the same upsampled logits; measured bit-equal), and against the plain
# version, whose matmul resize rounds the logits (|x| < 8) up to 9.5e-7
# apart (measured on the card: p_y up to 1.15e-6 apart)
K7_PROB_TOL = 1e-6
K7_PLAIN_TOL = 2e-6
K7_NEAR = 1e-6  # a kept pixel may differ between routes only this close (relative) to the threshold
# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# expf / logf on the special-function units: 16 per SM per clock, 132 SMs
# at the 1.98 GHz that the 67 TFLOP/s float32 peak assumes
PEAK_SFU_S = 16 * 132 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30) -> float:
    """Mean device ms per call of `fn` over `iters` back-to-back calls.  A
    ~20 ms device sleep is queued first, so the host enqueues the calls
    while the card waits and the events time the device's work, not the
    host's launch overhead (unless `fn` waits for the card itself)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_profiled(fn, iters: int = 10):
    """Device ms per call of `fn` from torch.profiler over `iters` calls:
    the mean duration of each of the device's kernels, memsets and copies,
    summed over them (each runs once per call; the trace may drop some
    events), and their names with their counts; None when the trace shows
    no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, names = 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.count:
            total = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
            us += total / ev.count
            names[ev.key[:40]] = ev.count
    return (us / 1e3, names) if us > 0 else None


def profiled_text(prof) -> str:
    if prof is None:
        return "none in the trace"
    ms, names = prof
    return f"{ms:.4f} ms (device events seen: {names})"


def phase1_kernels(dev):
    import torch

    from u2pl_tpu_torch.ops.resize import (
        _fwd_plan, _resize_mode, _sm_count, _wide, resize_argmax, resize_argmax_plain,
        resize_bilinear, resize_bilinear_plain, resize_bilinear_rounded,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    a_err = {}
    for shape, out in A_SHAPES:
        x = torch.randn(*shape, device=dev, generator=g)
        y = resize_bilinear(x, out)
        torch.cuda.synchronize()
        exact = resize_bilinear_rounded(x, out)
        ref = resize_bilinear_plain(x, out)
        torch.cuda.synchronize()
        if y.shape != ref.shape:
            fail(f"kernel A {shape}->{out}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
        same = torch.equal(y, exact)
        err = (y - ref).abs().max().item()
        log(f"[phase 1] kernel A {shape} -> {out}: bit-equal to the rounded H-then-W formula "
            f"{same}; max abs diff to the plain version {err:.3e} (bound {A_TOL})")
        if not same or not err <= A_TOL:
            fail(f"kernel A {shape}->{out}: bit-equal {same}, max abs diff {err} (bound {A_TOL})")
        a_err[shape] = err
        # the bf16 modes at the same shape and plan: bf16 in and out (the
        # wide branch at 256 channels with bf16-exact weights, else narrow),
        # and bf16 in, f32 out
        xb = x.to(torch.bfloat16)
        same_bf = torch.equal(resize_bilinear(xb, out), resize_bilinear_rounded(xb, out))
        same_up = torch.equal(resize_bilinear(xb, out, out_dtype=torch.float32),
                              resize_bilinear_rounded(xb.float(), out))
        torch.cuda.synchronize()
        branch = "wide" if _wide(xb.dtype, shape[1], shape[2:], out, True) else "narrow"
        plan = _fwd_plan(shape[0] * shape[1], *shape[2:], *out, _sm_count(dev))
        bplan = _fwd_plan(shape[0] * shape[1], *shape[2:], *out, _sm_count(dev),
                          _resize_mode(xb.dtype, shape[1], shape[2:], out, True))
        log(f"[phase 1] kernel A {shape} -> {out} {plan}: bf16 ({branch}, plan "
            f"{bplan}) bit-equal to the rounded formula {same_bf}; bf16 -> f32 {same_up}")
        if not same_bf or not same_up:
            fail(f"kernel A {shape}->{out}: bf16 modes bit-equal {same_bf} / {same_up}")
        del x, y, exact, ref, xb
    b_err = 0
    for shape, out in B_SHAPES:
        x = torch.randn(*shape, device=dev, generator=g)
        m = resize_argmax(x, out)
        torch.cuda.synchronize()
        ref = resize_argmax_plain(x, out)
        top2 = resize_bilinear_plain(x[None], out)[0].topk(2, dim=0).values
        torch.cuda.synchronize()
        near = (top2[0] - top2[1]) <= NEAR_TIE * top2[0].abs().clamp(min=1.0)
        bad = (m != ref) & ~near
        diff = (m.int() - ref.int()).abs()[~near]
        err = int(diff.max().item()) if diff.numel() else 0
        log(
            f"[phase 1] kernel B {shape} -> {out}: {int((m != ref).sum())} label "
            f"mismatches, {int(bad.sum())} outside the {int(near.sum())} near-tie "
            f"pixels (bound 0)"
        )
        if bad.any():
            fail(f"kernel B {shape}->{out}: {int(bad.sum())} mismatches off near-ties")
        if out == shape[1:]:
            exact = torch.equal(m, x.argmax(dim=0).to(torch.uint8))
            log(f"[phase 1] kernel B at identity size {out}: equal to argmax {exact}")
            if not exact:
                fail(f"kernel B at identity size {out} differs from argmax")
        b_err = max(b_err, err)
        del x, m, ref, top2
    return a_err, b_err


def synthetic_jpegs(folder: str):
    """Smooth random colour fields with noise, one JPEG per IMAGE_SIZES entry."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(SEED)
    paths = []
    for i, (h, w) in enumerate(IMAGE_SIZES):
        coarse = rng.rand(h // 32 + 2, w // 32 + 2, 3)
        img = np.kron(coarse, np.ones((32, 32, 1)))[:h, :w] * 200
        img = np.clip(img + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)
        path = os.path.join(folder, f"synthetic_{i}.jpg")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


def random_weights_pth(cfg, path):
    """A reference-format .pth (model_state = teacher_state) of `cfg.net`
    at full width from seeded random weights, BN statistics drawn too;
    returns the parameter count."""
    import torch

    from u2pl_tpu_torch.models import build_model

    g = torch.Generator().manual_seed(SEED)
    model = build_model(cfg.net, device="cpu", generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = model.state_dict()
    torch.save({"epoch": 0, "model_state": sd, "teacher_state": sd, "best_miou": 0.0}, path)
    return sum(p.numel() for p in model.parameters())


def phase2_slice(dev, card, tmp):
    import numpy as np
    import torch
    from PIL import Image

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.serving import InferEngine, load_image_plain, run_server

    cfg = load_config(VOC_CONFIG)
    log(
        f"[phase 2] config {os.path.relpath(VOC_CONFIG, ROOT)}: "
        f"{cfg.net.encoder.type.rsplit('.', 1)[-1]} + "
        f"{cfg.net.decoder.type.rsplit('.', 1)[-1]}, {cfg.net.num_classes} classes, "
        f"multi_grid={cfg.net.encoder.multi_grid}, rep_head={cfg.net.decoder.rep_head}, "
        f"served in float32 (config dtype {cfg.net.dtype})"
    )
    t0 = time.monotonic()
    pth = os.path.join(tmp, "ckpt_best.pth")
    n_params = random_weights_pth(cfg, pth)
    engine = InferEngine(cfg, pth, batch_size=4, dtype="float32", device=dev)
    log(f"[phase 2] {n_params} parameters; model built, saved, loaded in "
        f"{time.monotonic() - t0:.1f}s")
    warmup_s = engine.warmup()
    log(f"[{card}] warmup (first batch-4 forward): {warmup_s:.3f} s")

    images = synthetic_jpegs(tmp)
    out = os.path.join(tmp, "served")
    reqs = [json.dumps({"op": "ping", "id": "p0"})]
    reqs += [json.dumps({"op": "infer", "id": f"r{i}", "image": p}) for i, p in enumerate(images)]
    reqs += ["{not json", json.dumps({"op": "shutdown", "id": "bye"})]

    batches, masks = [], []
    forward, to_mask = engine.forward, engine.to_mask
    engine.forward = lambda imgs: (batches.append(len(imgs)), forward(imgs))[1]
    engine.to_mask = lambda logit, size: (masks.append(to_mask(logit, size)), masks[-1])[1]
    writer = io.StringIO()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.monotonic()
    served = run_server(
        io.StringIO("".join(r + "\n" for r in reqs)), writer, engine,
        default_save_folder=out, batch_window_s=0.5,
    )
    serve_s = time.monotonic() - t0
    launches = {a: n for a, n in read_counters().items()
                if a in ("A", "A_logits", "A_decoder", "A_image", "B")}
    peak_serve = torch.cuda.max_memory_allocated(dev)
    engine.forward, engine.to_mask = forward, to_mask

    resp = [json.loads(line) for line in writer.getvalue().splitlines()]
    log(f"[phase 2] served {served} requests in {serve_s:.3f} s; batches {batches}; "
        f"launches A={launches['A']} (request images {launches['A_image']}, logits "
        f"{launches['A_logits']}, decoder {launches['A_decoder']}) B={launches['B']}")
    if [r["id"] for r in resp] != ["p0"] + [f"r{i}" for i in range(6)] + [None, "bye"]:
        fail(f"unexpected responses {resp}")
    if not (resp[0]["ok"] and resp[0]["served"] == 0 and resp[-1]["ok"]):
        fail(f"ping/shutdown responses {resp[0]} {resp[-1]}")
    if resp[7]["ok"] or "bad request" not in resp[7]["error"]:
        fail(f"malformed line answered {resp[7]}")
    if batches != [4, 2] or served != 6 or len(masks) != 6:
        fail(f"batches {batches}, served {served}, masks {len(masks)}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
    if (launches["A_image"], launches["A_logits"], launches["B"]) != (6, 2, 6):
        fail(f"want kernel A once per request image and per batch and B once per image: "
             f"{launches}")
    for r, path, mask in zip(resp[1:7], images, masks):
        if not r["ok"] or r["batch_ms"] <= 0:
            fail(f"infer response {r}")
        h, w = Image.open(path).size[::-1]
        for key, shape in (("gray", (h, w)), ("color", (h, w, 3))):
            got = np.asarray(Image.open(r[key])).shape
            if got != shape:
                fail(f"{r[key]}: shape {got} != {shape}")
        if mask.shape != (h, w) or mask.max() >= cfg.net.num_classes:
            fail(f"mask {mask.shape} max {mask.max()} for {(h, w)}")

    # the request images on the card (kernel A) against the numpy route
    loaded = [engine.load(p) for p in images]
    load_err = max((img - load_image_plain(p, engine.mean, engine.std, engine.input_scale, dev)[0])
                   .abs().max().item() for (img, _), p in zip(loaded, images))
    log(f"[phase 2] request images loaded on the card vs the numpy route: max abs diff "
        f"{load_err:.3e} (bound {A_TOL})")
    if not load_err <= A_TOL:
        fail(f"the request image's load on the card differs from the numpy route by {load_err}")
    # the same requests through the plain versions of both kernels and the numpy load
    before = (R.resize_bilinear.launches, R.resize_argmax.launches)
    agreement = []
    with torch.inference_mode(), plain_versions():
        plain_loaded = [engine.load(p) for p in images]
        for i in range(0, len(plain_loaded), 4):
            chunk = plain_loaded[i : i + 4]
            logits = engine.model(torch.stack([img for img, _ in chunk]))["pred"]
            up = R.resize_bilinear_plain(logits, engine.input_scale)
            if not torch.isfinite(up).all():
                fail("non-finite logits")
            for j, (_, size) in enumerate(chunk):
                plain = R.resize_argmax_plain(up[j], size).cpu().numpy()
                agreement.append(float((plain == masks[i + j]).mean()))
    if (R.resize_bilinear.launches, R.resize_argmax.launches) != before:
        fail("the plain-version path launched a kernel")
    log(f"[phase 2] served masks vs plain-version path, pixel agreement per image: "
        f"{agreement} (bound {MIN_AGREEMENT}); logits range "
        f"[{up.min().item():.3f}, {up.max().item():.3f}]")
    if min(agreement) < MIN_AGREEMENT:
        fail(f"served masks disagree with the plain path: {agreement}")
    label_counts = np.bincount(np.concatenate([m.ravel() for m in masks]), minlength=21)
    log(f"[phase 2] label histogram of the served masks: {label_counts.tolist()}")
    log(f"[{card}] peak device memory while serving: {peak_serve / 2**20:.1f} MiB")
    return engine, images, loaded, launches


def phase3_timings(dev, card, engine, images, loaded, tmp):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.serving import load_image_plain

    # a request's load: decode, upload, normalise and resize to 513² on the
    # card (engine.load, kernel A), beside the numpy route (decode,
    # normalise, resize on the host, upload), each synchronised; and mask
    # encoding (two PNG writes)
    load_ms, plain_load_ms, save_ms = [], [], []
    for path, (_, size) in zip(images, loaded):
        t0 = time.perf_counter()
        engine.load(path)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        load_image_plain(path, engine.mean, engine.std, engine.input_scale, dev)
        torch.cuda.synchronize()
        plain_load_ms.append((time.perf_counter() - t0) * 1e3)
        mask = np.zeros(size, np.uint8)
        t0 = time.perf_counter()
        engine.save_mask(mask, path, os.path.join(tmp, "timing"))
        save_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[{card}] per request image, load on the card (decode, upload, normalise, kernel A "
        f"to 513²): median {statistics.median(load_ms):.2f} ms (min {min(load_ms):.2f}, max "
        f"{max(load_ms):.2f}); the numpy route (resize on the host): median "
        f"{statistics.median(plain_load_ms):.1f} ms (min {min(plain_load_ms):.1f}, max "
        f"{max(plain_load_ms):.1f}); save_mask median {statistics.median(save_ms):.1f} ms, over "
        f"{len(images)} images")
    imgs = [img for img, _ in loaded]
    fwd = {}
    for bs in (1, 4):
        batch = imgs[:bs]
        for _ in range(2):
            engine.forward(batch)
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for _ in range(12):
            t0 = time.perf_counter()
            engine.forward(batch)
            runs.append((time.perf_counter() - t0) * 1e3)
        fwd[bs] = statistics.median(runs)
        log(
            f"[{card}] forward batch {bs} (host->device copy, model, upsample; "
            f"synchronised): median {fwd[bs]:.3f} ms over {len(runs)} runs "
            f"(min {min(runs):.3f}, max {max(runs):.3f}); "
            f"{bs * 1e3 / fwd[bs]:.2f} img/s; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB"
        )
    # a request's latency at batch 1: load, forward, mask (kernel B), two PNGs
    latency = []
    for path in images * 2:
        t0 = time.perf_counter()
        img, size = engine.load(path)
        logits = engine.forward([img])
        engine.save_mask(engine.to_mask(logits[0], size), path, os.path.join(tmp, "latency"))
        latency.append((time.perf_counter() - t0) * 1e3)
    latency = latency[len(images):]  # the second pass: every shape seen before
    log(f"[{card}] request latency at batch 1 (load on the card, forward, kernel B, two PNGs): "
        f"median {statistics.median(latency):.2f} ms (min {min(latency):.2f}, max "
        f"{max(latency):.2f}) over {len(latency)} requests")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    times = {}  # name -> (kernel ms, plain ms, library ms or None)
    for name, (shape, out) in (("A_logits", A_SHAPES[0]), ("A_decoder", A_SHAPES[1]),
                               ("A_image", A_IMAGE), ("A_image_city", A_IMAGE_CITY),
                               ("A_eval_crop", A_EVAL_CROP)):
        x = torch.randn(*shape, device=dev, generator=g)
        k = cuda_ms(lambda: R.resize_bilinear(x, out))
        p = cuda_ms(lambda: R.resize_bilinear_plain(x, out))
        lib = cuda_ms(lambda: F.interpolate(x, size=out, mode="bilinear", align_corners=True))
        prof = device_ms_profiled(lambda: R.resize_bilinear(x, out))
        times[name] = (k, p, lib)
        log(f"[{card}] kernel A {shape} -> {out}: {k:.4f} ms; plain version {p:.4f} ms; "
            f"F.interpolate(bilinear, align_corners=True) {lib:.4f} ms; torch.profiler device "
            f"time per call {profiled_text(prof)}")
        del x
    logits = torch.randn(21, 513, 513, device=dev, generator=g)
    k = cuda_ms(lambda: R.resize_argmax(logits, (375, 500)))
    p = cuda_ms(lambda: R.resize_argmax_plain(logits, (375, 500)))
    times["B"] = (k, p, None)
    log(f"[{card}] kernel B (21, 513, 513) -> (375, 500): {k:.4f} ms; plain version {p:.4f} ms")
    return times


def phase1_train_kernels(dev):
    """The training slice's kernels against their plain versions, on the card,
    at the slice's shapes and a few odd ones.  Returns {kernel: max error}."""
    import torch

    from u2pl_tpu_torch.losses import ce, unsup
    from u2pl_tpu_torch.ops import mixing, quantile
    from u2pl_tpu_torch.ops import resize as R

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    # A-bwd: the decoder's os8 -> os4 upsample at VOC and Cityscapes, and
    # the logits' upsample
    worst = 0.0
    for shape, out in (((8, 256, 65, 65), (129, 129)),
                       ((4, FEATURES, CITY_OS8, CITY_OS8), (CITY_OS4, CITY_OS4)),
                       ((4, 21, 129, 129), (513, 513)), ((2, 3, 33, 17), (7, 9))):
        x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
        y = R.resize_bilinear(x, out)
        if not y.requires_grad:
            fail("kernel A: the output of a tensor that requires grad has no grad_fn")
        gy = torch.randn(y.shape, device=dev, generator=g)
        (gx,) = torch.autograd.grad(y, x, gy)
        ref = R.resize_bilinear_bwd_plain(gy, shape[2:])
        torch.cuda.synchronize()
        abs_err = (gx - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        again = R.resize_bilinear_bwd(gy, shape[2:])
        log(f"[phase 1] kernel A-bwd {shape[2:]} <- {out} x{shape[0] * shape[1]} planes: max abs "
            f"diff / max |grad| {err:.3e} (bound {A_BWD_TOL}); run-to-run equal: "
            f"{torch.equal(again, gx)}")
        if not err <= A_BWD_TOL or not torch.equal(again, gx):
            fail(f"kernel A-bwd {shape}->{out}: {err}")
        worst = max(worst, abs_err)
        del x, y, gy, gx, ref, again
    errs["A_bwd"] = worst

    # C forward and backward (fused with its adjoint resize) at the VOC CE's
    # shape, the Cityscapes heads' (weighted on the main head, most pixels
    # ignored as after OHEM) and an odd one; all-ignored -> 0
    from u2pl_tpu_torch.losses.ohem import CITYSCAPES_OHEM_WEIGHT

    city_w = torch.tensor(CITYSCAPES_OHEM_WEIGHT, dtype=torch.float32, device=dev)
    loss_err = grad_err = 0.0
    for shape, out, cw, ignore_frac in (
            ((4, 21, 129, 129), (513, 513), None, 0.1),
            ((CITY_B, 19, CITY_OS4, CITY_OS4), (CITY_CROP, CITY_CROP), city_w, 0.9),
            ((CITY_B, 19, CITY_OS8, CITY_OS8), (CITY_CROP, CITY_CROP), None, 0.9),
            ((3, 5, 9, 7), (33, 25), None, 0.1)):
        x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
        lab = torch.randint(0, shape[1], (shape[0],) + out, device=dev, generator=g,
                            dtype=torch.int32)
        lab[torch.rand(lab.shape, device=dev, generator=g) < ignore_frac] = 255
        loss = ce.upsample_cross_entropy(x, lab, 255, cw)
        n_abwd = R.resize_bilinear_bwd.launches
        (gx,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        if R.resize_bilinear_bwd.launches != n_abwd:
            fail("kernel C's backward launched kernel A-bwd: it is fused with it")
        xp = x.detach().clone().requires_grad_(True)
        ref = ce.upsample_cross_entropy_plain(xp, lab, 255, cw)
        (gref,) = torch.autograd.grad(ref, xp)
        gplain = ce.upsample_ce_bwd_plain(x.detach(), lab, cw)
        torch.cuda.synchronize()
        le_abs, ge_abs = abs(loss.item() - ref.item()), (gx - gref).abs().max().item()
        le, ge = le_abs / abs(ref.item()), ge_abs / gref.abs().max().item()
        gp = (gx - gplain).abs().max().item() / gplain.abs().max().item()
        log(f"[phase 1] kernel C {shape} -> {out}{', weighted' if cw is not None else ''}, "
            f"{ignore_frac:.0%} ignored: loss {loss.item():.6f} vs plain {ref.item():.6f}, rel "
            f"diff {le:.3e} (bound {C_LOSS_TOL}); gradient max abs diff / max |grad| {ge:.3e} "
            f"against autograd of the plain loss, {gp:.3e} against upsample_ce_bwd_plain "
            f"(bound {C_GRAD_TOL})")
        if not (le <= C_LOSS_TOL and ge <= C_GRAD_TOL and gp <= C_GRAD_TOL):
            fail(f"kernel C {shape}: loss {le}, gradient {ge} / {gp}")
        loss_err, grad_err = max(loss_err, le_abs), max(grad_err, ge_abs)
        del x, lab, loss, gx, xp, ref, gref, gplain
    x = torch.randn(4, 21, 129, 129, device=dev, generator=g, requires_grad=True)
    lab = torch.full((4, 513, 513), 255, dtype=torch.int32, device=dev)
    loss = ce.upsample_cross_entropy(x, lab)
    (gx,) = torch.autograd.grad(loss, x)
    log(f"[phase 1] kernel C all ignored: loss {loss.item()}, gradient all zero "
        f"{not gx.any().item()} (must be 0 and True)")
    if loss.item() != 0.0 or gx.any().item():
        fail("kernel C: an all-ignored batch must give loss 0 and a zero gradient")
    errs["C_fwd"], errs["C_bwd"] = loss_err, grad_err

    # D: max-prob, argmax, entropy, at the VOC and Cityscapes steps' shapes
    # and an odd one; each output selection bit-equal to the all-outputs call
    worst = 0.0
    for shape, out in (((4, 21, 129, 129), (513, 513)),
                       ((CITY_B, 19, CITY_OS4, CITY_OS4), (CITY_CROP, CITY_CROP)),
                       ((3, 5, 9, 7), (33, 25))):
        x = torch.randn(*shape, device=dev, generator=g) * 3
        mp, am, ent = unsup.upsample_softmax_stats(x, out)
        pmp, pam, pent = unsup.upsample_softmax_stats(x, out, outputs="prob")
        emp, eam, eent = unsup.upsample_softmax_stats(x, out, outputs="entropy")
        rmp, ram, rent = unsup.upsample_softmax_stats_plain(x, out)
        top2 = R.resize_bilinear_plain(x, out).topk(2, dim=1).values
        near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE * top2[:, 0].abs().clamp(min=1.0)
        torch.cuda.synchronize()
        e_mp = ((mp - rmp).abs() / rmp.abs()).max().item()
        e_ent = ((ent - rent).abs() / rent.abs().clamp(min=1e-3)).max().item()
        bad = int(((am != ram) & ~near).sum())
        selected = (torch.equal(pmp, mp) and torch.equal(pam, am) and pent is None
                    and emp is None and eam is None and torch.equal(eent, ent))
        log(f"[phase 1] kernel D {shape} -> {out}: max-prob rel {e_mp:.3e}, entropy rel "
            f"{e_ent:.3e} (bound {D_TOL}); argmax {int((am != ram).sum())} mismatches, {bad} "
            f"outside the {int(near.sum())} near-tie pixels (bound 0); the max-prob + argmax "
            f"and the entropy calls bit-equal to the all-outputs call: {selected}")
        if not (e_mp <= D_TOL and e_ent <= D_TOL and bad == 0 and selected):
            fail(f"kernel D {shape}: {e_mp} {e_ent} {bad} {selected}")
        worst = max(worst, (mp - rmp).abs().max().item(), (ent - rent).abs().max().item())
        del x, mp, am, ent, pmp, pam, eent, rmp, ram, rent, top2, near
    errs["D"] = worst

    # E: bit-equal to the masked sort at 1 to 4 percents, 1,052,676 values
    # (4 x 513²) with ties, an empty mask, n = 1, and n against the
    # descent's grid (one block per SM): not a multiple of it, under its
    # block count, past what its shared memory holds
    from u2pl_tpu_torch.ops.resize import _sm_count

    sms = _sm_count(dev)
    grid, _, cap = quantile._descent_plan(1 << 30, sms)
    pct = torch.tensor([0.0, 85.0, 37.5, 100.0], device=dev)
    cases = []
    for name, n in ((f"{B_U * CROP * CROP:,} values, ~85% valid, ties", B_U * CROP * CROP),
                    (f"n = {1_182_722 + 3 * sms + 1:,}, not a multiple of the {grid} blocks",
                     1_182_722 + 3 * sms + 1),
                    (f"n = {sms // 2 + 1}, under the {grid} blocks", sms // 2 + 1),
                    (f"n = {grid * cap + 12_345:,}, past the grid's shared memory "
                     f"({grid * cap:,} keys)", grid * cap + 12_345)):
        v = torch.rand(n, device=dev, generator=g) * 3
        v[: n // 4] = torch.randint(0, 9, (n // 4,), device=dev, generator=g).float() * 0.25
        cases.append((name, v, torch.rand(n, device=dev, generator=g) < 0.85))
    ent, valid = cases[0][1:]
    one = torch.zeros_like(valid)
    one[valid.numel() // 3] = True
    cases += [("empty mask", ent, torch.zeros_like(valid)), ("n = 1", ent, one)]
    for name, v, m in cases:
        for k in range(1, 5):
            got = quantile.masked_percentiles(v, m, pct[:k])
            ref = quantile.masked_percentiles_plain(v, m, pct[:k])
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"kernel E ({name}, {k} percents) is not bit-equal to the masked sort: "
                     f"{got.tolist()} vs {ref.tolist()}")
        log(f"[phase 1] kernel E {name}: {got.tolist()} at 1-4 percents, each bit-equal to "
            f"the masked sort")
    del cases, v, one
    errs["E"] = 0.0

    # K3: cutmix and cutout, bit-equal
    img = torch.randn(B_U, 3, CROP, CROP, device=dev, generator=g)
    lab = torch.randint(0, 21, (B_U, CROP, CROP), device=dev, generator=g, dtype=torch.int32)
    prob = torch.rand(B_U, CROP, CROP, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, B_U, CROP, CROP)
    for mode in ("cutmix", "cutout"):
        got = mixing.generate_unsup_data(img, lab, prob, boxes, mode)
        ref = mixing.generate_unsup_data_plain(img, lab, prob, boxes, mode)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"[phase 1] kernel K3 {mode} {tuple(img.shape)}, boxes {boxes.tolist()}: bit-equal {same}")
        if not same:
            fail(f"kernel K3 ({mode}) is not bit-equal to its plain version")
    errs["K3"] = 0.0
    return errs


def classmix_case(dev, g):
    """K3c's inputs at the flagship's shapes: (4, 3, 513², 513²) images,
    pseudo-labels (~5% 255, which count as class C-1; sample 1 a single
    class), max-probs and (4, C) draws, sample 0's with ties."""
    import torch

    img = torch.randn(B_U, 3, CROP, CROP, device=dev, generator=g)
    lab = torch.randint(0, 21, (B_U, CROP, CROP), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = 255
    lab[1] = 7
    prob = torch.rand(B_U, CROP, CROP, device=dev, generator=g)
    u = torch.rand(B_U, 21, device=dev, generator=g)
    u[0, 1::3] = u[0, 0]
    return img, lab, prob, u


def radix_case(dev, g, negative, k):
    """K4r's inputs: the flagship's (21, N) negative mask with u32 keys (in
    int32) from `g`, and planted cases on the classes with the most
    candidates, in order: 64 more masked keys tied at the rank-k key (the
    first, over the cap), a masked key 0xFFFFFFFF, a class cut to k // 2
    masked pixels (all taken, one of them keyed 0xFFFFFFFF), an empty
    class.  Returns (mask, keys, the
    four classes)."""
    import torch

    mask = negative.clone()
    keys = torch.randint(-2**31, 2**31, mask.shape, device=dev, generator=g, dtype=torch.int64)
    keys = keys.to(torch.int32)
    tie, top, cut, empty = torch.argsort(mask.sum(1), descending=True)[:4].tolist()
    u32 = keys.to(torch.int64) & 0xFFFFFFFF
    kv = torch.where(mask[tie], u32[tie], torch.full_like(u32[tie], 2**32 - 1))
    t = int(torch.kthvalue(kv, k).values)
    above = torch.nonzero(mask[tie] & (u32[tie] > t)).flatten()[:64]
    keys[tie, above] = t - 2**32 if t >= 2**31 else t
    keys[top, torch.nonzero(mask[top]).flatten()[0]] = -1
    on = torch.nonzero(mask[cut]).flatten()
    mask[cut, on[k // 2:]] = False
    keys[cut, on[0]] = -1  # taken: its class is under the cap
    mask[empty] = False
    return mask, keys, (tie, top, cut, empty)


def phase1_variant_kernels(dev, negative, k):
    """K3c (ClassMix) and K4r (radix key selection) against their plain
    versions, bit-equal, at the flagship's shapes, with the planted cases
    of `classmix_case` and `radix_case`.  Returns ({kernel: max error},
    their inputs)."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.ops import mixing

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    img, lab, prob, u = classmix_case(dev, g)
    before = (mixing.generate_unsup_data.classmix_launches, tc.select_keys_radix.launches)
    got = mixing.generate_unsup_data(img, lab, prob, u, "classmix")
    ref = mixing.generate_unsup_data_plain(img, lab, prob, u, "classmix")
    sel = mixing.class_half_mask_plain(lab, u, u.shape[1])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    kept = [round(float(s.float().mean()), 4) for s in sel]
    log(f"[phase 1] kernel K3c classmix {tuple(img.shape)}, {u.shape[1]} classes, tied draws in "
        f"sample 0, sample 1 one class: share of each sample's pixels kept {kept}; bit-equal {same}")
    if not same or kept[1] != 0.0 or not all(0 < s < 1 for s in kept[:1] + kept[2:]):
        fail("kernel K3c (classmix) is not bit-equal to its plain version (or a case is missing)")

    mask, keys, (tie, top, cut, empty) = radix_case(dev, g, negative, k)
    idx, n_sel = tc.select_keys_radix(mask, keys, k)
    ref_idx, ref_n = tc.select_keys_radix_plain(mask, keys, k)
    torch.cuda.synchronize()
    same = torch.equal(idx, ref_idx) and torch.equal(n_sel, ref_n)
    cnt = mask.sum(1)
    u32 = keys.to(torch.int64) & 0xFFFFFFFF
    kv = torch.where(mask[tie], u32[tie], torch.full_like(u32[tie], 2**32 - 1))
    at_or_under = int((kv <= torch.kthvalue(kv, k).values).sum())
    log(f"[phase 1] kernel K4r select_keys_radix {tuple(mask.shape)}, k {k}: candidates "
        f"{cnt.tolist()}; class {tie} has {at_or_under} keys at or under its rank-k key; class "
        f"{top} (over the cap) and {cut} (under it) each with a valid 0xFFFFFFFF key; class "
        f"{empty} empty; n_sel {n_sel.tolist()}; idx and n_sel bit-equal {same}")
    planted = (int(cnt[tie]) > k and at_or_under > k and int(cnt[cut]) <= k
               and int(cnt[empty]) == 0)
    if not same or not planted:
        fail("kernel K4r (select_keys_radix) is not bit-equal to its plain version "
             "(or a planted case is missing)")
    after = (mixing.generate_unsup_data.classmix_launches, tc.select_keys_radix.launches)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        fail(f"K3c / K4r launched {after[0] - before[0]} / {after[1] - before[1]} times for one "
             f"call each")
    return {"K3c": 0.0, "K4r": 0.0}, {"classmix": (img, lab, prob, u), "radix": (mask, keys)}


TRAIN_COUNTERS = {  # kernel -> (module, wrapper, counter attribute)
    "A": ("u2pl_tpu_torch.ops.resize", "resize_bilinear", "launches"),
    "A_bwd": ("u2pl_tpu_torch.ops.resize", "resize_bilinear_bwd", "launches"),
    "C_fwd": ("u2pl_tpu_torch.losses.ce", "upsample_cross_entropy", "fwd_launches"),
    "C_bwd": ("u2pl_tpu_torch.losses.ce", "upsample_cross_entropy", "bwd_launches"),
    "D": ("u2pl_tpu_torch.losses.unsup", "upsample_softmax_stats", "launches"),
    "E": ("u2pl_tpu_torch.ops.quantile", "masked_percentiles", "launches"),
    "K3": ("u2pl_tpu_torch.ops.mixing", "generate_unsup_data", "launches"),
}
CONTRA_COUNTERS = {
    "K4_masks": ("u2pl_tpu_torch.losses.contrastive", "contra_pixel_masks", "launches"),
    "K4_select": ("u2pl_tpu_torch.losses.contrastive", "select_keys", "launches"),
    "K4_anchors": ("u2pl_tpu_torch.losses.contrastive", "sample_anchors", "launches"),
    "K5": ("u2pl_tpu_torch.memobank", "memobank_enqueue", "launches"),
    "K6_fwd": ("u2pl_tpu_torch.losses.contrastive", "contra_infonce", "fwd_launches"),
    "K6_bwd": ("u2pl_tpu_torch.losses.contrastive", "contra_infonce", "bwd_launches"),
}
OHEM_COUNTERS = {
    "K7_prob": ("u2pl_tpu_torch.losses.ohem", "ohem_target_prob", "launches"),
    "K7_kth": ("u2pl_tpu_torch.ops.quantile", "kth_smallest", "launches"),
    "K7_keep": ("u2pl_tpu_torch.losses.ohem", "ohem_keep_labels", "launches"),
}
VARIANT_COUNTERS = {  # apply_aug: classmix, contrastive.select_keys: radix
    "K3c": ("u2pl_tpu_torch.ops.mixing", "generate_unsup_data", "classmix_launches"),
    "K4r": ("u2pl_tpu_torch.losses.contrastive", "select_keys_radix", "launches"),
}
VAL_COUNTERS = {"B": ("u2pl_tpu_torch.ops.resize", "resize_argmax", "launches")}
DIST_COUNTERS = {  # K5's modes under a process group (phase 16)
    "K5_gather": ("u2pl_tpu_torch.memobank", "memobank_gather", "launches"),
    "K5_slabs": ("u2pl_tpu_torch.memobank", "memobank_enqueue_slabs", "launches"),
}
EMA_COUNTERS = {  # K6's per-query positive, contrastive.anchor_ema (phase 17)
    "K6_fwd_pq": ("u2pl_tpu_torch.losses.contrastive", "contra_infonce", "fwd_pq_launches"),
}
COUNTERS = {**TRAIN_COUNTERS, **CONTRA_COUNTERS, **OHEM_COUNTERS, **VARIANT_COUNTERS,
            **VAL_COUNTERS, **DIST_COUNTERS, **EMA_COUNTERS}


def _counter(name):
    import importlib

    mod, fn, attr = COUNTERS[name]
    return getattr(importlib.import_module(mod), fn), attr


def read_counters():
    """The launch counts, with kernel A's split by shape: the decoder's
    upsample (FEATURES channels), the request and eval images' (3
    channels), the Cityscapes eval crops' logits (A_EVAL_CROP) and the other
    logits' (serving, validation, whole-image eval); and by mode: A's
    narrow bf16 mode and its bf16 -> f32 mode, B per logits dtype."""
    import torch

    from u2pl_tpu_torch.ops.resize import resize_argmax, resize_bilinear

    out = {k: getattr(*_counter(k)) for k in COUNTERS}
    out["A_bf16_narrow"], out["A_bf16_f32"] = resize_bilinear.modes[1], resize_bilinear.modes[3]
    out["A_bf16_wide"] = resize_bilinear.modes[2]
    out["B_bf16"] = resize_argmax.dtypes[torch.bfloat16]
    out["B_f32"] = resize_argmax.dtypes[torch.float32]
    out["A_decoder"] = sum(n for (shape, _), n in resize_bilinear.shapes.items()
                           if shape[1] == FEATURES)
    out["A_image_city"] = resize_bilinear.shapes[A_IMAGE_CITY]
    out["A_image"] = sum(n for (shape, _), n in resize_bilinear.shapes.items()
                         if shape[1] == 3) - out["A_image_city"]
    out["A_eval_crop"] = resize_bilinear.shapes[A_EVAL_CROP]
    out["A_logits"] = (out["A"] - out["A_decoder"] - out["A_image"] - out["A_image_city"]
                       - out["A_eval_crop"])
    from u2pl_tpu_torch.losses.unsup import upsample_softmax_stats

    for sel in ("prob", "entropy"):  # kernel D's launches per output selection
        out[f"D_{sel}"] = upsample_softmax_stats.selections[sel]
    from u2pl_tpu_torch.losses.ohem import ohem_target_prob

    # K7 prob's launches per Cityscapes head, by the logits' (h, w)
    out["K7_prob_main"] = ohem_target_prob.shapes[(CITY_OS4, CITY_OS4)]
    out["K7_prob_aux"] = ohem_target_prob.shapes[(CITY_OS8, CITY_OS8)]
    return out


def zero_counters():
    from u2pl_tpu_torch.losses.unsup import upsample_softmax_stats
    from u2pl_tpu_torch.ops.resize import resize_argmax, resize_bilinear

    for k in COUNTERS:
        setattr(*_counter(k), 0)
    resize_bilinear.shapes.clear()
    resize_bilinear.modes.clear()
    resize_argmax.dtypes.clear()
    upsample_softmax_stats.selections.clear()
    from u2pl_tpu_torch.losses.ohem import ohem_target_prob

    ohem_target_prob.shapes.clear()


def check_per_semi_step(path, launches, semi_steps, contrastive, heads=1):
    """Per semi step, kernel D twice (max-prob + argmax for the pseudo-labels,
    the entropy alone for the gate) and, with the contrastive branch, K4's
    masks, key selection and anchor draws once each; C's forward once per
    supervised head (`heads`: the main head, and on Cityscapes the aux head)
    on every step and once more for the unsupervised CE on a semi step."""
    want = {"D": 2 * semi_steps, "D_prob": semi_steps, "D_entropy": semi_steps,
            "C_fwd": TRAIN_STEPS * heads + semi_steps}
    if contrastive:
        want.update(K4_masks=semi_steps, K4_select=semi_steps, K4_anchors=semi_steps)
    got = {k: launches[k] for k in want}
    log(f"[{path}] launches over {semi_steps} semi steps: {got} (want {want})")
    if got != want:
        fail(f"{path}: launches {got} over {semi_steps} semi steps, want {want}")


def check_a_bwd_per_step(path, launches):
    """Kernel A-bwd runs once per step, for the decoder's upsample: the
    logits' adjoint resize lives inside kernel C's backward."""
    if launches["A_bwd"] != TRAIN_STEPS:
        fail(f"{path}: kernel A-bwd launched {launches['A_bwd']} times in {TRAIN_STEPS} steps "
             f"(want one per step, the decoder's; C's backward is fused with its own)")


def scalars(metrics):
    """The 0-d metrics of a step as floats (neg_cand is per class)."""
    return {k: v.item() for k, v in metrics.items() if v.dim() == 0}


@contextlib.contextmanager
def plain_versions():
    """Route every kernel of the serving forward, the eval path and the
    training step through its plain version, and the request image's load
    through the numpy route."""
    import u2pl_tpu_torch.eval as eval_cli
    import u2pl_tpu_torch.evallib.slide as slide
    import u2pl_tpu_torch.losses.ce as ce
    import u2pl_tpu_torch.losses.contrastive as contrastive
    import u2pl_tpu_torch.losses.unsup as unsup
    import u2pl_tpu_torch.memobank as memobank
    import u2pl_tpu_torch.losses.ohem as ohem
    import u2pl_tpu_torch.models.decoder as decoder
    import u2pl_tpu_torch.ops.mixing as mixing
    import u2pl_tpu_torch.ops.quantile as quantile
    import u2pl_tpu_torch.serving as serving
    from u2pl_tpu_torch.ops.resize import resize_argmax_plain, resize_bilinear_plain

    swaps = [
        (decoder, "resize_bilinear", resize_bilinear_plain),
        (slide, "resize_bilinear", resize_bilinear_plain),
        (slide, "resize_argmax", resize_argmax_plain),
        (serving, "resize_bilinear", resize_bilinear_plain),
        (serving, "resize_argmax", resize_argmax_plain),
        (serving, "load_image", serving.load_image_plain),
        (eval_cli, "load_image", serving.load_image_plain),
        (ce, "upsample_cross_entropy", ce.upsample_cross_entropy_plain),
        (ohem, "ohem_cross_entropy", ohem.ohem_cross_entropy_plain),
        (unsup, "upsample_cross_entropy", ce.upsample_cross_entropy_plain),
        (unsup, "upsample_softmax_stats", unsup.upsample_softmax_stats_plain),
        (quantile, "masked_percentiles", quantile.masked_percentiles_plain),
        (mixing, "generate_unsup_data", mixing.generate_unsup_data_plain),
        (contrastive, "contra_pixel_masks", contrastive.contra_pixel_masks_plain),
        (contrastive, "select_keys", contrastive.select_keys_plain),
        (contrastive, "select_keys_radix", contrastive.select_keys_radix_plain),
        (contrastive, "sample_anchors", contrastive.sample_anchors_plain),
        (contrastive, "memobank_enqueue", memobank.memobank_enqueue_plain),
        (contrastive, "memobank_gather", memobank.memobank_gather_plain),
        (contrastive, "memobank_enqueue_slabs", memobank.memobank_enqueue_slabs_plain),
        (contrastive, "contra_infonce", contrastive.contra_infonce_plain),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


# phases 1-12 train and serve in float32 whatever the configs' net.dtype
# (bfloat16 in all of them), as they did before the port had bf16; phase 13
# trains in the configs' bfloat16
F32_OVERRIDE = {"net.dtype": "float32"}


def load_f32(path):
    """The config at `path` with net.dtype float32."""
    from u2pl_tpu_torch.config import load_config

    cfg = load_config(path)
    return dataclasses.replace(cfg, net=dataclasses.replace(cfg.net, dtype="float32"))


def train_config():
    """The VOC `ours` config without its contrastive block (float32)."""
    cfg = load_f32(VOC_CONFIG)
    return dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, contrastive=None))


def synthetic_batches(dev, n, b=B_L, crop=CROP, classes=21, seed=SEED + 3):
    """n batches of (b labeled, their labels, b unlabeled) crop² images, made
    from `seed` with numpy: smooth colour fields with noise, normalised like
    the dataset; labels quantise the first channel into the classes, ~5% of
    them 255 (by default the VOC slice's 4 + 4 at 513², 21 classes)."""
    import numpy as np
    import torch

    from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

    rng = np.random.RandomState(seed)

    def images(b):
        x = np.stack([resize_bilinear_numpy(rng.randn(9, 9, 3).astype(np.float32), (crop, crop))
                      for _ in range(b)])
        x = (x + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        return x

    out = []
    for _ in range(n):
        img_l, img_u = images(b), images(b)
        lab = np.clip(((img_l[..., 0] + 2.5) * classes / 5).astype(np.int32), 0, classes - 1)
        lab[rng.rand(*lab.shape) < 0.05] = 255
        to = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dev)  # noqa: E731
        out.append((to(img_l), torch.from_numpy(lab).to(dev), to(img_u)))
    return out


def _params_equal(a, b):
    import torch

    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@contextlib.contextmanager
def shared_pseudo_labels(route, labels):
    """Within a semi step: records the route's pseudo-labels (kernel D's
    argmax, the step's `outputs="prob"` call) and the teacher logits they
    come from in labels[route]; the plain route returns the kernel route's
    labels in place of its own."""
    from u2pl_tpu_torch.losses import unsup

    stats = unsup.upsample_softmax_stats

    def tap(logits, size, outputs="all"):
        out = stats(logits, size, outputs)
        if outputs != "prob":
            return out
        labels[route] = (logits.detach().clone(), out[1])
        return out if route == "kernels" else (out[0], labels["kernels"][1], out[2])

    tap.__dict__ = stats.__dict__  # the kernel counts its launches on the module's name
    unsup.upsample_softmax_stats = tap
    try:
        yield
    finally:
        unsup.upsample_softmax_stats = stats


def both_routes(snapshot, run, what, bf16=False):
    """`run(state, route)` (one step, returning its metrics) on a copy of
    `snapshot` with dropout off, through the kernels and through the plain
    versions: {route: (metrics, the student's update per parameter, the
    state after)}.  Fails if the plain route launched a kernel.

    The teacher's pseudo-labels may differ between the routes only at near
    ties of the upsampled logits, as kernel D's argmax may in phase 1; the
    plain route takes the kernel route's.  One label flipped at a near tie
    changes ClassMix's mask, hence the student's input, and the contrastive
    masks: con_loss then moves past CON_LOSS_TOL through the labels'
    rounding, not through a difference of the kernels the step is held to.
    `bf16`: the logits are bf16, and a near tie is a top-2 gap of at most one
    bf16 ulp (the routes round the upsample at its boundaries apart)."""
    import torch

    from u2pl_tpu_torch.models.decoder import Dropout2d
    from u2pl_tpu_torch.ops.resize import resize_bilinear_plain

    runs, labels = {}, {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(snapshot)
        for mm in list(st.student.modules()) + list(st.teacher.modules()):
            if isinstance(mm, Dropout2d):
                mm.p = 0.0
        before = {a: p.detach().clone() for a, p in st.student.named_parameters()}
        counts = read_counters()
        with plain_versions() if route == "plain" else contextlib.nullcontext():
            with shared_pseudo_labels(route, labels):
                m = run(st, route)
        torch.cuda.synchronize()
        if route == "plain" and read_counters() != counts:
            fail("the plain-version step launched a kernel")
        runs[route] = (m, {a: p.detach() - before[a] for a, p in st.student.named_parameters()}, st)
    (_, lk), (logits, lp) = labels["kernels"], labels["plain"]
    top2 = resize_bilinear_plain(logits, tuple(lk.shape[1:])).float().topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    if bf16:
        near = gap <= bf16_ulp(top2[:, 0])
    else:
        near = gap <= NEAR_TIE * top2[:, 0].abs().clamp(min=1.0)
    flips = lk != lp
    bad = int((flips & ~near).sum())
    log(f"[{what}] the teacher's pseudo-labels, kernels vs plain versions: {int(flips.sum())} of "
        f"{lk.numel()} differ, {bad} outside the {int(near.sum())} near ties (bound 0; smallest "
        f"top-2 gap {gap.min().item():.3e}); the plain route took the kernel route's")
    if bad:
        fail(f"{what}: {bad} pseudo-labels differ between the routes outside near ties")
    return runs


def update_closeness(dk, dp):
    """The two routes' updates per parameter: ({name: L2 of the difference /
    L2 of the plain route's update}, the three closest to the bound
    STEP_UPDATE_TOL of the update + STEP_UPDATE_FLOOR RMS, as (name, share
    of the bound), closest first)."""
    diff = {a: (dk[a] - dp[a]).norm().item() for a in dp}
    norm = {a: dp[a].norm().item() for a in dp}
    upd = {a: diff[a] / max(norm[a], 1e-30) for a in dp}
    over = {a: diff[a] / (STEP_UPDATE_TOL * norm[a] + STEP_UPDATE_FLOOR * dp[a].numel() ** 0.5)
            for a in dp}
    return upd, sorted(over.items(), key=lambda kv: -kv[1])[:3]


def phase4_training(dev, card):
    import torch

    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.steps import run_steps
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import make_semi_step

    cfg = train_config()
    log(f"[phase 4] config {os.path.relpath(VOC_CONFIG, ROOT)} minus its trainer.contrastive "
        f"block (contrastive -> None), trained in float32 with TF32 off (config dtype "
        f"{cfg.net.dtype}, sync_bn {cfg.net.sync_bn}: one card, plain BN); "
        f"{cfg.trainer.optimizer.type} lr {cfg.trainer.optimizer.lr} x10 head, poly, "
        f"drop_percent {cfg.trainer.unsupervised.drop_percent}, apply_aug "
        f"{cfg.trainer.unsupervised.apply_aug}, ema {cfg.net.ema_decay}; {B_L}+{B_U} images "
        f"of {CROP}², steps_per_epoch {STEPS_PER_EPOCH}, sup_only_epoch "
        f"{cfg.trainer.sup_only_epoch}, {TRAIN_STEPS} steps")
    t0 = time.monotonic()
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    batches = synthetic_batches(dev, TRAIN_STEPS)
    n_params = sum(p.numel() for p in state.student.parameters())
    log(f"[phase 4] student + teacher ({n_params} parameters each) and {TRAIN_STEPS} batches "
        f"built in {time.monotonic() - t0:.1f}s")
    student, teacher = state.student, state.teacher
    # behind kernel A (the decoder's upsample), so A-bwd must reach them; the
    # layer4 one on the shortcut path (zero_init_residual zeroes each block's
    # last BN scale, so a residual branch gets no gradient at step 0)
    watch = {
        "decoder.aspp.conv3.0.weight": student.decoder.aspp.conv3[0].weight,
        "encoder.layer4.0.downsample.0.weight": student.encoder.layer4[0].downsample[0].weight,
    }
    start = {k: p.detach().clone() for k, p in watch.items()}
    t_bn0 = {k: v.clone() for k, v in teacher.state_dict().items() if "running" in k}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    history, snapshot = [], None
    t0 = time.monotonic()
    for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
        epoch = i_iter // STEPS_PER_EPOCH
        for k, p in watch.items():
            if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0:
                fail(f"step {i_iter}: no finite nonzero gradient reached {k}")
        if epoch < cfg.trainer.sup_only_epoch and i_iter == STEPS_PER_EPOCH - 1:
            moved = [k for k, v in teacher.state_dict().items() if k in t_bn0 and not torch.equal(v, t_bn0[k])]
            log(f"[phase 4] after warmup: {len(moved)} of {len(t_bn0)} teacher BN buffers moved")
            if len(moved) < len(t_bn0) // 2:
                fail("the teacher's BN statistics did not track the warmup batches")
        same = _params_equal(teacher, student)
        if epoch == cfg.trainer.sup_only_epoch and not same:
            fail(f"step {i_iter} (first semi epoch): teacher != student")
        if epoch > cfg.trainer.sup_only_epoch and same:
            fail(f"step {i_iter} (epoch {epoch}): teacher == student after the EMA")
        history.append((i_iter, scalars(m), same))
        if i_iter == TRAIN_STEPS - 2:
            snapshot = copy.deepcopy(state)  # before step 5
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    for i_iter, m, same in history:
        log(f"[phase 4] step {i_iter} ({'warmup' if 'drop_thresh' not in m else 'semi'}, epoch "
            f"{i_iter // STEPS_PER_EPOCH}): " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
            + f"; teacher == student: {same}")
        if not all(v == v and abs(v) != float("inf") for v in m.values()):
            fail(f"step {i_iter}: non-finite metrics {m}")
    changed = {k: (watch[k] - start[k]).norm().item() for k in watch}
    log(f"[phase 4] {TRAIN_STEPS} steps in {run_s:.2f} s; L2 of the change over the run: "
        f"{changed}; launches {launches}")
    if not all(v > 0 for v in changed.values()):
        fail(f"student parameters did not change: {changed}")
    missing = [k for k in TRAIN_COUNTERS if launches[k] <= 0]
    if missing:
        fail(f"a kernel of the training path was never launched: {missing}")
    check_a_bwd_per_step("VOC training", launches)
    check_per_semi_step("VOC training", launches,
                        sum("drop_thresh" in m for _, m, _ in history), contrastive=False)
    log(f"[{card}] peak device memory over the {TRAIN_STEPS} training steps: "
        f"{peak / 2**30:.2f} GiB")

    # step 5 again from the snapshot, dropout off and the mix injected (coin
    # heads), through the kernels and through the plain versions
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = both_routes(snapshot, lambda st, route: step(st, *batches[-1], mix=mix), "phase 4")
    del snapshot
    (mk, dk, _), (mp, dp, _) = runs["kernels"], runs["plain"]
    mk, mp = scalars(mk), scalars(mp)
    rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30)
           for k in ("sup_loss", "uns_loss", "drop_thresh")}
    upd, tight = update_closeness(dk, dp)
    worst = sorted(upd.items(), key=lambda kv: -kv[1])[:3]
    log(f"[phase 4] step {TRAIN_STEPS} again, kernels vs plain versions: kernels {mk}; plain "
        f"{mp}; rel diffs {rel} (bound {STEP_LOSS_TOL}); per-tensor update L2 diff / L2: median "
        f"{statistics.median(upd.values()):.3e}, largest {worst} (bound {STEP_UPDATE_TOL} of the "
        f"update + {STEP_UPDATE_FLOOR} RMS; closest to it, as a share of the bound: {tight})")
    if not all(v <= STEP_LOSS_TOL for v in rel.values()):
        fail(f"step {TRAIN_STEPS}: kernels vs plain versions {rel}")
    if tight[0][1] > 1.0:
        fail(f"step {TRAIN_STEPS}: parameter update differs from the plain route: {tight}")
    return state, batches, launches, peak


def phase5_train_timings(dev, card, state, batches):
    import torch

    from u2pl_tpu_torch.losses import ce, unsup
    from u2pl_tpu_torch.ops import mixing, quantile
    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.train.steps import make_semi_step, make_semi_warmup_step

    cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    steps = {"warmup": (make_semi_warmup_step(cfg, STEPS_PER_EPOCH), B_L),
             "semi": (make_semi_step(cfg, STEPS_PER_EPOCH), B_L + B_U)}
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for name, (fn, imgs) in steps.items():
        runs = []
        for i in range(2 + 7):
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, *batch, gen)
            torch.cuda.synchronize()
            if i >= 2:
                runs.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(runs)
        out[name] = med
        log(f"[{card}] {name} step ({imgs} images of {CROP}², f32, synchronised): median "
            f"{med:.1f} ms over {len(runs)} runs after 2 (min {min(runs):.1f}, max "
            f"{max(runs):.1f}); {imgs * 1e3 / med:.2f} img/s")
    log(f"[{card}] peak device memory over the timed training steps: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    times = {}
    # A_bwd_logits: a shape no path launches since C's backward took in its
    # adjoint resize; kept as the logits-scale reference
    for label, shape, out_hw in (("A_bwd_decoder", (8, 256, 65, 65), (129, 129)),
                                 ("A_bwd_city", (4, FEATURES, CITY_OS8, CITY_OS8),
                                  (CITY_OS4, CITY_OS4)),
                                 ("A_bwd_logits", (4, 21, 129, 129), (513, 513))):
        gy = torch.randn(shape[:2] + out_hw, device=dev, generator=g)
        times[label] = (
            cuda_ms(lambda: R.resize_bilinear_bwd(gy, shape[2:]), 20),
            cuda_ms(lambda: R.resize_bilinear_bwd_plain(gy, shape[2:]), 20),
            # F.interpolate's own backward, called directly
            cuda_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                gy, list(out_hw), list(shape), True), 20),
        )
        del gy
    x = torch.randn(4, 21, 129, 129, device=dev, generator=g, requires_grad=True)
    lab = torch.randint(0, 21, (4, CROP, CROP), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    with torch.no_grad():
        times["C_fwd"] = (cuda_ms(lambda: ce.upsample_cross_entropy(x, lab)),
                          cuda_ms(lambda: ce.upsample_cross_entropy_plain(x, lab)), None)
    times["C_bwd"] = c_bwd_timing(card, "C_bwd", x, lab, None)
    xd = x.detach()
    for sel in ("prob", "entropy"):  # the semi step's two calls
        times[f"D_{sel}"] = (
            cuda_ms(lambda: unsup.upsample_softmax_stats(xd, (CROP, CROP), outputs=sel)),
            cuda_ms(lambda: unsup.upsample_softmax_stats_plain(xd, (CROP, CROP), sel)), None)
    ent = torch.rand(B_U, CROP, CROP, device=dev, generator=g)
    valid = torch.rand(B_U, CROP, CROP, device=dev, generator=g) < 0.85
    # one percentile (the step without the contrastive branch), and the
    # contrastive step's three: the drop and the low / high entropy percents
    # at epoch 1 of 80
    for key, pct in (("E", [80.25]), ("E_3", [80.25, 19.75, 80.25])):
        pct = torch.tensor(pct, device=dev)
        times[key] = (cuda_ms(lambda: quantile.masked_percentiles(ent, valid, pct)),
                      cuda_ms(lambda: quantile.masked_percentiles_plain(ent, valid, pct)),
                      # numpy-'linear' percentiles of the masked values: the same function
                      cuda_ms(lambda: torch.quantile(ent[valid], pct / 100.0,
                                                     interpolation="linear")))
    img = torch.randn(B_U, 3, CROP, CROP, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, B_U, CROP, CROP)
    lab_u = lab.clone()
    times["K3"] = (cuda_ms(lambda: mixing.generate_unsup_data(img, lab_u, ent, boxes, "cutmix")),
                   cuda_ms(lambda: mixing.generate_unsup_data_plain(img, lab_u, ent, boxes, "cutmix")),
                   None)
    shapes = {
        "A_bwd_decoder": "(8, 256, 129, 129) -> (8, 256, 65, 65)",
        "A_bwd_city": f"(4, 256, {CITY_OS4}, {CITY_OS4}) -> (4, 256, {CITY_OS8}, {CITY_OS8})",
        "A_bwd_logits": "(4, 21, 513, 513) -> (4, 21, 129, 129)",
        "C_fwd": "(4, 21, 129, 129) -> 513², labels (4, 513, 513)",
        "C_bwd": "the same, backward to the os4 logits (fused with its adjoint resize)",
        "D_prob": "(4, 21, 129, 129) -> 513², max-prob + argmax",
        "D_entropy": "(4, 21, 129, 129) -> 513², entropy",
        "E": "1 percentile of (4, 513, 513), ~85% valid",
        "E_3": "3 percentiles of (4, 513, 513), ~85% valid (the contrastive step's call)",
        "K3": "cutmix (4, 3, 513, 513) + label + max-prob",
    }
    library = {k: "torch.quantile(values[mask], linear)" for k in ("E", "E_3")}
    for k, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; {library.get(k, 'aten upsample_bilinear2d_backward')} {tl:.4f} ms"
        log(f"[{card}] kernel {k} {shapes[k]}: {tk:.4f} ms; plain version {tp:.4f} ms{lib}")
    return out, times


# the pixels each timed C backward weighs (its labels' valid count), for
# its bound: where coef is 0 the gradient needs no softmax
C_BWD_VALID = {}
# the valid pixels of phase 9's K7 prob heads: an ignored pixel needs no softmax
K7_VALID = {}
# K4 masks' (bytes, compares) on the timed inputs (timing_ab.masks_needed)
K4_MASKS_NEEDED = {}


def c_bwd_timing(card, key, x, lab, cw):
    """Kernel C's backward (fused with its adjoint resize) through
    torch.autograd.grad, as the step runs it, beside the plain route's
    autograd backward; torch.profiler's device time logged beside it."""
    import torch

    from u2pl_tpu_torch.losses import ce

    x = x.detach().requires_grad_(True)
    lk = ce.upsample_cross_entropy(x, lab, 255, cw)
    lp = ce.upsample_cross_entropy_plain(x, lab, 255, cw)
    fused = lambda: torch.autograd.grad(lk, x, retain_graph=True)  # noqa: E731
    out = (cuda_ms(fused), cuda_ms(lambda: torch.autograd.grad(lp, x, retain_graph=True)), None)
    C_BWD_VALID[key] = int(((lab != 255) & (lab < x.shape[1])).sum())
    log(f"[{card}] kernel {key} {tuple(x.shape)} -> {tuple(lab.shape[1:])}"
        f"{', weighted' if cw is not None else ''}, {C_BWD_VALID[key]} of {lab.numel()} pixels "
        f"valid: {out[0]:.4f} ms; plain route {out[1]:.4f} ms; torch.profiler: "
        f"{profiled_text(device_ms_profiled(fused))}")
    return out


def mask_inputs(g, b, b_l, c, hw):
    """K4 masks' inputs from the generator `g` (on the card): the os4
    softmax of b images (c classes, peaked), small labels (class 0 on ~60%
    of the pixels, ~5% ignored), low / high masks, the first b_l images
    labeled (their masks: the labeled pixels)."""
    import torch

    dev = g.device
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)  # noqa: E731
    prob = torch.softmax(4 * torch.randn(b, c, hw, hw, device=dev, generator=g), dim=1)
    labels = torch.randint(0, c, (b, hw, hw), device=dev, generator=g, dtype=torch.int32)
    labels[rand(b, hw, hw) < 0.6] = 0
    labels[rand(b, hw, hw) < 0.05] = 255
    low, high = rand(b, hw, hw) < 0.7, rand(b, hw, hw) < 0.5
    low[:b_l] = high[:b_l] = labels[:b_l] != 255
    return prob, labels, low, high


def contra_case(dev, cfg):
    """The contrastive loss's pieces at the flagship shapes, from SEED: the
    os4 softmax of 4 + 4 images (21 classes, peaked), small labels (class 0
    on ~60% of the pixels, so its candidates pass the 8192-key cap; ~5%
    ignored), low / high masks, student and teacher representations (256
    features), a (21, 50000, 256) bf16 bank full of seeded keys with each
    ring's `ptr` k/8 rows before its end, so a write of more keys wraps, and
    the draws."""
    import torch

    from u2pl_tpu_torch.memobank import init_memobank

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    ccfg = cfg.trainer.contrastive
    b, c, f = B_L + B_U, cfg.net.num_classes, 256
    n = b * OS4 * OS4
    q, m = ccfg.num_queries, ccfg.num_negatives
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)  # noqa: E731
    prob, labels, low, high = mask_inputs(g, b, B_L, c, OS4)
    rep = torch.randn(b, f, OS4, OS4, device=dev, generator=g)
    rep_t = rep + 0.1 * torch.randn(b, f, OS4, OS4, device=dev, generator=g)
    bank = init_memobank(c, f, dtype=torch.bfloat16, device=dev)
    for j in range(c):
        bank.keys[j].copy_(torch.randn(bank.keys.shape[1:], device=dev, generator=g))
    bank.occupancy.copy_(bank.sizes)
    bank.ptr.copy_(bank.sizes - max(ccfg.max_keys_per_class_per_step // 8, 1))
    return {"prob": prob, "labels": labels, "low": low, "high": high, "rep": rep,
            "rep_t": rep_t, "bank": bank, "pri": rand(c, n), "u_anchor": rand(c, q),
            "u_neg": rand(c, q * m)}


def phase1_contrastive_kernels(dev, cfg):
    """K4, K5 and K6 against their plain versions at the flagship shapes.
    Returns ({kernel: max error}, the case with its intermediates)."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain

    ccfg = cfg.trainer.contrastive
    case = contra_case(dev, cfg)
    c, n = case["pri"].shape
    k = ccfg.max_keys_per_class_per_step
    errs = {}
    args = (case["prob"], case["labels"], case["low"], case["high"], B_L, ccfg)
    got, ref = tc.contra_pixel_masks(*args), tc.contra_pixel_masks_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    anchor, negative, low_valid, counts = got
    log(f"[phase 1] K4 contra_pixel_masks {tuple(case['prob'].shape)}: masks and counts bit-equal "
        f"{same}; n_low_valid {counts[0].tolist()}; neg_candidates {counts[1].tolist()}")
    if not same or not anchor.any():
        fail("K4 contra_pixel_masks is not bit-equal to its plain version (or no anchors)")
    errs["K4_masks"] = 0.0

    for kk in (k, 12288):  # the VOC cap and the Cityscapes configs' cap
        idx, n_sel = tc.select_keys(negative, case["pri"], kk)
        ref_idx, ref_n = tc.select_keys_plain(negative, case["pri"], kk)
        torch.cuda.synchronize()
        same = torch.equal(n_sel, ref_n) and all(
            torch.equal(idx[j, : int(ref_n[j])], ref_idx[j, : int(ref_n[j])]) for j in range(c))
        over = int((counts[1] > kk).sum())
        log(f"[phase 1] K4 select_keys ({c}, {n}), k {kk}: {over} classes over the cap; "
            f"n_sel {n_sel.tolist()}; slabs bit-equal {same}")
        if not same or (kk == k and over == 0):
            fail(f"K4 select_keys (k {kk}) differs from the stable argsort (or no class over the cap)")
        if kk == k:
            case["sel_idx"], case["n_sel"] = idx, n_sel
    errs["K4_select"] = 0.0

    class_valid = counts[0] > 0
    b_j = tc.valid_classes_first(class_valid)
    a_j = torch.arange(c, dtype=torch.int32, device=dev)
    got = tc.sample_anchors(anchor, a_j, case["u_anchor"])
    ref = tc.sample_anchors_plain(anchor, a_j, case["u_anchor"])
    torch.cuda.synchronize()
    same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    log(f"[phase 1] K4 sample_anchors ({c}, {n}) x {case['u_anchor'].shape[1]} draws: n_anchor "
        f"{got[1].tolist()}; bit-equal {same}")
    if not same:
        fail("K4 sample_anchors is not bit-equal to its plain version")
    errs["K4_anchors"] = 0.0

    bank = case["bank"]
    kb = memobank_enqueue(clone_bank(bank), case["rep_t"], case["sel_idx"], case["n_sel"])
    rb = memobank_enqueue_plain(clone_bank(bank), case["rep_t"], case["sel_idx"], case["n_sel"])
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(kb, a), getattr(rb, a)) for a in ("keys", "ptr", "occupancy"))
    wrapped = int((bank.ptr + case["n_sel"] > bank.sizes).sum())
    log(f"[phase 1] K5 memobank_enqueue {tuple(bank.keys.shape)} bf16, {int(case['n_sel'].sum())} "
        f"keys, {wrapped} classes' rings wrapped: keys, ptr and occupancy bit-equal {same}")
    if not same or wrapped == 0:
        fail("K5 memobank_enqueue is not bit-equal to its plain version (or no ring wrapped)")
    errs["K5"] = 0.0
    del kb, rb

    lv = low_valid.view(c, B_L + B_U, -1).transpose(0, 1)
    rep_t = case["rep_t"]
    proto = torch.bmm(lv, rep_t.flatten(2).transpose(1, 2)).sum(0)
    proto = proto / torch.clamp(counts[0][:, None].float(), min=1.0)
    valid_seg = class_valid.sum().to(torch.int32)
    active = ((torch.arange(c, device=dev) < valid_seg) & (got[1] > 0)
              & (bank.occupancy[b_j.long()] > 0))
    case.update(anchor=anchor, negative=negative, anchor_idx=got[0], a_j=a_j, b_j=b_j,
                positive=proto[a_j.long()].contiguous(), active=active, valid_seg=valid_seg)
    k6 = (case["anchor_idx"], case["positive"], bank, b_j, case["u_neg"], active, valid_seg,
          ccfg.temperature)
    rk = case["rep"].clone().requires_grad_(True)
    rp = case["rep"].clone().requires_grad_(True)
    lk = tc.contra_infonce(rk, *k6)
    (gk,) = torch.autograd.grad(lk, rk)
    lp = tc.contra_infonce_plain(rp, *k6)
    (gp,) = torch.autograd.grad(lp, rp)
    torch.cuda.synchronize()
    le = abs(lk.item() - lp.item())
    ge = (gk - gp).abs().max().item()
    rel, grel = le / max(abs(lp.item()), 1e-30), ge / max(gp.abs().max().item(), 1e-30)
    log(f"[phase 1] K6 contra_infonce, {int(active.sum())} active positions x "
        f"{case['u_anchor'].shape[1]} anchors x (1 + {ccfg.num_negatives}) keys: loss "
        f"{lk.item():.6f} vs plain {lp.item():.6f}, rel diff {rel:.3e} (bound {K6_LOSS_TOL}); "
        f"gradient max abs diff / max |grad| {grel:.3e} (bound {K6_GRAD_TOL})")
    if not (lp.item() > 0 and rel <= K6_LOSS_TOL and grel <= K6_GRAD_TOL):
        fail(f"K6 contra_infonce: loss {rel}, gradient {grel}")
    errs["K6_fwd"], errs["K6_bwd"] = le, ge
    return errs, case


EMA_ITER = 37  # the anchor_ema blend's step in phase 1: d = 1 - 1/37


def phase1_k6_per_query(dev, card, case, cfg):
    """K6's forward with a (C, Q, F) positive (the anchor_ema blend of the
    flagship's prototypes with a seeded momentum prototype) at the flagship
    shape, on the prefilled bank that wraps, with an f32 rep and a bf16 rep
    on the bf16 bank, against the plain route in float64 (the rep widened):
    the loss within K6_LOSS_TOL, the gradient within K6_GRAD_TOL of its max
    (for the bf16 rep: the f32 gradient of its forward's stored directions,
    K6's backward in f32 mode; its bf16 gradient is held one bf16 ulp from
    the bf16 plain route's at rounding boundaries, as phase 13 holds it).
    Each mode timed beside the per-class mode on the same inputs.  Returns
    ({key: error}, {key: (ms, plain ms, None)}, {key: f32 mode ms},
    {key: per-class mode ms})."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc

    ccfg = cfg.trainer.contrastive
    c, q = case["anchor_idx"].shape
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    momentum = torch.randn(c, q, 1, FEATURES, device=dev, generator=g)
    pos_pq, _ = tc._anchor_ema(case["positive"], momentum, case["b_j"], case["active"],
                               torch.tensor(EMA_ITER, device=dev))
    if pos_pq.shape != (c, q, FEATURES) or torch.equal(pos_pq[:, 0], pos_pq[:, 1]):
        fail(f"phase 1: the anchor_ema positive {tuple(pos_pq.shape)} is not one per draw")
    rest = (case["bank"], case["b_j"], case["u_neg"], case["active"], case["valid_seg"],
            ccfg.temperature)
    pq = (case["anchor_idx"], pos_pq) + rest
    pc = (case["anchor_idx"], case["positive"]) + rest
    bf = torch.bfloat16
    errs, times, f32, per_class = {}, {}, {}, {}
    r64 = case["rep"].double().requires_grad_(True)
    l64 = tc.contra_infonce_plain(r64, *pq)
    (g64,) = torch.autograd.grad(l64, r64)
    top = max(g64.abs().max().item(), 1e-30)
    one = torch.ones((), device=dev)
    for key, dtype in (("K6_fwd_pq", torch.float32), ("K6_fwd_pq_bf16", bf)):
        rep = case["rep"].detach().to(dtype, copy=True).requires_grad_(True)
        launched = tc.contra_infonce.fwd_pq_launches
        lk = tc.contra_infonce(rep, *pq)
        if tc.contra_infonce.fwd_pq_launches != launched + 1:
            fail(f"{key}: the per-query mode did not launch")
        (gk,) = torch.autograd.grad(lk, rep, retain_graph=True)
        if dtype == bf:
            # the f32 gradient of the bf16 forward's directions (the negatives'
            # parts added back), through K6's backward in f32 mode
            anchor_idx, active, valid_seg, gdir = lk.grad_fn.saved_tensors
            g32 = tc._infonce_bwd_cuda(anchor_idx, active, valid_seg, gdir.sum(0), one,
                                       tuple(rep.shape))
            rp = rep.detach().clone().requires_grad_(True)
            (gp,) = torch.autograd.grad(tc.contra_infonce_plain(rp, *pq), rp)
            # the same bf16 values widened: the float64 route of this rep
            r64b = rep.detach().double().requires_grad_(True)
            l64b = tc.contra_infonce_plain(r64b, *pq)
            (g64b,) = torch.autograd.grad(l64b, r64b)
            ref_l, ref_g, ref_top = l64b.item(), g64b, max(g64b.abs().max().item(), 1e-30)
        else:
            g32, ref_l, ref_g, ref_top = gk, l64.item(), g64, top
        torch.cuda.synchronize()
        rel = abs(lk.item() - ref_l) / max(abs(ref_l), 1e-30)
        grel = (g32.double() - ref_g).abs().max().item() / ref_top
        log(f"[phase 1] K6 contra_infonce per-query positive {tuple(pos_pq.shape)}, "
            f"{str(dtype).replace('torch.', '')} rep, {int(case['active'].sum())} active positions "
            f"x {q} x (1 + {ccfg.num_negatives}): loss {lk.item():.6f} vs float64 {ref_l:.9f} "
            f"(rel {rel:.3e}, bound {K6_LOSS_TOL}); f32 gradient {grel:.3e} of its max (bound "
            f"{K6_GRAD_TOL})")
        if not (ref_l > 0 and rel <= K6_LOSS_TOL and grel <= K6_GRAD_TOL):
            fail(f"{key}: loss {rel:.3e}, gradient {grel:.3e} against the float64 plain route")
        errs[key] = abs(lk.item() - ref_l)
        if dtype == bf:
            bf16_flips("kernel K6 per-query bf16 (8, 256, 129²) rep gradient, kernel vs the "
                       "bf16 plain route", gk, gp, K6_BF16_FLIP_FRAC, row_dim=1, where="phase 1")
        del lk, gk, g32
        with torch.no_grad():
            times[key] = (cuda_ms(lambda: tc.contra_infonce(rep, *pq), 20),
                          cuda_ms(lambda: tc.contra_infonce_plain(rep, *pq), 20), None)
            per_class[key] = cuda_ms(lambda: tc.contra_infonce(rep, *pc), 20)
            if dtype == bf:
                rep32 = case["rep"]
                f32[key] = cuda_ms(lambda: tc.contra_infonce(rep32, *pq), 20)
        log(f"[{card}] kernel {key}: {times[key][0]:.4f} ms, the per-class mode on the same "
            f"inputs {per_class[key]:.4f} ms; plain version {times[key][1]:.4f} ms"
            + (f"; its f32 mode {f32[key]:.4f} ms" if key in f32 else ""))
    return errs, times, f32, per_class


def ohem_case(dev, g, hw, amp, block, ignore_frac, c=19):
    """Logits (CITY_B, c, hw, hw) of a head and 769² labels on which the
    label's class leads at most pixels: classes constant on block² cells of
    the head's grid, each label the nearest cell's class, the logits amp on
    that class and 0 elsewhere, shifted by -amp / 2, plus 0.3 randn; a share
    `ignore_frac` of the labels 255."""
    import torch

    from u2pl_tpu_torch.ops.resize import resize_nearest

    cells = torch.randint(0, c, (CITY_B, -(-hw // block), -(-hw // block)), device=dev,
                          generator=g, dtype=torch.int32)
    lab_s = resize_nearest(cells, (hw, hw))
    onehot = torch.nn.functional.one_hot(lab_s.long(), c).permute(0, 3, 1, 2).float()
    noise = torch.randn(CITY_B, c, hw, hw, device=dev, generator=g)
    x = (amp * onehot - amp / 2 + 0.3 * noise).contiguous()
    lab = resize_nearest(lab_s, (CITY_CROP, CITY_CROP)).contiguous()
    lab[torch.rand(lab.shape, device=dev, generator=g) < ignore_frac] = 255
    return x, lab


def phase1_ohem_kernels(dev, cfg):
    """K7 against its plain versions at the Cityscapes heads' shapes, with
    the config's thresh and min_kept.  On identical inputs the k-th value
    and the kept labels are bit-equal; against the whole plain route, the
    kept pixels may differ only within K7_NEAR of the threshold (p_y differ
    in the last ulps), and they are counted.  The loss is held against the
    plain route, its gradient against the plain CE of the kernel route's
    kept labels.  Returns {kernel: max error}."""
    import torch

    from u2pl_tpu_torch.losses import ce, ohem
    from u2pl_tpu_torch.ops import quantile
    from u2pl_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_plain

    thresh, min_kept = cfg.criterion.thresh, cfg.criterion.min_kept
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = [  # (name, head side, amp, block, ignored share, what the k-th value must do)
        ("main head, k-th above thresh", CITY_OS4, 8.0, 8, 0.05, "above"),
        ("aux head, k-th above thresh", CITY_OS8, 8.0, 8, 0.05, "above"),
        ("main head, k-th below thresh", CITY_OS4, 6.0, 4, 0.05, "below"),
        ("main head, fewer valid pixels than min_kept", CITY_OS4, 8.0, 8, 0.95, "unapplied"),
        ("main head, all ignored", CITY_OS4, 8.0, 8, 1.0, "empty"),
    ]
    t32 = torch.tensor(thresh, dtype=torch.float32, device=dev)
    prob_err = 0.0
    for j, (name, hw, amp, block, ignore, expect) in enumerate(cases):
        x, lab = ohem_case(dev, g, hw, amp, block, ignore)
        k = min(lab.numel(), min_kept)
        p, nv = ohem.ohem_target_prob(x, lab)
        kth = quantile.kth_smallest(p, k)
        kept = ohem.ohem_keep_labels(lab, p, kth, nv, thresh, min_kept)
        kth_same = quantile.kth_smallest_plain(p, k)
        kept_same = ohem.ohem_keep_labels_plain(lab, p, kth_same, nv, thresh, min_kept)
        p_ref, nv_ref = ohem.ohem_target_prob_plain(x, lab)
        up = resize_bilinear(x, lab.shape[1:])
        p_a, _ = ohem._target_prob(up, lab, 255)
        up_diff = (up - resize_bilinear_plain(x, lab.shape[1:])).abs().max().item()
        del up
        kth_ref = quantile.kth_smallest_plain(p_ref, k)
        kept_ref = ohem.ohem_keep_labels_plain(lab, p_ref, kth_ref, nv_ref, thresh, min_kept)
        torch.cuda.synchronize()
        rel = ((p - p_ref).abs() / p_ref).max().item()
        rel_a = ((p - p_a).abs() / p_a).max().item()
        thr, thr_ref = torch.maximum(t32, kth), torch.maximum(t32, kth_ref)
        near = (((p - thr).abs() <= K7_NEAR * thr) | ((p_ref - thr_ref).abs() <= K7_NEAR * thr_ref))
        diff = kept != kept_ref
        n_valid, n_kept = int(nv), int((kept != 255).sum())
        n_diff, n_far = int(diff.sum()), int((diff & ~near).sum())
        log(f"[phase 1] K7 {name} {tuple(x.shape)} -> {CITY_CROP}², min_kept {min_kept}: p_y rel "
            f"{rel_a:.3e} against the softmax of kernel A's upsample (bound {K7_PROB_TOL}), "
            f"{rel:.3e} against the plain version (bound {K7_PLAIN_TOL}; the two upsamples' "
            f"logits {up_diff:.3e} apart); num_valid {n_valid} "
            f"(plain {int(nv_ref)}); k-th "
            f"{kth.item():.9g}, bit-equal on identical p_y {torch.equal(kth, kth_same)} (plain route "
            f"{kth_ref.item():.9g}); kept {n_kept}, bit-equal on identical inputs "
            f"{torch.equal(kept, kept_same)}; vs the plain route {n_diff} kept pixels differ, "
            f"{n_far} of them farther than {K7_NEAR} from the threshold (bound 0)")
        if not (rel_a <= K7_PROB_TOL and rel <= K7_PLAIN_TOL and n_valid == int(nv_ref)
                and torch.equal(kth, kth_same)
                and torch.equal(kept, kept_same) and n_far == 0):
            fail(f"K7 ({name}) differs from its plain versions")
        ok = {"above": kth.item() > thresh and n_valid >= min_kept,
              "below": kth.item() < thresh and n_valid >= min_kept,
              "unapplied": 0 < n_valid < min_kept and n_kept == n_valid,
              "empty": n_valid == 0 and kth.item() == 1.0 and n_kept == 0}[expect]
        if not ok:
            fail(f"K7 ({name}): the case is not what it should show ({expect}): k-th "
                 f"{kth.item()}, valid {n_valid}, kept {n_kept}")
        prob_err = max(prob_err, (p - p_ref).abs().max().item())
        if j == 0:  # the descent at its extreme ranks too
            for kk in (1, p.numel()):
                got, ref = quantile.kth_smallest(p, kk), quantile.kth_smallest_plain(p, kk)
                torch.cuda.synchronize()
                log(f"[phase 1] K7 kth, k {kk} of {p.numel()}: {got.item():.9g}, bit-equal to "
                    f"the sort {torch.equal(got, ref)}")
                if not torch.equal(got, ref):
                    fail(f"K7 kth (k {kk}) is not bit-equal to the sort")

        # the whole loss: the kernel route against the plain route, and its
        # gradient against the plain CE of the kernel route's kept labels
        for use_weight in (False, True) if j == 0 else (False,):
            xk, xp, xs = (x.clone().requires_grad_(True) for _ in range(3))
            loss = ohem.ohem_cross_entropy(xk, lab, thresh, min_kept, 255, use_weight)
            (gk,) = torch.autograd.grad(loss, xk)
            ref = ohem.ohem_cross_entropy_plain(xp, lab, thresh, min_kept, 255, use_weight)
            (gp,) = torch.autograd.grad(ref, xp)
            cw = ohem._class_weight(use_weight, dev)
            same = ce.upsample_cross_entropy_plain(xs, kept, 255, cw)
            (gs,) = torch.autograd.grad(same, xs)
            torch.cuda.synchronize()
            if expect == "empty":
                log(f"[phase 1] K7 {name}: loss {loss.item()}, gradient all zero "
                    f"{not gk.any().item()} (must be 0 and True)")
                if loss.item() != 0.0 or gk.any().item():
                    fail("K7: an all-ignored map must give loss 0 and a zero gradient")
                continue
            le = abs(loss.item() - ref.item()) / abs(ref.item())
            ge = (gk - gs).abs().max().item() / gs.abs().max().item()
            ge_route = (gk - gp).abs().max().item() / gp.abs().max().item()
            log(f"[phase 1] K7 + C {name}{', weighted' if use_weight else ''}: loss "
                f"{loss.item():.6f} vs plain route {ref.item():.6f}, rel {le:.3e} (bound "
                f"{C_LOSS_TOL}); gradient max abs diff / max |grad| {ge:.3e} against the plain "
                f"CE of the same kept labels (bound {C_GRAD_TOL}), {ge_route:.3e} against the plain "
                f"route")
            if not (le <= C_LOSS_TOL and ge <= C_GRAD_TOL):
                fail(f"K7 + C ({name}): loss {le}, gradient {ge}")
        del x, lab, p, p_ref, p_a, kept, kept_same, kept_ref
    return {"K7_prob": prob_err, "K7_kth": 0.0, "K7_keep": 0.0}


def phase6_contrastive(dev, card, cfg):
    import torch

    import u2pl_tpu_torch.losses.contrastive as contrastive
    from u2pl_tpu_torch.memobank import clone_bank
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import draw_contrastive, make_semi_step, run_steps

    ccfg = cfg.trainer.contrastive
    k = ccfg.max_keys_per_class_per_step
    log(f"[phase 6] config {os.path.relpath(VOC_CONFIG, ROOT)} with trainer.contrastive: "
        f"{ccfg.num_queries} queries, {ccfg.num_negatives} negatives, {k} keys per class and "
        f"step, ranks [{ccfg.low_rank}, {ccfg.high_rank}), temperature {ccfg.temperature}, "
        f"a {ccfg.queue_dtype} bank; float32, TF32 off; {B_L}+{B_U} images of {CROP}², "
        f"steps_per_epoch {STEPS_PER_EPOCH}, {TRAIN_STEPS} steps")
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    batches = synthetic_batches(dev, TRAIN_STEPS)
    log(f"[phase 6] bank {tuple(state.bank.keys.shape)} {state.bank.keys.dtype}, "
        f"{state.bank.keys.numel() * state.bank.keys.element_size() / 1e6:.1f} MB")
    rep_head = state.student.decoder.representation
    watch = {"decoder.representation.0.weight": rep_head[0].weight,
             "decoder.representation.8.weight": rep_head[8].weight}
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    enqueued = torch.zeros(cfg.net.num_classes, dtype=torch.int64, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    history, snapshot = [], None
    t0 = time.monotonic()
    for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
        if "low_thresh" in m:
            for name, p in watch.items():
                if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0:
                    fail(f"step {i_iter}: no finite nonzero gradient reached {name}")
            enqueued += torch.clamp(m["neg_cand"], max=k)
            expect = torch.minimum(enqueued, state.bank.sizes.long())
            if not torch.equal(state.bank.occupancy.long(), expect):
                fail(f"step {i_iter}: bank occupancy {state.bank.occupancy.tolist()} != "
                     f"min(keys enqueued, size) {expect.tolist()}")
        history.append((i_iter, scalars(m), m["neg_cand"].tolist() if "neg_cand" in m else None))
        if i_iter == TRAIN_STEPS - 2:
            snapshot = copy.deepcopy(state)  # before step 5
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    for i_iter, m, neg in history:
        semi = "low_thresh" in m
        log(f"[phase 6] step {i_iter} ({'semi' if semi else 'warmup'}, epoch "
            f"{i_iter // STEPS_PER_EPOCH}): " + ", ".join(f"{a} {v:.6g}" for a, v in m.items())
            + (f"; neg_cand {neg}" if semi else ""))
        if not all(v == v and abs(v) != float("inf") for v in m.values()):
            fail(f"step {i_iter}: non-finite metrics {m}")
        if semi and not m["con_loss"] > 0:
            fail(f"step {i_iter}: con_loss {m['con_loss']} is not > 0")
    log(f"[phase 6] {TRAIN_STEPS} steps in {run_s:.2f} s; bank occupancy "
        f"{state.bank.occupancy.tolist()}, ptr {state.bank.ptr.tolist()}; launches {launches}")
    missing = [name for name in (*TRAIN_COUNTERS, *CONTRA_COUNTERS) if launches[name] <= 0]
    if missing:
        fail(f"a kernel of the contrastive training path was never launched: {missing}")
    check_a_bwd_per_step("VOC contrastive training", launches)
    check_per_semi_step("VOC contrastive training", launches,
                        sum("low_thresh" in m for _, m, _ in history), contrastive=True)
    log(f"[{card}] peak device memory over the {TRAIN_STEPS} contrastive training steps: "
        f"{peak / 2**30:.2f} GiB")

    # step 5 again from the snapshot, dropout off, the mix and the contrastive
    # draws injected, through the kernels and through the plain versions; the
    # contrastive loss's inputs are captured on the way
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    draws = draw_contrastive(g, cfg, (B_L + B_U) * OS4 * OS4)
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    original = contrastive.compute_contra_memobank_loss
    captured = {}

    def run(st, route):
        def capture(*args, **kw):
            captured[route] = ([a.detach().clone() if torch.is_tensor(a) else a for a in args],
                               clone_bank(args[8]), kw)
            return original(*args, **kw)

        contrastive.compute_contra_memobank_loss = capture
        try:
            return step(st, *batches[-1], mix=mix, contra=draws)
        finally:
            contrastive.compute_contra_memobank_loss = original

    runs = both_routes(snapshot, run, "phase 6")
    del snapshot
    (mk, dk, sk), (mp, dp, sp) = runs["kernels"], runs["plain"]
    nk, np_ = mk["neg_cand"].tolist(), mp["neg_cand"].tolist()
    mk, mp, bk, bp = scalars(mk), scalars(mp), sk.bank, sp.bank
    names = ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "low_thresh", "high_thresh")
    rel = {a: abs(mk[a] - mp[a]) / max(abs(mp[a]), 1e-30) for a in names}
    (ak, _, _), (ap, _, _) = captured["kernels"], captured["plain"]
    discrete = {"labels": sum(int((ak[i] != ap[i]).sum()) for i in (1, 2)),
                "masks": sum(int((ak[i] != ap[i]).sum()) for i in (5, 6))}
    _, tight = update_closeness(dk, dp)
    log(f"[phase 6] step {TRAIN_STEPS} again, kernels vs plain versions: kernels {mk}; plain {mp}; "
        f"rel diffs {rel}; neg_cand {nk} vs {np_}; the loss's inputs: {discrete} label / mask "
        f"pixels differ, teacher softmax max abs diff "
        f"{(ak[3] - ap[3]).abs().max().item():.3e}; bank occupancy equal "
        f"{torch.equal(bk.occupancy, bp.occupancy)}; update closest to the bound, as a share of "
        f"it: {tight}")
    del runs, sk, sp, bk, bp
    if not rel["con_loss"] <= CON_LOSS_TOL:
        fail(f"step {TRAIN_STEPS}: con_loss kernels vs plain versions {rel['con_loss']}")
    if not all(rel[a] <= STEP_LOSS_TOL for a in ("sup_loss", "uns_loss", "drop_thresh")):
        fail(f"step {TRAIN_STEPS}: kernels vs plain versions {rel}")
    if tight[0][1] > 1.0:
        fail(f"step {TRAIN_STEPS}: parameter update differs from the plain route: {tight}")

    # the contrastive loss on the kernel route's own inputs, through the
    # kernels, the plain versions and the plain versions in float64 (the rep
    # widened): selections, anchors and bank bit-equal, the kernels' loss and
    # gradient within K6's bounds of the float64 route's.  A class with one
    # anchor pixel puts all 256 draws on it, and there each f32 route's sum
    # of 256 rows sits 3.3e-7 to 6.6e-7 of the gradient's max from the
    # float64 sum and the two f32 routes up to 9.2e-7 apart (12 runs of
    # u2pl_tpu_torch/kernels/k6_rounding.py on an NVIDIA H100 80GB HBM3 at
    # 700 W), so that gap is no measure of the kernel's error; it is logged
    args, bank0, kw = captured["kernels"]
    out = {}
    for route, dtype in (("kernels", torch.float32), ("plain", torch.float32),
                         ("float64", torch.float64)):
        rep = args[0].to(dtype, copy=True).requires_grad_(True)
        with plain_versions() if route != "kernels" else contextlib.nullcontext():
            bank, loss, info = original(rep, *args[1:8], clone_bank(bank0), *args[9:], **kw)
        (grad,) = torch.autograd.grad(loss, rep)
        out[route] = (loss.item(), grad, bank, info["neg_candidates"])
    torch.cuda.synchronize()
    (lk, gk, bk, ck), (lp, gp, bp, cp), (lr, gr, br, cr) = out.values()
    same = all(torch.equal(getattr(bk, a), getattr(b_, a))
               for a in ("keys", "ptr", "occupancy") for b_ in (bp, br))
    counts = torch.equal(ck, cp) and torch.equal(ck, cr)
    top = max(gr.abs().max().item(), 1e-30)
    rel_l = abs(lk - lr) / max(abs(lr), 1e-30)
    rel_g = (gk.double() - gr).abs().max().item() / top
    rel_p = (gp.double() - gr).abs().max().item() / top
    rel_kp = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
    log(f"[phase 6] the step's contrastive loss on identical inputs, kernels vs the plain "
        f"versions in float64: loss {lk:.6f} vs {lr:.9f} (rel {rel_l:.3e}, bound {K6_LOSS_TOL}); "
        f"gradient {rel_g:.3e} of its max (bound {K6_GRAD_TOL}); the plain versions in f32: "
        f"loss {lp:.6f}, gradient {rel_p:.3e} of the float64 max, {rel_kp:.3e} from the "
        f"kernels'; selections and bank bit-equal {same}; neg_candidates equal {counts}")
    if not (same and counts and rel_l <= K6_LOSS_TOL and rel_g <= K6_GRAD_TOL):
        fail(f"the contrastive loss differs between the kernels and the plain versions in "
             f"float64: loss rel {rel_l:.3e} (bound {K6_LOSS_TOL}), gradient {rel_g:.3e} of its "
             f"max (bound {K6_GRAD_TOL}), selections and bank bit-equal {same}, neg_candidates "
             f"equal {counts}")
    return state, batches, launches, peak


def phase7_contrastive_timings(dev, card, cfg, state, batches, case):
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain
    from u2pl_tpu_torch.train.steps import make_semi_step

    ccfg = cfg.trainer.contrastive
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2 + 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(runs)
    imgs = B_L + B_U
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{card}] contrastive semi step ({imgs} images of {CROP}², f32, synchronised): median "
        f"{med:.1f} ms over {len(runs)} runs after 2 (min {min(runs):.1f}, max {max(runs):.1f}); "
        f"{imgs * 1e3 / med:.2f} img/s; peak device memory {peak / 2**30:.2f} GiB")

    k = ccfg.max_keys_per_class_per_step
    masks = (case["prob"], case["labels"], case["low"], case["high"], B_L, ccfg)
    neg, pri = case["negative"], case["pri"]
    masked = torch.where(neg, pri, torch.full_like(pri, float("inf")))
    bank_k, bank_p = clone_bank(case["bank"]), clone_bank(case["bank"])
    enq = (case["rep_t"], case["sel_idx"], case["n_sel"])
    anchors = (case["anchor"], case["a_j"], case["u_anchor"])
    k6 = (case["anchor_idx"], case["positive"], case["bank"], case["b_j"], case["u_neg"],
          case["active"], case["valid_seg"], ccfg.temperature)
    times = {
        "K4_masks": (cuda_ms(lambda: tc.contra_pixel_masks(*masks)),
                     cuda_ms(lambda: tc.contra_pixel_masks_plain(*masks)), None),
        "K4_select": (cuda_ms(lambda: tc.select_keys(neg, pri, k)),
                      cuda_ms(lambda: tc.select_keys_plain(neg, pri, k)),
                      cuda_ms(lambda: torch.sort(masked, dim=1, stable=True))),
        "K4_anchors": (cuda_ms(lambda: tc.sample_anchors(*anchors)),
                       cuda_ms(lambda: tc.sample_anchors_plain(*anchors)), None),
        "K5": (cuda_ms(lambda: memobank_enqueue(bank_k, *enq)),
               cuda_ms(lambda: memobank_enqueue_plain(bank_p, *enq)), None),
    }
    del bank_k, bank_p
    rep = case["rep"].clone().requires_grad_(True)
    with torch.no_grad():
        fwd = (cuda_ms(lambda: tc.contra_infonce(rep, *k6), 20),
               cuda_ms(lambda: tc.contra_infonce_plain(rep, *k6), 20))
    times["K6_fwd"] = fwd + (None,)
    lk, lp = tc.contra_infonce(rep, *k6), tc.contra_infonce_plain(rep, *k6)
    # the backward as a plain call (the gradient's allocation included), as
    # the autograd engine's call, and in the profiler's trace
    saved = lk.grad_fn.saved_tensors  # anchor_idx, active, valid_seg, gdir
    one = torch.ones((), device=dev)
    bwd = lambda: tc._infonce_bwd_cuda(*saved, one, tuple(rep.shape))  # noqa: E731
    # the library yardstick: index_add_ of the anchors' gradient rows into
    # a zeroed (N, F) gradient (NHWC rows)
    b, f = rep.shape[:2]
    rows = case["anchor_idx"].flatten().long()
    src = torch.randn(rows.numel(), f, device=dev)
    times["K6_bwd"] = (
        cuda_ms(bwd, 20),
        cuda_ms(lambda: torch.autograd.grad(lp, rep, retain_graph=True), 20),
        cuda_ms(lambda: torch.zeros(b * OS4 * OS4, f, device=dev).index_add_(0, rows, src), 20),
    )
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(lk, rep, retain_graph=True), 20)
    prof = device_ms_profiled(bwd)
    log(f"[{card}] kernel K6_bwd through torch.autograd.grad: {autograd_ms:.4f} ms; "
        f"torch.profiler device time per call of the plain call {profiled_text(prof)}")
    del lk, lp, saved
    shapes = {
        "K4_masks": f"prob {tuple(case['prob'].shape)} -> (21, N) masks",
        "K4_select": f"({neg.shape[0]}, {neg.shape[1]}), k {k}",
        "K4_anchors": f"({neg.shape[0]}, {neg.shape[1]}) x {case['u_anchor'].shape[1]} draws",
        "K5": f"{int(case['n_sel'].sum())} keys into {tuple(case['bank'].keys.shape)} bf16",
        "K6_fwd": f"{int(case['active'].sum())} positions x {case['u_anchor'].shape[1]} x "
                  f"(1 + {ccfg.num_negatives})",
        "K6_bwd": "the same, backward to the (8, 256, 129, 129) rep, as a plain call",
    }
    library = {"K4_select": "torch.sort(stable=True)", "K6_bwd": "index_add_ into (N, F) rows"}
    for name, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; {library[name]} {tl:.4f} ms"
        log(f"[{card}] kernel {name} {shapes[name]}: {tk:.4f} ms; plain version {tp:.4f} ms{lib}")
    return {"semi_ms": med, "img_s": imgs * 1e3 / med, "peak": peak}, times


def phase8_cityscapes(dev, card, cfg):
    import torch

    import u2pl_tpu_torch.losses.ohem as ohem
    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import (
        draw_contrastive, make_semi_step, make_sup_step, run_steps,
    )

    ccfg, crit, tr = cfg.trainer.contrastive, cfg.criterion, cfg.trainer
    k = ccfg.max_keys_per_class_per_step
    ignore = cfg.dataset.ignore_label
    log(f"[phase 8] config {os.path.relpath(CITY_CONFIG, ROOT)}: {cfg.dataset.type}, "
        f"{cfg.net.num_classes} classes, aux head (weight {cfg.net.aux_loss.loss_weight}), "
        f"criterion {crit.type} (thresh {crit.thresh}, min_kept {crit.min_kept}, use_weight "
        f"{crit.use_weight}), {tr.optimizer.type} lr {tr.optimizer.lr} (x1 head), contrastive "
        f"{ccfg.num_queries} queries, {ccfg.num_negatives} negatives, {k} keys per class, a "
        f"{ccfg.queue_dtype} bank; float32, TF32 off; {CITY_B}+{CITY_B} images of {CITY_CROP}², "
        f"steps_per_epoch {STEPS_PER_EPOCH}, sup_only_epoch {tr.sup_only_epoch}, "
        f"{TRAIN_STEPS} steps")
    t0 = time.monotonic()
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    batches = synthetic_batches(dev, TRAIN_STEPS, CITY_B, CITY_CROP, cfg.net.num_classes, SEED + 12)
    student, teacher = state.student, state.teacher
    log(f"[phase 8] student + teacher ({sum(p.numel() for p in student.parameters())} parameters "
        f"each), bank {tuple(state.bank.keys.shape)} {state.bank.keys.dtype} and {TRAIN_STEPS} "
        f"batches built in {time.monotonic() - t0:.1f}s")
    watch = {"auxor.aux.0.weight": student.auxor.aux[0].weight,
             "auxor.aux.4.weight": student.auxor.aux[4].weight,
             "decoder.representation.0.weight": student.decoder.representation[0].weight,
             "decoder.representation.8.weight": student.decoder.representation[8].weight}
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    enqueued = torch.zeros(cfg.net.num_classes, dtype=torch.int64, device=dev)

    # each OHEM call's head (its logits' side) and kept-pixel count, recorded
    # around `ohem_kept_labels` (the three K7 kernels; each counts its launches)
    heads = []
    kept_fn = ohem.ohem_kept_labels

    def record_kept(logits, *args, **kw):
        out = kept_fn(logits, *args, **kw)
        heads.append((tuple(logits.shape[2:]), (out != ignore).sum()))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    history, snapshot = [], None
    ohem.ohem_kept_labels = record_kept
    t0 = time.monotonic()
    try:
        for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
            epoch = i_iter // STEPS_PER_EPOCH
            for name, p in watch.items():
                if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0:
                    fail(f"step {i_iter}: no finite nonzero gradient reached {name}")
            enqueued += torch.clamp(m["neg_cand"], max=k)
            expect = torch.minimum(enqueued, state.bank.sizes.long())
            if not torch.equal(state.bank.occupancy.long(), expect):
                fail(f"step {i_iter}: bank occupancy {state.bank.occupancy.tolist()} != "
                     f"min(keys enqueued, size) {expect.tolist()}")
            same = _params_equal(teacher, student)
            if epoch == tr.sup_only_epoch and not same:
                fail(f"step {i_iter} (first semi epoch): teacher != student")
            if epoch > tr.sup_only_epoch and same:
                fail(f"step {i_iter} (epoch {epoch}): teacher == student after the EMA")
            history.append((i_iter, scalars(m), m["neg_cand"].tolist(), same))
            if i_iter == TRAIN_STEPS - 2:
                snapshot = copy.deepcopy(state)  # before step 5
        torch.cuda.synchronize()
    finally:
        ohem.ohem_kept_labels = kept_fn
    run_s = time.monotonic() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    kept = [(hw, int(c)) for hw, c in heads]
    for j, (i_iter, m, neg, same) in enumerate(history):
        log(f"[phase 8] step {i_iter} (semi, epoch {i_iter // STEPS_PER_EPOCH}): "
            + ", ".join(f"{a} {v:.6g}" for a, v in m.items())
            + f"; kept pixels (main {kept[2 * j][0]}, aux {kept[2 * j + 1][0]} heads): "
            f"{kept[2 * j][1]}, {kept[2 * j + 1][1]} of {CITY_B * CITY_CROP ** 2}; "
            f"teacher == student: {same}; neg_cand {neg}")
        if not all(v == v and abs(v) != float("inf") for v in m.values()):
            fail(f"step {i_iter}: non-finite metrics {m}")
        if not m["con_loss"] > 0:
            fail(f"step {i_iter}: con_loss {m['con_loss']} is not > 0")
    want = [(CITY_OS4, CITY_OS4), (CITY_OS8, CITY_OS8)] * TRAIN_STEPS
    if [hw for hw, _ in kept] != want:
        fail(f"OHEM heads {[hw for hw, _ in kept]}: not the os4 main and os8 aux head per step")
    log(f"[phase 8] {TRAIN_STEPS} steps in {run_s:.2f} s; bank occupancy "
        f"{state.bank.occupancy.tolist()}; launches {launches}")
    missing = [a for a in (*TRAIN_COUNTERS, *CONTRA_COUNTERS, *OHEM_COUNTERS) if launches[a] <= 0]
    if missing:
        fail(f"a kernel of the Cityscapes training path was never launched: {missing}")
    check_a_bwd_per_step("Cityscapes training", launches)
    check_per_semi_step("Cityscapes training", launches, len(history), contrastive=True,
                        heads=2)
    # C's forward per head: one after each OHEM call (main, aux), the rest
    # the unsupervised CE
    for name, hw in (("C_fwd_city_main", (CITY_OS4, CITY_OS4)),
                     ("C_fwd_city_aux", (CITY_OS8, CITY_OS8))):
        launches[name] = sum(h == hw for h, _ in kept)
    launches["C_fwd_city_unsup"] = (launches["C_fwd"] - launches["C_fwd_city_main"]
                                    - launches["C_fwd_city_aux"])
    # each OHEM call launches each K7 kernel once, twice per semi step: K7
    # prob once per head
    if (any(launches[a] != 2 * TRAIN_STEPS for a in OHEM_COUNTERS)
            or launches["K7_prob_main"] != TRAIN_STEPS or launches["K7_prob_aux"] != TRAIN_STEPS):
        fail(f"the OHEM kernels did not run on both heads of every step (twice per semi "
             f"step): {launches}")
    log(f"[{card}] peak device memory over the {TRAIN_STEPS} Cityscapes training steps: "
        f"{peak / 2**30:.2f} GiB")

    # step 5 again from the snapshot, dropout off, the mix and the
    # contrastive draws injected, through the kernels and the plain versions
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, CITY_B, CITY_CROP, CITY_CROP))
    draws = draw_contrastive(g, cfg, 2 * CITY_B * CITY_OS4 * CITY_OS4)
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = both_routes(snapshot, lambda st, route: step(st, *batches[-1], mix=mix, contra=draws),
                       "phase 8")
    del snapshot
    (mk, dk, _), (mp, dp, _) = runs["kernels"], runs["plain"]
    del runs
    mk, mp = scalars(mk), scalars(mp)
    names = ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "low_thresh", "high_thresh")
    rel = {a: abs(mk[a] - mp[a]) / max(abs(mp[a]), 1e-30) for a in names}
    _, tight = update_closeness(dk, dp)
    log(f"[phase 8] step {TRAIN_STEPS} again, kernels vs plain versions: kernels {mk}; plain {mp}; "
        f"rel diffs {rel}; update closest to the bound, as a share of it: {tight}")
    if not rel["con_loss"] <= CON_LOSS_TOL:
        fail(f"step {TRAIN_STEPS}: con_loss kernels vs plain versions {rel['con_loss']}")
    if not all(rel[a] <= STEP_LOSS_TOL for a in ("sup_loss", "uns_loss", "drop_thresh")):
        fail(f"step {TRAIN_STEPS}: kernels vs plain versions {rel}")
    if tight[0][1] > 1.0:
        fail(f"step {TRAIN_STEPS}: parameter update differs from the plain route: {tight}")

    # the supervised baseline: experiments/cityscapes/744/suponly, make_sup_step
    sup_cfg = load_f32(CITY_SUP_CONFIG)
    sup_state = create_train_state(sup_cfg, device=dev,
                                   generator=torch.Generator().manual_seed(SEED + 1))
    sup_step = make_sup_step(sup_cfg, STEPS_PER_EPOCH)
    aux_w = sup_state.student.auxor.aux[4].weight
    zero_counters()
    sup_losses = []
    for image, label, _ in batches[:CITY_SUP_STEPS]:
        m = sup_step(sup_state, image, label, gen)
        grad = aux_w.grad
        if grad is None or not torch.isfinite(grad).all() or grad.abs().sum() == 0:
            fail("suponly: no finite nonzero gradient reached auxor.aux.4.weight")
        sup_losses.append(m["sup_loss"].item())
    sup_launches = {a: v for a, v in read_counters().items() if v}
    log(f"[phase 8] {os.path.relpath(CITY_SUP_CONFIG, ROOT)} ({sup_cfg.dataset.type}, criterion "
        f"{sup_cfg.criterion.type}): {CITY_SUP_STEPS} make_sup_step steps of {CITY_B} images, "
        f"sup_loss {sup_losses}; launches {sup_launches}")
    if not all(v == v and abs(v) != float("inf") for v in sup_losses):
        fail(f"suponly: non-finite losses {sup_losses}")
    if any(sup_launches.get(a, 0) != 2 * CITY_SUP_STEPS for a in OHEM_COUNTERS):
        fail(f"suponly: the OHEM kernels did not run on both heads of every step: {sup_launches}")
    del sup_state, sup_step
    return state, batches, launches, peak


def phase9_city_timings(dev, card, cfg, state, batches):
    import torch

    from u2pl_tpu_torch.losses import ce, ohem
    from u2pl_tpu_torch.ops import quantile
    from u2pl_tpu_torch.train.steps import make_semi_step

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2 + 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(runs)
    imgs = 2 * CITY_B
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{card}] Cityscapes semi step (OHEM, contrastive; {imgs} images of {CITY_CROP}², f32, "
        f"synchronised): median {med:.1f} ms over {len(runs)} runs after 2 (min {min(runs):.1f}, "
        f"max {max(runs):.1f}); {imgs * 1e3 / med:.2f} img/s; peak device memory "
        f"{peak / 2**30:.2f} GiB")

    thresh, min_kept = cfg.criterion.thresh, cfg.criterion.min_kept
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    x, lab = ohem_case(dev, g, CITY_OS4, 8.0, 8, 0.05)
    p, nv = ohem.ohem_target_prob(x, lab)
    k = min(p.numel(), min_kept)
    kth = quantile.kth_smallest(p, k)
    flat = p.reshape(-1)
    # C's backward at the heads' shapes, on OHEM's kept labels (the main
    # head's with the class weight that `use_weight` selects)
    kept = ohem.ohem_kept_labels(x, lab, thresh, min_kept)
    c_bwd = c_bwd_timing(card, "C_bwd_city_main", x, kept, ohem._class_weight(True, dev))
    xa, laba = ohem_case(dev, g, CITY_OS8, 8.0, 4, 0.05)
    kept_a = ohem.ohem_kept_labels(xa, laba, thresh, min_kept)
    c_bwd_aux = c_bwd_timing(card, "C_bwd_city_aux", xa, kept_a, None)
    # C's forward at the three heads of the step: OHEM main (kept labels,
    # the class weight `use_weight` selects) and aux (kept labels), and the
    # unsupervised CE (20% of the pseudo-labels dropped by the entropy gate)
    xu = torch.randn(CITY_B, 19, CITY_OS4, CITY_OS4, device=dev, generator=g)
    labu = torch.randint(0, 19, lab.shape, device=dev, generator=g, dtype=torch.int32)
    labu[torch.rand(labu.shape, device=dev, generator=g) < 0.2] = 255
    c_fwd, c_fwd_shapes = {}, {}
    with torch.no_grad():
        for name, (xc, lc, cw) in (("C_fwd_city_main", (x, kept, ohem._class_weight(True, dev))),
                                   ("C_fwd_city_aux", (xa, kept_a, None)),
                                   ("C_fwd_city_unsup", (xu, labu, None))):
            c_fwd[name] = (cuda_ms(lambda: ce.upsample_cross_entropy(xc, lc, 255, cw)),
                           cuda_ms(lambda: ce.upsample_cross_entropy_plain(xc, lc, 255, cw)), None)
            c_fwd_shapes[name] = f"{tuple(xc.shape)} -> {tuple(lc.shape[1:])}" + (
                ", weighted" if cw is not None else "")
    del kept_a, xu, labu
    K7_VALID["K7_prob"], K7_VALID["K7_prob_aux"] = int(nv), int((laba != 255).sum())
    ent = torch.rand(CITY_B, CITY_CROP, CITY_CROP, device=dev, generator=g) * 3
    valid = torch.rand(ent.shape, device=dev, generator=g) < 0.85
    pct = torch.tensor([80.25, 19.75, 80.25], device=dev)  # the contrastive step's call
    times = {
        "K7_prob": (cuda_ms(lambda: ohem.ohem_target_prob(x, lab)),
                    cuda_ms(lambda: ohem.ohem_target_prob_plain(x, lab)), None),
        "K7_prob_aux": (cuda_ms(lambda: ohem.ohem_target_prob(xa, laba)),
                        cuda_ms(lambda: ohem.ohem_target_prob_plain(xa, laba)), None),
        "E_city_3": (cuda_ms(lambda: quantile.masked_percentiles(ent, valid, pct)),
                     cuda_ms(lambda: quantile.masked_percentiles_plain(ent, valid, pct)),
                     cuda_ms(lambda: torch.quantile(ent[valid], pct / 100.0,
                                                    interpolation="linear"))),
        "K7_kth": (cuda_ms(lambda: quantile.kth_smallest(p, k)),
                   cuda_ms(lambda: quantile.kth_smallest_plain(p, k)),
                   cuda_ms(lambda: torch.kthvalue(flat, k))),
        "K7_keep": (cuda_ms(lambda: ohem.ohem_keep_labels(lab, p, kth, nv, thresh, min_kept)),
                    cuda_ms(lambda: ohem.ohem_keep_labels_plain(lab, p, kth, nv, thresh, min_kept)),
                    None),
    }
    # K4's masks and anchor draws at the Cityscapes step's shapes, bit-equal
    # to their plain versions, then timed
    from u2pl_tpu_torch.kernels.timing_ab import masks_needed
    from u2pl_tpu_torch.losses import contrastive as tc

    ccfg = cfg.trainer.contrastive
    masks = (*mask_inputs(g, 2 * CITY_B, CITY_B, 19, CITY_OS4), CITY_B, ccfg)
    got, ref = tc.contra_pixel_masks(*masks), tc.contra_pixel_masks_plain(*masks)
    a_j = torch.arange(19, dtype=torch.int32, device=dev)
    u = torch.rand(19, ccfg.num_queries, device=dev, generator=g)
    u[:, 0] = 0.99999994  # the largest draw below 1
    anchors = (got[0], a_j, u)
    got_a, ref_a = tc.sample_anchors(*anchors), tc.sample_anchors_plain(*anchors)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(got, ref))
            and all(torch.equal(a, b) for a, b in zip(got_a, ref_a)))
    log(f"[phase 9] K4 contra_pixel_masks {tuple(masks[0].shape)} and sample_anchors "
        f"{tuple(got[0].shape)} x {u.shape[1]} draws: bit-equal {same}; n_low_valid "
        f"{got[3][0].tolist()}; neg_candidates {got[3][1].tolist()}; n_anchor {got_a[1].tolist()}")
    if not same or not got[0].any() or not got[1].any():
        fail("K4 masks or anchor draws at the Cityscapes shape differ from their plain versions "
             "(or no anchors or negatives)")
    times["K4_masks_city"] = (cuda_ms(lambda: tc.contra_pixel_masks(*masks)),
                              cuda_ms(lambda: tc.contra_pixel_masks_plain(*masks)), None)
    K4_MASKS_NEEDED["K4_masks_city"] = masks_needed(*masks)
    times["K4_anchors_city"] = (cuda_ms(lambda: tc.sample_anchors(*anchors)),
                                cuda_ms(lambda: tc.sample_anchors_plain(*anchors)), None)
    del masks, got, ref, anchors
    from u2pl_tpu_torch.losses import unsup

    xd = torch.randn(CITY_B, 19, CITY_OS4, CITY_OS4, device=dev, generator=g) * 3
    out_hw = (CITY_CROP, CITY_CROP)
    for sel in ("prob", "entropy"):  # the semi step's two calls of kernel D
        times[f"D_city_{sel}"] = (
            cuda_ms(lambda: unsup.upsample_softmax_stats(xd, out_hw, outputs=sel)),
            cuda_ms(lambda: unsup.upsample_softmax_stats_plain(xd, out_hw, sel)), None)
    del xd
    shapes = {
        "D_city_prob": f"({CITY_B}, 19, {CITY_OS4}, {CITY_OS4}) -> {CITY_CROP}², max-prob + argmax",
        "D_city_entropy": f"({CITY_B}, 19, {CITY_OS4}, {CITY_OS4}) -> {CITY_CROP}², entropy",
        "K7_prob": f"{tuple(x.shape)} -> {CITY_CROP}², labels {tuple(lab.shape)}",
        "K7_prob_aux": f"{tuple(xa.shape)} -> {CITY_CROP}², labels {tuple(laba.shape)}",
        "E_city_3": f"3 percentiles of {tuple(ent.shape)}, ~85% valid",
        "K7_kth": f"k {k} of {p.numel()} p_y",
        "K7_keep": f"labels and p_y {tuple(lab.shape)}",
        "K4_masks_city": f"prob ({2 * CITY_B}, 19, {CITY_OS4}, {CITY_OS4}) -> (19, N) masks",
        "K4_anchors_city": f"(19, {2 * CITY_B * CITY_OS4 ** 2}) x {ccfg.num_queries} draws",
        **c_fwd_shapes,
    }
    times.update(c_fwd)
    library = {"K7_kth": "torch.kthvalue", "E_city_3": "torch.quantile(values[mask], linear)"}
    for name, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; {library[name]} {tl:.4f} ms"
        log(f"[{card}] kernel {name} {shapes[name]}: {tk:.4f} ms; plain version {tp:.4f} ms{lib}")
    times["C_bwd_city_main"], times["C_bwd_city_aux"] = c_bwd, c_bwd_aux
    return {"semi_ms": med, "img_s": imgs * 1e3 / med, "peak": peak}, times


# phases 10 and 11: the trainer CLIs on a synthetic VOC-layout workspace
CLI_LABELED = CLI_UNLABELED = 16
CLI_VAL = 4
CLI_IMAGE = (375, 500)  # VOC's most common image size, (h, w)
CLI_VAL_SIZES = [CLI_IMAGE, (500, 333), (281, 500), (333, 500)]  # VOC val sizes, for eval
# 4 steps per epoch of 4 + 4 images; 2 epochs, the first of them warmup
CLI_OVERRIDES = {"dataset.n_sup": 16, "dataset.pool_size": 32, "trainer.epochs": 2,
                 "trainer.sup_only_epoch": 1, **F32_OVERRIDE}
VARIANT_OVERRIDES = {**CLI_OVERRIDES, "trainer.epochs": 1, "trainer.sup_only_epoch": 0,
                     "trainer.unsupervised.apply_aug": "classmix",
                     "trainer.contrastive.select_keys": "radix"}


@contextlib.contextmanager
def random_init_allowed():
    """U2PL_ALLOW_RANDOM_INIT=1: the configs require ImageNet weights, which
    the smoke test does not have."""
    old = os.environ.get("U2PL_ALLOW_RANDOM_INIT")
    os.environ["U2PL_ALLOW_RANDOM_INIT"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["U2PL_ALLOW_RANDOM_INIT"]
        else:
            os.environ["U2PL_ALLOW_RANDOM_INIT"] = old


def run_cli(module, cfg_path, args=None):
    """`module.main` on the card, in process, with `args` after the config
    (default: the trainers' seed SEED): (summary, the log lines, the launch
    counts of the run, counted from 0)."""
    import logging

    lines = []
    rec = logging.Handler()
    rec.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("global")
    logger.addHandler(rec)
    zero_counters()
    try:
        with random_init_allowed():
            summary = module.main(["--config", cfg_path] + (
                ["--seed", str(SEED)] if args is None else list(args)))
    finally:
        logger.removeHandler(rec)
    import torch

    torch.cuda.synchronize()
    return summary, lines, read_counters()


def cli_report(card, name, summary):
    for e, (ep_s, waits, data_s, step_s) in enumerate(zip(
            summary["epoch_s"], summary["data_waits"], summary["data_s"], summary["step_s"])):
        log(f"[{card}] {name} epoch {summary['start_epoch'] + e}: {ep_s:.3f} s for "
            f"{summary['steps_per_epoch']} steps; per step: host step time {step_s * 1e3:.1f} ms "
            f"(batch on the card -> step returned), data wait {data_s * 1e3:.1f} ms (the "
            f"loader's mean; step by step {[round(w * 1e3, 1) for w in waits]} ms)")


def check_validations(name, summary, lines, n, classes):
    ious = [ln for ln in lines if ln.startswith(" * class [")]
    mious = summary["mious"]
    log(f"[phase 10] {name}: {len(mious)} validations, mIoU {mious}; best {summary['best_miou']}")
    if len(mious) != n or len(ious) != n * classes or not all(0.0 <= m <= 1.0 for m in mious):
        fail(f"{name}: validations {mious}, {len(ious)} per-class IoU lines "
             f"(want {n} and {n * classes})")


def phase10_cli(dev, card, tmp):
    """train_semi on the flagship config (2 epochs, then a resume into a
    third), and train_sup on suponly (1 epoch)."""
    import torch

    from u2pl_tpu_torch import train_semi, train_sup
    from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config
    from u2pl_tpu_torch.utils.checkpoint import CKPT_BEST_NAME, CKPT_NAME

    t_phase = time.monotonic()
    paths = make_voc_workspace(os.path.join(tmp, "voc"), CLI_LABELED, CLI_UNLABELED, CLI_VAL,
                               size=CLI_IMAGE, seed=SEED, val_sizes=CLI_VAL_SIZES)
    log(f"[phase 10] synthetic VOC workspace: {CLI_LABELED} labeled and {CLI_UNLABELED} "
        f"unlabeled JPEG / PNG pairs of {CLI_IMAGE[1]}x{CLI_IMAGE[0]}, {CLI_VAL} val of (h, w) "
        f"{CLI_VAL_SIZES}, made in "
        f"{time.monotonic() - t_phase:.1f} s; config {os.path.relpath(VOC_CONFIG, ROOT)} with "
        f"{CLI_OVERRIDES}")
    exp = os.path.join(tmp, "exp_semi")
    cfg_path = write_config(VOC_CONFIG, paths, exp, CLI_OVERRIDES)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    summary, lines, launches = run_cli(train_semi, cfg_path)
    run_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check_validations("train_semi", summary, lines, 2, 21)
    ckpt = {n: os.path.join(exp, "checkpoints", n) for n in (CKPT_NAME, CKPT_BEST_NAME)}
    if not all(os.path.isfile(p) for p in ckpt.values()):
        fail(f"train_semi wrote {os.listdir(os.path.join(exp, 'checkpoints'))}")
    size = {n: os.path.getsize(p) for n, p in ckpt.items()}
    log(f"[phase 10] train_semi: {summary['steps']} steps, 2 validations in {run_s:.1f} s; "
        f"checkpoints {size} bytes, written in {[round(t, 3) for t in summary['ckpt_s']]} s per "
        f"epoch (best and latest); launches {launches}")
    cli_report(card, "train_semi", summary)
    state = summary.pop("state")
    occupancy = state.bank.occupancy.clone()
    want_b = 2 * CLI_VAL
    missing = [a for a in (*TRAIN_COUNTERS, *CONTRA_COUNTERS) if launches[a] <= 0]
    if summary["steps"] != 8 or int(state.step) != 8 or missing or launches["B"] != want_b:
        fail(f"train_semi: {summary['steps']} steps, kernels never launched {missing}, "
             f"kernel B {launches['B']} times (want one per val image, {want_b})")
    if launches["K3c"] or launches["K4r"] or int(occupancy.sum()) <= 0:
        fail(f"train_semi: an option's kernel ran, or the bank is empty: {launches}, "
             f"{occupancy.tolist()}")
    del state
    torch.cuda.empty_cache()

    # resume into a third epoch: auto_resume restores epoch 2, step 8 and the bank
    cfg_path = write_config(VOC_CONFIG, paths, exp, {**CLI_OVERRIDES, "trainer.epochs": 3,
                                                     "saver.auto_resume": True})
    restored = {}
    maybe_resume = train_semi.maybe_resume

    def recording(cfg_saver, save_path, st):
        out = maybe_resume(cfg_saver, save_path, st)
        restored.update(step=int(st.step), occupancy=st.bank.occupancy.clone())
        return out

    train_semi.maybe_resume = recording
    try:
        t0 = time.monotonic()
        resumed, lines, res_launches = run_cli(train_semi, cfg_path)
        res_s = time.monotonic() - t0
    finally:
        train_semi.maybe_resume = maybe_resume
    st = resumed.pop("state")
    log(f"[phase 10] resume with epochs 3, auto_resume: started at epoch {resumed['start_epoch']}, "
        f"step {resumed['start_iter']} (state step {restored.get('step')}); bank occupancy "
        f"restored {restored['occupancy'].tolist()}; ran {resumed['steps']} steps to step "
        f"{int(st.step)} in {res_s:.1f} s")
    check_validations("train_semi resumed", resumed, lines, 1, 21)
    if (resumed["start_epoch"], resumed["start_iter"], restored.get("step")) != (2, 8, 8) or not (
            torch.equal(restored["occupancy"], occupancy)) or int(st.step) != 12:
        fail("the resumed run did not start at epoch 2, step 8 with the saved bank")
    cli_report(card, "train_semi resumed", resumed)
    del st
    torch.cuda.empty_cache()

    # the supervised CLI on suponly, one epoch
    sup_exp = os.path.join(tmp, "exp_sup")
    sup_path = write_config(VOC_SUP_CONFIG, paths, sup_exp,
                            {"dataset.n_sup": 16, "trainer.epochs": 1, **F32_OVERRIDE})
    t0 = time.monotonic()
    sup, lines, sup_launches = run_cli(train_sup, sup_path)
    sup_s = time.monotonic() - t0
    sup.pop("state")
    check_validations("train_sup", sup, lines, 1, 21)
    log(f"[phase 10] train_sup {os.path.relpath(VOC_SUP_CONFIG, ROOT)}: {sup['steps']} steps in "
        f"{sup_s:.1f} s; launches {sup_launches}")
    cli_report(card, "train_sup", sup)
    sup_missing = [a for a in ("A", "A_bwd", "C_fwd", "C_bwd") if sup_launches[a] <= 0]
    if sup["steps"] != 4 or sup_missing or sup_launches["B"] != CLI_VAL or not os.path.isfile(
            os.path.join(sup_exp, "checkpoints", CKPT_BEST_NAME)):
        fail(f"train_sup: {sup['steps']} steps, kernels never launched {sup_missing}, "
             f"B {sup_launches['B']}")
    torch.cuda.empty_cache()
    phase_s = time.monotonic() - t_phase
    log(f"[{card}] phase 10 (workspace, train_semi 2 epochs, resume, train_sup) in {phase_s:.1f} s; "
        f"peak device memory of the train_semi run {peak / 2**30:.2f} GiB")
    total = {a: launches[a] + res_launches[a] + sup_launches[a] for a in launches}
    return paths, total, {"semi": summary, "resumed": resumed, "sup": sup, "ckpt_bytes": size,
                          "phase_s": phase_s}


def phase11_variant(dev, card, tmp, paths):
    """train_semi with apply_aug: classmix and contrastive.select_keys: radix
    (sup_only_epoch 0, one epoch of 4 semi steps); then its last step again
    from a copy of the state before it, through the kernels and through the
    plain versions."""
    import torch

    from u2pl_tpu_torch import train_semi
    from u2pl_tpu_torch.data.synthetic import write_config
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.steps import draw_contrastive

    exp = os.path.join(tmp, "exp_variant")
    cfg_path = write_config(VOC_CONFIG, paths, exp, VARIANT_OVERRIDES)
    before_last = {}
    run_steps = train_semi.run_steps

    def tapped(state, batches, steps_per_epoch, cfg, **kw):
        last = cfg.trainer.epochs * steps_per_epoch - 1

        def tap(it):
            for j, batch in enumerate(it):
                if kw.get("start_iter", 0) + j == last:
                    before_last.update(state=copy.deepcopy(state), batch=batch, cfg=cfg,
                                       steps_per_epoch=steps_per_epoch, i_iter=last)
                yield batch

        yield from run_steps(state, tap(batches), steps_per_epoch, cfg, **kw)

    train_semi.run_steps = tapped
    try:
        t0 = time.monotonic()
        summary, lines, launches = run_cli(train_semi, cfg_path)
        run_s = time.monotonic() - t0
    finally:
        train_semi.run_steps = run_steps
    del summary["state"]
    log(f"[phase 11] {os.path.relpath(VOC_CONFIG, ROOT)} with {VARIANT_OVERRIDES}: "
        f"{summary['steps']} semi steps and a validation in {run_s:.1f} s, mIoU {summary['mious']}; "
        f"launches {launches}")
    cli_report(card, "train_semi classmix + radix", summary)
    off = ("K3", "K4_select")
    missing = [a for a in (*TRAIN_COUNTERS, *CONTRA_COUNTERS, *VARIANT_COUNTERS)
               if a not in off and launches[a] <= 0]
    if missing or any(launches[a] for a in off) or launches["B"] != CLI_VAL or len(
            summary["mious"]) != 1:
        fail(f"the variant run: kernels never launched {missing}, or K3 / K4 select ran "
             f"({[launches[a] for a in off]}), or B {launches['B']}")
    per_step = {a: launches[a] for a in VARIANT_COUNTERS}
    if per_step != {a: summary["steps"] for a in VARIANT_COUNTERS}:
        fail(f"the variant run: K3c / K4r launches {per_step} over {summary['steps']} semi steps "
             f"(want one each per semi step)")

    # its last step again, the ClassMix and contrastive draws injected (coin heads)
    cfg, spe, i_iter = before_last["cfg"], before_last["steps_per_epoch"], before_last["i_iter"]
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    mix = (torch.tensor(True, device=dev),
           mixing.draw_mix(g, "classmix", B_U, CROP, CROP, cfg.net.num_classes))
    draws = draw_contrastive(g, cfg, (B_L + B_U) * OS4 * OS4)
    if draws[0].dtype != torch.int32:
        fail("select_keys: radix must draw u32 keys (in int32)")

    def run(st, route):
        steps = train_semi.run_steps(st, [before_last["batch"]], spe, cfg, start_iter=i_iter,
                                     mixes=[mix], contras=[draws])
        return next(iter(steps))[1]

    runs = both_routes(before_last.pop("state"), run, "phase 11")
    (mk, dk, _), (mp, dp, _) = runs["kernels"], runs["plain"]
    del runs
    mk, mp = scalars(mk), scalars(mp)
    names = ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "low_thresh", "high_thresh")
    rel = {a: abs(mk[a] - mp[a]) / max(abs(mp[a]), 1e-30) for a in names}
    _, tight = update_closeness(dk, dp)
    log(f"[phase 11] step {i_iter} again, kernels vs plain versions: kernels {mk}; plain {mp}; "
        f"rel diffs {rel}; update closest to the bound, as a share of it: {tight}")
    if not rel["con_loss"] <= CON_LOSS_TOL:
        fail(f"variant step {i_iter}: con_loss kernels vs plain versions {rel['con_loss']}")
    if not all(rel[a] <= STEP_LOSS_TOL for a in ("sup_loss", "uns_loss", "drop_thresh")):
        fail(f"variant step {i_iter}: kernels vs plain versions {rel}")
    if tight[0][1] > 1.0:
        fail(f"variant step {i_iter}: parameter update differs from the plain route: {tight}")
    torch.cuda.empty_cache()
    return launches, summary


# phase 12: the eval and infer CLIs
EVAL_SCALES = [0.75, 1.0, 1.25]
CITY_EVAL_IMAGE = (1024, 2048)  # Cityscapes' size, (h, w)
CITY_EVAL_VAL = 2


def gray_pngs(folder):
    import numpy as np
    from PIL import Image

    return {n: np.asarray(Image.open(os.path.join(folder, n))) for n in sorted(os.listdir(folder))}


def agreement(got, want):
    """Pixel agreement per image of two {name: mask} dicts, checked."""
    if list(got) != list(want):
        fail(f"mask files {list(got)} != {list(want)}")
    out = []
    for name, g in got.items():
        if g.shape != want[name].shape:
            fail(f"{name}: mask {g.shape} != {want[name].shape}")
        out.append(float((g == want[name]).mean()))
    return out


def phase12_eval(dev, card, tmp, paths):
    """`u2pl_tpu_torch.eval` and `.infer` on the card: VOC on phase 10's
    workspace and ckpt_best.pth at one and three scales, infer at batch 1
    and 3; Cityscapes on a workspace of 1024x2048 images with seeded random
    weights of the `ours` config at full width (base_size 2048, 8 crops of
    769²), and its infer at 769²; each run also through the plain versions
    and the numpy load, the masks compared."""
    import torch

    from u2pl_tpu_torch import eval as eval_cli
    from u2pl_tpu_torch import infer as infer_cli
    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.data.synthetic import make_cityscapes_workspace, write_config
    from u2pl_tpu_torch.serving import InferEngine
    from u2pl_tpu_torch.utils.checkpoint import CKPT_BEST_NAME

    total = {}
    infer_masks = []
    to_mask = InferEngine.to_mask

    def recording(self, logits, size):
        infer_masks.append(to_mask(self, logits, size))
        return infer_masks[-1]

    def run(name, module, cfg_path, args, n_images, classes):
        """The run through the kernels, then through the plain versions;
        returns the kernels' summary."""
        outs = {}
        for route in ("kernels", "plain"):
            out = os.path.join(tmp, "eval_out", f"{name}_{route}")
            infer_masks.clear()
            argv = list(args) + ["--save_folder", out]
            InferEngine.to_mask = recording
            try:
                if route == "kernels":
                    t0 = time.monotonic()
                    summary, _, launches = run_cli(module, cfg_path, argv)
                    run_s = time.monotonic() - t0
                else:  # the counters are read outside plain_versions, which swaps them away
                    zero_counters()
                    with plain_versions():
                        summary = module.main(["--config", cfg_path] + argv)
                    torch.cuda.synchronize()
                    launches = read_counters()
            finally:
                InferEngine.to_mask = to_mask
            masks = (gray_pngs(os.path.join(out, "gray")) if module is eval_cli
                     else {str(i): m for i, m in enumerate(infer_masks)})
            outs[route] = (summary, launches, masks)
            if route == "kernels":
                for a in ("A", "A_image", "A_image_city", "A_logits", "A_eval_crop", "B"):
                    total[a] = total.get(a, 0) + launches[a]
                main_launches, main_s = launches, run_s
        (summary, launches, masks), (plain, plain_launches, plain_masks) = outs.values()
        if plain_launches["A"] or plain_launches["B"]:
            fail(f"{name}: the plain route launched A {plain_launches['A']} / B "
                 f"{plain_launches['B']} times")
        agree = agreement(masks, plain_masks)
        if len(masks) != n_images or summary["images"] != n_images or min(agree) < MIN_AGREEMENT:
            fail(f"{name}: {len(masks)} masks of {n_images}, agreement with the plain route "
                 f"{agree}")
        if any(m.max() >= classes for m in masks.values()):
            fail(f"{name}: a label past {classes} classes")
        sec = summary["seconds"]
        per_image = sec if module is eval_cli else [sum(sec) / n_images]
        log(f"[{card}] {name}: {n_images} images in {main_s:.1f} s (the CLI, model build and "
            f"load included); seconds per image {[round(t, 4) for t in per_image]} ("
            + ("each; the first forwards at a shape included" if module is eval_cli
               else "the mean over the run") + "); per image launches A "
            f"{main_launches['A'] / n_images:g} (images {main_launches['A_image'] / n_images:g}, "
            f"Cityscapes request images {main_launches['A_image_city'] / n_images:g}, "
            f"logits {main_launches['A_logits'] / n_images:g}, eval crops "
            f"{main_launches['A_eval_crop'] / n_images:g}), B {main_launches['B'] / n_images:g}; "
            f"masks vs the plain route, pixel agreement per image {agree} (bound "
            f"{MIN_AGREEMENT})" + (f"; mIoU {summary['miou']:.4f}, plain route "
                                    f"{plain['miou']:.4f}" if "miou" in summary else ""))
        if main_launches["B"] != n_images:
            fail(f"{name}: kernel B launched {main_launches['B']} times for {n_images} images")
        return summary

    t_phase = time.monotonic()
    voc_cfg = os.path.join(tmp, "exp_semi", "config.yaml")
    ckpt = os.path.join(tmp, "exp_semi", "checkpoints", CKPT_BEST_NAME)
    flat = ["--model_path", ckpt]
    one = run("eval VOC, scales 1.0", eval_cli, voc_cfg, flat + ["--scales", "1.0"], CLI_VAL, 21)
    three = run(f"eval VOC, scales {EVAL_SCALES}", eval_cli, voc_cfg,
                flat + ["--scales", *map(str, EVAL_SCALES)], CLI_VAL, 21)
    # again: every image size and scale has been forwarded once in this
    # process, so no first-forward cost of a new shape is in these seconds
    for scales in (["1.0"], list(map(str, EVAL_SCALES))):
        run(f"eval VOC again, scales {scales}", eval_cli, voc_cfg, flat + ["--scales", *scales],
            CLI_VAL, 21)
    masks = {}
    for bs in (1, 3):
        run(f"infer VOC, batch {bs}", infer_cli, voc_cfg, flat + ["--batch_size", str(bs)],
            CLI_VAL, 21)
        masks[bs] = {str(i): m for i, m in enumerate(infer_masks)}
    same = agreement(masks[3], masks[1])
    log(f"[phase 12] infer masks at batch 3 vs batch 1, pixel agreement per image {same}")
    if min(same) < MIN_AGREEMENT:
        fail(f"infer masks depend on the batch size: {same}")

    city = make_cityscapes_workspace(os.path.join(tmp, "city"), 0, 0, CITY_EVAL_VAL,
                                     size=CITY_EVAL_IMAGE, seed=SEED)
    city_cfg = write_config(CITY_CONFIG, city, os.path.join(tmp, "exp_city"), {})
    pth = os.path.join(tmp, "exp_city", "city_random.pth")
    n_params = random_weights_pth(load_config(city_cfg), pth)
    log(f"[phase 12] Cityscapes workspace: {CITY_EVAL_VAL} val images of "
        f"{CITY_EVAL_IMAGE[1]}x{CITY_EVAL_IMAGE[0]}; {os.path.relpath(CITY_CONFIG, ROOT)} as it "
        f"stands, {n_params} parameters from seeded random weights")
    city_eval = run("eval Cityscapes, base_size 2048, scales 1.0", eval_cli, city_cfg,
                    ["--model_path", pth, "--base_size", "2048", "--scales", "1.0"],
                    CITY_EVAL_VAL, 19)
    run("infer Cityscapes (769²), batch 1", infer_cli, city_cfg, ["--model_path", pth],
        CITY_EVAL_VAL, 19)
    if total["A_eval_crop"] != CITY_EVAL_VAL:
        fail(f"kernel A at the eval crops {A_EVAL_CROP}: {total['A_eval_crop']} launches for "
             f"{CITY_EVAL_VAL} images (want one, 8 crops in one forward, per image)")
    if total["A_image_city"] != CITY_EVAL_VAL:
        fail(f"kernel A at the Cityscapes request image {A_IMAGE_CITY}: "
             f"{total['A_image_city']} launches for {CITY_EVAL_VAL} images (want one each, "
             f"infer's load)")
    log(f"[{card}] phase 12 (eval and infer, each also on the plain route) in "
        f"{time.monotonic() - t_phase:.1f} s; launches of the kernels' runs {total}")
    torch.cuda.empty_cache()
    return total, {"voc_1": one, "voc_3": three, "city": city_eval}


def variant_timings(card, inputs, k):
    """K3c and K4r on phase 1's inputs, each beside its plain version; K4r
    also beside torch.topk (the same set of keys up to ties, not in pixel
    order)."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.ops import mixing

    img, lab, prob, u = inputs["classmix"]
    mask, keys = inputs["radix"]
    masked = torch.where(mask, keys.to(torch.int64) & 0xFFFFFFFF,
                         torch.full(keys.shape, 2**32 - 1, dtype=torch.int64, device=keys.device))
    times = {
        "K3c": (cuda_ms(lambda: mixing.generate_unsup_data(img, lab, prob, u, "classmix")),
                cuda_ms(lambda: mixing.generate_unsup_data_plain(img, lab, prob, u, "classmix")),
                None),
        "K4r": (cuda_ms(lambda: tc.select_keys_radix(mask, keys, k)),
                cuda_ms(lambda: tc.select_keys_radix_plain(mask, keys, k)),
                cuda_ms(lambda: torch.topk(masked, k, dim=1, largest=False, sorted=False))),
    }
    log(f"[{card}] kernel K3c classmix {tuple(img.shape)} + label + max-prob, {u.shape[1]} "
        f"classes: {times['K3c'][0]:.4f} ms; plain version {times['K3c'][1]:.4f} ms")
    log(f"[{card}] kernel K4r {tuple(mask.shape)}, k {k}: {times['K4r'][0]:.4f} ms; plain version "
        f"{times['K4r'][1]:.4f} ms; torch.topk(largest=False, sorted=False) {times['K4r'][2]:.4f} ms")
    return times


# ---- phase 13: bfloat16 -------------------------------------------------------

BF16_FLIP_FRAC = 0.01  # A-bwd, C bwd: a share of the elements one bf16 ulp apart, at most
K6_BF16_FLIP_FRAC = 0.02  # K6 bwd: each draw's row rounded, then the rows added in bf16
BF16_STEPS = 5  # the bf16 VOC run: 2 warmup, 3 semi steps, as phases 4 and 6
CITY_BF16_STEPS = 2  # the bf16 Cityscapes run: 2 semi steps (sup_only_epoch 0)
# the bf16 step through the kernels against the plain versions: each loss,
# threshold and the update within this share of the step's own bf16-vs-f32
# gap (the same snapshot and inputs through the kernels in f32); the
# measured spread and the bound's derivation are in CHANGES.md.  A loss or
# threshold whose routes differ by one f32 ulp of its value or less passes
# whatever its gap: f32 arithmetic cannot show less, and a threshold's
# bf16-vs-f32 gap has itself measured one ulp
BF16_ROUTE_SHARE = 0.5


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def bf16_flips(what, got, want, max_frac, row_dim=None, where="phase 13"):
    """Two bf16 results of the same f32 values summed in another order:
    equal but at bf16 rounding boundaries, there one bf16 ulp apart (of the
    larger magnitude, or along `row_dim` (a dim or dims) of the largest
    there), in at most `max_frac` of the elements.  Returns the max abs
    difference."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16 or got.shape != want.shape:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    a, b = got.float(), want.float()
    diff = a != b
    scale = torch.maximum(a.abs(), b.abs())
    if row_dim is not None:
        scale = scale.amax(dim=row_dim, keepdim=True).expand_as(scale)
    over = int(((a - b).abs() > bf16_ulp(scale))[diff].sum())
    frac = diff.float().mean().item()
    err = (a - b).abs().max().item()
    log(f"[{where}] {what}: {int(diff.sum())} of {diff.numel()} elements one bf16 ulp apart "
        f"({frac:.2e}; bound {max_frac}), {over} beyond one ulp (bound 0), max abs diff {err:.3e}")
    if over or frac > max_frac:
        fail(f"{what}: kernel and plain version differ beyond the bf16 rounding boundaries")
    return err


def rounded_stats(x, size):
    """Kernel D's statistics of kernel A's bf16 upsample (the bits C, D and
    K7 compute inside), in torch ops."""
    import torch

    from u2pl_tpu_torch.losses import unsup
    from u2pl_tpu_torch.ops.resize import resize_bilinear_rounded

    up = resize_bilinear_rounded(x, size).float()
    return (torch.exp(up.amax(dim=1) - torch.logsumexp(up, dim=1)),
            up.argmax(dim=1).to(torch.int32), unsup.teacher_entropy(up))


def bf16_kernels(dev, card, case, cfg):
    """Each bf16 mode against its plain bf16 version at the paths' full
    shapes, timed beside its f32 mode: ({key: max abs err}, {key: (ms,
    plain ms, library ms)}, {key: f32 ms})."""
    import torch
    import torch.nn.functional as F

    from u2pl_tpu_torch.losses import ce, ohem, unsup
    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain
    from u2pl_tpu_torch.ops import resize as R

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    errs, times, f32 = {}, {}, {}
    # A: the decoder's wide upsamples (VOC, Cityscapes) and the logits' narrow
    # one, each bit-equal to its rounded formula (the wide one to the plain
    # einsums too: every product exact)
    for key, shape, out_hw in (("A_decoder_bf16", (8, 256, 65, 65), (OS4, OS4)),
                               ("A_decoder_city_bf16", (4, 256, CITY_OS8, CITY_OS8),
                                (CITY_OS4, CITY_OS4)),
                               ("A_logits_bf16", (4, 21, OS4, OS4), (CROP, CROP))):
        x = (3 * torch.randn(shape, device=dev, generator=g)).to(bf)
        wide = R._wide(bf, shape[1], shape[2:], out_hw, True)
        y = R.resize_bilinear(x, out_hw)
        same = torch.equal(y, R.resize_bilinear_rounded(x, out_hw))
        if wide:
            same = same and torch.equal(y, R.resize_bilinear_plain(x, out_hw))
        log(f"[phase 13] kernel A bf16 ({'wide' if wide else 'narrow'}) {shape} -> {out_hw}: "
            f"bit-equal to its rounded formula{' and the plain einsums' if wide else ''} {same}")
        if not same:
            fail(f"kernel A bf16 at {shape}: not bit-equal to its plain version")
        errs[key] = 0.0
        x32 = x.float()
        times[key] = (cuda_ms(lambda: R.resize_bilinear(x, out_hw)),
                      cuda_ms(lambda: R.resize_bilinear_plain(x, out_hw)),
                      cuda_ms(lambda: F.interpolate(x, out_hw, mode="bilinear",
                                                    align_corners=True)))
        f32[key] = cuda_ms(lambda: R.resize_bilinear(x32, out_hw))
        planes = shape[0] * shape[1]
        mode = R._resize_mode(bf, shape[1], shape[2:], out_hw, True)
        log(f"[{card}] kernel A bf16 ({'wide' if wide else 'narrow'}) {shape} -> {out_hw}, plan "
            f"{R._fwd_plan(planes, *shape[2:], *out_hw, R._sm_count(dev), mode)}: "
            f"{times[key][0]:.4f} ms; its f32 mode (plan "
            f"{R._fwd_plan(planes, *shape[2:], *out_hw, R._sm_count(dev))}) {f32[key]:.4f} ms; "
            f"plain version {times[key][1]:.4f} ms; F.interpolate bf16 {times[key][2]:.4f} ms")
        del x, x32, y
    # A-bwd: the decoder's adjoints (wide: the W sum rounded to bf16)
    for key, shape, out_hw in (("A_bwd_bf16", (8, 256, 65, 65), (OS4, OS4)),
                               ("A_bwd_city_bf16", (4, 256, CITY_OS8, CITY_OS8),
                                (CITY_OS4, CITY_OS4))):
        gy = torch.randn(shape[:2] + out_hw, device=dev, generator=g).to(bf)
        errs[key] = bf16_flips(f"kernel A-bwd bf16 {shape[:2] + out_hw} -> {shape}",
                               R.resize_bilinear_bwd(gy, shape[2:]),
                               R.resize_bilinear_bwd_plain(gy, shape[2:]), BF16_FLIP_FRAC)
        gy32 = gy.float()
        times[key] = (cuda_ms(lambda: R.resize_bilinear_bwd(gy, shape[2:]), 20),
                      cuda_ms(lambda: R.resize_bilinear_bwd_plain(gy, shape[2:]), 20),
                      cuda_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                          gy, list(out_hw), list(shape), True), 20))
        f32[key] = cuda_ms(lambda: R.resize_bilinear_bwd(gy32, shape[2:]), 20)
        del gy, gy32
    # C fwd / bwd and D at the VOC step's (4, 21, 129²) -> 513²
    x = (3 * torch.randn(4, 21, OS4, OS4, device=dev, generator=g)).to(bf)
    lab = torch.randint(0, 21, (4, CROP, CROP), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    up = R.resize_bilinear_rounded(x, (CROP, CROP))
    with torch.no_grad():
        loss = ce.upsample_cross_entropy(x, lab)
        via_a = ce.cross_entropy_ignore(up, lab)
        plain = ce.upsample_cross_entropy_plain(x, lab)
    errs["C_fwd_bf16"] = abs(loss.item() - via_a.item())
    rel = errs["C_fwd_bf16"] / abs(via_a.item())
    log(f"[phase 13] kernel C fwd bf16: {loss.item():.7f}; on kernel A's rounded upsample "
        f"{via_a.item():.7f} (rel {rel:.3e}, bound {C_LOSS_TOL}); plain version (einsum "
        f"upsample) {plain.item():.7f}")
    if rel > C_LOSS_TOL:
        fail("kernel C fwd bf16 differs from its plain version")
    # C bwd bf16 at each of the main path's three compilations: VOC (x4, 21
    # classes), the Cityscapes main head (x4, 19 classes in two owner pairs a
    # thread, OHEM's kept labels and the class weight) and its aux head (x8,
    # kept labels), each bit-equal to its own arithmetic in torch ops on the
    # forward's saved lse and denominator, and within the bf16 flips of the
    # plain version
    crit = load_f32(CITY_CONFIG).criterion
    gc = torch.Generator(device=dev).manual_seed(SEED + 24)
    c_bwd_cases = [(f"(4, 21, {OS4}²) <- {CROP}²", x, lab, None)]
    for head, hw, block, weighted in (("main", CITY_OS4, 8, True), ("aux", CITY_OS8, 4, False)):
        xc, labc = ohem_case(dev, gc, hw, 8.0, block, 0.05)
        xc = xc.to(bf)
        kept = ohem.ohem_kept_labels(xc, labc, crit.thresh, crit.min_kept)
        c_bwd_cases.append((f"Cityscapes {head} head {tuple(xc.shape)} <- {CITY_CROP}², kept "
                            f"labels{', weighted' if weighted else ''}", xc, kept,
                            ohem._class_weight(weighted, dev)))
    errs["C_bwd_bf16"] = 0.0
    for what, xb, lb, cw in c_bwd_cases:
        xg = xb.detach().requires_grad_(True)
        lk = ce.upsample_cross_entropy(xg, lb, 255, cw)
        _, _, lse, stats, _ = lk.grad_fn.saved_tensors
        (gk,) = torch.autograd.grad(lk, xg)
        same = torch.equal(gk, ce.upsample_ce_bwd_ordered(xb, lb, cw, 255, 1.0, lse, stats[1]))
        plan = ce._bwd_plan(*xb.shape, *lb.shape[1:], ce._sm_count(dev), 2)
        log(f"[phase 13] kernel C bwd bf16 {what}, plan {tuple(plan)}: bit-equal to "
            f"upsample_ce_bwd_ordered {same}")
        if not same:
            fail(f"kernel C bwd bf16 {what} is not bit-equal to its ordered formula")
        # the ulp of each (image, class) plane's largest: the kernel and the
        # plain version round the full-resolution gradient at its boundaries
        # apart, and the adjoint's sums of those terms may cancel to a small
        # element
        errs["C_bwd_bf16"] = max(errs["C_bwd_bf16"], bf16_flips(
            f"kernel C bwd bf16 {what}", gk, ce.upsample_ce_bwd_plain(xb, lb, cw),
            BF16_FLIP_FRAC, row_dim=(2, 3)))
        del xg, lk, lse, stats, gk
    del c_bwd_cases, xc, labc, kept
    x32 = x.float()
    with torch.no_grad():
        times["C_fwd_bf16"] = (cuda_ms(lambda: ce.upsample_cross_entropy(x, lab)),
                               cuda_ms(lambda: ce.upsample_cross_entropy_plain(x, lab)), None)
        f32["C_fwd_bf16"] = cuda_ms(lambda: ce.upsample_cross_entropy(x32, lab))
    times["C_bwd_bf16"] = c_bwd_timing(card, "C_bwd_bf16", x, lab, None)
    f32["C_bwd_bf16"] = c_bwd_timing(card, "C_bwd_bf16_as_f32", x32, lab, None)[0]
    mp, am, ent = unsup.upsample_softmax_stats(x, (CROP, CROP), outputs="all")
    rmp, ram, rent = rounded_stats(x, (CROP, CROP))
    e_mp = ((mp - rmp).abs() / rmp).max().item()
    e_en = ((ent - rent).abs() / rent.abs().clamp(min=1e-3)).max().item()
    e_am = int((am != ram).sum())
    errs["D_bf16"] = max((mp - rmp).abs().max().item(), (ent - rent).abs().max().item())
    log(f"[phase 13] kernel D bf16 against the statistics of kernel A's rounded upsample: "
        f"max-prob rel {e_mp:.3e}, entropy rel {e_en:.3e} (bound {D_TOL}), argmax differs at "
        f"{e_am} pixels (bound 0: exact ties keep the first class)")
    if e_mp > D_TOL or e_en > D_TOL or e_am:
        fail("kernel D bf16 differs from its plain version")
    for sel in ("prob", "entropy"):
        times[f"D_{sel}_bf16"] = (
            cuda_ms(lambda: unsup.upsample_softmax_stats(x, (CROP, CROP), outputs=sel)),
            cuda_ms(lambda: unsup.upsample_softmax_stats_plain(x, (CROP, CROP), sel)), None)
        f32[f"D_{sel}_bf16"] = cuda_ms(
            lambda: unsup.upsample_softmax_stats(x32, (CROP, CROP), outputs=sel))
    del x, x32, up, mp, am, ent, rmp, ram, rent
    # K7 prob at the Cityscapes heads
    for key, hw in (("K7_prob_bf16", CITY_OS4), ("K7_prob_aux_bf16", CITY_OS8)):
        xc, labc = ohem_case(dev, g, hw, 8.0, 4, 0.05)
        xc = xc.to(bf)
        p_y, nv = ohem.ohem_target_prob(xc, labc)
        up = R.resize_bilinear_rounded(xc, (CITY_CROP, CITY_CROP))
        rp, rnv = ohem._target_prob(up, labc, 255)
        e = ((p_y - rp).abs() / rp).max().item()
        errs[key] = (p_y - rp).abs().max().item()
        log(f"[phase 13] kernel K7 prob bf16 {tuple(xc.shape)} -> {CITY_CROP}²: p_y rel {e:.3e} "
            f"(bound {D_TOL}) against the softmax of kernel A's rounded upsample; num_valid "
            f"{int(nv)} vs {int(rnv)}")
        if e > D_TOL or int(nv) != int(rnv):
            fail("kernel K7 prob bf16 differs from its plain version")
        K7_VALID[key] = int(rnv)
        xc32 = xc.float()
        times[key] = (cuda_ms(lambda: ohem.ohem_target_prob(xc, labc)),
                      cuda_ms(lambda: ohem.ohem_target_prob_plain(xc, labc)), None)
        f32[key] = cuda_ms(lambda: ohem.ohem_target_prob(xc32, labc))
        del xc, xc32, labc, p_y, rp, up
    # K5: the flagship's write from a bf16 teacher rep into the bf16 bank
    enq = (case["rep_t"].to(bf), case["sel_idx"], case["n_sel"])
    bk = memobank_enqueue(clone_bank(case["bank"]), *enq)
    bp = memobank_enqueue_plain(clone_bank(case["bank"]), *enq)
    same = all(torch.equal(getattr(bk, a), getattr(bp, a)) for a in ("keys", "ptr", "occupancy"))
    log(f"[phase 13] kernel K5 bf16 rep {tuple(enq[0].shape)}, {int(case['n_sel'].sum())} keys: "
        f"bank bit-equal to the plain version {same}")
    if not same:
        fail("kernel K5 bf16 differs from its plain version")
    errs["K5_bf16"] = 0.0
    bank_k, bank_p, bank_f = (clone_bank(case["bank"]) for _ in range(3))
    enq32 = (case["rep_t"],) + enq[1:]
    times["K5_bf16"] = (cuda_ms(lambda: memobank_enqueue(bank_k, *enq)),
                        cuda_ms(lambda: memobank_enqueue_plain(bank_p, *enq)), None)
    f32["K5_bf16"] = cuda_ms(lambda: memobank_enqueue(bank_f, *enq32))
    del bk, bp, bank_k, bank_p, bank_f, enq, enq32
    # K6 forward / backward on a bf16 rep and the bf16 bank (JAX's dot-first path)
    k6 = (case["anchor_idx"], case["positive"], case["bank"], case["b_j"], case["u_neg"],
          case["active"], case["valid_seg"], cfg.trainer.contrastive.temperature)
    rep = case["rep"].to(bf).requires_grad_(True)
    lk = tc.contra_infonce(rep, *k6)
    (gk,) = torch.autograd.grad(lk, rep)
    rp = rep.detach().clone().requires_grad_(True)
    lp = tc.contra_infonce_plain(rp, *k6)
    (gp,) = torch.autograd.grad(lp, rp)
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    errs["K6_fwd_bf16"] = abs(lk.item() - lp.item())
    log(f"[phase 13] kernel K6 fwd bf16 rep, bf16 bank: loss {lk.item():.6f} vs plain "
        f"{lp.item():.6f} (rel {rel:.3e}, bound {K6_LOSS_TOL})")
    if rel > K6_LOSS_TOL:
        fail("kernel K6 fwd bf16 differs from its plain version")
    errs["K6_bwd_bf16"] = bf16_flips("kernel K6 bwd bf16 (8, 256, 129²) rep gradient", gk, gp,
                                     K6_BF16_FLIP_FRAC, row_dim=1)
    del gk, gp, rp
    rep32 = case["rep"].clone().requires_grad_(True)
    with torch.no_grad():
        times["K6_fwd_bf16"] = (cuda_ms(lambda: tc.contra_infonce(rep, *k6), 20),
                                cuda_ms(lambda: tc.contra_infonce_plain(rep, *k6), 20), None)
        f32["K6_fwd_bf16"] = cuda_ms(lambda: tc.contra_infonce(rep32, *k6), 20)
    lk, lp, l32 = (tc.contra_infonce(rep, *k6), tc.contra_infonce_plain(rep, *k6),
                   tc.contra_infonce(rep32, *k6))
    one = torch.ones((), device=dev)
    saved, saved32 = lk.grad_fn.saved_tensors, l32.grad_fn.saved_tensors
    b, f = rep.shape[:2]
    rows = case["anchor_idx"].flatten().long()
    src = torch.randn(rows.numel(), f, device=dev, generator=g).to(bf)
    times["K6_bwd_bf16"] = (
        cuda_ms(lambda: tc._infonce_bwd_cuda(*saved, one, tuple(rep.shape), bf), 20),
        cuda_ms(lambda: torch.autograd.grad(lp, rep, retain_graph=True), 20),
        cuda_ms(lambda: torch.zeros(b * OS4 * OS4, f, device=dev, dtype=bf).index_add_(
            0, rows, src), 20))
    f32["K6_bwd_bf16"] = cuda_ms(lambda: tc._infonce_bwd_cuda(*saved32, one, tuple(rep.shape)), 20)
    # the same with no active position: the gradient's zero write alone
    none = torch.zeros_like(case["active"])
    empty, empty32 = ((s[0], none, *s[2:]) for s in (saved, saved32))
    times["K6_bwd_bf16_no_draws"] = (
        cuda_ms(lambda: tc._infonce_bwd_cuda(*empty, one, tuple(rep.shape), bf), 20), None,
        cuda_ms(lambda: torch.zeros(rep.shape, device=dev, dtype=bf), 20))
    f32["K6_bwd_bf16_no_draws"] = cuda_ms(
        lambda: tc._infonce_bwd_cuda(*empty32, one, tuple(rep.shape)), 20)
    del lk, lp, l32, saved, saved32, empty, empty32, rep, rep32
    library = {**{k: "F.interpolate bf16" for k in
                  ("A_decoder_bf16", "A_decoder_city_bf16", "A_logits_bf16")},
               **{k: "aten upsample_bilinear2d_backward bf16" for k in
                  ("A_bwd_bf16", "A_bwd_city_bf16")},
               "K6_bwd_bf16": "index_add_ of bf16 rows",
               "K6_bwd_bf16_no_draws": "torch.zeros bf16"}
    for key, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; {library[key]} {tl:.4f} ms"
        plain = "" if tp is None else f"; plain version {tp:.4f} ms"
        log(f"[{card}] kernel {key}: {tk:.4f} ms (its f32 mode {f32[key]:.4f} ms){plain}{lib}")
    return errs, times, f32


def bf16_voc_training(dev, card):
    """The flagship semi step with contrastive in bf16: BF16_STEPS steps of the
    VOC `ours` config as it stands (net.dtype bfloat16) through `run_steps`,
    its step times, then step 5 again through the kernels and the plain
    versions (and through the kernels in f32, for the bf16 gap the routes
    are held to)."""
    import torch

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import draw_contrastive, make_semi_step, run_steps

    cfg = load_config(VOC_CONFIG)
    if cfg.net.dtype != "bfloat16":
        fail(f"{VOC_CONFIG}: net.dtype {cfg.net.dtype}, the bf16 phase expects bfloat16")
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    if state.student.dtype != torch.bfloat16 or state.teacher.dtype != torch.bfloat16:
        fail("the bf16 config built a model that does not compute in bf16")
    log(f"[phase 13] config {os.path.relpath(VOC_CONFIG, ROOT)} as it stands: net.dtype "
        f"{cfg.net.dtype} (float32 parameters, EMA and optimizer; bf16 compute), contrastive "
        f"with a {cfg.trainer.contrastive.queue_dtype} bank; {B_L}+{B_U} images of {CROP}², "
        f"{BF16_STEPS} steps")
    batches = synthetic_batches(dev, BF16_STEPS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    history, snapshot = [], None
    for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
        history.append((i_iter, scalars(m)))
        if i_iter == BF16_STEPS - 2:
            snapshot = copy.deepcopy(state)
    torch.cuda.synchronize()
    launches = read_counters()
    peak_run = torch.cuda.max_memory_allocated(dev)
    for i_iter, m in history:
        semi = "low_thresh" in m
        log(f"[phase 13] bf16 step {i_iter} ({'semi' if semi else 'warmup'}): "
            + ", ".join(f"{a} {v:.6g}" for a, v in m.items()))
        if not all(v == v and abs(v) != float("inf") for v in m.values()):
            fail(f"bf16 step {i_iter}: non-finite metrics {m}")
        if semi and not m["con_loss"] > 0:
            fail(f"bf16 step {i_iter}: con_loss {m['con_loss']} is not > 0")
    if not all(p.dtype == torch.float32 for p in state.student.parameters()):
        fail("bf16 training changed the parameters' dtype")
    missing = [k for k in (*TRAIN_COUNTERS, *CONTRA_COUNTERS) if launches[k] <= 0]
    if missing:
        fail(f"a kernel of the bf16 training path was never launched: {missing}")
    check_a_bwd_per_step("VOC bf16 training", launches)
    check_per_semi_step("VOC bf16 training", launches,
                        sum("low_thresh" in m for _, m in history), contrastive=True)
    log(f"[phase 13] bf16 launches {launches}")
    # the step's time, as phase 7 times the f32 one
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2 + 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    med, imgs = statistics.median(runs), B_L + B_U
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{card}] bf16 contrastive semi step ({imgs} images of {CROP}², synchronised): median "
        f"{med:.1f} ms over {len(runs)} runs after 2 (min {min(runs):.1f}, max {max(runs):.1f}); "
        f"{imgs * 1e3 / med:.2f} img/s; peak device memory {peak / 2**30:.2f} GiB (over the "
        f"{BF16_STEPS} run steps {peak_run / 2**30:.2f} GiB)")
    del state

    # step 5 again: kernels, plain versions, and the kernels in f32
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    draws = draw_contrastive(g, cfg, (B_L + B_U) * OS4 * OS4)

    def run(st, route):
        return step(st, *batches[-1], mix=mix, contra=draws)

    routes = bf16_routes(snapshot, run, "phase 13")
    del snapshot
    return launches, {"semi_ms": med, "img_s": imgs * 1e3 / med, "peak": peak, **routes}


def bf16_routes(snapshot, run, what):
    """The bf16 step `run` on copies of `snapshot` through the kernels, the
    plain versions (`both_routes`) and the kernels in f32: fails unless each
    loss and threshold and the update of the two bf16 routes lie within
    BF16_ROUTE_SHARE of the step's own bf16-vs-f32 gap, and so must the
    anchor_ema prototype where the step writes one (`_prototype_routes`).
    Returns {"route", "gap", "update", "prototype"}."""
    import numpy as np
    import torch

    from u2pl_tpu_torch.models.builder import computing_in
    from u2pl_tpu_torch.models.decoder import Dropout2d

    runs2 = both_routes(snapshot, run, what, bf16=True)
    st32 = copy.deepcopy(snapshot)
    for mm in list(st32.student.modules()) + list(st32.teacher.modules()):
        if isinstance(mm, Dropout2d):
            mm.p = 0.0
    before = {a: p.detach().clone() for a, p in st32.student.named_parameters()}
    with computing_in(st32.student, torch.float32), computing_in(st32.teacher, torch.float32):
        m32 = scalars(run(st32, "kernels"))
    d32 = {a: p.detach() - before[a] for a, p in st32.student.named_parameters()}
    prototype = _prototype_routes(runs2["kernels"][2].prototype, runs2["plain"][2].prototype,
                                  st32.prototype, what)
    del st32
    (mk, dk, _), (mp, dp, _) = runs2["kernels"], runs2["plain"]
    mk, mp = scalars(mk), scalars(mp)
    names = ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "high_thresh")
    route = {a: abs(mk[a] - mp[a]) for a in names}
    gap = {a: abs(mk[a] - m32[a]) for a in names}
    l2 = lambda d, e: sum(((d[a] - e[a]).float() ** 2).sum().item() for a in d) ** 0.5  # noqa: E731
    upd_route, upd_gap = l2(dk, dp), l2(dk, d32)
    share = {a: route[a] / max(gap[a], 1e-30) for a in names}
    # one f32 ulp of the value: the least two f32 routes can differ by
    ulp = {a: float(np.spacing(np.float32(abs(mk[a])))) for a in names}
    over = [a for a in names if route[a] > max(BF16_ROUTE_SHARE * gap[a], ulp[a])]
    log(f"[{what}] the bf16 step again: kernels {mk}; plain {mp}; the kernels in f32 "
        f"{m32}; |kernels - plain| {route}; |bf16 - f32| {gap}; share {share} (bound "
        f"{BF16_ROUTE_SHARE}, or one f32 ulp of the value: {ulp}); update L2 kernels - plain "
        f"{upd_route:.4e}, bf16 - f32 {upd_gap:.4e} (share "
        f"{upd_route / max(upd_gap, 1e-30):.3e}); over the bound {over}")
    if over or upd_route > BF16_ROUTE_SHARE * upd_gap:
        fail(f"{what}: the bf16 step through the kernels and through the plain versions differ "
             f"by more than {BF16_ROUTE_SHARE} of the step's bf16-vs-f32 gap")
    return {"route": route, "gap": gap, "update": (upd_route, upd_gap), "prototype": prototype}


def _prototype_routes(pk, pp, p32, what):
    """The new anchor_ema prototypes of the kernel, plain and f32 routes:
    fails unless the bf16 routes write the same slots and lie within
    BF16_ROUTE_SHARE of the bf16-vs-f32 gap (L2).  Returns (L2 kernels -
    plain, L2 bf16 - f32), or None where the step wrote no prototype."""
    import torch

    if pk is None or not (pk.any() or pp.any()):
        return None
    slots = lambda p: p.flatten(1).ne(0).any(1)  # noqa: E731
    d_route, d_gap = (pk - pp).norm().item(), (pk - p32).norm().item()
    alike = torch.equal(slots(pk), slots(pp))
    log(f"[{what}] the step's new prototype: L2 kernels - plain {d_route:.4e}, bf16 - f32 "
        f"{d_gap:.4e} (share {d_route / max(d_gap, 1e-30):.3e}, bound {BF16_ROUTE_SHARE}); "
        f"slots written alike {alike}")
    if d_route > BF16_ROUTE_SHARE * d_gap or not alike:
        fail(f"{what}: the new prototype differs between the kernels and the plain versions "
             f"beyond the bf16 gap's share")
    return d_route, d_gap


def bf16_city_training(dev, card):
    """The Cityscapes `ours` config as it stands (bf16, OHEM on the main and
    aux heads, contrastive), CITY_BF16_STEPS semi steps of 2 + 2 images at
    769² through `run_steps`: finite losses, the OHEM kernels on both heads
    of every step, the time per step and the peak memory."""
    import torch

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import make_semi_step, run_steps

    cfg = load_config(CITY_CONFIG)
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, sup_only_epoch=0))
    if cfg.net.dtype != "bfloat16":
        fail(f"{CITY_CONFIG}: net.dtype {cfg.net.dtype}, the bf16 phase expects bfloat16")
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    batches = synthetic_batches(dev, CITY_BF16_STEPS, CITY_B, CITY_CROP, cfg.net.num_classes,
                                SEED + 12)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times, history = [], []
    t0 = time.perf_counter()
    for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append(scalars(m))
        t0 = time.perf_counter()
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, m in enumerate(history):
        log(f"[phase 13] bf16 Cityscapes step {i} (semi): " + ", ".join(
            f"{a} {v:.6g}" for a, v in m.items()))
        if not all(v == v and abs(v) != float("inf") for v in m.values()) or not m["con_loss"] > 0:
            fail(f"bf16 Cityscapes step {i}: metrics {m}")
    want = {"K7_prob_main": CITY_BF16_STEPS, "K7_prob_aux": CITY_BF16_STEPS,
            "K7_kth": 2 * CITY_BF16_STEPS, "K7_keep": 2 * CITY_BF16_STEPS}
    got = {k: launches[k] for k in want}
    log(f"[phase 13] bf16 Cityscapes launches {launches}; OHEM {got} (want {want})")
    if got != want:
        fail(f"bf16 Cityscapes: OHEM launches {got}, want {want}")
    # the step's time, as phase 9 times the f32 one, after the run's steps
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = []
    for i in range(2 + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    med, imgs = statistics.median(runs), 2 * CITY_B
    log(f"[{card}] bf16 Cityscapes semi step (OHEM, contrastive; {imgs} images of {CITY_CROP}², "
        f"synchronised): median {med:.1f} ms over {len(runs)} runs after the run's "
        f"{CITY_BF16_STEPS} and 2 more (min {min(runs):.1f}, max {max(runs):.1f}; the run's "
        f"{[round(t, 1) for t in times]}); {imgs * 1e3 / med:.2f} img/s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (over the run's steps "
        f"{peak / 2**30:.2f} GiB)")
    del state
    return launches, {"semi_ms": med, "img_s": imgs * 1e3 / med, "peak": peak}


def phase13_bf16(dev, card, case, cfg):
    """bfloat16: every bf16 kernel mode against its plain version at full
    shapes and timed, the VOC flagship contrastive step and a Cityscapes
    step in bf16 ({key: launches summed over both runs}, errs, times, f32
    times, the runs' summaries)."""
    import torch

    log(f"[phase 13] bfloat16 (JAX's rounding points: u2pl_tpu_torch/train/steps.py)")
    errs, times, f32 = bf16_kernels(dev, card, case, cfg)
    torch.cuda.empty_cache()
    voc_launches, voc = bf16_voc_training(dev, card)
    torch.cuda.empty_cache()
    city_launches, city = bf16_city_training(dev, card)
    torch.cuda.empty_cache()
    return voc_launches, city_launches, errs, times, f32, voc, city


# ---- phase 14: bfloat16 serving, infer and eval -------------------------------

# kernel B's bf16 mode at the served VOC and Cityscapes shapes, and kernel
# A's bf16-in, f32-out mode at VOC eval's per-scale logits of a 500x375
# image (scales 0.75 and 1.25) back to (375, 500)
B_BF16_SHAPES = {"B_bf16": ((21, CROP, CROP), (375, 500)),
                 "B_city_bf16": ((19, CITY_CROP, CITY_CROP), CITY_EVAL_IMAGE)}
A_BF16_F32_SHAPES = [((1, 21, 281, 375), (375, 500)), ((1, 21, 469, 625), (375, 500))]
# kernel A's narrow bf16 mode at VOC eval's shapes of a 375x500 image at
# scale 1.0 (sizes that are multiples of nothing): the decoder's upsample
# (its align-corners weights not bf16-exact, so narrow) and the logits'
A_NARROW_EVAL = {"A_decoder_eval_bf16": ((1, FEATURES, 47, 63), (94, 125)),
                 "A_logits_eval_bf16": ((1, 21, 94, 125), (375, 500))}
LATENCY_PASSES = 8  # batch-1 requests per dtype: the six images, eight times
BATCH8 = 8


def bf16_inference_kernels(dev, card):
    """Kernel B's bf16 mode against its f32 mode on the exact upcast (labels
    equal at every pixel, ties planted), A's bf16 -> f32 mode against its
    f32 mode on the upcast (bit-equal) and A's narrow bf16 mode at VOC
    eval's decoder and logits shapes against its rounded formula
    (bit-equal), each timed beside its f32 mode and its plain version:
    ({key: err}, {key: (ms, plain ms, library ms)}, {key: f32 ms})."""
    import torch
    import torch.nn.functional as F

    from u2pl_tpu_torch.ops import resize as R

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    errs, times, f32 = {}, {}, {}
    for key, (shape, out) in A_NARROW_EVAL.items():
        x = (3 * torch.randn(shape, device=dev, generator=g)).to(torch.bfloat16)
        if R._wide(torch.bfloat16, shape[1], shape[2:], out, True):
            fail(f"kernel A bf16 at {shape} -> {out}: wide, not the narrow mode eval runs")
        y = R.resize_bilinear(x, out)
        same = y.dtype == torch.bfloat16 and torch.equal(y, R.resize_bilinear_rounded(x, out))
        log(f"[phase 14] kernel A bf16 (narrow) {shape} -> {out}: bit-equal to its rounded "
            f"formula {same}")
        if not same:
            fail(f"kernel A narrow bf16 at {shape} -> {out}: not bit-equal to its rounded formula")
        errs[key] = 0.0
        x32 = x.float()
        times[key] = (cuda_ms(lambda: R.resize_bilinear(x, out)),
                      cuda_ms(lambda: R.resize_bilinear_plain(x, out)),
                      cuda_ms(lambda: F.interpolate(x, out, mode="bilinear", align_corners=True)))
        f32[key] = cuda_ms(lambda: R.resize_bilinear(x32, out))
        log(f"[{card}] kernel A bf16 (narrow) {shape} -> {out}: {times[key][0]:.4f} ms; its f32 "
            f"mode {f32[key]:.4f} ms; plain version {times[key][1]:.4f} ms; F.interpolate bf16 "
            f"{times[key][2]:.4f} ms")
        del x, x32, y
    for key, (chw, out) in B_BF16_SHAPES.items():
        x = (4 * torch.randn(chw, device=dev, generator=g)).to(torch.bfloat16)
        x[1] = torch.where(torch.rand(chw[1:], device=dev, generator=g) < 0.1, x[0], x[1])
        x32 = x.float()
        got, want = R.resize_argmax(x, out), R.resize_argmax(x32, out)
        diff = int((got != want).sum())
        log(f"[phase 14] kernel B bf16 {chw} -> {out}: {diff} labels differ from its f32 mode on "
            f"the exact upcast (bound 0; ties planted on a tenth of the pixels)")
        if diff:
            fail(f"kernel B bf16 at {chw}: {diff} labels differ from its f32 mode on the upcast")
        errs[key] = float(diff)
        times[key] = (cuda_ms(lambda: R.resize_argmax(x, out)),
                      cuda_ms(lambda: R.resize_argmax_plain(x, out), 10), None)
        f32[key] = cuda_ms(lambda: R.resize_argmax(x32, out))
        log(f"[{card}] kernel B bf16 {chw} -> {out}: {times[key][0]:.4f} ms; its f32 mode "
            f"{f32[key]:.4f} ms; plain version {times[key][1]:.4f} ms")
        del x, x32, got, want
    for shape, out in A_BF16_F32_SHAPES:
        x = (3 * torch.randn(shape, device=dev, generator=g)).to(torch.bfloat16)
        x32 = x.float()
        y = R.resize_bilinear(x, out, out_dtype=torch.float32)
        same = (y.dtype == torch.float32 and torch.equal(y, R.resize_bilinear(x32, out))
                and torch.equal(y, R.resize_bilinear_rounded(x32, out)))
        log(f"[phase 14] kernel A bf16 -> f32 {shape} -> {out}: bit-equal to its f32 mode on the "
            f"exact upcast and to the rounded formula {same}")
        if not same:
            fail(f"kernel A bf16 -> f32 at {shape}: not bit-equal to its f32 mode on the upcast")
        errs["A_bf16_f32"] = 0.0
    # timed at the larger, scale 1.25 (the last shape)
    times["A_bf16_f32"] = (
        cuda_ms(lambda: R.resize_bilinear(x, out, out_dtype=torch.float32)),
        cuda_ms(lambda: R.resize_bilinear_plain(x, out, out_dtype=torch.float32)), None)
    f32["A_bf16_f32"] = cuda_ms(lambda: R.resize_bilinear(x32, out))
    log(f"[{card}] kernel A bf16 -> f32 {shape} -> {out}: {times['A_bf16_f32'][0]:.4f} ms; its "
        f"f32 mode on the upcast {f32['A_bf16_f32']:.4f} ms; plain version "
        f"{times['A_bf16_f32'][1]:.4f} ms")
    return errs, times, f32


def decoder_narrow(launches):
    """Kernel A's narrow bf16 launches on the decoder's upsample (FEATURES
    channels) in a bf16 run: narrow where its weights are not bf16-exact,
    at most eval image sizes; else wide (the logits, 21 or 19 channels, are
    never wide)."""
    return launches["A_decoder"] - launches["A_bf16_wide"]


def logits_narrow(launches):
    """Kernel A's narrow bf16 launches on the logits in a bf16 run: all
    narrow ones less the decoder's."""
    return launches["A_bf16_narrow"] - decoder_narrow(launches)


def pooled_agreement(got, want):
    """The share of all pixels where two {name: mask} dicts agree."""
    agreement(got, want)  # the same files and shapes
    same = sum(int((g == want[n]).sum()) for n, g in got.items())
    return same / sum(g.size for g in got.values())


def nearest_rank(values, q):
    """The q-quantile of `values` by nearest rank."""
    import math

    return sorted(values)[max(0, math.ceil(q * len(values)) - 1)]


def bf16_serving(dev, card, tmp):
    """`InferEngine(dtype="bfloat16")` on the VOC `ours` config at full width
    from seeded random weights: `run_server` on six 500x375-class JPEGs
    with its launches counted from 0, the masks through the kernels against
    the plain versions on the same bf16 logits, then batch-1 latency (p50,
    p99), masks/s at batch 8 and peak memory beside a float32 engine on the
    same weights, and the share of pixels where the two dtypes' masks
    agree.  Returns the run's launches and its numbers."""
    import numpy as np
    import torch

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.serving import InferEngine, run_server

    cfg = load_config(VOC_CONFIG)
    pth = os.path.join(tmp, "bf16_serve.pth")
    random_weights_pth(cfg, pth)
    engines = {dt: InferEngine(cfg, pth, batch_size=4, dtype=dt, device=dev)
               for dt in ("bfloat16", "float32")}
    engine = engines["bfloat16"]
    if engine.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in engine.model.parameters()):
        fail("InferEngine(dtype='bfloat16') did not build a bf16-compute model with f32 parameters")
    for e in engines.values():
        e.warmup()
    folder = os.path.join(tmp, "bf16_requests")
    os.makedirs(folder, exist_ok=True)
    images = synthetic_jpegs(folder)
    reqs = [json.dumps({"op": "infer", "id": f"r{i}", "image": p}) for i, p in enumerate(images)]
    reqs.append(json.dumps({"op": "shutdown", "id": "bye"}))
    logits, masks = [], []
    forward, to_mask = engine.forward, engine.to_mask

    def recording_forward(imgs):
        out = forward(imgs)
        logits.extend(out)
        return out

    def recording_to_mask(logit, size):
        masks.append((to_mask(logit, size), size))
        return masks[-1][0]

    engine.forward, engine.to_mask = recording_forward, recording_to_mask
    writer = io.StringIO()
    zero_counters()
    served = run_server(io.StringIO("".join(r + "\n" for r in reqs)), writer, engine,
                        default_save_folder=os.path.join(tmp, "bf16_served"), batch_window_s=0.5)
    torch.cuda.synchronize()
    launches = read_counters()
    engine.forward, engine.to_mask = forward, to_mask
    resp = [json.loads(line) for line in writer.getvalue().splitlines()]
    want = {"A_image": len(images), "logits narrow": 2, "B_bf16": len(images)}
    got = {"A_image": launches["A_image"], "logits narrow": logits_narrow(launches),
           "B_bf16": launches["B_bf16"]}
    log(f"[phase 14] bf16 server: {served} requests, logits {logits[0].dtype}; launches {got} "
        f"(want {want}: kernel A on each request image in f32, A's narrow bf16 mode once per "
        f"batch on the logits, B's bf16 mode once per image)")
    if served != len(images) or not all(r["ok"] for r in resp) or len(masks) != len(images):
        fail(f"bf16 server: {served} served, responses {resp}")
    if got != want or any(lg.dtype != torch.bfloat16 for lg in logits):
        fail(f"bf16 server: launches {got}, want {want}; logits {logits[0].dtype}")
    # the masks through kernel B and through its plain version, from the
    # same bf16 logits: equal but where the f32 resize of the upcast has a
    # top-2 gap within rounding (the plain version's matmul sums in another
    # order)
    off = near_ties = 0
    with torch.inference_mode():
        for lg, (mask, size) in zip(logits, masks):
            plain = R.resize_argmax_plain(lg, size).cpu().numpy()
            top2 = R.resize_bilinear_plain(lg[None].float(), size)[0].topk(2, dim=0).values
            near = ((top2[0] - top2[1]) <= NEAR_TIE * top2[0].abs().clamp(min=1.0)).cpu().numpy()
            off += int(((plain != mask) & ~near).sum())
            near_ties += int(((plain != mask) & near).sum())
    log(f"[phase 14] bf16 served masks, kernels vs plain versions on the same bf16 logits: "
        f"{off} labels differ off near-ties (bound 0), {near_ties} at near-ties")
    if off:
        fail(f"bf16 served masks: {off} labels differ from the plain versions off near-ties")
    # latency at batch 1 and masks/s at batch 8, each dtype in turn
    numbers, dtype_masks = {}, {}
    for dt, e in engines.items():
        img, _ = e.load(images[0])
        fwd = []
        for k in range(2 + 12):  # the forward alone at batch 1 (it waits for the card)
            t0 = time.perf_counter()
            e.forward([img])
            if k >= 2:
                fwd.append((time.perf_counter() - t0) * 1e3)
        lat, dtype_masks[dt] = [], []
        for k in range(LATENCY_PASSES + 1):
            for path in images:
                t0 = time.perf_counter()
                img, size = e.load(path)
                m = e.to_mask(e.forward([img])[0], size)
                e.save_mask(m, path, os.path.join(tmp, f"latency_{dt}"))
                if k:  # the first pass: every shape's first forward
                    lat.append((time.perf_counter() - t0) * 1e3)
                else:
                    dtype_masks[dt].append(m)
        loaded = [e.load(p) for p in (images + images)[:BATCH8]]
        batch = [img for img, _ in loaded]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for k in range(2 + 6):
            t0 = time.perf_counter()
            for lg, (_, size) in zip(e.forward(batch), loaded):
                e.to_mask(lg, size)
            if k >= 2:
                runs.append((time.perf_counter() - t0) * 1e3)
        numbers[dt] = {"p50": statistics.median(lat), "p99": nearest_rank(lat, 0.99),
                       "forward_ms": statistics.median(fwd),
                       "n": len(lat), "masks_s": BATCH8 * 1e3 / statistics.median(runs),
                       "batch8_ms": statistics.median(runs),
                       "peak": torch.cuda.max_memory_allocated(dev)}
    agree = [float((a == b).mean()) for a, b in zip(dtype_masks["bfloat16"], dtype_masks["float32"])]
    for dt, n in numbers.items():
        log(f"[{card}] {dt} serving, VOC 513², full width: request latency at batch 1 (load on the "
            f"card, forward, kernel B, two PNGs) p50 {n['p50']:.2f} ms, p99 {n['p99']:.2f} ms "
            f"(nearest rank over {n['n']} requests: their max); the forward alone at batch 1 "
            f"(copy in, model, upsample) median {n['forward_ms']:.2f} ms; batch 8 (forward, then "
            f"kernel B per image): {n['batch8_ms']:.2f} ms, {n['masks_s']:.2f} masks/s; peak device memory "
            f"{n['peak'] / 2**20:.1f} MiB (both engines' weights resident)")
    log(f"[phase 14] bf16 vs f32 served masks, pixel agreement per image {agree} (not gated)")
    for e in engines.values():
        del e.model
    del engines, engine, logits
    torch.cuda.empty_cache()
    return launches, {**numbers, "agree": agree}


def phase14_bf16_inference(dev, card, tmp, f32_evals):
    """bfloat16 serving, infer and eval on the card (`--dtype bfloat16`):
    the new kernel modes checked and timed; `InferEngine(dtype="bfloat16")`
    served, timed beside f32 (`bf16_serving`); `u2pl_tpu_torch.eval --dtype
    bfloat16` on phase 10's workspace at scales 1.0 and 0.75 / 1.0 / 1.25
    (each also through the plain versions, then again with every size
    seen, kernels only) and on phase 12's Cityscapes workspace at scale
    1.0 (also through the plain versions); `u2pl_tpu_torch.infer --dtype
    bfloat16` at batch 3 and on the Cityscapes workspace at 769² (kernels
    only: the plain route's numpy resize of each request image takes ~1
    s).  Returns ({key: launches summed over the phase's runs}, errs,
    times, f32 times, the runs' numbers)."""
    import torch

    import u2pl_tpu_torch.evallib.slide as slide
    from u2pl_tpu_torch import eval as eval_cli
    from u2pl_tpu_torch import infer as infer_cli
    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.utils.checkpoint import CKPT_BEST_NAME

    t_phase = time.monotonic()
    log("[phase 14] bfloat16 serving, infer and eval (rounding points: "
        "u2pl_tpu_torch/evallib/slide.py)")
    errs, times, f32 = bf16_inference_kernels(dev, card)
    serve_launches, serving = bf16_serving(dev, card, tmp)
    total = {k: serve_launches[k] for k in BF16_INFER_KEYS + ("A_decoder", "A_bf16_wide")}

    def run(name, module, cfg_path, args, n_images, plain=True, f32_name=None):
        """The CLI in bf16 through the kernels (launches counted from 0), and
        an eval also through the plain versions on the kernel route's own
        bf16 logits (`net_process`'s outputs, recorded and replayed: the
        comparison is post-forward), its masks equal to the kernels' but at
        near-ties; the share of pixels where the bf16 masks differ from
        phase 12's f32 run `f32_name` is printed: (summary, launches)."""
        argv = list(args) + ["--dtype", "bfloat16"]
        out = os.path.join(tmp, "eval_out", f"bf16 {name}")
        compare = plain and module is eval_cli
        logits, masks, plain_masks = [], [], []
        make, argmax = eval_cli.make_net_process, slide.resize_argmax

        def recording_make(model):
            inner = make(model)

            def net_process(images):
                logits.append(inner(images))
                return logits[-1]

            return net_process

        def recording_argmax(x, size, align_corners=True):
            masks.append(argmax(x, size, align_corners=align_corners))
            return masks[-1]

        def replaying_make(model):
            recorded = iter(logits)

            def net_process(images):
                lg = next(recorded)
                if lg.shape[0] != images.shape[0] or lg.shape[2:] != images.shape[2:]:
                    fail(f"bf16 {name}: the plain route asked for {tuple(images.shape)}, the "
                         f"kernel route gave {tuple(lg.shape)}")
                return lg

            return net_process

        def plain_argmax(x, size, align_corners=True):
            top2 = R.resize_bilinear_plain(x[None].float(), size, align_corners)[0]
            top2 = top2.topk(2, dim=0).values
            near = (top2[0] - top2[1]) <= NEAR_TIE * top2[0].abs().clamp(min=1.0)
            plain_masks.append((R.resize_argmax_plain(x, size, align_corners), near))
            return plain_masks[-1][0]

        t0 = time.monotonic()
        if compare:
            eval_cli.make_net_process, slide.resize_argmax = recording_make, recording_argmax
        try:
            summary, _, launches = run_cli(module, cfg_path,
                                           argv + ["--save_folder", out + "_kernels"])
        finally:
            eval_cli.make_net_process, slide.resize_argmax = make, argmax
        run_s = time.monotonic() - t0
        for k in total:
            total[k] += launches[k]
        per = {k: launches[k] / n_images for k in BF16_INFER_KEYS}
        per["A_bf16_narrow on the logits"] = logits_narrow(launches) / n_images
        per["A_bf16_narrow on the decoder"] = decoder_narrow(launches) / n_images
        text = (f"[{card}] bf16 {name}: {n_images} images in {run_s:.1f} s (the CLI, model build "
                f"and load included); seconds per image "
                f"{[round(t, 4) for t in summary['seconds']]}; per image launches {per}")
        if compare:
            zero_counters()
            try:
                with plain_versions():
                    eval_cli.make_net_process, slide.resize_argmax = replaying_make, plain_argmax
                    psum = module.main(["--config", cfg_path] + argv
                                       + ["--save_folder", out + "_plain"])
            finally:
                eval_cli.make_net_process, slide.resize_argmax = make, argmax
            torch.cuda.synchronize()
            if any(read_counters()[k] for k in ("A", "B")):
                fail(f"bf16 {name}: the plain route launched a kernel")
            if len(masks) != n_images or len(plain_masks) != n_images:
                fail(f"bf16 {name}: {len(masks)} kernel and {len(plain_masks)} plain masks for "
                     f"{n_images} images")
            off = sum(int(((m != p) & ~near).sum()) for m, (p, near) in zip(masks, plain_masks))
            ties = sum(int(((m != p) & near).sum()) for m, (p, near) in zip(masks, plain_masks))
            f32_masks = gray_pngs(os.path.join(tmp, "eval_out", f"{f32_name}_kernels", "gray"))
            gap = 1 - pooled_agreement(gray_pngs(out + "_kernels/gray"), f32_masks)
            text += (f"; masks vs the plain versions on the same bf16 logits: {off} labels differ "
                     f"off near-ties (bound 0), {ties} at near-ties; mIoU {summary['miou']:.4f}, "
                     f"plain versions {psum['miou']:.4f}; bf16 vs phase 12's f32 masks differ in "
                     f"a share {gap:.3e} of the pixels (not gated)")
            if off:
                fail(f"bf16 {name}: {off} labels differ from the plain versions off near-ties")
        log(text)
        if summary["images"] != n_images or launches["B"] != n_images:
            fail(f"bf16 {name}: {summary['images']} images, B launches {launches['B']}")
        return summary, launches

    voc_cfg = os.path.join(tmp, "exp_semi", "config.yaml")
    flat = ["--model_path", os.path.join(tmp, "exp_semi", "checkpoints", CKPT_BEST_NAME)]
    evals = {}
    for key, scales in (("voc_1", ["1.0"]), ("voc_3", list(map(str, EVAL_SCALES)))):
        f32_name = "eval VOC, scales " + ("1.0" if key == "voc_1" else str(EVAL_SCALES))
        evals[key], launches = run(f"eval VOC, scales {scales}", eval_cli, voc_cfg,
                                   flat + ["--scales", *scales], CLI_VAL, f32_name=f32_name)
        # per image and scale the logits' narrow upsample; per scale off 1.0
        # their bf16 -> f32 resize back; B on one scale's bf16 logits, or on
        # the f32 total
        one = len(scales) == 1
        want = {"logits narrow": CLI_VAL * len(scales),
                "A_bf16_f32": CLI_VAL * sum(s != "1.0" for s in scales),
                "B_bf16": CLI_VAL if one else 0, "B_f32": 0 if one else CLI_VAL}
        got = {k: launches[k] for k in want if k in launches}
        got["logits narrow"] = logits_narrow(launches)
        if got != want:
            fail(f"bf16 eval {scales}: launches {got}, want {want}")
    for scales in (["1.0"], list(map(str, EVAL_SCALES))):
        run(f"eval VOC again (every size seen), scales {scales}", eval_cli, voc_cfg,
            flat + ["--scales", *scales], CLI_VAL, plain=False)
    city_cfg = os.path.join(tmp, "exp_city", "config.yaml")
    city_name = "eval Cityscapes, base_size 2048, scales 1.0"
    evals["city"], launches = run(
        city_name, eval_cli, city_cfg,
        ["--model_path", os.path.join(tmp, "exp_city", "city_random.pth"),
         "--base_size", str(max(CITY_EVAL_IMAGE)), "--scales", "1.0"], CITY_EVAL_VAL,
        f32_name=city_name)
    if logits_narrow(launches) != CITY_EVAL_VAL or launches["B_f32"] != CITY_EVAL_VAL:
        fail(f"bf16 Cityscapes eval: A narrow on the logits {logits_narrow(launches)} (the "
             f"crops', one forward per image), B f32 {launches['B_f32']} (the canvas)")
    _, launches = run("infer VOC, batch 3", infer_cli, voc_cfg, flat + ["--batch_size", "3"],
                      CLI_VAL, plain=False)
    if launches["B_bf16"] != CLI_VAL or logits_narrow(launches) != 2:
        fail(f"bf16 infer at batch 3: B bf16 {launches['B_bf16']}, A narrow on the logits "
             f"{logits_narrow(launches)} (want {CLI_VAL}, 2)")
    # kernel B's bf16 mode at the Cityscapes serving shape, (19, 769²) ->
    # 1024x2048
    _, launches = run("infer Cityscapes (769²), batch 1", infer_cli, city_cfg,
                      ["--model_path", os.path.join(tmp, "exp_city", "city_random.pth")],
                      CITY_EVAL_VAL, plain=False)
    city_b = launches["B_bf16"]
    if city_b != CITY_EVAL_VAL:
        fail(f"bf16 Cityscapes infer: B bf16 {city_b} (want {CITY_EVAL_VAL})")
    log(f"[phase 14] bf16 vs f32 mIoU: " + ", ".join(
        f"{k} {evals[k]['miou']:.4f} vs {f32_evals[k]['miou']:.4f}" for k in evals))
    missing = [k for k in BF16_INFER_KEYS if total[k] <= 0]
    missing += [k for k, n in (("A narrow on the logits", logits_narrow(total)),
                               ("A narrow on the decoder", decoder_narrow(total))) if n <= 0]
    if missing:
        fail(f"a kernel of the bf16 inference path was never launched: {missing}")
    log(f"[{card}] phase 14 (bf16 serving, eval and infer) in {time.monotonic() - t_phase:.1f} s; "
        f"launches of the kernels' runs {total}")
    return total, errs, times, f32, {"serving": serving, "evals": evals, "city_b": city_b}


# the kernels (and modes) of the bf16 inference path: A on the request and
# eval images (f32), A's narrow bf16 mode on the logits, its bf16 -> f32
# mode on eval's per-scale logits, B's bf16 mode on one scale's logits and
# its f32 mode on eval's f32 totals and canvases
BF16_INFER_KEYS = ("A_image", "A_bf16_narrow", "A_bf16_f32", "B_bf16", "B_f32")


# ---- phase 16: the data-parallel VOC bf16 contrastive step ------------------

DIST_START = 2  # phase 16 steps from the first semi epoch (2 steps an epoch)
DIST_STEPS = 3  # two steps of the first semi epoch, one of epoch 2
DIST_TIMEOUT = 900  # seconds for phase 16's two rank processes


def state_hash(state) -> str:
    """sha256 of the state's bits: the step, both models' parameters and
    buffers, the optimizer's traces and the bank."""
    import hashlib

    import torch

    h = hashlib.sha256()
    tensors = [state.step]
    for model in (state.student, state.teacher):
        tensors += [t for _, t in sorted(model.state_dict().items())]
    for p in state.student.parameters():
        per = state.optimizer.state.get(p, {})
        tensors += [per[k] for k in sorted(per) if torch.is_tensor(per[k])]
    if state.bank is not None:
        tensors += [state.bank.keys, state.bank.ptr, state.bank.occupancy]
    for t in tensors:
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dist_steps(state, cfg, batches, group):
    """DIST_STEPS semi steps through `run_steps` from DIST_START, each rank's
    draws from `step_generator(SEED, i, rank)`: (ms per step, synchronised;
    the state's hash after each step; the metrics)."""
    import torch

    from u2pl_tpu_torch.train.steps import run_steps

    times, hashes, metrics = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, start_iter=DIST_START,
                          seed=SEED, group=group):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(scalars(m))
        hashes.append(state_hash(state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    return times, hashes, metrics


def dist_state(dev, group=None):
    """The VOC `ours` config as it stands (bf16, contrastive on) and its
    state from SEED at step DIST_START, its BatchNorms synced over `group`."""
    import torch

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.train.state import broadcast_state, create_train_state

    cfg = load_config(VOC_CONFIG)
    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                               group=group)
    broadcast_state(state, group)
    state.step.fill_(DIST_START)
    return cfg, state


def phase16_one_rank_group(dev, card):
    """(a) The VOC bf16 contrastive semi step, DIST_STEPS steps, with no group
    and in a one-process NCCL group on `dev`, from the same state and draws:
    bit-equal after every step.  Both runs take cuDNN's deterministic
    algorithms: its default convolution backward varies in the last bits
    from run to run on this card, group or not.  Returns (the group run's
    launches, ms per step of each)."""
    import torch

    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _one_rank_group(dev, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _one_rank_group(dev, card):
    import torch.distributed as tdist

    from u2pl_tpu_torch import dist
    from u2pl_tpu_torch.models.builder import sync_batch_norm

    cfg, state = dist_state(dev)
    snapshot = copy.deepcopy(state)
    batches = synthetic_batches(dev, DIST_STEPS, seed=SEED + 40)
    none = dist_steps(state, cfg, batches, None)
    del state
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                             world_size=1)
    try:
        group = dist.Group()
        for model in (snapshot.student, snapshot.teacher):
            sync_batch_norm(model, group)
        zero_counters()
        got = dist_steps(snapshot, cfg, batches, group)
        launches = read_counters()
    finally:
        tdist.destroy_process_group()
    del snapshot, batches
    same = got[1] == none[1] and got[2] == none[2]
    log(f"[{card}] phase 16a VOC bf16 contrastive semi step, {B_L}+{B_U} at {CROP}², "
        f"{DIST_STEPS} steps, cudnn.deterministic: no group {[f'{t:.1f}' for t in none[0]]} ms, "
        f"a one-process NCCL "
        f"group {[f'{t:.1f}' for t in got[0]]} ms; states bit-equal after every step {same}; "
        f"K5 gather / slab launches {launches['K5_gather']} / {launches['K5_slabs']}, rep mode "
        f"{launches['K5']}")
    if not same:
        fail("phase 16a: a one-process group does not give the bits of no group")
    if (launches["K5_gather"], launches["K5_slabs"], launches["K5"]) != (DIST_STEPS, DIST_STEPS, 0):
        fail(f"phase 16a: K5 launches {launches}: want the gather and slab modes once a step")
    return launches, {"none_ms": none[0], "group_ms": got[0]}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def phase16_two_ranks(card):
    """(b) The same step on DIST_W ranks, one process each: NCCL with one
    rank per card when the machine has DIST_W cards, else both on cuda:0
    under gloo (NCCL takes one rank per device).  Each rank steps on its own
    4 + 4 images with its own draws; their states must be bit-equal after
    each step, and each rank's last step through the kernels and through the
    plain versions is held to phase 13's bounds.  Returns (launches summed
    over the ranks' step runs, the ranks' reports)."""
    import torch

    backend = "nccl" if torch.cuda.device_count() >= DIST_W else "gloo"
    torch.cuda.empty_cache()
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_dist_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(DIST_W)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase16-rank",
                                   str(r), str(DIST_W), str(port), backend, outs[r]], cwd=ROOT)
                 for r in range(DIST_W)]
        try:
            codes = [p.wait(timeout=DIST_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            fail(f"phase 16b: the rank processes exited {codes}")
        reports = []
        for path in outs:
            with open(path) as f:
                reports.append(json.load(f))
    hashes = [r["hashes"] for r in reports]
    same = all(h == hashes[0] for h in hashes)
    log(f"[{card}] phase 16b {DIST_W} ranks over {backend} "
        f"({'one per card' if backend == 'nccl' else 'both on cuda:0'}), VOC bf16 contrastive "
        f"semi step, {B_L}+{B_U} at {CROP}² a rank: ms per step "
        + "; ".join(f"rank {i} {[f'{t:.1f}' for t in r['ms']]}" for i, r in enumerate(reports))
        + f"; slab exchange {reports[0]['exchange_bytes']} bytes a step; states bit-equal "
        f"across the ranks after every step {same}")
    if not same:
        fail("phase 16b: the ranks' states differ")
    launches = {k: sum(r["launches"][k] for r in reports) for k in reports[0]["launches"]}
    if (launches["K5_gather"], launches["K5_slabs"]) != (DIST_W * DIST_STEPS,) * 2:
        fail(f"phase 16b: K5 gather / slab launches {launches}")
    return launches, {"backend": backend, "reports": reports}


def phase16_rank(rank, world, port, backend, out):
    """One rank of phase 16b (run as `chip_smoke.py --phase16-rank RANK WORLD
    PORT BACKEND OUT`): writes its report to OUT."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as tdist

    from u2pl_tpu_torch import dist
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.steps import draw_contrastive, make_semi_step

    rank, world = int(rank), int(world)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                             world_size=world)
    group = dist.Group()
    cfg, state = dist_state(dev, group)
    batches = synthetic_batches(dev, DIST_STEPS, seed=SEED + 40 + rank)
    zero_counters()
    times, hashes, _ = dist_steps(state, cfg, batches, group)
    launches = read_counters()
    what = f"phase 16b rank {rank}"
    log(f"[{what}] ms per step {[f'{t:.1f}' for t in times]}; launches {launches}")
    # a step from the run's end state through both routes (phase 13's bounds)
    snapshot = copy.deepcopy(state)
    del state
    step = make_semi_step(cfg, STEPS_PER_EPOCH, group)
    g = torch.Generator(device=dev).manual_seed(SEED + 50 + rank)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    draws = draw_contrastive(g, cfg, (B_L + B_U) * OS4 * OS4)
    routes = bf16_routes(snapshot, lambda st, route: step(st, *batches[-1], mix=mix, contra=draws),
                         what)
    c, k = cfg.net.num_classes, cfg.trainer.contrastive.max_keys_per_class_per_step
    report = {"ms": times, "hashes": hashes, "launches": launches, "routes": routes,
              "exchange_bytes": world * c * (k * 256 * 2 + 4),
              "peak": torch.cuda.max_memory_allocated(dev)}
    with open(out, "w") as f:
        json.dump(report, f)
    tdist.destroy_process_group()
    return 0


# ---- phase 17: contrastive.anchor_ema ------------------------------------------

EMA_STEPS = 5  # 2 warmup, 3 semi steps, as phase 13


def ema_config(cfg):
    """`cfg` with trainer.contrastive.anchor_ema: true."""
    contra = dataclasses.replace(cfg.trainer.contrastive, anchor_ema=True)
    return dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, contrastive=contra))


def ema_run(dev, cfg, what, seed):
    """EMA_STEPS steps of the anchor_ema config `cfg` through `run_steps`
    with every count set to 0 just before them: the prototype all zero
    into the first semi step and written after it, at the active
    positions' bank-class slots and nowhere else (the slots and the
    positions read from the step's own blend, by tapping
    `losses/contrastive.py:_anchor_ema`); con_loss finite and > 0; K6's
    per-query mode and the rest of K6 once per semi step, every kernel of
    the contrastive semi step launched.  Returns (state, batches, the
    step generator, the run's launches, the state before the last step)."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.train.state import create_train_state
    from u2pl_tpu_torch.train.steps import run_steps

    state = create_train_state(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    log(f"[{what}] config {os.path.relpath(VOC_CONFIG, ROOT)} (net.dtype {cfg.net.dtype}) with "
        f"trainer.contrastive.anchor_ema: true; prototype {tuple(state.prototype.shape)} "
        f"{state.prototype.dtype}; {B_L}+{B_U} images of {CROP}², {EMA_STEPS} steps")
    batches = synthetic_batches(dev, EMA_STEPS, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    blends = []  # (b_j, active) of each semi step's blend
    original = tc._anchor_ema

    def tap(positive, prototype, b_j, active, i_iter):
        blends.append((b_j.clone(), active.clone()))
        return original(positive, prototype, b_j, active, i_iter)

    history, snapshot = [], None
    tc._anchor_ema = tap
    try:
        torch.cuda.synchronize()
        zero_counters()
        into = state.prototype.clone()
        for i_iter, m in run_steps(state, batches, STEPS_PER_EPOCH, cfg, generator=gen):
            semi = "low_thresh" in m
            out = state.prototype.clone()
            history.append((i_iter, scalars(m), semi, into, out))
            into = out
            if i_iter == EMA_STEPS - 2:
                snapshot = copy.deepcopy(state)
        torch.cuda.synchronize()
        launches = read_counters()
    finally:
        tc._anchor_ema = original
    semi_steps = sum(h[2] for h in history)
    if len(blends) != semi_steps or semi_steps != EMA_STEPS - cfg.trainer.sup_only_epoch * (
            STEPS_PER_EPOCH):
        fail(f"{what}: {len(blends)} blends over {semi_steps} semi steps")
    first = True
    for (i_iter, m, semi, p_in, p_out) in history:
        log(f"[{what}] step {i_iter} ({'semi' if semi else 'warmup'}): "
            + ", ".join(f"{a} {v:.6g}" for a, v in m.items()))
        if not all(v == v and abs(v) != float("inf") for v in m.values()):
            fail(f"{what} step {i_iter}: non-finite metrics {m}")
        if not semi:
            if p_out.any():
                fail(f"{what}: a warmup step wrote the prototype")
            continue
        b_j, active = blends.pop(0)
        written = torch.zeros_like(active)
        written[b_j.long()] = active  # slot b_j[j] takes position j's blend
        slots = p_out.flatten(1).ne(0).any(1)
        log(f"[{what}] step {i_iter}: prototype in all zero {not p_in.any()}; active positions "
            f"{active.nonzero().flatten().tolist()}, their bank classes "
            f"{b_j[active].tolist()}; slots written {slots.nonzero().flatten().tolist()}")
        if first and p_in.any():
            fail(f"{what}: the prototype is not all zero into the first semi step")
        if not first and not p_in.any():
            fail(f"{what}: the prototype is all zero into a later semi step")
        if not torch.equal(slots, written) or not active.any():
            fail(f"{what} step {i_iter}: slots written {slots.tolist()}, active bank-class "
                 f"slots {written.tolist()}")
        if not m["con_loss"] > 0:
            fail(f"{what} step {i_iter}: con_loss {m['con_loss']} is not > 0")
        first = False
    want = {"K6_fwd_pq": semi_steps, "K6_fwd": semi_steps, "K6_bwd": semi_steps}
    got = {k: launches[k] for k in want}
    log(f"[{what}] launches {launches}; K6 {got} (want {want})")
    if got != want:
        fail(f"{what}: K6 launches {got}, want {want}: the per-query mode once a semi step")
    missing = [k for k in (*TRAIN_COUNTERS, *CONTRA_COUNTERS) if launches[k] <= 0]
    if missing:
        fail(f"{what}: a kernel of the anchor_ema path was never launched: {missing}")
    check_per_semi_step(what, launches, semi_steps, contrastive=True)
    return state, batches, gen, launches, snapshot


def phase17_anchor_ema(dev, card, bf16_semi_ms):
    """The VOC `ours` config as it stands (bf16) with
    `trainer.contrastive.anchor_ema: true` set in memory: EMA_STEPS steps
    through `run_steps` (`ema_run`); the step's ms beside phase 13's step
    without anchor_ema (`bf16_semi_ms`); step 5 again from a copy through
    the kernels, the plain versions and the kernels in f32 (`bf16_routes`,
    phase 13's bounds), the new prototype of the two bf16 routes within
    BF16_ROUTE_SHARE of its bf16-vs-f32 gap.  Then the same config in f32
    (`load_f32`), EMA_STEPS steps through `run_steps` again (`ema_run`):
    the f32 per-query mode's own main-path run.  Returns (launches of the
    bf16 run, launches of the f32 run, a summary)."""
    import torch

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.train.steps import draw_contrastive, make_semi_step

    cfg = ema_config(load_config(VOC_CONFIG))
    if cfg.net.dtype != "bfloat16":
        fail(f"{VOC_CONFIG}: net.dtype {cfg.net.dtype}, phase 17 expects bfloat16")
    state, batches, gen, launches, snapshot = ema_run(dev, cfg, "phase 17", SEED + 50)

    # the step's time, as phase 13 times it
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = []
    for i in range(2 + 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    med, imgs = statistics.median(runs), B_L + B_U
    log(f"[{card}] bf16 anchor_ema contrastive semi step ({imgs} images of {CROP}², "
        f"synchronised): median {med:.1f} ms over {len(runs)} runs after 2 (min {min(runs):.1f}, "
        f"max {max(runs):.1f}); {imgs * 1e3 / med:.2f} img/s; phase 13's step without anchor_ema "
        f"{bf16_semi_ms:.1f} ms")
    del state

    g = torch.Generator(device=dev).manual_seed(SEED + 52)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    draws = draw_contrastive(g, cfg, (B_L + B_U) * OS4 * OS4)

    def run(st, route):
        return step(st, *batches[-1], mix=mix, contra=draws)

    if not snapshot.prototype.any():
        fail("phase 17: the prototype into step 5 is all zero")
    routes = bf16_routes(snapshot, run, "phase 17")
    del snapshot, batches
    if routes["prototype"] is None:
        fail("phase 17: step 5 wrote no prototype")
    torch.cuda.empty_cache()

    # the f32 per-query mode on a main-path run of its own
    state, _, _, f32_launches, _ = ema_run(dev, ema_config(load_f32(VOC_CONFIG)),
                                           "phase 17 f32", SEED + 53)
    del state
    return launches, f32_launches, {"semi_ms": med, "img_s": imgs * 1e3 / med, **routes}


# ---- phase 15: K5's modes for several ranks ----------------------------------

SLAB_WORLDS = (1, 2, 4, 8)  # ranks whose slabs phase 15 enqueues
DIST_W = 2  # phase 16's ranks


def rank_selections(case, w):
    """Rank w's (sel_idx, n_sel) for phase 15: the flagship selection with
    classes 1 .. C-1 rolled by w among themselves, so each rank brings other
    counts to a class; class 0 keeps its 8192 keys on every rank, past its
    50,000-row ring at 8 ranks."""
    import torch

    c = case["n_sel"].shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      (torch.arange(c - 1) - w) % (c - 1) + 1]).to(case["n_sel"].device)
    return case["sel_idx"][perm].contiguous(), case["n_sel"][perm].contiguous()


def slab_bytes(counts, sizes, k, f, in_bytes, out_bytes):
    """(kept rows, bytes) of a slab enqueue: each class's rows up to its
    queue, read in the slabs' dtype and written in the bank's."""
    import torch

    kept = int(torch.minimum(torch.clamp(counts, max=k).sum(0), sizes).sum())
    return kept, kept * f * (in_bytes + out_bytes) + counts.numel() * 4


def phase15_slabs(dev, card, case):
    """K5's gather (each rank's (C, K, F) slab from the teacher's NCHW rep)
    and slab enqueue (the gathered (W, C, K, F) slabs into the ring) against
    their plain versions at the VOC bank (21, 50000, 256), K = 8192, in
    bf16 and f32, for 1, 2, 4 and 8 ranks on a bank whose rings wrap: the
    gathered rows, keys, ptr and occupancy bit-equal; W = 8 must overflow a
    ring.  Times each beside its plain version and, for the enqueue, one
    `index_put_` of the kept rows.  Returns ({key: (ms, plain_ms,
    library_ms)}, {key: f32_ms}, {key: bound ms}, {W: {...}} per world)."""
    import torch

    from u2pl_tpu_torch.memobank import (
        clone_bank, memobank_enqueue_slabs, memobank_enqueue_slabs_plain, memobank_gather,
        memobank_gather_plain,
    )

    bank0 = case["bank"]
    c, cap, f = bank0.keys.shape
    k = case["sel_idx"].shape[1]
    times, f32, bounds_ms, per_world = {}, {}, {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        rep = case["rep_t"].to(dt)
        bank = clone_bank(bank0)
        bank.keys = bank.keys.to(dt)
        sel = [rank_selections(case, w) for w in range(max(SLAB_WORLDS))]
        slabs = [memobank_gather(rep, *s) for s in sel]
        torch.cuda.synchronize()
        for w, ((idx, n), slab) in enumerate(zip(sel, slabs)):
            ref = memobank_gather_plain(rep, idx, n)
            rows = torch.arange(k, device=dev)[None, :] < n[:, None]
            if not torch.equal(slab[rows], ref[rows]):
                fail(f"phase 15: K5 gather ({name}) rank {w} differs from its plain version")
        sel_rows = int(case["n_sel"].sum())
        gather_ms = cuda_ms(lambda: memobank_gather(rep, *sel[0]))
        gather_plain = cuda_ms(lambda: memobank_gather_plain(rep, *sel[0]))
        rb = rep.element_size()
        gather_bound = (sel_rows * f * 2 * rb + sel_rows * 4) / PEAK_BYTES_S * 1e3
        log(f"[{card}] phase 15 K5 gather {name} rep {tuple(rep.shape)} -> ({c}, {k}, {f}), "
            f"{sel_rows} rows: bit-equal; {gather_ms:.4f} ms (plain {gather_plain:.4f}; bytes "
            f"bound {gather_bound:.4f} ms)")
        key = f"K5_gather_{name}"
        times[key], bounds_ms[key] = (gather_ms, gather_plain, None), gather_bound
        overflow = {}
        for w in SLAB_WORLDS:
            stacked = torch.stack(slabs[:w])
            counts = torch.stack([s[1] for s in sel[:w]])
            kb = memobank_enqueue_slabs(clone_bank(bank), stacked, counts)
            pb = memobank_enqueue_slabs_plain(clone_bank(bank), stacked, counts)
            torch.cuda.synchronize()
            same = all(torch.equal(getattr(kb, a), getattr(pb, a))
                       for a in ("keys", "ptr", "occupancy"))
            total = torch.clamp(counts, max=k).sum(0)
            overflow[w] = int((total > bank.sizes).sum())
            wrapped = int((bank.ptr + torch.minimum(total, bank.sizes) > bank.sizes).sum())
            if not same:
                fail(f"phase 15: K5 slab enqueue ({name}, W={w}) differs from its plain version")
            # the library call: one index_put_ of the kept rows at their ring rows
            first = torch.clamp(total - bank.sizes, min=0)
            flat = stacked.transpose(0, 1).reshape(c, w * k, f)
            valid = (torch.arange(k, device=dev)[None, None] < torch.clamp(counts, max=k).t()[:, :, None]
                     ).reshape(c, w * k)
            rank = torch.cumsum(valid.int(), 1) - 1
            keep = valid & (rank >= first[:, None])
            ring = (torch.arange(c, device=dev)[:, None] * cap
                    + torch.remainder(bank.ptr[:, None] + rank, bank.sizes[:, None]))[keep]
            vals = flat[keep].to(bank.keys.dtype)
            bl, bk, bp = clone_bank(bank), clone_bank(bank), clone_bank(bank)
            dst = bl.keys.view(c * cap, f)
            lib_ms = cuda_ms(lambda: dst.index_put_((ring,), vals))
            ms = cuda_ms(lambda: memobank_enqueue_slabs(bk, stacked, counts))
            plain_ms = cuda_ms(lambda: memobank_enqueue_slabs_plain(bp, stacked, counts))
            kept, nbytes = slab_bytes(counts, bank.sizes, k, f, rb, bank.keys.element_size())
            bound = nbytes / PEAK_BYTES_S * 1e3
            log(f"[{card}] phase 15 K5 slab enqueue {name}, W={w}: {kept} kept rows of "
                f"{int(total.sum())}, {overflow[w]} classes past their queue, {wrapped} rings "
                f"wrapped; keys, ptr, occupancy bit-equal; {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"index_put_ {lib_ms:.4f}; bytes bound {bound:.4f} ms)")
            per_world.setdefault(w, {})[name] = {"ms": ms, "plain_ms": plain_ms,
                                                 "library_ms": lib_ms, "bound_ms": bound,
                                                 "kept_rows": kept}
            if w == DIST_W:
                key = f"K5_slabs_{name}"
                times[key], bounds_ms[key] = (ms, plain_ms, lib_ms), bound
            del kb, pb, bk, bp, bl, dst, stacked, flat, vals, ring
        if overflow[max(SLAB_WORLDS)] == 0:
            fail(f"phase 15: at W={max(SLAB_WORLDS)} no class took more keys than its queue")
        del slabs, rep, bank
    for name in ("gather", "slabs"):
        f32[f"K5_{name}_bf16"] = times[f"K5_{name}_f32"][0]
    return times, f32, bounds_ms, per_world


def bounds(case, cfg):
    """{kernel: (bound ms, "bytes" or "operations")}: the least time the card
    could take for each timed call, the larger of the bytes it must move
    over the HBM rate and its operations over the float32 peak (for D also
    its expf / logf over the special-function units' rate), from the
    shapes (and, for K5 and K6, this run's selections; for C's backward
    and K7 prob, the valid pixels of its labels) of the timed calls (K7's
    and C bwd's Cityscapes entries: phase 9's heads)."""
    c, n = case["pri"].shape
    ccfg = cfg.trainer.contrastive
    q, m, k = ccfg.num_queries, ccfg.num_negatives, ccfg.max_keys_per_class_per_step
    f, b, hw = 256, B_L + B_U, OS4 * OS4
    lo, hi = 4 * 21 * OS4 * OS4, 4 * 21 * CROP * CROP  # (4, 21) logits at os4 / 513²
    px = 4 * CROP * CROP
    cpx = CITY_B * CITY_CROP * CITY_CROP  # Cityscapes labels
    clo, chi = 19 * CITY_B * CITY_OS4 * CITY_OS4, 19 * cpx  # its 19-class logits, os4 / 769²
    clo8 = 19 * CITY_B * CITY_OS8 * CITY_OS8  # the aux head's, os8
    ncity = 2 * CITY_B * CITY_OS4 * CITY_OS4  # the Cityscapes step's os4 pixels
    sel = int(case["n_sel"].sum())
    act = int(case["active"].sum())
    # K5's reads as the card makes them: sel_idx is random in pixel space and
    # the rep NCHW, so each feature read costs its 32-byte sector; the
    # distinct sectors of the (B, F, h, w) f32 rep that the written rows'
    # pixels touch, over all F planes
    import torch

    from u2pl_tpu_torch.kernels.timing_ab import masks_needed

    n_new = torch.minimum(case["n_sel"], torch.tensor(k, device=case["n_sel"].device))
    first = torch.clamp(n_new - case["bank"].sizes, min=0)
    rank = torch.arange(case["sel_idx"].shape[1], device=n_new.device)
    written = (rank >= first[:, None]) & (rank < n_new[:, None])
    pix = case["sel_idx"][written].long()
    planes = (pix // hw * f)[:, None] + torch.arange(f, device=pix.device)
    flat = planes * hw + (pix % hw)[:, None]
    sectors = int(torch.unique(flat // 8).numel())
    # operations per upsampled value: 9 for the bilinear taps (6 products,
    # 3 sums), plus the softmax / CE / entropy terms the function needs
    moved = {  # kernel -> (bytes, float32 operations)
        "A_logits": ((lo + hi) * 4, hi * 9),
        # a request image (1, 3, 375, 500) -> 513²; the Cityscapes eval's 8
        # crops' (19, 193²) logits -> 769²
        "A_image": ((3 * 375 * 500 + 3 * CROP * CROP) * 4, 3 * CROP * CROP * 9),
        # a Cityscapes request image (1, 3, 1024, 2048) -> 769²
        "A_image_city": ((3 * 1024 * 2048 + 3 * CITY_CROP ** 2) * 4, 3 * CITY_CROP ** 2 * 9),
        "A_eval_crop": (8 * 19 * (CITY_OS4 ** 2 + CITY_CROP ** 2) * 4,
                        8 * 19 * CITY_CROP ** 2 * 9),
        # the decoder's (8, 256, 65²) -> 129²
        "A_decoder": (8 * 256 * (65 * 65 + 129 * 129) * 4, 8 * 256 * 129 * 129 * 9),
        "B": (21 * CROP * CROP * 4 + 375 * 500, 21 * 375 * 500 * 10),
        "A_bwd": ((8 * 256 * 129 * 129 + 8 * 256 * 65 * 65) * 4, 8 * 256 * 129 * 129 * 9),
        "A_bwd_city": ((4 * 256 * CITY_OS4 ** 2 + 4 * 256 * CITY_OS8 ** 2) * 4,
                       4 * 256 * CITY_OS4 ** 2 * 9),
        # C fwd: the os4 logits and the labels in, lse out; per upsampled
        # value the taps, the max and the exp's argument, one expf each, and
        # per pixel one logf
        "C_fwd": (lo * 4 + px * 8, hi * 11, hi + px),
        "C_fwd_city_main": (clo * 4 + cpx * 8 + 19 * 4, chi * 11, chi + cpx),
        "C_fwd_city_aux": (clo8 * 4 + cpx * 8, chi * 11, chi + cpx),
        "C_fwd_city_unsup": (clo * 4 + cpx * 8, chi * 11, chi + cpx),
        # C bwd (fused with its adjoint resize): logits, labels and lse in,
        # the logits' gradient out; the softmax only where a pixel is valid
        "C_bwd": (2 * lo * 4 + 2 * px * 4, C_BWD_VALID["C_bwd"] * 21 * 20),
        "C_bwd_city_main": (2 * clo * 4 + 2 * cpx * 4 + 19 * 4,
                            C_BWD_VALID["C_bwd_city_main"] * 19 * 20),
        "C_bwd_city_aux": (2 * clo8 * 4 + 2 * cpx * 4, C_BWD_VALID["C_bwd_city_aux"] * 19 * 20),
        # D per output selection: the os4 logits in, the selected outputs
        # out; per upsampled value the taps and the softmax terms, one expf
        # each (and per pixel the max-prob's expf and logf), plus a logf
        # each for the entropy
        "D_prob": (lo * 4 + px * 8, hi * 12, hi + 2 * px),
        "D_entropy": (lo * 4 + px * 4, hi * 16, 2 * hi),
        "D_city_prob": (clo * 4 + cpx * 8, chi * 12, chi + 2 * cpx),
        "D_city_entropy": (clo * 4 + cpx * 4, chi * 16, 2 * chi),
        # E: each value and its mask read once
        "E": (px * 5, 0),
        "E_3": (px * 5, 0),
        "E_city_3": (cpx * 5, 0),
        "K3": (2 * px * (12 + 4 + 4), 0),
        # K3c: K3's bytes and the (4, 21) draws
        "K3c": (2 * px * (12 + 4 + 4) + 4 * 21 * 4, 0),
        # K4 masks: what its timed inputs need (timing_ab.masks_needed): the
        # (C, N) outputs, labels and low bits, the unlabeled images' high
        # bits, all C probabilities of a pixel whose label rank is needed
        # and p[L] alone of the other pixels that need it; C compares per
        # ranked pixel
        "K4_masks": masks_needed(case["prob"], case["labels"], case["low"], case["high"],
                                 B_L, ccfg),
        "K4_masks_city": K4_MASKS_NEEDED["K4_masks_city"],
        "K4_select": (c * n * 5 + c * k * 4, 0),
        "K4r": (c * n * 5 + c * k * 4 + c * 4, 0),  # mask + u32 keys in; idx + n_sel out
        "K4_anchors": (c * n + 2 * c * q * 4, 0),
        "K4_anchors_city": (19 * ncity + 2 * 19 * q * 4, 0),
        "K5": (sel * (f * 4 + 4 + f * 2), 0),
        "K5_sectors": (sectors * 32 + sel * (4 + f * 2), 0),
        "K6_fwd": (act * q * (f * 4 + m * (f * 2 + 4)) + act * f * 4, act * q * (m + 1) * f * 4),
        "K6_bwd": (b * f * hw * 4 + act * q * (f * 4 + 4), 0),
        # K7 at the Cityscapes heads, timed in phase 9: p_y from the os4 (os8)
        # logits and the labels, per valid pixel its 19 upsampled values, the
        # max and the exp's argument, and one expf each (p_y's numerator is
        # one of the sum's terms); k-th smallest: one read of p_y; kept labels
        "K7_prob": (clo * 4 + cpx * 8, K7_VALID["K7_prob"] * 19 * 11,
                    K7_VALID["K7_prob"] * 19),
        "K7_prob_aux": (clo8 * 4 + cpx * 8, K7_VALID["K7_prob_aux"] * 19 * 11,
                        K7_VALID["K7_prob_aux"] * 19),
        "K7_kth": (cpx * 4, 0),
        "K7_keep": (cpx * 12, 0),
        # the bf16 modes: the same work, each bf16 tensor at 2 bytes (labels,
        # lse, p_y, the stats and K6's directions stay f32)
        "A_decoder_bf16": (8 * 256 * (65 * 65 + 129 * 129) * 2, 8 * 256 * 129 * 129 * 9),
        "A_decoder_city_bf16": (4 * 256 * (CITY_OS8 ** 2 + CITY_OS4 ** 2) * 2,
                                4 * 256 * CITY_OS4 ** 2 * 9),
        "A_logits_bf16": ((lo + hi) * 2, hi * 9),
        "A_bwd_bf16": ((8 * 256 * 129 * 129 + 8 * 256 * 65 * 65) * 2, 8 * 256 * 129 * 129 * 9),
        "A_bwd_city_bf16": ((4 * 256 * CITY_OS4 ** 2 + 4 * 256 * CITY_OS8 ** 2) * 2,
                            4 * 256 * CITY_OS4 ** 2 * 9),
        "C_fwd_bf16": (lo * 2 + px * 8, hi * 11, hi + px),
        "C_bwd_bf16": (2 * lo * 2 + 2 * px * 4, C_BWD_VALID["C_bwd_bf16"] * 21 * 20),
        "D_prob_bf16": (lo * 2 + px * 8, hi * 12, hi + 2 * px),
        "D_entropy_bf16": (lo * 2 + px * 4, hi * 16, 2 * hi),
        "K7_prob_bf16": (clo * 2 + cpx * 8, K7_VALID["K7_prob_bf16"] * 19 * 11,
                         K7_VALID["K7_prob_bf16"] * 19),
        "K7_prob_aux_bf16": (clo8 * 2 + cpx * 8, K7_VALID["K7_prob_aux_bf16"] * 19 * 11,
                             K7_VALID["K7_prob_aux_bf16"] * 19),
        "K5_bf16": (sel * (f * 2 + 4 + f * 2), 0),
        "K6_fwd_bf16": (act * q * (f * 2 + m * (f * 2 + 4)) + act * f * 4,
                        act * q * (m + 1) * f * 4),
        # the per-query positive (anchor_ema): a (C, Q, F) f32 row per draw
        # in place of a (C, F) row per position
        "K6_fwd_pq": (act * q * (f * 4 + m * (f * 2 + 4)) + act * q * f * 4,
                      act * q * (m + 1) * f * 4),
        "K6_fwd_pq_bf16": (act * q * (f * 2 + m * (f * 2 + 4)) + act * q * f * 4,
                           act * q * (m + 1) * f * 4),
        "K6_bwd_bf16": (b * f * hw * 2 + act * q * (2 * f * 4 + 4), 0),
        # phase 14: B reads the bf16 logits and writes a byte per pixel; A
        # bf16 -> f32 reads bf16 and writes f32; A narrow at the decoder's
        # VOC eval shape reads and writes bf16
        "A_decoder_eval_bf16": (FEATURES * (47 * 63 + 94 * 125) * 2, FEATURES * 94 * 125 * 9),
        "B_bf16": (21 * CROP * CROP * 2 + 375 * 500, 21 * 375 * 500 * 10),
        "B_city_bf16": (19 * CITY_CROP ** 2 * 2 + CITY_EVAL_IMAGE[0] * CITY_EVAL_IMAGE[1],
                        19 * CITY_EVAL_IMAGE[0] * CITY_EVAL_IMAGE[1] * 10),
        "A_bf16_f32": (21 * 469 * 625 * 2 + 21 * 375 * 500 * 4, 21 * 375 * 500 * 9),
    }
    out = {}
    for name, (nbytes, ops, *sfu) in moved.items():
        t_b = nbytes / PEAK_BYTES_S
        t_o = max(ops / PEAK_F32_FLOPS, sum(sfu) / PEAK_SFU_S)
        out[name] = (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--phase16-rank":
        return phase16_rank(*sys.argv[2:7])
    if not os.path.isdir(os.path.join(ROOT, "u2pl_tpu_torch")):
        fail(f"no u2pl_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[phase 0] nvidia-smi: {card}; torch.cuda.get_device_name: {kind}; "
        f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    import PIL
    import yaml

    log(f"[phase 0] probe: yaml {yaml.__version__}, PIL {PIL.__version__}")
    from u2pl_tpu_torch import kernels

    lib = kernels.load()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines() if "Used" in ln or "spill" in ln]
    log(f"[phase 0] kernels built in {lib.build_seconds:.2f} s: {ptxas}")

    a_err, b_err = phase1_kernels(dev)
    errs = phase1_train_kernels(dev)
    ccfg = load_f32(VOC_CONFIG)  # the `ours` config as it stands (f32), contrastive included
    contra_errs, case = phase1_contrastive_kernels(dev, ccfg)
    errs.update(contra_errs)
    pq_errs, pq_times, pq_f32, pq_class = phase1_k6_per_query(dev, card, case, ccfg)
    errs.update(pq_errs)
    k = ccfg.trainer.contrastive.max_keys_per_class_per_step
    variant_errs, variant_inputs = phase1_variant_kernels(dev, case["negative"], k)
    errs.update(variant_errs)
    variant_times = variant_timings(card, variant_inputs, k)
    del variant_inputs
    city_cfg = load_f32(CITY_CONFIG)  # as it stands (f32): OHEM, aux head, contrastive
    errs.update(phase1_ohem_kernels(dev, city_cfg))
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_") as tmp:
        engine, images, loaded, launches = phase2_slice(dev, card, tmp)
        times = phase3_timings(dev, card, engine, images, loaded, tmp)
    del engine, images, loaded
    state, batches, train_launches, _ = phase4_training(dev, card)
    _, train_times = phase5_train_timings(dev, card, state, batches)
    del state, batches
    state, batches, contra_launches, _ = phase6_contrastive(dev, card, ccfg)
    contra_times_run, contra_times = phase7_contrastive_timings(dev, card, ccfg, state, batches,
                                                                case)
    del state, batches
    torch.cuda.empty_cache()
    state, batches, city_launches, _ = phase8_cityscapes(dev, card, city_cfg)
    city_times_run, city_times = phase9_city_timings(dev, card, city_cfg, state, batches)
    del state, batches
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_cli_") as tmp:
        paths, cli_launches, _ = phase10_cli(dev, card, tmp)
        variant_launches, _ = phase11_variant(dev, card, tmp, paths)
        eval_launches, f32_evals = phase12_eval(dev, card, tmp, paths)
        torch.cuda.empty_cache()
        bf_voc, bf_city, bf_errs, bf_times, bf_f32, bf_voc_run, bf_city_run = phase13_bf16(
            dev, card, case, ccfg)
        # phase 14 evaluates on phases 10 and 12's workspaces
        inf_launches, inf_errs, inf_times, inf_f32, inf_run = phase14_bf16_inference(
            dev, card, tmp, f32_evals)
    torch.cuda.empty_cache()
    slab_times, slab_f32, slab_bounds, slab_worlds = phase15_slabs(dev, card, case)
    one_rank, one_rank_run = phase16_one_rank_group(dev, card)
    two_ranks, two_ranks_run = phase16_two_ranks(card)
    torch.cuda.empty_cache()
    ema_launches, ema_f32_launches, ema_run = phase17_anchor_ema(dev, card, bf_voc_run["semi_ms"])
    torch.cuda.empty_cache()
    bound = bounds(case, ccfg)
    bound.update({key: (ms, "bytes") for key, ms in slab_bounds.items()})
    bf_errs.update(inf_errs)
    bf_f32.update(inf_f32)
    bf_f32.update(slab_f32)
    bf_f32.update(pq_f32)

    csrc = "u2pl_tpu_torch/kernels/csrc/"
    times.update(train_times)
    times.update(contra_times)
    times.update(city_times)
    times.update(variant_times)
    times.update(bf_times)
    times.update(inf_times)
    times.update(slab_times)
    times.update(pq_times)
    srv = inf_run["serving"]
    log(f"[{card}] bf16 beside f32, VOC serving at 513² (phase 14): batch-1 latency p50 "
        f"{srv['bfloat16']['p50']:.2f} / p99 {srv['bfloat16']['p99']:.2f} ms vs "
        f"{srv['float32']['p50']:.2f} / {srv['float32']['p99']:.2f} ms; batch 8 "
        f"{srv['bfloat16']['masks_s']:.2f} vs {srv['float32']['masks_s']:.2f} masks/s; peak "
        f"{srv['bfloat16']['peak'] / 2**20:.1f} vs {srv['float32']['peak'] / 2**20:.1f} MiB")
    log(f"[{card}] bf16 beside f32, VOC contrastive semi step ({B_L}+{B_U} at {CROP}²): "
        f"{bf_voc_run['semi_ms']:.1f} ms, {bf_voc_run['img_s']:.2f} img/s, peak "
        f"{bf_voc_run['peak'] / 2**30:.2f} GiB (bf16) vs {contra_times_run['semi_ms']:.1f} ms, "
        f"{contra_times_run['img_s']:.2f} img/s, peak {contra_times_run['peak'] / 2**30:.2f} GiB "
        f"(f32, phase 7); Cityscapes semi step ({CITY_B}+{CITY_B} at {CITY_CROP}²): bf16 "
        f"{bf_city_run['semi_ms']:.1f} ms, {bf_city_run['img_s']:.2f} img/s, peak "
        f"{bf_city_run['peak'] / 2**30:.2f} GiB vs f32 {city_times_run['semi_ms']:.1f} ms "
        f"(phase 9)")
    log(f"[{card}] phase 16: the VOC bf16 contrastive semi step, ms per step: no group "
        f"{one_rank_run['none_ms']}, one-process NCCL group {one_rank_run['group_ms']}; "
        f"{DIST_W} ranks over {two_ranks_run['backend']} "
        + "; ".join(f"rank {i} {r['ms']}, peak {r['peak'] / 2**30:.2f} GiB"
                    for i, r in enumerate(two_ranks_run["reports"])))
    log(f"[{card}] phase 17: the VOC bf16 contrastive semi step with anchor_ema "
        f"{ema_run['semi_ms']:.1f} ms, phase 13's without it {bf_voc_run['semi_ms']:.1f} ms")
    for key in ("K6_fwd_pq", "K6_fwd_pq_bf16"):
        ms = times[key][0]
        log(f"[{card}] kernel {key}: {ms:.4f} ms (the per-class mode on the same inputs "
            f"{pq_class[key]:.4f} ms), {ms / bound[key][0]:.1f}x its bound {bound[key][0]:.4f} ms "
            f"({bound[key][1]})")
    ms = times["K5"][0]
    log(f"[{card}] kernel K5: {ms:.4f} ms, {ms / bound['K5'][0]:.1f}x its row-bytes bound "
        f"{bound['K5'][0]:.4f} ms, {ms / bound['K5_sectors'][0]:.1f}x its NCHW sector bound "
        f"{bound['K5_sectors'][0]:.4f} ms")
    for key in ("C_fwd", "C_fwd_city_main", "C_fwd_city_aux", "C_fwd_city_unsup",
                "C_bwd", "C_bwd_city_main", "C_bwd_city_aux"):
        ms, plain_ms, _ = times[key]
        log(f"[{card}] kernel {key}: {ms:.4f} ms, {ms / bound[key][0]:.1f}x its bound "
            f"{bound[key][0]:.4f} ms ({bound[key][1]}); plain route {plain_ms:.4f} ms")

    def entry(name, key, source, replaces, launches_, err, timing):
        ms, plain_ms, library_ms = times[timing]
        bound_ms, bound_by = bound[key]
        out = {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
               "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if timing in bf_f32:  # a bf16 mode: its f32 mode's time in the same call
            out["f32_ms"] = bf_f32[timing]
        return out

    def bf(key):  # launches in phase 13's bf16 runs (VOC and Cityscapes)
        return bf_voc[key] + bf_city[key]

    # launches: each path's run counted from 0 just before it (serving,
    # training without and with the contrastive branch, Cityscapes
    # training, the CLIs' runs, the classmix + radix run and the eval and
    # infer runs), summed per kernel
    def runs(key):
        return (train_launches[key] + contra_launches[key] + city_launches[key]
                + cli_launches[key] + variant_launches[key] + eval_launches.get(key, 0))

    report = {"kernels": [
        entry("resize_bilinear_ac_logits", "A_logits", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              launches["A_logits"] + runs("A_logits"), a_err[A_SHAPES[0][0]], "A_logits"),
        entry("resize_bilinear_ac_decoder", "A_decoder", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", launches["A_decoder"] + runs("A_decoder"),
              a_err[A_SHAPES[1][0]], "A_decoder"),
        entry("resize_bilinear_ac_image", "A_image", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              launches["A_image"] + runs("A_image"), a_err[A_IMAGE[0]], "A_image"),
        entry("resize_bilinear_ac_image_cityscapes", "A_image_city", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", runs("A_image_city"),
              a_err[A_IMAGE_CITY[0]], "A_image_city"),
        entry("resize_bilinear_ac_eval_crops", "A_eval_crop", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", runs("A_eval_crop"), a_err[A_EVAL_CROP[0]],
              "A_eval_crop"),
        entry("resize_argmax_ac", "B", "resize.cu", "u2pl_tpu/serving.py:115",
              launches["B"] + runs("B"), b_err, "B"),
        entry("resize_bilinear_ac_bwd", "A_bwd", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              runs("A_bwd") - city_launches["A_bwd"], errs["A_bwd"], "A_bwd_decoder"),
        entry("resize_bilinear_ac_bwd_cityscapes", "A_bwd_city", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", city_launches["A_bwd"], errs["A_bwd"], "A_bwd_city"),
        entry("upsample_ce_fwd", "C_fwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              runs("C_fwd") - city_launches["C_fwd"], errs["C_fwd"], "C_fwd"),
        *(entry(f"upsample_ce_fwd_cityscapes_{head}", f"C_fwd_city_{head}", "upsample_ce.cu",
                "u2pl_tpu/losses/ce.py:23", city_launches[f"C_fwd_city_{head}"], errs["C_fwd"],
                f"C_fwd_city_{head}") for head in ("main", "aux", "unsup")),
        entry("upsample_ce_bwd", "C_bwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              runs("C_bwd"), errs["C_bwd"], "C_bwd"),
        entry("upsample_softmax_stats_prob", "D_prob", "upsample_ce.cu",
              "u2pl_tpu/train/steps.py:300", runs("D_prob") - city_launches["D_prob"], errs["D"],
              "D_prob"),
        entry("upsample_softmax_stats_entropy", "D_entropy", "upsample_ce.cu",
              "u2pl_tpu/losses/unsup.py:24", runs("D_entropy") - city_launches["D_entropy"],
              errs["D"], "D_entropy"),
        entry("upsample_softmax_stats_prob_cityscapes", "D_city_prob", "upsample_ce.cu",
              "u2pl_tpu/train/steps.py:300", city_launches["D_prob"], errs["D"],
              "D_city_prob"),
        entry("upsample_softmax_stats_entropy_cityscapes", "D_city_entropy", "upsample_ce.cu",
              "u2pl_tpu/losses/unsup.py:24", city_launches["D_entropy"], errs["D"],
              "D_city_entropy"),
        # E: one percentile on the step without the contrastive branch (phase
        # 4), three on the contrastive step (phases 6, 10, 11 at VOC, 8 at
        # Cityscapes)
        entry("masked_percentiles", "E", "quantile.cu", "u2pl_tpu/ops/quantile.py:136",
              train_launches["E"], errs["E"], "E"),
        entry("masked_percentiles_k3", "E_3", "quantile.cu", "u2pl_tpu/ops/quantile.py:136",
              runs("E") - train_launches["E"] - city_launches["E"], errs["E"], "E_3"),
        entry("masked_percentiles_cityscapes_k3", "E_city_3", "quantile.cu",
              "u2pl_tpu/ops/quantile.py:136", city_launches["E"], errs["E"], "E_city_3"),
        entry("unsup_mix_boxes", "K3", "mixing.cu", "u2pl_tpu/ops/mixing.py:62",
              runs("K3"), errs["K3"], "K3"),
        entry("unsup_class_mix", "K3c", "mixing.cu", "u2pl_tpu/ops/mixing.py:44",
              runs("K3c"), errs["K3c"], "K3c"),
        entry("contra_pixel_masks", "K4_masks", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:50", runs("K4_masks") - city_launches["K4_masks"],
              errs["K4_masks"], "K4_masks"),
        entry("contra_pixel_masks_cityscapes", "K4_masks_city", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:50", city_launches["K4_masks"],
              errs["K4_masks"], "K4_masks_city"),
        entry("select_keys", "K4_select", "contrastive.cu", "u2pl_tpu/losses/contrastive.py:89",
              runs("K4_select"), errs["K4_select"], "K4_select"),
        entry("select_keys_radix", "K4r", "contrastive.cu", "u2pl_tpu/losses/contrastive.py:106",
              runs("K4r"), errs["K4r"], "K4r"),
        entry("sample_anchors", "K4_anchors", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:73",
              runs("K4_anchors") - city_launches["K4_anchors"], errs["K4_anchors"], "K4_anchors"),
        entry("sample_anchors_cityscapes", "K4_anchors_city", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:73", city_launches["K4_anchors"],
              errs["K4_anchors"], "K4_anchors_city"),
        {**entry("memobank_enqueue", "K5", "memobank.cu", "u2pl_tpu/memobank.py:92",
                 runs("K5"), errs["K5"], "K5"),
         "sector_bound_ms": bound["K5_sectors"][0]},
        entry("contra_infonce_fwd", "K6_fwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              runs("K6_fwd"), errs["K6_fwd"], "K6_fwd"),
        entry("contra_infonce_bwd", "K6_bwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              runs("K6_bwd"), errs["K6_bwd"], "K6_bwd"),
        entry("ohem_target_prob", "K7_prob", "upsample_ce.cu", "u2pl_tpu/losses/ohem.py:66",
              city_launches["K7_prob_main"], errs["K7_prob"], "K7_prob"),
        entry("ohem_target_prob_aux", "K7_prob_aux", "upsample_ce.cu",
              "u2pl_tpu/losses/ohem.py:66", city_launches["K7_prob_aux"], errs["K7_prob"],
              "K7_prob_aux"),
        entry("kth_smallest", "K7_kth", "quantile.cu", "u2pl_tpu/losses/ohem.py:35",
              city_launches["K7_kth"], errs["K7_kth"], "K7_kth"),
        entry("ohem_keep_labels", "K7_keep", "ohem.cu", "u2pl_tpu/losses/ohem.py:76",
              city_launches["K7_keep"], errs["K7_keep"], "K7_keep"),
        # the bf16 modes (phase 13): launches on its bf16 training runs; A's
        # narrow mode runs on the logits of phase 14's bf16 serving, eval and
        # infer runs (C, D and K7 upsample inside themselves) and on the
        # decoder's upsample at eval image sizes, each row with its own
        # launches (its time: phase 13's shape for the logits, phase 14's
        # VOC eval shape for the decoder)
        entry("resize_bilinear_ac_decoder_bf16", "A_decoder_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", bf_voc["A_decoder"], bf_errs["A_decoder_bf16"],
              "A_decoder_bf16"),
        entry("resize_bilinear_ac_decoder_cityscapes_bf16", "A_decoder_city_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", bf_city["A_decoder"], bf_errs["A_decoder_city_bf16"],
              "A_decoder_city_bf16"),
        entry("resize_bilinear_ac_logits_bf16", "A_logits_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76",
              logits_narrow(bf_voc) + logits_narrow(bf_city) + logits_narrow(inf_launches),
              bf_errs["A_logits_bf16"], "A_logits_bf16"),
        entry("resize_bilinear_ac_decoder_eval_bf16", "A_decoder_eval_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76",
              decoder_narrow(bf_voc) + decoder_narrow(bf_city) + decoder_narrow(inf_launches),
              bf_errs["A_decoder_eval_bf16"], "A_decoder_eval_bf16"),
        entry("resize_bilinear_ac_bwd_bf16", "A_bwd_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", bf_voc["A_bwd"], bf_errs["A_bwd_bf16"], "A_bwd_bf16"),
        entry("resize_bilinear_ac_bwd_cityscapes_bf16", "A_bwd_city_bf16", "resize.cu",
              "u2pl_tpu/ops/resize.py:76", bf_city["A_bwd"], bf_errs["A_bwd_city_bf16"],
              "A_bwd_city_bf16"),
        entry("upsample_ce_fwd_bf16", "C_fwd_bf16", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              bf("C_fwd"), bf_errs["C_fwd_bf16"], "C_fwd_bf16"),
        entry("upsample_ce_bwd_bf16", "C_bwd_bf16", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              bf("C_bwd"), bf_errs["C_bwd_bf16"], "C_bwd_bf16"),
        entry("upsample_softmax_stats_prob_bf16", "D_prob_bf16", "upsample_ce.cu",
              "u2pl_tpu/train/steps.py:300", bf("D_prob"), bf_errs["D_bf16"], "D_prob_bf16"),
        entry("upsample_softmax_stats_entropy_bf16", "D_entropy_bf16", "upsample_ce.cu",
              "u2pl_tpu/losses/unsup.py:24", bf("D_entropy"), bf_errs["D_bf16"],
              "D_entropy_bf16"),
        entry("ohem_target_prob_bf16", "K7_prob_bf16", "upsample_ce.cu",
              "u2pl_tpu/losses/ohem.py:66", bf_city["K7_prob_main"], bf_errs["K7_prob_bf16"],
              "K7_prob_bf16"),
        entry("ohem_target_prob_aux_bf16", "K7_prob_aux_bf16", "upsample_ce.cu",
              "u2pl_tpu/losses/ohem.py:66", bf_city["K7_prob_aux"], bf_errs["K7_prob_aux_bf16"],
              "K7_prob_aux_bf16"),
        entry("memobank_enqueue_bf16", "K5_bf16", "memobank.cu", "u2pl_tpu/memobank.py:92",
              bf("K5"), bf_errs["K5_bf16"], "K5_bf16"),
        entry("contra_infonce_fwd_bf16", "K6_fwd_bf16", "infonce.cu",
              "u2pl_tpu/losses/contrastive.py:168", bf("K6_fwd"), bf_errs["K6_fwd_bf16"],
              "K6_fwd_bf16"),
        # K6's forward with the (C, Q, F) anchor_ema positive: its launches on
        # phase 17's bf16 run, and the f32 mode's on that phase's f32 run;
        # each beside the per-class mode timed on the same inputs
        {**entry("contra_infonce_fwd_per_query", "K6_fwd_pq", "infonce.cu",
                 "u2pl_tpu/losses/contrastive.py:168", ema_f32_launches["K6_fwd_pq"],
                 errs["K6_fwd_pq"], "K6_fwd_pq"), "per_class_ms": pq_class["K6_fwd_pq"]},
        {**entry("contra_infonce_fwd_per_query_bf16", "K6_fwd_pq_bf16", "infonce.cu",
                 "u2pl_tpu/losses/contrastive.py:168", ema_launches["K6_fwd_pq"],
                 errs["K6_fwd_pq_bf16"], "K6_fwd_pq_bf16"),
         "per_class_ms": pq_class["K6_fwd_pq_bf16"]},
        {**entry("contra_infonce_bwd_bf16", "K6_bwd_bf16", "infonce.cu",
                 "u2pl_tpu/losses/contrastive.py:168", bf("K6_bwd"), bf_errs["K6_bwd_bf16"],
                 "K6_bwd_bf16"),
         # with no active position: the gradient's zero write alone
         "no_draws_ms": times["K6_bwd_bf16_no_draws"][0],
         "no_draws_library_ms": times["K6_bwd_bf16_no_draws"][2]},
        # phase 14's modes, with their launches on its bf16 serving, eval and
        # infer runs: B on bf16 logits (at the VOC and Cityscapes serving
        # shapes, the latter from its Cityscapes infer run), A bf16 in, f32 out
        entry("resize_argmax_ac_bf16", "B_bf16", "resize.cu", "u2pl_tpu/serving.py:115",
              inf_launches["B_bf16"] - inf_run["city_b"], bf_errs["B_bf16"], "B_bf16"),
        entry("resize_argmax_ac_cityscapes_bf16", "B_city_bf16", "resize.cu",
              "u2pl_tpu/serving.py:115", inf_run["city_b"], bf_errs["B_city_bf16"],
              "B_city_bf16"),
        entry("resize_bilinear_ac_bf16_to_f32", "A_bf16_f32", "resize.cu",
              "u2pl_tpu/ops/resize.py:217", inf_launches["A_bf16_f32"], bf_errs["A_bf16_f32"],
              "A_bf16_f32"),
        # K5's modes for several ranks (phase 15's times at the VOC bank, bf16
        # slabs into the bf16 bank, the enqueue at DIST_W ranks; each world's
        # in `by_world`), with their launches on phase 16's data-parallel runs
        entry("memobank_gather_bf16", "K5_gather_bf16", "memobank.cu",
              "u2pl_tpu/losses/contrastive.py:259",
              one_rank["K5_gather"] + two_ranks["K5_gather"], 0.0, "K5_gather_bf16"),
        {**entry("memobank_enqueue_slabs_bf16", "K5_slabs_bf16", "memobank.cu",
                 "u2pl_tpu/memobank.py:92", one_rank["K5_slabs"] + two_ranks["K5_slabs"], 0.0,
                 "K5_slabs_bf16"),
         "world": DIST_W, "by_world": {str(w): v for w, v in slab_worlds.items()}},
    ]}
    log(card)
    log(json.dumps(report))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
