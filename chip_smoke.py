#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (u2pl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit code:
  0. setup: the card's name and power limit, the kernels built from
     u2pl_tpu_torch/kernels/csrc with nvcc, and the yaml / PIL probe;
  1. each CUDA kernel against its plain PyTorch version at the serving and
     training paths' shapes, on the card;
  2. the slice: the full VOC model of experiments/pascal/1464/ours (ResNet-101
     + DeepLabv3+, 21 classes, float32 as serve.py's default) from seeded
     random weights, saved as a reference-format .pth, loaded by InferEngine
     and driven through run_server with six JPEG requests; the served masks
     are checked against the plain-version path and both kernels' launch
     counts against zero;
  3. timings: the host's load and save per image, forwards at batch 1
     and 4, each kernel beside its plain version, peak device memory;
  4. the training slice: the same VOC config minus its `trainer.contrastive`
     block, full ResNet-101 student and EMA teacher from seeded random
     weights, 5 steps of 4 labeled + 4 unlabeled synthetic 513² images
     through `train.steps.run_steps` (2 warmup, 2 in the first semi epoch,
     1 in epoch 2), checked for finite losses, gradients reaching the ASPP
     and layer4, the teacher copy / EMA, teacher BN tracking and every
     training kernel's launch count; then step 5 again from a copy of the
     state, through the kernels and through the plain versions, compared;
  5. training timings: warmup and semi step medians, images/s, peak device
     memory, each training kernel beside its plain version;
  6. the contrastive slice: the full `ours` config WITH trainer.contrastive
     (a (21, 50000, 256) bf16 memory bank, 8192 keys per class and step,
     256 queries, 50 negatives), 5 steps through `run_steps` (2 warmup, 3
     semi), checked for finite losses, con_loss > 0 on every semi step, the
     bank's occupancy against the keys enqueued, a gradient reaching the
     representation head and every kernel's launch count; then step 5 again
     from a copy, through the kernels and through the plain versions,
     compared, and the contrastive loss on the step's own inputs, kernels
     against plain versions, its selections and bank bit-equal;
  7. contrastive timings: the contrastive semi step's median, images/s and
     peak memory, and each K4-K6 kernel beside its plain version and, where
     one exists, a single PyTorch call for the same function;
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
     and each OHEM kernel (K7) beside its plain version and a library call;
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
     kernels and through the plain versions, compared.
Phase 1 also holds the contrastive kernels (K4: pixel masks, key selection,
anchor draws; K5: the bank write; K6: the InfoNCE forward and backward)
against their plain versions at the flagship shapes, on a prefilled bank
that wraps, the OHEM kernels (K7: target-class probability, k-th
smallest, kept labels) at the Cityscapes heads' shapes, with the k-th value
above and below thresh, an all-ignored map and fewer valid pixels than
min_kept, and K3c (ClassMix) and K4r (radix key selection) bit-equal at the
flagship's shapes, with tied draws, a single-class sample, keys tied at the
threshold, valid 0xFFFFFFFF keys, a class under the cap and an empty one.
It prints a JSON line of kernels (each with its launches on the main paths,
its error against its plain version, its time beside the plain version's,
its bound and a library call's time), then one JSON line
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
A_SHAPES = [
    ((4, 21, 129, 129), (513, 513)),  # serving: os4 logits -> input scale
    ((2, 256, 65, 65), (129, 129)),  # decoder: os8 head -> os4
    ((2, 3, 97, 65), (513, 513)),
    ((2, 3, 7, 9), (33, 17)),
    ((2, 3, 1, 5), (4, 10)),
]
B_SHAPES = [
    ((21, 513, 513), (375, 500)),
    ((21, 513, 513), (500, 333)),
    ((21, 513, 513), (7, 9)),
]
# kernel A vs plain, max abs diff on randn inputs: the kernel rounds each
# product and sum, but the plain version's matmul may fuse and reorder them
A_TOL = 1e-5
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
    """Mean device ms per call of `fn` over `iters` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase1_kernels(dev):
    import torch

    from u2pl_tpu_torch.ops.resize import (
        resize_argmax, resize_argmax_plain, resize_bilinear, resize_bilinear_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    a_err = 0.0
    for shape, out in A_SHAPES:
        x = torch.randn(*shape, device=dev, generator=g)
        y = resize_bilinear(x, out)
        torch.cuda.synchronize()
        ref = resize_bilinear_plain(x, out)
        torch.cuda.synchronize()
        if y.shape != ref.shape:
            fail(f"kernel A {shape}->{out}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
        err = (y - ref).abs().max().item()
        log(f"[phase 1] kernel A {shape} -> {out}: max abs diff {err:.3e} (bound {A_TOL})")
        if not err <= A_TOL:
            fail(f"kernel A {shape}->{out}: max abs diff {err} > {A_TOL}")
        a_err = max(a_err, err)
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
        b_err = max(b_err, err)
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


def phase2_slice(dev, card, tmp):
    import numpy as np
    import torch
    from PIL import Image

    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.models import build_model
    from u2pl_tpu_torch.ops import resize as R
    from u2pl_tpu_torch.serving import InferEngine, run_server

    cfg = load_config(VOC_CONFIG)
    log(
        f"[phase 2] config {os.path.relpath(VOC_CONFIG, ROOT)}: "
        f"{cfg.net.encoder.type.rsplit('.', 1)[-1]} + "
        f"{cfg.net.decoder.type.rsplit('.', 1)[-1]}, {cfg.net.num_classes} classes, "
        f"multi_grid={cfg.net.encoder.multi_grid}, rep_head={cfg.net.decoder.rep_head}, "
        f"served in float32 (config dtype {cfg.net.dtype})"
    )
    t0 = time.monotonic()
    g = torch.Generator().manual_seed(SEED)
    model = build_model(cfg.net, device="cpu", generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    pth = os.path.join(tmp, "ckpt_best.pth")
    torch.save({"epoch": 0, "model_state": sd, "teacher_state": sd, "best_miou": 0.0}, pth)
    del model, sd
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
    R.resize_bilinear.launches = 0
    R.resize_argmax.launches = 0
    t0 = time.monotonic()
    served = run_server(
        io.StringIO("".join(r + "\n" for r in reqs)), writer, engine,
        default_save_folder=out, batch_window_s=0.5,
    )
    serve_s = time.monotonic() - t0
    launches = {"A": R.resize_bilinear.launches, "B": R.resize_argmax.launches}
    peak_serve = torch.cuda.max_memory_allocated(dev)
    engine.forward, engine.to_mask = forward, to_mask

    resp = [json.loads(line) for line in writer.getvalue().splitlines()]
    log(f"[phase 2] served {served} requests in {serve_s:.3f} s; batches {batches}; "
        f"launches A={launches['A']} B={launches['B']}")
    if [r["id"] for r in resp] != ["p0"] + [f"r{i}" for i in range(6)] + [None, "bye"]:
        fail(f"unexpected responses {resp}")
    if not (resp[0]["ok"] and resp[0]["served"] == 0 and resp[-1]["ok"]):
        fail(f"ping/shutdown responses {resp[0]} {resp[-1]}")
    if resp[7]["ok"] or "bad request" not in resp[7]["error"]:
        fail(f"malformed line answered {resp[7]}")
    if batches != [4, 2] or served != 6 or len(masks) != 6:
        fail(f"batches {batches}, served {served}, masks {len(masks)}")
    if launches["A"] <= 0 or launches["B"] <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
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

    # the same requests through the plain versions of both kernels
    loaded = [engine.load(p) for p in images]
    before = (R.resize_bilinear.launches, R.resize_argmax.launches)
    agreement = []
    with torch.inference_mode(), plain_versions():
        for i in range(0, len(loaded), 4):
            chunk = loaded[i : i + 4]
            x = torch.from_numpy(np.stack([img for img, _ in chunk])).to(dev)
            logits = engine.model(x.permute(0, 3, 1, 2).contiguous())["pred"]
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

    # the host's share of a request: decode + normalize + resize to 513²
    # (engine.load), and mask encoding (two PNG writes)
    load_ms, save_ms = [], []
    for path, (_, size) in zip(images, loaded):
        t0 = time.perf_counter()
        engine.load(path)
        load_ms.append((time.perf_counter() - t0) * 1e3)
        mask = np.zeros(size, np.uint8)
        t0 = time.perf_counter()
        engine.save_mask(mask, path, os.path.join(tmp, "timing"))
        save_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[host of the {card} machine] per image: load (decode, normalize, resize "
        f"to 513² in numpy) median {statistics.median(load_ms):.1f} ms, "
        f"save_mask median {statistics.median(save_ms):.1f} ms, over {len(images)} images")
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
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    times = {}  # name -> (kernel ms, plain ms, library ms or None)
    for name, (shape, out) in (("A_logits", A_SHAPES[0]), ("A_decoder", A_SHAPES[1])):
        x = torch.randn(*shape, device=dev, generator=g)
        k = cuda_ms(lambda: R.resize_bilinear(x, out))
        p = cuda_ms(lambda: R.resize_bilinear_plain(x, out))
        lib = cuda_ms(lambda: F.interpolate(x, size=out, mode="bilinear", align_corners=True))
        times[name] = (k, p, lib)
        log(f"[{card}] kernel A {shape} -> {out}: {k:.4f} ms; plain version {p:.4f} ms; "
            f"F.interpolate(bilinear, align_corners=True) {lib:.4f} ms")
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
    # A-bwd: the decoder's os8 -> os4 upsample and the logits' upsample
    worst = 0.0
    for shape, out in (((8, 256, 65, 65), (129, 129)), ((4, 21, 129, 129), (513, 513)),
                       ((2, 3, 33, 17), (7, 9))):
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

    # C forward and backward, ~10% of the labels ignored; all-ignored -> 0
    loss_err = grad_err = 0.0
    for shape, out in (((4, 21, 129, 129), (513, 513)), ((3, 5, 9, 7), (33, 25))):
        x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
        lab = torch.randint(0, shape[1], (shape[0],) + out, device=dev, generator=g,
                            dtype=torch.int32)
        lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
        loss = ce.upsample_cross_entropy(x, lab)
        (gx,) = torch.autograd.grad(loss, x)
        xp = x.detach().clone().requires_grad_(True)
        ref = ce.upsample_cross_entropy_plain(xp, lab)
        (gref,) = torch.autograd.grad(ref, xp)
        torch.cuda.synchronize()
        le_abs, ge_abs = abs(loss.item() - ref.item()), (gx - gref).abs().max().item()
        le, ge = le_abs / abs(ref.item()), ge_abs / gref.abs().max().item()
        log(f"[phase 1] kernel C {shape} -> {out}: loss {loss.item():.6f} vs plain "
            f"{ref.item():.6f}, rel diff {le:.3e} (bound {C_LOSS_TOL}); gradient max abs "
            f"diff / max |grad| {ge:.3e} (bound {C_GRAD_TOL})")
        if not (le <= C_LOSS_TOL and ge <= C_GRAD_TOL):
            fail(f"kernel C {shape}: loss {le}, gradient {ge}")
        loss_err, grad_err = max(loss_err, le_abs), max(grad_err, ge_abs)
    x = torch.randn(4, 21, 129, 129, device=dev, generator=g, requires_grad=True)
    lab = torch.full((4, 513, 513), 255, dtype=torch.int32, device=dev)
    loss = ce.upsample_cross_entropy(x, lab)
    (gx,) = torch.autograd.grad(loss, x)
    log(f"[phase 1] kernel C all ignored: loss {loss.item()}, gradient all zero "
        f"{not gx.any().item()} (must be 0 and True)")
    if loss.item() != 0.0 or gx.any().item():
        fail("kernel C: an all-ignored batch must give loss 0 and a zero gradient")
    errs["C_fwd"], errs["C_bwd"] = loss_err, grad_err

    # D: max-prob, argmax, entropy
    worst = 0.0
    for shape, out in (((4, 21, 129, 129), (513, 513)), ((3, 5, 9, 7), (33, 25))):
        x = torch.randn(*shape, device=dev, generator=g) * 3
        mp, am, ent = unsup.upsample_softmax_stats(x, out)
        rmp, ram, rent = unsup.upsample_softmax_stats_plain(x, out)
        top2 = R.resize_bilinear_plain(x, out).topk(2, dim=1).values
        near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE * top2[:, 0].abs().clamp(min=1.0)
        torch.cuda.synchronize()
        e_mp = ((mp - rmp).abs() / rmp.abs()).max().item()
        e_ent = ((ent - rent).abs() / rent.abs().clamp(min=1e-3)).max().item()
        bad = int(((am != ram) & ~near).sum())
        log(f"[phase 1] kernel D {shape} -> {out}: max-prob rel {e_mp:.3e}, entropy rel "
            f"{e_ent:.3e} (bound {D_TOL}); argmax {int((am != ram).sum())} mismatches, {bad} "
            f"outside the {int(near.sum())} near-tie pixels (bound 0)")
        if not (e_mp <= D_TOL and e_ent <= D_TOL and bad == 0):
            fail(f"kernel D {shape}: {e_mp} {e_ent} {bad}")
        worst = max(worst, (mp - rmp).abs().max().item(), (ent - rent).abs().max().item())
    errs["D"] = worst

    # E: bit-equal to the masked sort, 1,052,676 values (4 x 513²)
    pct = torch.tensor([0.0, 37.5, 80.0, 100.0], device=dev)
    n = B_U * CROP * CROP
    ent = torch.rand(n, device=dev, generator=g) * 3
    ent[: n // 4] = torch.randint(0, 9, (n // 4,), device=dev, generator=g).float() * 0.25
    valid = torch.rand(n, device=dev, generator=g) < 0.85
    one = torch.zeros(n, dtype=torch.bool, device=dev)
    one[n // 3] = True
    for name, v, m in (("1,052,676 values, ~85% valid, duplicates", ent, valid),
                       ("empty mask", ent, torch.zeros_like(valid)), ("n = 1", ent, one)):
        got = quantile.masked_percentiles(v, m, pct)
        ref = quantile.masked_percentiles_plain(v, m, pct)
        torch.cuda.synchronize()
        log(f"[phase 1] kernel E {name}: {got.tolist()} vs plain {ref.tolist()}; bit-equal "
            f"{torch.equal(got, ref)}")
        if not torch.equal(got, ref):
            fail(f"kernel E ({name}) is not bit-equal to the masked sort")
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
COUNTERS = {**TRAIN_COUNTERS, **CONTRA_COUNTERS, **OHEM_COUNTERS, **VARIANT_COUNTERS,
            **VAL_COUNTERS}


def _counter(name):
    import importlib

    mod, fn, attr = COUNTERS[name]
    return getattr(importlib.import_module(mod), fn), attr


def read_counters():
    return {k: getattr(*_counter(k)) for k in COUNTERS}


def zero_counters():
    for k in COUNTERS:
        setattr(*_counter(k), 0)


def scalars(metrics):
    """The 0-d metrics of a step as floats (neg_cand is per class)."""
    return {k: v.item() for k, v in metrics.items() if v.dim() == 0}


@contextlib.contextmanager
def plain_versions():
    """Route every kernel of the serving forward and the training step
    through its plain version."""
    import u2pl_tpu_torch.losses.ce as ce
    import u2pl_tpu_torch.losses.contrastive as contrastive
    import u2pl_tpu_torch.losses.unsup as unsup
    import u2pl_tpu_torch.memobank as memobank
    import u2pl_tpu_torch.losses.ohem as ohem
    import u2pl_tpu_torch.models.decoder as decoder
    import u2pl_tpu_torch.ops.mixing as mixing
    import u2pl_tpu_torch.ops.quantile as quantile
    from u2pl_tpu_torch.ops.resize import resize_bilinear_plain

    swaps = [
        (decoder, "resize_bilinear", resize_bilinear_plain),
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


def train_config():
    """The VOC `ours` config without its contrastive block (float32)."""
    from u2pl_tpu_torch.config import load_config

    cfg = load_config(VOC_CONFIG)
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


def both_routes(snapshot, run):
    """`run(state, route)` (one step, returning its metrics) on a copy of
    `snapshot` with dropout off, through the kernels and through the plain
    versions: {route: (metrics, the student's update per parameter, the
    state after)}.  Fails if the plain route launched a kernel."""
    import torch

    from u2pl_tpu_torch.models.decoder import Dropout2d

    runs = {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(snapshot)
        for mm in list(st.student.modules()) + list(st.teacher.modules()):
            if isinstance(mm, Dropout2d):
                mm.p = 0.0
        before = {a: p.detach().clone() for a, p in st.student.named_parameters()}
        counts = read_counters()
        with plain_versions() if route == "plain" else contextlib.nullcontext():
            m = run(st, route)
        torch.cuda.synchronize()
        if route == "plain" and read_counters() != counts:
            fail("the plain-version step launched a kernel")
        runs[route] = (m, {a: p.detach() - before[a] for a, p in st.student.named_parameters()}, st)
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
    log(f"[{card}] peak device memory over the {TRAIN_STEPS} training steps: "
        f"{peak / 2**30:.2f} GiB")

    # step 5 again from the snapshot, dropout off and the mix injected (coin
    # heads), through the kernels and through the plain versions
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, B_U, CROP, CROP))
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = both_routes(snapshot, lambda st, route: step(st, *batches[-1], mix=mix))
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
    for label, shape, out_hw in (("A_bwd_decoder", (8, 256, 65, 65), (129, 129)),
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
    lk, lp = ce.upsample_cross_entropy(x, lab), ce.upsample_cross_entropy_plain(x, lab)
    times["C_bwd"] = (cuda_ms(lambda: torch.autograd.grad(lk, x, retain_graph=True)),
                      cuda_ms(lambda: torch.autograd.grad(lp, x, retain_graph=True)), None)
    del lk, lp
    xd = x.detach()
    times["D"] = (cuda_ms(lambda: unsup.upsample_softmax_stats(xd, (CROP, CROP))),
                  cuda_ms(lambda: unsup.upsample_softmax_stats_plain(xd, (CROP, CROP))), None)
    ent = torch.rand(B_U, CROP, CROP, device=dev, generator=g)
    valid = torch.rand(B_U, CROP, CROP, device=dev, generator=g) < 0.85
    pct = torch.tensor([85.0], device=dev)
    times["E"] = (cuda_ms(lambda: quantile.masked_percentiles(ent, valid, pct)),
                  cuda_ms(lambda: quantile.masked_percentiles_plain(ent, valid, pct)), None)
    img = torch.randn(B_U, 3, CROP, CROP, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, B_U, CROP, CROP)
    lab_u = lab.clone()
    times["K3"] = (cuda_ms(lambda: mixing.generate_unsup_data(img, lab_u, ent, boxes, "cutmix")),
                   cuda_ms(lambda: mixing.generate_unsup_data_plain(img, lab_u, ent, boxes, "cutmix")),
                   None)
    shapes = {
        "A_bwd_decoder": "(8, 256, 129, 129) -> (8, 256, 65, 65)",
        "A_bwd_logits": "(4, 21, 513, 513) -> (4, 21, 129, 129)",
        "C_fwd": "(4, 21, 129, 129) -> 513², labels (4, 513, 513)",
        "C_bwd": "the same, backward to the os4 logits (incl. A-bwd)",
        "D": "(4, 21, 129, 129) -> 513²",
        "E": "1 percentile of (4, 513, 513), ~85% valid",
        "K3": "cutmix (4, 3, 513, 513) + label + max-prob",
    }
    for k, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; aten upsample_bilinear2d_backward {tl:.4f} ms"
        log(f"[{card}] kernel {k} {shapes[k]}: {tk:.4f} ms; plain version {tp:.4f} ms{lib}")
    return out, times


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
    prob = torch.softmax(4 * torch.randn(b, c, OS4, OS4, device=dev, generator=g), dim=1)
    labels = torch.randint(0, c, (b, OS4, OS4), device=dev, generator=g, dtype=torch.int32)
    labels[rand(b, OS4, OS4) < 0.6] = 0
    labels[rand(b, OS4, OS4) < 0.05] = 255
    low, high = rand(b, OS4, OS4) < 0.7, rand(b, OS4, OS4) < 0.5
    low[:B_L] = high[:B_L] = labels[:B_L] != 255
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

    runs = both_routes(snapshot, run)
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

    # the contrastive loss on the kernel route's own inputs, both ways:
    # selections, anchors and bank bit-equal, loss and gradient within K6's bounds
    args, bank0, kw = captured["kernels"]
    out = {}
    for route in ("kernels", "plain"):
        rep = args[0].clone().requires_grad_(True)
        with plain_versions() if route == "plain" else contextlib.nullcontext():
            bank, loss, info = original(rep, *args[1:8], clone_bank(bank0), *args[9:], **kw)
        (grad,) = torch.autograd.grad(loss, rep)
        out[route] = (loss.item(), grad, bank, info["neg_candidates"])
    torch.cuda.synchronize()
    (lk, gk, bk, ck), (lp, gp, bp, cp) = out["kernels"], out["plain"]
    same = all(torch.equal(getattr(bk, a), getattr(bp, a)) for a in ("keys", "ptr", "occupancy"))
    rel_l = abs(lk - lp) / max(abs(lp), 1e-30)
    rel_g = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
    log(f"[phase 6] the step's contrastive loss on identical inputs, kernels vs plain versions: "
        f"loss {lk:.6f} vs {lp:.6f} (rel {rel_l:.3e}, bound {K6_LOSS_TOL}); gradient "
        f"{rel_g:.3e} of its max (bound {K6_GRAD_TOL}); selections and bank bit-equal {same}; "
        f"neg_candidates equal {torch.equal(ck, cp)}")
    if not (same and torch.equal(ck, cp) and rel_l <= K6_LOSS_TOL and rel_g <= K6_GRAD_TOL):
        fail("the contrastive loss differs between the kernels and the plain versions")
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
    # the library yardstick of the backward: index_add_ of the anchors'
    # gradient rows into a zeroed (N, F) gradient (NHWC rows)
    b, f = rep.shape[:2]
    rows = case["anchor_idx"].flatten().long()
    src = torch.randn(rows.numel(), f, device=dev)
    times["K6_bwd"] = (
        cuda_ms(lambda: torch.autograd.grad(lk, rep, retain_graph=True), 20),
        cuda_ms(lambda: torch.autograd.grad(lp, rep, retain_graph=True), 20),
        cuda_ms(lambda: torch.zeros(b * OS4 * OS4, f, device=dev).index_add_(0, rows, src), 20),
    )
    del lk, lp
    shapes = {
        "K4_masks": f"prob {tuple(case['prob'].shape)} -> (21, N) masks",
        "K4_select": f"({neg.shape[0]}, {neg.shape[1]}), k {k}",
        "K4_anchors": f"({neg.shape[0]}, {neg.shape[1]}) x {case['u_anchor'].shape[1]} draws",
        "K5": f"{int(case['n_sel'].sum())} keys into {tuple(case['bank'].keys.shape)} bf16",
        "K6_fwd": f"{int(case['active'].sum())} positions x {case['u_anchor'].shape[1]} x "
                  f"(1 + {ccfg.num_negatives})",
        "K6_bwd": "the same, backward to the (8, 256, 129, 129) rep",
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
    if any(launches[a] != 2 * TRAIN_STEPS for a in OHEM_COUNTERS):
        fail(f"the OHEM kernels did not run on both heads of every step: {launches}")
    log(f"[{card}] peak device memory over the {TRAIN_STEPS} Cityscapes training steps: "
        f"{peak / 2**30:.2f} GiB")

    # step 5 again from the snapshot, dropout off, the mix and the
    # contrastive draws injected, through the kernels and the plain versions
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    mix = (torch.tensor(True, device=dev), mixing.draw_boxes(g, CITY_B, CITY_CROP, CITY_CROP))
    draws = draw_contrastive(g, cfg, 2 * CITY_B * CITY_OS4 * CITY_OS4)
    step = make_semi_step(cfg, STEPS_PER_EPOCH)
    runs = both_routes(snapshot, lambda st, route: step(st, *batches[-1], mix=mix, contra=draws))
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
    sup_cfg = load_config(CITY_SUP_CONFIG)
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

    from u2pl_tpu_torch.losses import ohem
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
    times = {
        "K7_prob": (cuda_ms(lambda: ohem.ohem_target_prob(x, lab)),
                    cuda_ms(lambda: ohem.ohem_target_prob_plain(x, lab)), None),
        "K7_kth": (cuda_ms(lambda: quantile.kth_smallest(p, k)),
                   cuda_ms(lambda: quantile.kth_smallest_plain(p, k)),
                   cuda_ms(lambda: torch.kthvalue(flat, k))),
        "K7_keep": (cuda_ms(lambda: ohem.ohem_keep_labels(lab, p, kth, nv, thresh, min_kept)),
                    cuda_ms(lambda: ohem.ohem_keep_labels_plain(lab, p, kth, nv, thresh, min_kept)),
                    None),
    }
    shapes = {
        "K7_prob": f"{tuple(x.shape)} -> {CITY_CROP}², labels {tuple(lab.shape)}",
        "K7_kth": f"k {k} of {p.numel()} p_y",
        "K7_keep": f"labels and p_y {tuple(lab.shape)}",
    }
    for name, (tk, tp, tl) in times.items():
        lib = "" if tl is None else f"; torch.kthvalue {tl:.4f} ms"
        log(f"[{card}] kernel {name} {shapes[name]}: {tk:.4f} ms; plain version {tp:.4f} ms{lib}")
    return {"semi_ms": med, "img_s": imgs * 1e3 / med, "peak": peak}, times


# phases 10 and 11: the trainer CLIs on a synthetic VOC-layout workspace
CLI_LABELED = CLI_UNLABELED = 16
CLI_VAL = 4
CLI_IMAGE = (375, 500)  # VOC's most common image size, (h, w)
# 4 steps per epoch of 4 + 4 images; 2 epochs, the first of them warmup
CLI_OVERRIDES = {"dataset.n_sup": 16, "dataset.pool_size": 32, "trainer.epochs": 2,
                 "trainer.sup_only_epoch": 1}
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


def run_cli(module, cfg_path):
    """`module.main` on the card (seed SEED), in process: (summary, the log
    lines, the launch counts of the run, counted from 0)."""
    import logging

    lines = []
    rec = logging.Handler()
    rec.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("global")
    logger.addHandler(rec)
    zero_counters()
    try:
        with random_init_allowed():
            summary = module.main(["--config", cfg_path, "--seed", str(SEED)])
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
                               size=CLI_IMAGE, seed=SEED)
    log(f"[phase 10] synthetic VOC workspace: {CLI_LABELED} labeled, {CLI_UNLABELED} unlabeled "
        f"and {CLI_VAL} val JPEG / PNG pairs of {CLI_IMAGE[1]}x{CLI_IMAGE[0]}, made in "
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
                            {"dataset.n_sup": 16, "trainer.epochs": 1})
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
    total = {a: launches[a] + res_launches[a] + sup_launches[a] for a in COUNTERS}
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

    runs = both_routes(before_last.pop("state"), run)
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


def bounds(case, cfg):
    """{kernel: (bound ms, "bytes" or "operations")}: the least time the card
    could take for each timed call, the larger of the bytes it must move
    over the HBM rate and its operations over the float32 peak, from the
    shapes (and, for K5 and K6, this run's selections) of the timed calls
    (K7's: phase 9's Cityscapes main head)."""
    c, n = case["pri"].shape
    ccfg = cfg.trainer.contrastive
    q, m, k = ccfg.num_queries, ccfg.num_negatives, ccfg.max_keys_per_class_per_step
    f, b, hw = 256, B_L + B_U, OS4 * OS4
    lo, hi = 4 * 21 * OS4 * OS4, 4 * 21 * CROP * CROP  # (4, 21) logits at os4 / 513²
    px = 4 * CROP * CROP
    cpx = CITY_B * CITY_CROP * CITY_CROP  # Cityscapes labels
    clo, chi = 19 * CITY_B * CITY_OS4 * CITY_OS4, 19 * cpx  # its 19-class logits, os4 / 769²
    sel = int(case["n_sel"].sum())
    act = int(case["active"].sum())
    # operations per upsampled value: 9 for the bilinear taps (6 products,
    # 3 sums), plus the softmax / CE / entropy terms the function needs
    moved = {  # kernel -> (bytes, float32 operations)
        "A": ((lo + hi) * 4, hi * 9),
        "B": (21 * CROP * CROP * 4 + 375 * 500, 21 * 375 * 500 * 10),
        "A_bwd": ((8 * 256 * 129 * 129 + 8 * 256 * 65 * 65) * 4, 8 * 256 * 129 * 129 * 9),
        "C_fwd": (lo * 4 + px * 4, hi * 11),
        "C_bwd": (2 * lo * 4 + px * 4, hi * 20),
        "D": (lo * 4 + px * 12, hi * 16),
        "E": (px * 5, 0),
        "K3": (2 * px * (12 + 4 + 4), 0),
        # K3c: K3's bytes and the (4, 21) draws
        "K3c": (2 * px * (12 + 4 + 4) + 4 * 21 * 4, 0),
        "K4_masks": (b * hw * (21 * 4 + 4 + 2) + c * n * 6, n * c * c),
        "K4_select": (c * n * 5 + c * k * 4, 0),
        "K4r": (c * n * 5 + c * k * 4 + c * 4, 0),  # mask + u32 keys in; idx + n_sel out
        "K4_anchors": (c * n + 2 * c * q * 4, 0),
        "K5": (sel * (f * 4 + 4 + f * 2), 0),
        "K6_fwd": (act * q * (f * 4 + m * (f * 2 + 4)) + act * f * 4, act * q * (m + 1) * f * 4),
        "K6_bwd": (b * f * hw * 4 + act * q * (f * 4 + 4), 0),
        # K7 at the Cityscapes main head, timed in phase 9: p_y from the os4
        # logits and the labels; k-th smallest: one read of p_y; kept labels
        "K7_prob": (clo * 4 + cpx * 8, chi * 11),
        "K7_kth": (cpx * 4, 0),
        "K7_keep": (cpx * 12, 0),
    }
    out = {}
    for name, (nbytes, ops) in moved.items():
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
        out[name] = (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")
    return out


def main() -> int:
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
    from u2pl_tpu_torch.config import load_config

    ccfg = load_config(VOC_CONFIG)  # the `ours` config as it stands, contrastive included
    contra_errs, case = phase1_contrastive_kernels(dev, ccfg)
    errs.update(contra_errs)
    k = ccfg.trainer.contrastive.max_keys_per_class_per_step
    variant_errs, variant_inputs = phase1_variant_kernels(dev, case["negative"], k)
    errs.update(variant_errs)
    variant_times = variant_timings(card, variant_inputs, k)
    del variant_inputs
    city_cfg = load_config(CITY_CONFIG)  # as it stands: OHEM, aux head, contrastive
    errs.update(phase1_ohem_kernels(dev, city_cfg))
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_") as tmp:
        engine, images, loaded, launches = phase2_slice(dev, card, tmp)
        times = phase3_timings(dev, card, engine, images, loaded, tmp)
    del engine, images, loaded
    state, batches, train_launches, _ = phase4_training(dev, card)
    _, train_times = phase5_train_timings(dev, card, state, batches)
    del state, batches
    state, batches, contra_launches, _ = phase6_contrastive(dev, card, ccfg)
    _, contra_times = phase7_contrastive_timings(dev, card, ccfg, state, batches, case)
    del state, batches
    torch.cuda.empty_cache()
    state, batches, city_launches, _ = phase8_cityscapes(dev, card, city_cfg)
    _, city_times = phase9_city_timings(dev, card, city_cfg, state, batches)
    del state, batches
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_cli_") as tmp:
        paths, cli_launches, _ = phase10_cli(dev, card, tmp)
        variant_launches, _ = phase11_variant(dev, card, tmp, paths)
    bound = bounds(case, ccfg)

    csrc = "u2pl_tpu_torch/kernels/csrc/"
    times.update(train_times)
    times.update(contra_times)
    times.update(city_times)
    times.update(variant_times)

    def entry(name, key, source, replaces, launches_, err, timing):
        ms, plain_ms, library_ms = times[timing]
        bound_ms, bound_by = bound[key]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    # launches: each path's run counted from 0 just before it (serving,
    # training without and with the contrastive branch, Cityscapes
    # training, the CLIs' runs and the classmix + radix run), summed per kernel
    def runs(key):
        return (train_launches[key] + contra_launches[key] + city_launches[key]
                + cli_launches[key] + variant_launches[key])

    report = {"kernels": [
        entry("resize_bilinear_ac", "A", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              launches["A"] + runs("A"), a_err, "A_logits"),
        entry("resize_argmax_ac", "B", "resize.cu", "u2pl_tpu/serving.py:115",
              launches["B"] + runs("B"), b_err, "B"),
        entry("resize_bilinear_ac_bwd", "A_bwd", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              runs("A_bwd"), errs["A_bwd"], "A_bwd_decoder"),
        entry("upsample_ce_fwd", "C_fwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              runs("C_fwd"), errs["C_fwd"], "C_fwd"),
        entry("upsample_ce_bwd", "C_bwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              runs("C_bwd"), errs["C_bwd"], "C_bwd"),
        entry("upsample_softmax_stats", "D", "upsample_ce.cu", "u2pl_tpu/losses/unsup.py:24",
              runs("D"), errs["D"], "D"),
        entry("masked_percentiles", "E", "quantile.cu", "u2pl_tpu/ops/quantile.py:136",
              runs("E"), errs["E"], "E"),
        entry("unsup_mix_boxes", "K3", "mixing.cu", "u2pl_tpu/ops/mixing.py:62",
              runs("K3"), errs["K3"], "K3"),
        entry("unsup_class_mix", "K3c", "mixing.cu", "u2pl_tpu/ops/mixing.py:44",
              runs("K3c"), errs["K3c"], "K3c"),
        entry("contra_pixel_masks", "K4_masks", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:50", runs("K4_masks"),
              errs["K4_masks"], "K4_masks"),
        entry("select_keys", "K4_select", "contrastive.cu", "u2pl_tpu/losses/contrastive.py:89",
              runs("K4_select"), errs["K4_select"], "K4_select"),
        entry("select_keys_radix", "K4r", "contrastive.cu", "u2pl_tpu/losses/contrastive.py:106",
              runs("K4r"), errs["K4r"], "K4r"),
        entry("sample_anchors", "K4_anchors", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:73", runs("K4_anchors"),
              errs["K4_anchors"], "K4_anchors"),
        entry("memobank_enqueue", "K5", "memobank.cu", "u2pl_tpu/memobank.py:92",
              runs("K5"), errs["K5"], "K5"),
        entry("contra_infonce_fwd", "K6_fwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              runs("K6_fwd"), errs["K6_fwd"], "K6_fwd"),
        entry("contra_infonce_bwd", "K6_bwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              runs("K6_bwd"), errs["K6_bwd"], "K6_bwd"),
        entry("ohem_target_prob", "K7_prob", "ohem.cu", "u2pl_tpu/losses/ohem.py:66",
              city_launches["K7_prob"], errs["K7_prob"], "K7_prob"),
        entry("kth_smallest", "K7_kth", "quantile.cu", "u2pl_tpu/losses/ohem.py:35",
              city_launches["K7_kth"], errs["K7_kth"], "K7_kth"),
        entry("ohem_keep_labels", "K7_keep", "ohem.cu", "u2pl_tpu/losses/ohem.py:76",
              city_launches["K7_keep"], errs["K7_keep"], "K7_keep"),
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
