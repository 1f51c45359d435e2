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
     one exists, a single PyTorch call for the same function.
Phase 1 also holds the contrastive kernels (K4: pixel masks, key selection,
anchor draws; K5: the bank write; K6: the InfoNCE forward and backward)
against their plain versions at the flagship shapes, on a prefilled bank
that wraps.
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
    for mode in mixing.MODES:
        got = mixing.generate_unsup_data(img, lab, prob, boxes, mode)
        ref = mixing.generate_unsup_data_plain(img, lab, prob, boxes, mode)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"[phase 1] kernel K3 {mode} {tuple(img.shape)}, boxes {boxes.tolist()}: bit-equal {same}")
        if not same:
            fail(f"kernel K3 ({mode}) is not bit-equal to its plain version")
    errs["K3"] = 0.0
    return errs


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
COUNTERS = {**TRAIN_COUNTERS, **CONTRA_COUNTERS}


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
    import u2pl_tpu_torch.models.decoder as decoder
    import u2pl_tpu_torch.ops.mixing as mixing
    import u2pl_tpu_torch.ops.quantile as quantile
    from u2pl_tpu_torch.ops.resize import resize_bilinear_plain

    swaps = [
        (decoder, "resize_bilinear", resize_bilinear_plain),
        (ce, "upsample_cross_entropy", ce.upsample_cross_entropy_plain),
        (unsup, "upsample_cross_entropy", ce.upsample_cross_entropy_plain),
        (unsup, "upsample_softmax_stats", unsup.upsample_softmax_stats_plain),
        (quantile, "masked_percentiles", quantile.masked_percentiles_plain),
        (mixing, "generate_unsup_data", mixing.generate_unsup_data_plain),
        (contrastive, "contra_pixel_masks", contrastive.contra_pixel_masks_plain),
        (contrastive, "select_keys", contrastive.select_keys_plain),
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


def synthetic_batches(dev, n):
    """n batches of (4 labeled, their labels, 4 unlabeled) 513² images, made
    from SEED with numpy: smooth colour fields with noise, normalised like
    the dataset; labels quantise the first channel into the 21 classes, ~5%
    of them 255."""
    import numpy as np
    import torch

    from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

    rng = np.random.RandomState(SEED + 3)

    def images(b):
        x = np.stack([resize_bilinear_numpy(rng.randn(9, 9, 3).astype(np.float32), (CROP, CROP))
                      for _ in range(b)])
        x = (x + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        return x

    out = []
    for _ in range(n):
        img_l, img_u = images(B_L), images(B_U)
        lab = np.clip(((img_l[..., 0] + 2.5) * 21 / 5).astype(np.int32), 0, 20)
        lab[rng.rand(*lab.shape) < 0.05] = 255
        to = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dev)  # noqa: E731
        out.append((to(img_l), torch.from_numpy(lab).to(dev), to(img_u)))
    return out


def _params_equal(a, b):
    import torch

    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def phase4_training(dev, card):
    import torch

    from u2pl_tpu_torch.models.decoder import Dropout2d
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
    runs = {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(snapshot)
        for mm in list(st.student.modules()) + list(st.teacher.modules()):
            if isinstance(mm, Dropout2d):
                mm.p = 0.0
        before = {k: p.detach().clone() for k, p in st.student.named_parameters()}
        counts = read_counters()
        with plain_versions() if route == "plain" else contextlib.nullcontext():
            m = step(st, *batches[-1], mix=mix)
        torch.cuda.synchronize()
        delta = {k: p.detach() - before[k] for k, p in st.student.named_parameters()}
        runs[route] = (scalars(m), delta, read_counters() != counts)
        del st
    (mk, dk, _), (mp, dp, launched) = runs["kernels"], runs["plain"]
    if launched:
        fail("the plain-version step launched a kernel")
    rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in ("sup_loss", "uns_loss", "drop_thresh")}
    diff = {k: (dk[k] - dp[k]).norm().item() for k in dp}
    norm = {k: dp[k].norm().item() for k in dp}
    upd = {k: diff[k] / max(norm[k], 1e-30) for k in dp}
    over = {k: diff[k] / (STEP_UPDATE_TOL * norm[k] + STEP_UPDATE_FLOOR * dp[k].numel() ** 0.5)
            for k in dp}
    worst = sorted(upd.items(), key=lambda kv: -kv[1])[:3]
    tight = sorted(over.items(), key=lambda kv: -kv[1])[:3]
    log(f"[phase 4] step {TRAIN_STEPS} again, kernels vs plain versions: kernels {mk}; plain "
        f"{mp}; rel diffs {rel} (bound {STEP_LOSS_TOL}); per-tensor update L2 diff / L2: median "
        f"{statistics.median(upd.values()):.3e}, largest {[(k, v, norm[k]) for k, v in worst]} "
        f"(bound {STEP_UPDATE_TOL} of the update + {STEP_UPDATE_FLOOR} RMS; closest to it, as a "
        f"share of the bound: {tight})")
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


def phase6_contrastive(dev, card, cfg):
    import torch

    import u2pl_tpu_torch.losses.contrastive as contrastive
    from u2pl_tpu_torch.memobank import clone_bank
    from u2pl_tpu_torch.models.decoder import Dropout2d
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
    missing = [name for name, v in launches.items() if v <= 0]
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
    runs, captured = {}, {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(snapshot)
        for mm in list(st.student.modules()) + list(st.teacher.modules()):
            if isinstance(mm, Dropout2d):
                mm.p = 0.0
        before = {a: p.detach().clone() for a, p in st.student.named_parameters()}
        counts = read_counters()

        def capture(*args, _route=route, **kw):
            captured[_route] = ([a.detach().clone() if torch.is_tensor(a) else a for a in args],
                                clone_bank(args[8]), kw)
            return original(*args, **kw)

        contrastive.compute_contra_memobank_loss = capture
        try:
            with plain_versions() if route == "plain" else contextlib.nullcontext():
                m = step(st, *batches[-1], mix=mix, contra=draws)
        finally:
            contrastive.compute_contra_memobank_loss = original
        torch.cuda.synchronize()
        delta = {a: p.detach() - before[a] for a, p in st.student.named_parameters()}
        runs[route] = (scalars(m), m["neg_cand"].tolist(), delta, read_counters() != counts, st.bank)
        del st
    (mk, nk, dk, _, bk), (mp, np_, dp, launched, bp) = runs["kernels"], runs["plain"]
    if launched:
        fail("the plain-version step launched a kernel")
    names = ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "low_thresh", "high_thresh")
    rel = {a: abs(mk[a] - mp[a]) / max(abs(mp[a]), 1e-30) for a in names}
    (ak, _, _), (ap, _, _) = captured["kernels"], captured["plain"]
    discrete = {"labels": sum(int((ak[i] != ap[i]).sum()) for i in (1, 2)),
                "masks": sum(int((ak[i] != ap[i]).sum()) for i in (5, 6))}
    diff = {a: (dk[a] - dp[a]).norm().item() for a in dp}
    norm = {a: dp[a].norm().item() for a in dp}
    over = {a: diff[a] / (STEP_UPDATE_TOL * norm[a] + STEP_UPDATE_FLOOR * dp[a].numel() ** 0.5)
            for a in dp}
    tight = sorted(over.items(), key=lambda kv: -kv[1])[:3]
    log(f"[phase 6] step {TRAIN_STEPS} again, kernels vs plain versions: kernels {mk}; plain {mp}; "
        f"rel diffs {rel}; neg_cand {nk} vs {np_}; the loss's inputs: {discrete} label / mask "
        f"pixels differ, teacher softmax max abs diff "
        f"{(ak[3] - ap[3]).abs().max().item():.3e}; bank occupancy equal "
        f"{torch.equal(bk.occupancy, bp.occupancy)}; update closest to the bound, as a share of "
        f"it: {tight}")
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


def bounds(case, cfg):
    """{kernel: (bound ms, "bytes" or "operations")}: the least time the card
    could take for each timed call, the larger of the bytes it must move
    over the HBM rate and its operations over the float32 peak, from the
    shapes (and, for K5 and K6, this run's selections) of the timed calls."""
    c, n = case["pri"].shape
    ccfg = cfg.trainer.contrastive
    q, m, k = ccfg.num_queries, ccfg.num_negatives, ccfg.max_keys_per_class_per_step
    f, b, hw = 256, B_L + B_U, OS4 * OS4
    lo, hi = 4 * 21 * OS4 * OS4, 4 * 21 * CROP * CROP  # (4, 21) logits at os4 / 513²
    px = 4 * CROP * CROP
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
        "K4_masks": (b * hw * (21 * 4 + 4 + 2) + c * n * 6, n * c * c),
        "K4_select": (c * n * 5 + c * k * 4, 0),
        "K4_anchors": (c * n + 2 * c * q * 4, 0),
        "K5": (sel * (f * 4 + 4 + f * 2), 0),
        "K6_fwd": (act * q * (f * 4 + m * (f * 2 + 4)) + act * f * 4, act * q * (m + 1) * f * 4),
        "K6_bwd": (b * f * hw * 4 + act * q * (f * 4 + 4), 0),
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
    bound = bounds(case, ccfg)

    csrc = "u2pl_tpu_torch/kernels/csrc/"
    times.update(train_times)
    times.update(contra_times)

    def entry(name, key, source, replaces, launches_, err, timing):
        ms, plain_ms, library_ms = times[timing]
        bound_ms, bound_by = bound[key]
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    # launches: each path's run counted from 0 just before it (serving,
    # training without and with the contrastive branch), summed per kernel
    def runs(key):
        return train_launches[key] + contra_launches[key]

    report = {"kernels": [
        entry("resize_bilinear_ac", "A", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              launches["A"] + runs("A"), a_err, "A_logits"),
        entry("resize_argmax_ac", "B", "resize.cu", "u2pl_tpu/serving.py:115",
              launches["B"], b_err, "B"),
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
        entry("contra_pixel_masks", "K4_masks", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:50", contra_launches["K4_masks"],
              errs["K4_masks"], "K4_masks"),
        entry("select_keys", "K4_select", "contrastive.cu", "u2pl_tpu/losses/contrastive.py:89",
              contra_launches["K4_select"], errs["K4_select"], "K4_select"),
        entry("sample_anchors", "K4_anchors", "contrastive.cu",
              "u2pl_tpu/losses/contrastive.py:73", contra_launches["K4_anchors"],
              errs["K4_anchors"], "K4_anchors"),
        entry("memobank_enqueue", "K5", "memobank.cu", "u2pl_tpu/memobank.py:92",
              contra_launches["K5"], errs["K5"], "K5"),
        entry("contra_infonce_fwd", "K6_fwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              contra_launches["K6_fwd"], errs["K6_fwd"], "K6_fwd"),
        entry("contra_infonce_bwd", "K6_bwd", "infonce.cu", "u2pl_tpu/losses/contrastive.py:168",
              contra_launches["K6_bwd"], errs["K6_bwd"], "K6_bwd"),
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
