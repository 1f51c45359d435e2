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
     memory, each training kernel beside its plain version.
It prints a JSON line of kernels, then one JSON line
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
    times = {}
    for name, (shape, out) in (("A_logits", A_SHAPES[0]), ("A_decoder", A_SHAPES[1])):
        x = torch.randn(*shape, device=dev, generator=g)
        k = cuda_ms(lambda: R.resize_bilinear(x, out))
        p = cuda_ms(lambda: R.resize_bilinear_plain(x, out))
        times[name] = (k, p)
        log(f"[{card}] kernel A {shape} -> {out}: {k:.4f} ms; plain version {p:.4f} ms")
    logits = torch.randn(21, 513, 513, device=dev, generator=g)
    k = cuda_ms(lambda: R.resize_argmax(logits, (375, 500)))
    p = cuda_ms(lambda: R.resize_argmax_plain(logits, (375, 500)))
    times["B"] = (k, p)
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


def _counter(name):
    import importlib

    mod, fn, attr = TRAIN_COUNTERS[name]
    return getattr(importlib.import_module(mod), fn), attr


def read_counters():
    return {k: getattr(*_counter(k)) for k in TRAIN_COUNTERS}


def zero_counters():
    for k in TRAIN_COUNTERS:
        setattr(*_counter(k), 0)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel of the serving forward and the training step
    through its plain version."""
    import u2pl_tpu_torch.losses.ce as ce
    import u2pl_tpu_torch.losses.unsup as unsup
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
        history.append((i_iter, {k: v.item() for k, v in m.items()}, same))
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
    missing = [k for k, v in launches.items() if v <= 0]
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
        runs[route] = ({k: v.item() for k, v in m.items()}, delta, read_counters() != counts)
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
        times[label] = (cuda_ms(lambda: R.resize_bilinear_bwd(gy, shape[2:]), 20),
                        cuda_ms(lambda: R.resize_bilinear_bwd_plain(gy, shape[2:]), 20))
        del gy
    x = torch.randn(4, 21, 129, 129, device=dev, generator=g, requires_grad=True)
    lab = torch.randint(0, 21, (4, CROP, CROP), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    with torch.no_grad():
        times["C_fwd"] = (cuda_ms(lambda: ce.upsample_cross_entropy(x, lab)),
                          cuda_ms(lambda: ce.upsample_cross_entropy_plain(x, lab)))
    lk, lp = ce.upsample_cross_entropy(x, lab), ce.upsample_cross_entropy_plain(x, lab)
    times["C_bwd"] = (cuda_ms(lambda: torch.autograd.grad(lk, x, retain_graph=True)),
                      cuda_ms(lambda: torch.autograd.grad(lp, x, retain_graph=True)))
    del lk, lp
    xd = x.detach()
    times["D"] = (cuda_ms(lambda: unsup.upsample_softmax_stats(xd, (CROP, CROP))),
                  cuda_ms(lambda: unsup.upsample_softmax_stats_plain(xd, (CROP, CROP))))
    ent = torch.rand(B_U, CROP, CROP, device=dev, generator=g)
    valid = torch.rand(B_U, CROP, CROP, device=dev, generator=g) < 0.85
    pct = torch.tensor([85.0], device=dev)
    times["E"] = (cuda_ms(lambda: quantile.masked_percentiles(ent, valid, pct)),
                  cuda_ms(lambda: quantile.masked_percentiles_plain(ent, valid, pct)))
    img = torch.randn(B_U, 3, CROP, CROP, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, B_U, CROP, CROP)
    lab_u = lab.clone()
    times["K3"] = (cuda_ms(lambda: mixing.generate_unsup_data(img, lab_u, ent, boxes, "cutmix")),
                   cuda_ms(lambda: mixing.generate_unsup_data_plain(img, lab_u, ent, boxes, "cutmix")))
    shapes = {
        "A_bwd_decoder": "(8, 256, 129, 129) -> (8, 256, 65, 65)",
        "A_bwd_logits": "(4, 21, 513, 513) -> (4, 21, 129, 129)",
        "C_fwd": "(4, 21, 129, 129) -> 513², labels (4, 513, 513)",
        "C_bwd": "the same, backward to the os4 logits (incl. A-bwd)",
        "D": "(4, 21, 129, 129) -> 513²",
        "E": "1 percentile of (4, 513, 513), ~85% valid",
        "K3": "cutmix (4, 3, 513, 513) + label + max-prob",
    }
    for k, (tk, tp) in times.items():
        log(f"[{card}] kernel {k} {shapes[k]}: {tk:.4f} ms; plain version {tp:.4f} ms")
    return out, times


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
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_") as tmp:
        engine, images, loaded, launches = phase2_slice(dev, card, tmp)
        times = phase3_timings(dev, card, engine, images, loaded, tmp)
    del engine, images, loaded
    state, batches, train_launches, _ = phase4_training(dev, card)
    _, train_times = phase5_train_timings(dev, card, state, batches)

    csrc = "u2pl_tpu_torch/kernels/csrc/"

    def entry(name, source, replaces, launches_, err, ms):
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1]}

    # kernel A is on both paths: its launches are the serving run's plus the
    # training run's, each counted from 0 just before that run
    report = {"kernels": [
        entry("resize_bilinear_ac", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              launches["A"] + train_launches["A"], a_err, times["A_logits"]),
        entry("resize_argmax_ac", "resize.cu", "u2pl_tpu/serving.py:115",
              launches["B"], b_err, times["B"]),
        entry("resize_bilinear_ac_bwd", "resize.cu", "u2pl_tpu/ops/resize.py:76",
              train_launches["A_bwd"], errs["A_bwd"], train_times["A_bwd_decoder"]),
        entry("upsample_ce_fwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              train_launches["C_fwd"], errs["C_fwd"], train_times["C_fwd"]),
        entry("upsample_ce_bwd", "upsample_ce.cu", "u2pl_tpu/losses/ce.py:23",
              train_launches["C_bwd"], errs["C_bwd"], train_times["C_bwd"]),
        entry("upsample_softmax_stats", "upsample_ce.cu", "u2pl_tpu/losses/unsup.py:24",
              train_launches["D"], errs["D"], train_times["D"]),
        entry("masked_percentiles", "quantile.cu", "u2pl_tpu/ops/quantile.py:136",
              train_launches["E"], errs["E"], train_times["E"]),
        entry("unsup_mix_boxes", "mixing.cu", "u2pl_tpu/ops/mixing.py:62",
              train_launches["K3"], errs["K3"], train_times["K3"]),
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
