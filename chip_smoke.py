#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (u2pl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure ends the run with a nonzero exit code:
  0. setup: the card's name and power limit, the kernels built from
     u2pl_tpu_torch/kernels/csrc with nvcc, and the yaml / PIL probe;
  1. each CUDA kernel against its plain PyTorch version at the serving
     path's shapes, on the card;
  2. the slice: the full VOC model of experiments/pascal/1464/ours (ResNet-101
     + DeepLabv3+, 21 classes, float32 as serve.py's default) from seeded
     random weights, saved as a reference-format .pth, loaded by InferEngine
     and driven through run_server with six JPEG requests; the served masks
     are checked against the plain-version path and both kernels' launch
     counts against zero;
  3. timings: the host's load and save per image, forwards at batch 1
     and 4, each kernel beside its plain version, peak device memory.
It prints a JSON line of kernels, then one JSON line
{"ok": true, "device": {...}} as the last line of its output.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def plain_decoder_resize():
    """Route the decoder's upsample through the plain version."""
    import u2pl_tpu_torch.models.decoder as decoder
    from u2pl_tpu_torch.ops.resize import resize_bilinear_plain

    saved = decoder.resize_bilinear
    decoder.resize_bilinear = resize_bilinear_plain
    try:
        yield
    finally:
        decoder.resize_bilinear = saved


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
    with torch.inference_mode(), plain_decoder_resize():
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
    with tempfile.TemporaryDirectory(prefix="u2pl_chip_smoke_") as tmp:
        engine, images, loaded, launches = phase2_slice(dev, card, tmp)
        times = phase3_timings(dev, card, engine, images, loaded, tmp)

    source = "u2pl_tpu_torch/kernels/csrc/resize.cu"
    report = {
        "kernels": [
            {
                "name": "resize_bilinear_ac", "route": "cuda", "source": source,
                "replaces": "u2pl_tpu/ops/resize.py:76", "launches": launches["A"],
                "max_abs_err": a_err, "ms": times["A_logits"][0],
                "plain_ms": times["A_logits"][1],
            },
            {
                "name": "resize_argmax_ac", "route": "cuda", "source": source,
                "replaces": "u2pl_tpu/serving.py:115", "launches": launches["B"],
                "max_abs_err": b_err, "ms": times["B"][0], "plain_ms": times["B"][1],
            },
        ]
    }
    log(card)
    log(json.dumps(report))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
