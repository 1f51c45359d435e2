"""Times the launch plans of kernel A and K6's backward around the ones the
host picks, on one card, to show why they are picked:

    python -m u2pl_tpu_torch.kernels.plan_sweep

- kernel A at the 3-plane images (the VOC and Cityscapes request images,
  VOC eval's image at scales 0.75 and 1.25): the direct kernel (the plan
  `ops/resize.py:_fwd_plan` gives them), the band plan and bands of 1, 2
  and 4 rows, beside F.interpolate; then (1, P, 129²) -> 513² for P from 1
  to 21 planes and 84, the direct kernel beside the band plan (the switch
  is at FWD_BLOCKS_PER_SM blocks an SM);
- K6's backward at the flagship (timing_ab.py's K6_bwd inputs: a (8, 256,
  129²) rep, 21 x 256 draws from 2000 pixels a position, the last
  position inactive), bf16 with the directions' negatives' parts apart
  and f32, at tiles of 380, 508 (`losses/contrastive.py:_infonce_bwd_tile`'s
  pick there) and 636 pixels, with and without draws, and with every draw
  of a position on one pixel (256-draw segments);
- kernel A's bf16 wide branch at the decoders' (8, 256, 65²) -> 129² and
  (4, 256, 97²) -> 193²: the exact 2x kernel (the plan `_fwd_plan` gives
  them) beside the band plan;
- kernel C's backward in bf16 at the step's shapes (timing_ab.py's C_bwd
  bf16 inputs: VOC (4, 21, 129²) -> 513², the Cityscapes main and aux
  heads on OHEM's kept labels), through autograd: class groups of 3 and 4,
  bands of half, one less, one more and twice the picked rows and steps of
  2 to 4 output rows, around `losses/ce.py:_bwd_plan`'s pick (the faster
  of two timings each); the picked plan in f32 too.

Each result is bit-checked against the picked plan's.  Times are device ms
per call (timing_ab.py's `cuda_ms`); it prints the card's name and power
limit, one line per case, and a JSON line of them all.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA card", file=sys.stderr)
        return 1
    from u2pl_tpu_torch.kernels.timing_ab import cuda_ms
    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.ops import resize as R

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card, "A": {}, "K6_bwd": {}}
    picked = R._fwd_plan
    sms = R._sm_count(dev)

    def time_plan(x, size, plan):
        R._fwd_plan = lambda *a: plan
        try:
            return cuda_ms(lambda: R.resize_bilinear(x, size), 100), R.resize_bilinear(x, size)
        finally:
            R._fwd_plan = picked

    for shape, size in (((1, 3, 375, 500), (513, 513)), ((1, 3, 1024, 2048), (769, 769)),
                        ((1, 3, 375, 500), (281, 375)), ((1, 3, 375, 500), (469, 625))):
        x = torch.randn(*shape, device=dev, generator=g)
        want = R.resize_bilinear(x, size)
        band = picked(3, *shape[2:], *size, 0)  # the band plan, whatever the SM count
        row = {"picked": picked(3, *shape[2:], *size, sms),
               "F.interpolate": cuda_ms(lambda: F.interpolate(
                   x, size=size, mode="bilinear", align_corners=True), 100)}
        bands = [R.FwdPlan(R.FWD_BAND, r, -(-size[0] // r)) for r in (1, 2, 4) if r != band.rows]
        for plan in [R.FwdPlan(R.FWD_DIRECT), band] + bands:
            ms, y = time_plan(x, size, plan)
            if not torch.equal(y, want):
                print(f"plan_sweep: kernel A {shape} -> {size} at {plan} differs", file=sys.stderr)
                return 1
            row[str(plan)] = ms
        out["A"][f"{shape}->{size}"] = row
        print(f"A {shape} -> {size}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
            flush=True)
        del x, want
    for planes in (1, 3, 6, 9, 12, 21, 84):
        x = torch.randn(1, planes, 129, 129, device=dev, generator=g)
        band = picked(planes, 129, 129, 513, 513, 0)
        direct, yd = time_plan(x, (513, 513), R.FwdPlan(R.FWD_DIRECT))
        banded, yb = time_plan(x, (513, 513), band)
        if not torch.equal(yd, yb):
            print(f"plan_sweep: kernel A at {planes} planes: direct and bands differ",
                  file=sys.stderr)
            return 1
        out["A"][f"(1, {planes}, 129, 129)->(513, 513)"] = {
            "picked": picked(planes, 129, 129, 513, 513, sms), "direct": direct,
            str(band): banded}
        print(f"A (1, {planes}, 129²) -> 513²: direct {direct:.4f}, band {band} {banded:.4f}, "
              f"picked {picked(planes, 129, 129, 513, 513, sms)}", flush=True)
        del x, yd, yb

    b, c, hw, q = 8, 21, 129 * 129, 256
    pools = torch.stack([torch.randperm(b * hw, device=dev, generator=g)[:2000] for _ in range(c)])
    spread = pools.gather(1, torch.randint(0, 2000, (c, q), device=dev, generator=g))
    layouts = {"draws": spread.to(torch.int32).contiguous(),
               "one_pixel": pools[:, :1].expand(c, q).to(torch.int32).contiguous()}
    active = torch.arange(c, device=dev) < c - 1
    valid_seg = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    one = torch.ones((), device=dev)
    shape = (b, 256, 129, 129)
    tile_of = tc._infonce_bwd_tile
    for dtype in (torch.bfloat16, torch.float32):
        gdir = torch.randn(*((2,) if dtype == torch.bfloat16 else ()), c, q, 256, device=dev,
                           generator=g)
        want = {k: tc._infonce_bwd_cuda(idx, active, valid_seg, gdir, one, shape, dtype)
                for k, idx in layouts.items()}
        for tile in (380, 508, 636):
            tc._infonce_bwd_tile = lambda pixels, sms_, tile=tile: tile
            row = {}
            try:
                for name, idx, act in (("draws", layouts["draws"], active),
                                       ("no_draws", layouts["draws"], torch.zeros_like(active)),
                                       ("one_pixel", layouts["one_pixel"], active)):
                    fn = lambda: tc._infonce_bwd_cuda(  # noqa: E731
                        idx, act, valid_seg, gdir, one, shape, dtype)
                    if name in want and not torch.equal(fn(), want[name]):
                        print(f"plan_sweep: K6 bwd {dtype} tile {tile} {name} differs",
                              file=sys.stderr)
                        return 1
                    row[name] = cuda_ms(fn, 50)
            finally:
                tc._infonce_bwd_tile = tile_of
            key = f"{str(dtype).replace('torch.', '')} tile {tile}"
            out["K6_bwd"][key] = row
            print(f"K6 bwd {key} (picked {tile_of(b * hw, sms)}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    out["A_wide"] = {}
    for shape, size in (((8, 256, 65, 65), (129, 129)), ((4, 256, 97, 97), (193, 193))):
        x = (3 * torch.randn(*shape, device=dev, generator=g)).to(torch.bfloat16)
        want = R.resize_bilinear(x, size)
        row = {"picked": picked(shape[0] * shape[1], *shape[2:], *size, sms, 2)}
        for plan in (R.FwdPlan(R.FWD_WIDE_2X), picked(shape[0] * shape[1], *shape[2:], *size, sms)):
            ms, y = time_plan(x, size, plan)
            if not torch.equal(y, want):
                print(f"plan_sweep: kernel A bf16 {shape} at {plan} differs", file=sys.stderr)
                return 1
            row[str(plan)] = ms
        out["A_wide"][f"{shape}->{size}"] = row
        print(f"A bf16 wide {shape} -> {size}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
        del x, want
    if sweep_c_bwd(dev, g, out):
        return 1
    print(json.dumps(out), flush=True)
    return 0


def sweep_c_bwd(dev, g, out) -> int:
    """Kernel C's backward in bf16 at the step's shapes, plans around the
    picked one, each bit-checked against it (1 if one differs)."""
    from u2pl_tpu_torch.kernels.timing_ab import cuda_ms
    from u2pl_tpu_torch.losses import ce, ohem
    from u2pl_tpu_torch.ops import resize as R

    bf = torch.bfloat16
    sms = R._sm_count(dev)
    picked = ce._bwd_plan

    def head(hw, block):  # timing_ab.py's ohem_inputs, bf16 logits, kept labels
        cells = torch.randint(0, 19, (2, -(-hw // block), -(-hw // block)), device=dev,
                              generator=g, dtype=torch.int32)
        lab_s = R.resize_nearest(cells, (hw, hw))
        onehot = F.one_hot(lab_s.long(), 19).permute(0, 3, 1, 2).float()
        x = (8.0 * onehot - 4.0 + 0.3 * torch.randn(2, 19, hw, hw, device=dev, generator=g))
        lab = R.resize_nearest(lab_s, (769, 769)).contiguous()
        lab[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = 255
        x = x.to(bf).contiguous()
        return x, ohem.ohem_kept_labels(x, lab, 0.7, 100000)

    x = (3 * torch.randn(4, 21, 129, 129, device=dev, generator=g)).to(bf)
    lab = torch.randint(0, 21, (4, 513, 513), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(lab.shape, device=dev, generator=g) < 0.1] = 255
    cases = (("voc", x, lab, None), ("city_main", *head(193, 8), ohem._class_weight(True, dev)),
             ("city_aux", *head(97, 4), None))
    out["C_bwd_bf16"] = {}
    for name, x, lab, cw in cases:
        b, c, h, w = x.shape
        oh, ow = lab.shape[1:]
        base = picked(b, c, h, w, oh, ow, sms, 2)
        x = x.requires_grad_(True)
        loss = ce.upsample_cross_entropy(x, lab, 255, cw)
        fn = lambda: torch.autograd.grad(loss, x, retain_graph=True)[0]  # noqa: E731
        want = fn()
        row = {"picked": list(base), "picked_ms": cuda_ms(fn)}
        xf = x.detach().float().requires_grad_(True)
        lf = ce.upsample_cross_entropy(xf, lab, 255, cw)
        row["picked_f32_ms"] = cuda_ms(lambda: torch.autograd.grad(lf, xf, retain_graph=True))
        around = sorted({max(1, base.rows // 2), max(1, base.rows - 1), base.rows,
                         base.rows + 1, 2 * base.rows})
        for cls in (3, 4):
            pairs = 1 if cls * w <= ce.BWD_EXACT_THREADS else 2
            for rows in around:
                for chunk in (2, 3, 4):
                    plan = base._replace(groups=-(-c // cls), cls=cls, rows=rows,
                                         bands=-(-h // rows), chunk=chunk,
                                         threads=-(-cls * w // (32 * pairs)) * 32)
                    if ce._bwd_smem(c, w, ow, cls, chunk, plan.span, plan.gs, plan.ratio,
                                    2) > ce.BWD_MAX_SHARED:
                        continue
                    ce._bwd_plan = lambda *a, plan=plan: plan
                    try:
                        if not torch.equal(fn(), want):
                            print(f"plan_sweep: C bwd bf16 {name} at {plan} differs",
                                  file=sys.stderr)
                            return 1
                        row[f"{cls}/{rows}/{chunk}"] = min(cuda_ms(fn), cuda_ms(fn))
                    finally:
                        ce._bwd_plan = picked
        out["C_bwd_bf16"][name] = row
        best = sorted((v, k) for k, v in row.items() if "/" in k)[:6]
        print(f"C bwd bf16 {name} {tuple(x.shape)} -> {(oh, ow)}: picked {tuple(base)} "
              f"{row['picked_ms']:.4f} ms (f32 {row['picked_f32_ms']:.4f}); best cls/rows/chunk: "
              + ", ".join(f"{k} {v:.4f}" for v, k in best), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
