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
  of a position on one pixel (256-draw segments).

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
        for plan in [(0, 0), band] + [(r, -(-size[0] // r)) for r in (1, 2, 4) if r != band[0]]:
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
        direct, yd = time_plan(x, (513, 513), (0, 0))
        banded, yb = time_plan(x, (513, 513), band)
        if not torch.equal(yd, yb):
            print(f"plan_sweep: kernel A at {planes} planes: direct and bands differ",
                  file=sys.stderr)
            return 1
        out["A"][f"(1, {planes}, 129, 129)->(513, 513)"] = {
            "picked": picked(planes, 129, 129, 513, 513, sms), "(0, 0)": direct, str(band): banded}
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
