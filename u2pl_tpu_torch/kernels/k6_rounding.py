"""Holds K6's f32 rep gradient on the VOC contrastive step's own inputs
(`chip_smoke.py` phase 6) against the plain versions and a float64
evaluation of the same function, over several runs of the phase, on one
card:

    python u2pl_tpu_torch/kernels/k6_rounding.py --runs 6 [--save DIR]
    python u2pl_tpu_torch/kernels/k6_rounding.py --tree OTHER --replay DIR

Phase 6 trains 5 steps from seeded weights; the convolutions' backward
sums in no fixed order, so each run's step 5 inputs differ a little.  Per
run it prints a JSON line: the three routes' losses, the kernel-vs-plain
gradient gap (the measure phase 6 once held) and each f32 route's gap
from float64, all as shares of the gradient's largest magnitude, whether
each route gives the same bits on a second call, where the largest
kernel-vs-plain gap sits and how many draws that pixel takes.  `--save`
keeps the first run's inputs and K6 gradient in DIR; `--replay` computes
the K6 gradient of the checkout at `--tree` (another commit unpacked, its
own kernels built there) on them and says whether it is bit-equal.  The
float64 evaluation is written out here, so that it runs on a checkout
whose plain version takes no float64 rep.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def ref64(rep, idx, positive, bank, b_j, u_neg, active, valid_seg, temperature):
    """`contra_infonce_plain`'s f32 path in float64 (rep float64)."""
    import torch

    from u2pl_tpu_torch.memobank import gather_rows, sample

    c, q = idx.shape
    f = rep.shape[1]
    anchor = gather_rows(rep, idx)
    negs = sample(bank, u_neg, dtype=None)[0][b_j.long()].double().reshape(c, q, -1, f)
    pos = positive.double()[:, None, None, :].expand(c, q, 1, f)
    all_feat = torch.cat([pos, negs], dim=2)
    norm = torch.linalg.vector_norm
    a_n = anchor / torch.clamp(norm(anchor, dim=-1, keepdim=True), min=1e-8)
    f_n = all_feat / torch.clamp(norm(all_feat, dim=-1, keepdim=True), min=1e-8)
    logits = torch.einsum("cqf,cqkf->cqk", a_n, f_n) / temperature
    ce = -torch.log_softmax(logits, dim=-1)[..., 0].mean(dim=-1)
    loss = torch.where(active, ce, torch.zeros_like(ce)).sum() / torch.clamp(
        valid_seg.double(), min=1.0)
    return torch.where(valid_seg > 1, loss, torch.zeros_like(loss))


def gradients(args, kernel):
    """Loss and rep gradient of each route: K6 twice, the plain version
    twice, float64 once."""
    import torch

    from u2pl_tpu_torch.losses import contrastive as tc
    from u2pl_tpu_torch.memobank import MemoryBank

    rep0, idx, pos, (keys, occ), b_j, u_neg, active, vs, temp = args
    bank = MemoryBank(keys=keys, ptr=torch.zeros_like(occ), occupancy=occ,
                      sizes=torch.full_like(occ, keys.shape[1]))
    out = {}
    for name, fn, dt in (("k", kernel, torch.float32), ("k2", kernel, torch.float32),
                         ("p", tc.contra_infonce_plain, torch.float32),
                         ("p2", tc.contra_infonce_plain, torch.float32),
                         ("r", ref64, torch.float64)):
        rep = rep0.to(dt, copy=True).requires_grad_(True)
        loss = fn(rep, idx, pos, bank, b_j, u_neg, active, vs, temp)
        (g,) = torch.autograd.grad(loss, rep)
        out[name] = (loss.item(), g)
    torch.cuda.synchronize()
    return out


def measures(args, out):
    import torch

    idx, active = args[1], args[6]
    gk, gp, gr = out["k"][1], out["p"][1], out["r"][1]
    top = gr.abs().max().item()
    gap = (gk - gp).abs()
    i = int(gap.argmax())
    b, f, h, w = gk.shape
    at = (i // (f * h * w), (i // (h * w)) % f, i % (h * w))
    pixel = at[0] * h * w + at[2]
    hits = idx[active].flatten().long()
    return {
        "loss_kernels": out["k"][0], "loss_plain": out["p"][0], "loss_float64": out["r"][0],
        "kernels_vs_plain": gap.max().item() / gp.abs().max().item(),
        "kernels_vs_float64": (gk.double() - gr).abs().max().item() / top,
        "plain_vs_float64": (gp.double() - gr).abs().max().item() / top,
        "kernels_repeat": torch.equal(gk, out["k2"][1]),
        "plain_repeat": torch.equal(gp, out["p2"][1]),
        "largest_gap_at": list(at), "draws_there": int((hits == pixel).sum()),
        "most_draws_on_a_pixel": int(torch.bincount(hits).max()) if hits.numel() else 0,
    }


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here, help="the checkout whose port and chip_smoke.py run")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--save", help="keep the first run's inputs and K6 gradient here")
    ap.add_argument("--replay", help="K6 of --tree on the inputs saved here, no runs")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("k6_rounding: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from u2pl_tpu_torch import kernels
    from u2pl_tpu_torch.losses import contrastive as tc

    if not os.path.abspath(tc.__file__).startswith(tree + os.sep):
        print(f"k6_rounding: the port came from {tc.__file__}, not {tree}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    print(cs.card_line(), flush=True)
    kernel = tc.contra_infonce
    if opts.replay:
        saved = torch.load(os.path.join(opts.replay, "k6_inputs.pt"), map_location=dev)
        out = gradients(saved["args"], kernel)
        row = measures(saved["args"], out)
        row["bit_equal_to_saved"] = torch.equal(out["k"][1], saved["grad"])
        print("replay", json.dumps(row), flush=True)
        return 0

    class Failed(Exception):
        pass

    def fail(msg):
        raise Failed(msg)

    box = {}

    def spy(rep, idx, pos, bank, b_j, u_neg, active, vs, temp):
        # the last call through the kernels: phase 6's check on the step's inputs
        box["args"] = (rep.detach().clone(), idx.clone(), pos.clone(),
                       (bank.keys.clone(), bank.occupancy.clone()), b_j.clone(),
                       u_neg.clone(), active.clone(), vs.clone(), temp)
        return kernel(rep, idx, pos, bank, b_j, u_neg, active, vs, temp)

    cs.fail = fail
    cfg = cs.load_f32(cs.VOC_CONFIG)
    for r in range(opts.runs):
        t0 = time.time()
        status = "passed"
        tc.contra_infonce = spy
        try:
            cs.phase6_contrastive(dev, cs.card_line(), cfg)
        except Failed as e:
            status = f"failed: {e}"
        finally:
            tc.contra_infonce = kernel
        args = box.pop("args")
        out = gradients(args, kernel)
        row = {"run": r, "phase6": status, **measures(args, out), "s": time.time() - t0}
        print("run", json.dumps(row), flush=True)
        if opts.save and r == 0:
            os.makedirs(opts.save, exist_ok=True)
            torch.save({"args": args, "grad": out["k"][1]},
                       os.path.join(opts.save, "k6_inputs.pt"))
        del out, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
