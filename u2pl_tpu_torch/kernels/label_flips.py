"""What a pseudo-label flipped at a near tie does to the step comparison of
chip_smoke.py's phase 11 (apply_aug classmix, select_keys radix), on one
card:

    python u2pl_tpu_torch/kernels/label_flips.py [--draws 2]

It runs phase 11's train_semi epoch (4 semi steps on phase 10's synthetic
VOC workspace), keeps the state before each step, and runs each step again
from it through the kernels and through the plain versions with `--draws`
ClassMix / contrastive draws each, three ways: the plain route on its own
pseudo-labels, on the kernel route's (as `both_routes` gives them), and on
the kernel route's with the one label at the smallest top-2 gap of the
upsampled logits set to its second class.  Per step and draw it prints the
labels that differ between the routes, the near ties (gap <= NEAR_TIE, as
phase 1 holds kernel D's argmax) and the smallest gap, whether the teacher
logits and the kernel route's losses are the same in each run, and each
way's relative con_loss difference beside CON_LOSS_TOL.  It is run by file
path from the root of a checkout (it imports chip_smoke.py there).
"""
import argparse
import contextlib
import copy
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from u2pl_tpu_torch import kernels, train_semi
    from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config
    from u2pl_tpu_torch.losses import unsup
    from u2pl_tpu_torch.ops import mixing
    from u2pl_tpu_torch.ops.resize import resize_bilinear_plain
    from u2pl_tpu_torch.train.steps import draw_contrastive

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    print(cs.card_line(), flush=True)

    def pseudo_labels(mode, seen):
        """chip_smoke.shared_pseudo_labels with the plain route's labels
        chosen by `mode`: "own", "kernels" or "forced"."""
        @contextlib.contextmanager
        def swap(route, labels):
            stats = unsup.upsample_softmax_stats

            def tap(logits, size, outputs="all"):
                out = stats(logits, size, outputs)
                if outputs != "prob":
                    return out
                labels[route] = seen[route] = (logits.detach().clone(), out[1])
                if route == "kernels" or mode == "own":
                    return out
                lab = labels["kernels"][1]
                if mode == "forced":
                    top2 = resize_bilinear_plain(logits, size).topk(2, dim=1)
                    gap = top2.values[:, 0] - top2.values[:, 1]
                    at = gap == gap.min()
                    lab = torch.where(at, top2.indices[:, 1].to(lab.dtype), lab)
                return out[0], lab, out[2]

            tap.__dict__ = stats.__dict__
            unsup.upsample_softmax_stats = tap
            try:
                yield
            finally:
                unsup.upsample_softmax_stats = stats
        return swap

    with tempfile.TemporaryDirectory(prefix="u2pl_label_flips_") as tmp:
        paths = make_voc_workspace(os.path.join(tmp, "voc"), cs.CLI_LABELED, cs.CLI_UNLABELED,
                                   cs.CLI_VAL, size=cs.CLI_IMAGE, seed=cs.SEED,
                                   val_sizes=cs.CLI_VAL_SIZES)
        cfg_path = write_config(cs.VOC_CONFIG, paths, os.path.join(tmp, "exp"),
                                cs.VARIANT_OVERRIDES)
        snaps = []
        run_steps = train_semi.run_steps

        def tapped(state, batches, spe, cfg, **kw):
            def tap(it):
                for j, batch in enumerate(it):
                    snaps.append((copy.deepcopy(state), batch, cfg, spe,
                                  kw.get("start_iter", 0) + j))
                    yield batch

            yield from run_steps(state, tap(batches), spe, cfg, **kw)

        train_semi.run_steps = tapped
        try:
            cs.run_cli(train_semi, cfg_path)
        finally:
            train_semi.run_steps = run_steps
        shared = cs.shared_pseudo_labels
        try:
            for state, batch, cfg, spe, i_iter in snaps:
                for d in range(args.draws):
                    g = torch.Generator(device=dev).manual_seed(cs.SEED + 18 + 101 * d)
                    mix = (torch.tensor(True, device=dev),
                           mixing.draw_mix(g, "classmix", cs.B_U, cs.CROP, cs.CROP,
                                           cfg.net.num_classes))
                    draws = draw_contrastive(g, cfg, (cs.B_L + cs.B_U) * cs.OS4 * cs.OS4)

                    def run(st, route):
                        steps = train_semi.run_steps(st, [batch], spe, cfg, start_iter=i_iter,
                                                     mixes=[mix], contras=[draws])
                        return next(iter(steps))[1]

                    rel, kernel_losses, seen = {}, [], {}
                    for mode in ("own", "kernels", "forced"):
                        cs.shared_pseudo_labels = pseudo_labels(mode, seen)
                        runs = cs.both_routes(state, run, f"step {i_iter}, draw {d}, {mode}")
                        mk, mp = (cs.scalars(runs[r][0]) for r in ("kernels", "plain"))
                        del runs
                        kernel_losses.append(mk)
                        rel[mode] = abs(mk["con_loss"] - mp["con_loss"]) / abs(mp["con_loss"])
                    (tk, lk), (tp, lp) = seen["kernels"], seen["plain"]
                    top2 = resize_bilinear_plain(tp, (cs.CROP, cs.CROP)).topk(2, dim=1).values
                    gap = top2[:, 0] - top2[:, 1]
                    near = gap <= cs.NEAR_TIE * top2[:, 0].abs().clamp(min=1.0)
                    print(f"step {i_iter}, draw {d}: {int((lk != lp).sum())} labels differ "
                          f"between the routes; {int(near.sum())} near ties, "
                          f"{int((gap <= 1e-6).sum())} gaps <= 1e-6, smallest gap "
                          f"{gap.min().item():.3e}; teacher logits "
                          f"equal {torch.equal(tk, tp)}; the kernel route's losses equal in all "
                          f"three runs {all(m == kernel_losses[0] for m in kernel_losses)}; "
                          f"con_loss rel diff, plain on its own labels {rel['own']:.3e}, on the "
                          f"kernel route's {rel['kernels']:.3e}, with one flipped at the smallest "
                          f"gap {rel['forced']:.3e} (CON_LOSS_TOL {cs.CON_LOSS_TOL})", flush=True)
        finally:
            cs.shared_pseudo_labels = shared
    return 0


if __name__ == "__main__":
    sys.exit(main())
