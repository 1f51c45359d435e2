"""Supervised baseline trainer CLI (port of the root train_sup.py;
reference train_sup.py), on one card or data-parallel on W cards:

    python -m u2pl_tpu_torch.train_sup --config <config.yaml> --seed 2
    torchrun --nproc_per_node=W -m u2pl_tpu_torch.train_sup --config <config.yaml>

The flags, training in `net.dtype`, per-step generators, the data-parallel
launch, validation and checkpoints of `u2pl_tpu_torch.train_semi`, with `make_sup_step` on the
labeled loader and no teacher (the checkpoints have no teacher_state, so an
evaluator reads the student).  `main(argv)` runs in process and returns a
summary of the run.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from u2pl_tpu_torch import dist
from u2pl_tpu_torch.data.loader import build_loaders
from u2pl_tpu_torch.train.state import broadcast_state, create_train_state
from u2pl_tpu_torch.train.steps import make_sup_step, step_generator
from u2pl_tpu_torch.train_semi import (
    StepClock, device_batches, end_of_epoch, end_of_steps, make_parser, new_summary, setup,
    start,
)
from u2pl_tpu_torch.utils.checkpoint import load_encoder_pretrained, maybe_resume
from u2pl_tpu_torch.utils.logging_utils import AverageMeter

parser = make_parser("Supervised Semantic Segmentation (PyTorch / CUDA)")


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser.parse_args(argv)
    device, group, logger = start(args)
    cfg, tb = setup(args, logger, device, group)
    rank = dist.rank(group)

    loader_sup, loader_val = build_loaders(cfg, seed=args.seed, process_index=rank,
                                           process_count=dist.world_size(group))
    steps_per_epoch = len(loader_sup)
    state = create_train_state(cfg, device=device, with_teacher=False,
                               generator=torch.Generator().manual_seed(args.seed), group=group)
    state.bank = state.prototype = None  # the supervised step has no contrastive loss
    load_encoder_pretrained(cfg.net.encoder, state)
    resumed, last_epoch, best_prec = maybe_resume(cfg.saver, cfg.save_path, state)
    broadcast_state(state, group)
    if resumed:
        logger.info(f"resumed at epoch {last_epoch}, step {int(state.step)}")
    summary = new_summary(last_epoch, steps_per_epoch)
    sup_step = make_sup_step(cfg, steps_per_epoch, group)
    max_iter = cfg.trainer.epochs * steps_per_epoch
    try:
        for epoch in range(last_epoch, cfg.trainer.epochs):
            sup_losses = AverageMeter(10)
            clock = StepClock()
            t_epoch = time.perf_counter()
            for step, (img, lab) in enumerate(device_batches(loader_sup.epoch(epoch), device,
                                                             clock)):
                i_iter = epoch * steps_per_epoch + step
                m = sup_step(state, img, lab, step_generator(args.seed, i_iter, device, rank))
                if i_iter % 10 == 0:
                    sup_losses.update(float(m["sup_loss"]))
                    lr = float(m["lr"])
                    logger.info(
                        "[{}] Iter [{}/{}]\tData {:.2f} ({:.2f})\tTime {:.2f} ({:.2f})\t"
                        "Sup {:.3f} ({:.3f})\tLR {:.5f}".format(
                            cfg.dataset.n_sup, i_iter, max_iter, clock.data.val, clock.data.avg,
                            clock.batch.val, clock.batch.avg, sup_losses.val, sup_losses.avg, lr))
                    tb.add_scalar("lr", lr, i_iter)
                    tb.add_scalar("Sup Loss", sup_losses.val, i_iter)
                clock.step_done()
                summary["steps"] += 1
            end_of_steps(summary, t_epoch, clock, device)
            if cfg.trainer.eval_on:
                best_prec = end_of_epoch(cfg, state, state.student, loader_val, epoch, best_prec,
                                         logger, tb, summary, group)
    finally:
        for loader in (loader_sup, loader_val):
            loader.close()
        tb.close()
        dist.destroy(group)
    summary.update(best_miou=best_prec, step=int(state.step), state=state)
    return summary


if __name__ == "__main__":
    main()
