"""Semi-supervised U²PL trainer CLI on one card (port of the root
train_semi.py; reference train_semi.py).

    python -m u2pl_tpu_torch.train_semi --config <config.yaml> --seed 2

The same flags as the reference (--config --seed --port --local_rank; the
last two are accepted for launcher compatibility and unused on one card:
a launch of several processes raises, see `refuse_multi_process`),
`--profile_dir` for a torch.profiler trace of steps 10-13, and `--device`
(default: the card; `cpu` runs the plain versions of the kernels).
Set U2PL_ALLOW_RANDOM_INIT=1 to train a config that requires ImageNet
weights without them.

Per epoch: the labeled and unlabeled loaders feed `train.steps.run_steps`
(warmup while epoch < sup_only_epoch, then the semi step); every draw of
step i comes from a generator seeded by (seed, i), so a resumed run takes
the draws an uninterrupted one takes.  The metrics of step i are read one
step late, and logged every 10 steps with the scalars of tb.py.  After
each epoch, validation (the student during warmup, the teacher after it),
then `ckpt_best.pth` when the mIoU improved and `ckpt.pth` always.

The port trains in the config's `net.dtype`, as the JAX trainer does:
float32 (TF32 off), or bfloat16 under the JAX package's rounding points
(models/builder.py, train/steps.py) with float32 parameters, optimizer,
EMA and checkpoints; in-training validation runs a float32 forward either
way.  `sync_bn` on one card is plain BN.  `main(argv)` runs in
process and returns a summary of the run.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import pprint
import time
from datetime import datetime
from typing import Dict, List, Optional

import torch

from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.data.loader import build_loaders
from u2pl_tpu_torch.train.state import create_train_state
from u2pl_tpu_torch.train.steps import run_steps
from u2pl_tpu_torch.train.validate import validate
from u2pl_tpu_torch.utils.checkpoint import (
    CKPT_BEST_NAME,
    CKPT_NAME,
    load_encoder_pretrained,
    maybe_resume,
    save_checkpoint,
)
from u2pl_tpu_torch.utils.logging_utils import AverageMeter, init_log
from u2pl_tpu_torch.utils.tb import ScalarWriter


def make_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--local_rank", type=int, default=0)  # launcher parity
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--port", default=None, type=int)  # launcher parity
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: the card)")
    return parser


# the world size as torchrun / torch.distributed.launch, SLURM and Open MPI set it
WORLD_SIZE_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def refuse_multi_process() -> None:
    """Raise when a launcher started several processes.  The port trains on
    one card: each process would train its own copy on device 0 and write
    the same checkpoint files."""
    for name in WORLD_SIZE_VARS:
        try:
            n = int(os.environ.get(name, ""))
        except ValueError:
            continue
        if n > 1:
            raise RuntimeError(
                f"{name}={n}: the PyTorch port trains on one card in one process; "
                "multi-GPU training (DDP, SyncBN, the bank's all_gather) is ROADMAP.md "
                "queue 1 item 6. Launch a single process."
            )


parser = make_parser("Semi-Supervised Semantic Segmentation (PyTorch / CUDA)")
parser.add_argument("--profile_dir", type=str, default="",
                    help="write a torch.profiler chrome trace of train steps 10-13 here")


def setup(args, logger: logging.Logger):
    """Config, device (TF32 off: float32 means float32), scalar writer and
    save dir."""
    cfg = load_config(args.config)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    logger.info(pprint.pformat(cfg))
    logger.info(f"training in {cfg.net.dtype} on {device} (net.dtype; validation in float32); "
                f"sync_bn {cfg.net.sync_bn} on one card is plain BN")
    tb = ScalarWriter(osp.join(cfg.exp_path, "log/events_seg/"
                               + datetime.now().strftime("%Y%m%d_%H%M%S")))
    os.makedirs(cfg.save_path, exist_ok=True)
    return cfg, device, tb


class StepClock:
    """The host's time per step, split as the reference logs it: `data`,
    from the end of the last step to the next batch's arrival from the
    loader (the wait for the loader), and `batch`, from that arrival to the
    end of the step (the copy to the card, the step's launches and the read
    of the step before's metrics).  Each is kept in a window of 10 for the
    log line, the step times also as an epoch mean and the data waits one
    by one."""

    def __init__(self):
        self.data, self.batch = AverageMeter(10), AverageMeter(10)
        self.batch_all = AverageMeter(0)
        self.waits: List[float] = []
        self.end = self.arrived = time.perf_counter()

    def batch_arrived(self) -> None:
        self.arrived = time.perf_counter()
        self.waits.append(self.arrived - self.end)
        self.data.update(self.waits[-1])

    def step_done(self) -> None:
        self.end = time.perf_counter()
        for m in (self.batch, self.batch_all):
            m.update(self.end - self.arrived)


def device_batches(loader_iter, device, clock: StepClock):
    """Host batches (NHWC images, labels) -> NCHW tensors on `device`.  On
    the card each array is copied from pinned memory without blocking the
    host, so the host queues the next step while the card runs this one
    (a pageable copy would wait for the card's queue to drain)."""
    pin = device.type == "cuda"
    for batch in loader_iter:
        clock.batch_arrived()
        out = []
        for a in batch:
            t = torch.from_numpy(a)
            t = (t.pin_memory() if pin else t).to(device, non_blocking=True)
            out.append(t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t)
        yield tuple(out)


def end_of_epoch(cfg, state, model, loader_val, epoch, best_prec, logger, tb, summary):
    """Validation, the checkpoints and the red best-mIoU line; the new best."""
    logger.info("start evaluation")
    prec = validate(model, loader_val, cfg, epoch, logger)
    t0 = time.perf_counter()
    if prec > best_prec:
        best_prec = prec
        save_checkpoint(osp.join(cfg.save_path, CKPT_BEST_NAME), state, epoch + 1, best_prec,
                        save_memobank=cfg.saver.save_memobank)
    save_checkpoint(osp.join(cfg.save_path, CKPT_NAME), state, epoch + 1, best_prec,
                    save_memobank=cfg.saver.save_memobank)
    summary["ckpt_s"].append(time.perf_counter() - t0)
    summary["mious"].append(prec)
    logger.info("\033[31m * Currently, the best val result is: {:.2f}\033[0m".format(best_prec * 100))
    tb.add_scalar("mIoU val", prec, epoch)
    return best_prec


def end_of_steps(summary: Dict, t_epoch: float, clock: StepClock, device) -> None:
    """After an epoch's steps: wait for the card, then record the epoch's
    seconds, its data waits and its mean data wait and step time per step."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary["epoch_s"].append(time.perf_counter() - t_epoch)
    summary["data_waits"].append(clock.waits)
    summary["data_s"].append(sum(clock.waits) / max(len(clock.waits), 1))
    summary["step_s"].append(clock.batch_all.avg)


def new_summary(last_epoch: int, steps_per_epoch: int) -> Dict:
    return {"start_epoch": last_epoch, "start_iter": last_epoch * steps_per_epoch,
            "steps_per_epoch": steps_per_epoch, "steps": 0, "mious": [], "ckpt_s": [],
            "epoch_s": [], "data_waits": [], "data_s": [], "step_s": []}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parser.parse_args(argv)
    refuse_multi_process()
    logger = init_log("global", logging.INFO)
    cfg, device, tb = setup(args, logger)

    loader_sup, loader_unsup, loader_val = build_loaders(cfg, seed=args.seed)
    assert len(loader_sup) == len(loader_unsup), (
        f"labeled data {len(loader_sup)} unlabeled data {len(loader_unsup)}, imbalance!")
    steps_per_epoch = len(loader_sup)
    state = create_train_state(cfg, device=device,
                               generator=torch.Generator().manual_seed(args.seed))
    # ImageNet encoder warm start, before auto_resume / pretrain may overwrite it
    load_encoder_pretrained(cfg.net.encoder, state)
    resumed, last_epoch, best_prec = maybe_resume(cfg.saver, cfg.save_path, state)
    if resumed:
        logger.info(f"resumed at epoch {last_epoch}, step {int(state.step)}")
    summary = new_summary(last_epoch, steps_per_epoch)
    contra = cfg.trainer.contrastive
    sup_only_epoch = cfg.trainer.sup_only_epoch
    max_iter = cfg.trainer.epochs * steps_per_epoch
    try:
        for epoch in range(last_epoch, cfg.trainer.epochs):
            meters = {k: AverageMeter(10) for k in ("sup", "uns", "con")}
            clock = StepClock()
            warmup = epoch < sup_only_epoch
            rank_tag = "none" if warmup or not contra else f"{contra.low_rank}:{contra.high_rank} high"

            def flush(pending):
                """Log the metrics of the step before (read one step late,
                so the card stays busy while the host reads them)."""
                if pending is None:
                    return
                pi, pm = pending
                for k in meters:
                    meters[k].update(float(pm[f"{k}_loss"]))
                if pi % 10 == 0:
                    lr = float(pm["lr"])
                    logger.info(
                        "[{}][{}] Iter [{}/{}]\tData {:.2f} ({:.2f})\tTime {:.2f} ({:.2f})\t"
                        "Sup {:.3f} ({:.3f})\tUns {:.3f} ({:.3f})\tCon {:.3f} ({:.3f})\tLR {:.5f}"
                        .format(cfg.dataset.n_sup, rank_tag, pi, max_iter, clock.data.val,
                                clock.data.avg, clock.batch.val, clock.batch.avg,
                                meters["sup"].val, meters["sup"].avg, meters["uns"].val,
                                meters["uns"].avg, meters["con"].val, meters["con"].avg, lr))
                    tb.add_scalar("lr", lr, pi)
                    tb.add_scalar("Sup Loss", meters["sup"].val, pi)
                    tb.add_scalar("Uns Loss", meters["uns"].val, pi)
                    tb.add_scalar("Con Loss", meters["con"].val, pi)

            t_epoch = time.perf_counter()
            batches = device_batches(_pairs(loader_sup.epoch(epoch), loader_unsup.epoch(epoch)),
                                     device, clock)
            pending = None
            prof = None
            for i_iter, metrics in run_steps(state, batches, steps_per_epoch, cfg,
                                             start_iter=epoch * steps_per_epoch, seed=args.seed):
                flush(pending)
                pending = (i_iter, metrics)
                clock.step_done()
                summary["steps"] += 1
                if args.profile_dir and i_iter == 9:
                    prof = _start_profiler()
                if prof is not None and i_iter == 13:
                    _stop_profiler(prof, args.profile_dir, device, logger)
                    prof = None
            flush(pending)
            if prof is not None:
                _stop_profiler(prof, args.profile_dir, device, logger)
            end_of_steps(summary, t_epoch, clock, device)
            if cfg.trainer.eval_on:
                model = state.student if epoch < sup_only_epoch else state.teacher
                best_prec = end_of_epoch(cfg, state, model, loader_val, epoch, best_prec, logger,
                                         tb, summary)
    finally:
        for loader in (loader_sup, loader_unsup, loader_val):
            loader.close()
        tb.close()
    summary.update(best_miou=best_prec, step=int(state.step), state=state)
    return summary


def _pairs(a, b):
    """The labeled and the unlabeled loader's batches as one (img_l, lab_l,
    img_u) tuple per step."""
    for (img_l, lab_l), (img_u, lab_u) in zip(a, b):
        yield img_l, lab_l, img_u


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str, device, logger) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


if __name__ == "__main__":
    main()
