"""Per-iteration LR schedules as float32 device scalars (port of
u2pl_tpu/train/lr.py): poly (power 0.9), cosine, multistep.

The iteration counter is the train state's device step, so the schedule
never reads a value back to the host.  Every operation is the JAX
package's float32 operation in its order; divisions go through a divisor
tensor on the counter's device, because a Python-scalar divisor may be
turned into a multiply by its reciprocal on CUDA.
"""

from __future__ import annotations

import math

import torch

from u2pl_tpu_torch.config import LRSchedulerCfg


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.full_like(a, float(b))


def lr_at(
    cfg: LRSchedulerCfg,
    base_lr: float,
    it: torch.Tensor,
    max_iter: int,
    steps_per_epoch: int = 1,
) -> torch.Tensor:
    itf = it.to(torch.float32)
    if cfg.mode == "poly":
        return base_lr * torch.pow(1.0 - _div(itf, max_iter), torch.full_like(itf, cfg.power))
    if cfg.mode == "cosine":
        cos = torch.cos(_div(math.pi * itf, max_iter))
        return cfg.targetlr + _div((base_lr - cfg.targetlr) * (1.0 + cos), 2.0)
    if cfg.mode in ("multistep", "step"):
        epoch = torch.floor(_div(itf, steps_per_epoch))
        milestones = cfg.milestones or tuple(
            range(0, max_iter // steps_per_epoch, max(max_iter // steps_per_epoch // 3, 1))
        )[1:]
        power = torch.zeros_like(itf)
        for m in milestones:
            power = power + (epoch >= m).to(torch.float32)
        return base_lr * torch.pow(torch.full_like(itf, 0.1), power)
    raise ValueError(f"unknown lr mode {cfg.mode!r}")
