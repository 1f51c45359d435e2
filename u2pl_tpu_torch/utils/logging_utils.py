"""Logger setup and windowed meters (port of
u2pl_tpu/utils/logging_utils.py; reference utils.py:438-491)."""

from __future__ import annotations

import logging
import os

_logs = set()


def init_log(name: str = "global", level=logging.INFO) -> logging.Logger:
    """Stream logger that only rank 0 lets through; the rank comes from the
    launcher's environment (RANK, else SLURM_PROCID, else 0)."""
    logger = logging.getLogger(name)
    if (name, level) in _logs:
        return logger
    _logs.add((name, level))
    logger.setLevel(level)
    ch = logging.StreamHandler()
    ch.setLevel(level)
    rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", 0)))
    if rank != 0:
        logger.addFilter(lambda record: False)
    ch.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)8s] %(message)s"))
    logger.addHandler(ch)
    logger.propagate = False
    return logger


class AverageMeter:
    """Windowed (length > 0) or cumulative average (reference
    utils.py:438-468)."""

    def __init__(self, length: int = 0):
        self.length = length
        self.reset()

    def reset(self):
        self.history = []
        self.count = 0
        self.sum = 0.0
        self.val = 0.0
        self.avg = 0.0

    def update(self, val, num: int = 1):
        if self.length > 0:
            self.history.append(val)
            if len(self.history) > self.length:
                del self.history[0]
            self.val = self.history[-1]
            self.avg = sum(self.history) / len(self.history)
        else:
            self.val = val
            self.sum += val * num
            self.count += num
            self.avg = self.sum / max(self.count, 1)
