"""Logger setup (port of u2pl_tpu/utils/logging_utils.py:init_log)."""

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
