"""Scalar log of the trainers: one JSON line per `add_scalar`, in
`<logdir>/scalars.jsonl` (the JSONL writer of u2pl_tpu/utils/tb.py, with
the reference's rank-0 SummaryWriter surface, train_semi.py:64-69,
589-592)."""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "scalars.jsonl")
        self._f = open(self.path, "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NullWriter:
    """The writer of a rank other than 0: the reference writes scalars on
    rank 0 only."""

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def close(self) -> None:
        pass
