"""Checkpoint loading for eval/serve (port of the eval half of
u2pl_tpu/utils/checkpoint.py).

Reads reference-format torch `.pth` files ({epoch, model_state,
teacher_state, ...}, reference train_semi.py:211-224), teacher preferred as
in reference eval.py:123.  This repo's msgpack `.ckpt` files are not read
yet: that reader needs flax/msgpack and is ROADMAP.md queue 1 item 1.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Union

import torch

from u2pl_tpu_torch.utils.convert_jax import strip_module_prefix

log = logging.getLogger("global")


def load_model_variables(
    path: str,
    prefer_teacher: bool = True,
    device: Union[str, torch.device] = "cpu",
) -> Dict[str, torch.Tensor]:
    """The state dict of a reference `.pth` checkpoint on `device`,
    `teacher_state` preferred, else `model_state`."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path!r}: only reference torch .pth checkpoints are read by the "
            "port; the msgpack .ckpt reader is ROADMAP.md queue 1 item 1 "
            "(serving follow-ups)"
        )
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no torch checkpoint at '{path}'")
    # weights_only=False as in the JAX package: reference checkpoints pickle
    # numpy scalars (best_miou).  Load only checkpoints you trust.
    ckpt = torch.load(path, map_location=device, weights_only=False)
    key = "teacher_state" if prefer_teacher and "teacher_state" in ckpt else "model_state"
    log.info(f"=> load torch checkpoint[{key}] from {path}")
    return strip_module_prefix(ckpt[key])


def load_eval_variables(model: torch.nn.Module, model_path: str) -> torch.nn.Module:
    """Load `model_path` into `model` strictly (teacher preferred) and put
    the model in eval mode."""
    device = next(model.parameters()).device
    model.load_state_dict(load_model_variables(model_path, True, device), strict=True)
    return model.eval()
