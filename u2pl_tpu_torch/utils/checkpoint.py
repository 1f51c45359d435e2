"""Checkpoint save / restore (port of u2pl_tpu/utils/checkpoint.py).

The file is the reference's torch `.pth` (train_semi.py:211-224), named
`ckpt.pth` (latest) and `ckpt_best.pth`: {epoch, best_miou, model_state,
teacher_state, optimizer_state}, plus what the JAX package's payload adds
(checkpoint.py:41-60): `step`, the memory bank `memobank` (under
`saver.save_memobank`) and the anchor-EMA `prototype`.  `model_state` and
`teacher_state` are the port's state dicts, whose keys are the reference's
module names, so the reference, the JAX package's `load_eval_variables` and
the port's server read the file as it is.  Everything is written from the
CPU, atomically (`.tmp` + `os.replace`).

auto_resume > pretrain precedence as train_semi.py:138-154; a resume loads
onto the state's device.  `pretrain` loads weights only (no optimizer
state, no step); the ImageNet encoder warm start loads into both encoders
with strict=False.  Eval and serving also read the JAX package's msgpack
`.ckpt` files (`utils/msgpack_ckpt.py`, no flax needed), teacher
preferred; resuming or warm-starting training from a `.ckpt` is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from u2pl_tpu_torch.utils.convert_jax import flax_to_torch, strip_module_prefix
from u2pl_tpu_torch.utils.msgpack_ckpt import read_msgpack_ckpt

log = logging.getLogger("global")

CKPT_NAME = "ckpt.pth"
CKPT_BEST_NAME = "ckpt_best.pth"
BANK_FIELDS = ("keys", "ptr", "occupancy", "sizes")

# ImageNet encoder checkpoints by arch, the reference's user-edited dict
# (reference resnet.py:16-22; a copy of u2pl_tpu/models/resnet.py:model_urls).
# `encoder.pretrained: true` looks the arch up here; a string value of
# `encoder.pretrained` is an explicit path.
model_urls = {
    "resnet18": "/path/to/resnet18.pth",
    "resnet34": "/path/to/resnet34.pth",
    "resnet50": "/path/to/resnet50.pth",
    "resnet101": "/path/to/resnet101.pth",
    "resnet152": "/path/to/resnet152.pth",
}


def _cpu(obj: Any) -> Any:
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state, epoch: int, best_miou: float,
                    save_memobank: bool = True) -> None:
    """Write `state` (a train.state.TrainState) to `path`."""
    payload: Dict[str, Any] = {
        "epoch": int(epoch),
        "best_miou": float(best_miou),
        "step": int(state.step),
        "model_state": _cpu(state.student.state_dict()),
        "optimizer_state": _cpu(state.optimizer.state_dict()),
    }
    if state.teacher is not None:
        payload["teacher_state"] = _cpu(state.teacher.state_dict())
    if state.bank is not None and save_memobank:
        payload["memobank"] = {f: _cpu(getattr(state.bank, f)) for f in BANK_FIELDS}
    if state.prototype is not None:
        payload["prototype"] = _cpu(state.prototype)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _torch_load(path: str, device) -> Dict[str, Any]:
    if path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path!r}: training resumes or warm-starts from the port's .pth only; "
            "resuming from the JAX package's .ckpt is ROADMAP.md queue 1 item 4")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no torch checkpoint at '{path}'")
    # weights_only=False as in the JAX package: reference checkpoints pickle
    # numpy scalars (best_miou).  Load only checkpoints you trust.
    return torch.load(path, map_location=device, weights_only=False)


def load_model_variables(
    path: str,
    prefer_teacher: bool = True,
    device: Union[str, torch.device] = "cpu",
) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint on `device`, `teacher_state` preferred
    (reference eval.py:123), else `model_state`: a reference-format `.pth`,
    or else, as the JAX package reads any other name, its msgpack `.ckpt`,
    whose {params, batch_stats} go through `flax_to_torch`."""
    if not path.endswith(".pth"):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at '{path}'")
        payload = read_msgpack_ckpt(path)
        key = "teacher_state" if prefer_teacher and "teacher_state" in payload else "model_state"
        log.info(f"=> load checkpoint[{key}] from {path}")
        return {k: v.to(device) for k, v in flax_to_torch(payload[key]).items()}
    ckpt = _torch_load(path, device)
    key = "teacher_state" if prefer_teacher and "teacher_state" in ckpt else "model_state"
    log.info(f"=> load torch checkpoint[{key}] from {path}")
    return strip_module_prefix(ckpt[key])


def load_eval_variables(model: torch.nn.Module, model_path: str) -> torch.nn.Module:
    """Load `model_path` into `model` strictly (teacher preferred) and put
    the model in eval mode."""
    device = next(model.parameters()).device
    model.load_state_dict(load_model_variables(model_path, True, device), strict=True)
    return model.eval()


def _device(state) -> torch.device:
    return next(state.student.parameters()).device


def load_checkpoint(path: str, state) -> Tuple[Any, int, float]:
    """Restore `state` in place from `path`, on the state's device: both
    models, the optimizer, the step, the bank and the prototype where the
    file and the state have them.  Returns (state, epoch, best_miou)."""
    payload = _torch_load(path, _device(state))
    state.student.load_state_dict(strip_module_prefix(payload["model_state"]), strict=True)
    state.optimizer.load_state_dict(payload["optimizer_state"])
    state.step.fill_(int(payload.get("step", 0)))
    if "teacher_state" in payload and state.teacher is not None:
        state.teacher.load_state_dict(strip_module_prefix(payload["teacher_state"]), strict=True)
    if "memobank" in payload and state.bank is not None:
        for f in BANK_FIELDS:
            getattr(state.bank, f).copy_(payload["memobank"][f])
    if "prototype" in payload and state.prototype is not None:
        state.prototype.copy_(payload["prototype"])
    return state, int(payload["epoch"]), float(payload["best_miou"])


def _load_tolerant(model: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """strict=False, dropping the keys whose shape differs from the model's
    (the reference's load_state, utils.py:595-613)."""
    own = model.state_dict()
    sd = strip_module_prefix(sd)
    keep = {k: v for k, v in sd.items() if k in own and tuple(own[k].shape) == tuple(v.shape)}
    dropped = sorted(k for k in sd if k in own and k not in keep)
    missing = sorted(k for k in own if k not in keep)
    model.load_state_dict(keep, strict=False)
    log.info(f"=> {what}: {len(keep)} tensors loaded; shape-mismatched (dropped): {dropped}; "
             f"missing: {missing}")


def load_pretrain_weights(path: str, state) -> Any:
    """Weights-only warm start (reference train_semi.py:153-154 +
    utils.py:583-636): student `model_state` and teacher `teacher_state`,
    size-mismatched keys dropped; never the optimizer state or the step, so
    the epoch-derived schedules (drop_percent, alpha_t, poly LR) restart
    from 0."""
    ckpt = _torch_load(path, _device(state))
    _load_tolerant(state.student, ckpt["model_state"], f"pretrain {path} (student)")
    if "teacher_state" in ckpt and state.teacher is not None:
        _load_tolerant(state.teacher, ckpt["teacher_state"], f"pretrain {path} (teacher)")
    return state


def resolve_pretrained_path(enc_cfg) -> Optional[str]:
    """encoder.pretrained -> a .pth path or None: True looks the arch up in
    `model_urls`, a string is the path."""
    p = getattr(enc_cfg, "pretrained", False)
    if not p:
        return None
    if isinstance(p, str):
        return p
    return model_urls.get(enc_cfg.type.rsplit(".", 1)[-1])


def load_encoder_pretrained(enc_cfg, state) -> Any:
    """ImageNet warm start of the ResNet encoder of the student and the
    teacher (reference resnet.py:380-402, strict=False, in both model
    builders: train_semi.py:81, :123).  A missing file raises when the
    config sets `pretrained_required`, unless U2PL_ALLOW_RANDOM_INIT is
    set; otherwise it logs a warning and leaves the state as it is."""
    path = resolve_pretrained_path(enc_cfg)
    required = getattr(enc_cfg, "pretrained_required", False) and not os.environ.get(
        "U2PL_ALLOW_RANDOM_INIT")
    if path is None or not os.path.isfile(path):
        where = "configured for this arch (no model_urls entry)" if path is None else f"at '{path}'"
        msg = (f"encoder.pretrained: no ImageNet checkpoint {where}: published mIoU baselines "
               "are unreachable from random init; edit u2pl_tpu_torch/utils/checkpoint.py "
               "model_urls or set encoder.pretrained to a path")
        if required:
            raise FileNotFoundError(
                msg + " (this config sets encoder.kwargs.pretrained_required; set "
                "U2PL_ALLOW_RANDOM_INIT=1 to proceed from random init)")
        if path is not None:
            log.warning(msg + "; training from random init")
        return state
    sd = torch.load(path, map_location=_device(state), weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = strip_module_prefix(sd)
    for model in (state.student, state.teacher):
        if model is not None:
            res = model.encoder.load_state_dict(sd, strict=False)
    log.info(f"[Info] Load ImageNet pretrain from '{path}' \nmissing_keys: {res.missing_keys} "
             f"\nunexpected_keys: {res.unexpected_keys}")
    return state


def maybe_resume(cfg_saver, save_path: str, state) -> Tuple[bool, int, float]:
    """auto_resume > pretrain (reference train_semi.py:138-154), in place.
    Returns (whether a checkpoint or pretrain weights were loaded,
    last_epoch, best_miou)."""
    if cfg_saver.auto_resume:
        latest = os.path.join(save_path, CKPT_NAME)
        if os.path.exists(latest):
            log.info(f"Resume model from: '{latest}'")
            _, epoch, best = load_checkpoint(latest, state)
            return True, epoch, best
        log.info(f"No checkpoint found in '{latest}'")
    elif cfg_saver.pretrain:
        if os.path.exists(cfg_saver.pretrain):
            log.info(f"Load pretrain weights from: '{cfg_saver.pretrain}'")
            load_pretrain_weights(cfg_saver.pretrain, state)
            return True, 0, 0.0
        log.info(f"No pretrain checkpoint at '{cfg_saver.pretrain}'")
    return False, 0, 0.0
