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
with strict=False.

One reader, `read_checkpoint`, serves every load: it tells a torch file
from the JAX package's msgpack `.ckpt` (`utils/msgpack_ckpt.py`, no flax
needed) by the file's first byte, whatever its name, and turns a `.ckpt`
into the port's payload (both models through `flax_to_torch`, optax's
chain state by parameter name, the bank, the prototype).  So eval and
serving take a `.ckpt`'s weights, teacher preferred; `load_checkpoint`
resumes training from one through the same restore sequence as a `.pth`,
in the order of u2pl_tpu/utils/checkpoint.py:124-157, optax's leaves
placed onto the port's per-parameter SGD `trace` or Adam `mu` / `nu` /
step; `load_pretrain_weights` warm-starts from one; and auto_resume takes
the JAX package's `ckpt.ckpt` where a run's folder has no `ckpt.pth`, so a
run begun in the JAX package continues in the port.  A model, optimizer
leaf, bank field or prototype that does not fit the state raises, naming
it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from u2pl_tpu_torch.utils.convert_jax import flax_to_torch, strip_module_prefix
from u2pl_tpu_torch.utils.msgpack_ckpt import read_msgpack_ckpt

log = logging.getLogger("global")

CKPT_NAME = "ckpt.pth"
CKPT_BEST_NAME = "ckpt_best.pth"
JAX_CKPT_NAME = "ckpt.ckpt"  # the JAX package's latest (u2pl_tpu/utils/checkpoint.py:27)
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


MODEL_KEYS = ("model_state", "teacher_state")


def _is_msgpack(path: str) -> bool:
    """Whether the file at `path` is the JAX package's msgpack `.ckpt`: it
    opens with a msgpack map (0x81-0x8f, 0xde, 0xdf), where a torch file
    opens with a zip archive's "PK" or, in torch's legacy format, a
    pickle's 0x80."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def read_checkpoint(path: str, device, keys=None) -> Dict[str, Any]:
    """The checkpoint at `path` as the port's payload on `device`, the
    format told by the file's first byte, not its name: a torch file as
    saved (`save_checkpoint`, the reference's `.pth`), or the JAX package's
    msgpack `.ckpt` (u2pl_tpu/utils/checkpoint.py:41-60) converted: both
    models through `flax_to_torch`, optax's chain state by parameter name
    (`_optax_by_name`), the bank's fields and the prototype as tensors.
    `keys` limits a `.ckpt`'s conversion to those entries."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at '{path}'")
    if not _is_msgpack(path):
        # weights_only=False as in the JAX package: reference checkpoints pickle
        # numpy scalars (best_miou).  Load only checkpoints you trust.
        return torch.load(path, map_location=device, weights_only=False)
    out: Dict[str, Any] = {}
    for k, v in read_msgpack_ckpt(path).items():
        if keys is not None and k not in keys:
            continue
        if k in MODEL_KEYS:
            v = {n: t.to(device) for n, t in _jax_state_dict(v, path, k).items()}
        elif k == "optimizer_state":
            v = _optax_by_name(v, path, device)
        elif k == "memobank":
            v = {f: _tensor(v[f], device) for f in BANK_FIELDS if f in v}
        elif k == "prototype":
            v = _tensor(v, device)
        out[k] = v
    return out


def _tensor(value, device) -> torch.Tensor:
    t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    return t.to(device)


def _jax_state_dict(tree, path: str, what: str) -> Dict[str, torch.Tensor]:
    """A flax tree of the `.ckpt` at `path` as the port's state dict; a leaf
    `flax_to_torch` has no name for raises, naming it."""
    try:
        return flax_to_torch(tree)
    except KeyError as e:
        raise ValueError(f"{path}: {what}: {e.args[0]}") from None


def _optax_node(tree, fields) -> Optional[Dict[str, Any]]:
    """The map of optax's chain state (u2pl_tpu/train/optim.py:35-58, maps
    keyed "0", "1", ... in the file) that holds `fields`: SGD's TraceState
    or Adam's ScaleByAdamState."""
    if not isinstance(tree, dict):
        return None
    if all(f in tree for f in fields):
        return tree
    for v in tree.values():
        found = _optax_node(v, fields)
        if found is not None:
            return found
    return None


def _optax_by_name(tree, path: str, device) -> Dict[str, Any]:
    """optax's chain state as {field: {parameter name: tensor}}: SGD's
    `trace`, or Adam's `mu` and `nu` with its `count` as an int."""
    for fields in (("count", "mu", "nu"), ("trace",)):
        node = _optax_node(tree, fields)
        if node is not None:
            break
    else:
        raise ValueError(f"{path}: optimizer_state holds no optax trace or count/mu/nu")
    out: Dict[str, Any] = {
        f: {n: t.to(device) for n, t in _jax_state_dict(
            {"params": node[f]}, path, f"optimizer_state {f}").items()}
        for f in fields if f != "count"}
    if "count" in node:
        out["count"] = int(np.asarray(node["count"]))
    return out


def _optimizer_state_dict(state, by_name: Dict[str, Any], path: str) -> Dict[str, Any]:
    """The port's optimizer state dict of optax's leaves by parameter name
    (`_optax_by_name`): each parameter of the student takes its leaf of
    each field (SGD's `trace`; Adam's `mu` and `nu`, and `count` as each
    group's step); a field, a leaf missing, a leaf left over or misshapen
    raises."""
    from u2pl_tpu_torch.train.optim import Adam

    opt = state.optimizer
    adam = isinstance(opt, Adam)
    fields = ("count", "mu", "nu") if adam else ("trace",)
    if any(f not in by_name for f in fields):
        raise ValueError(f"{path}: optimizer_state holds no optax {'/'.join(fields)} for the "
                         f"port's {type(opt).__name__}")
    named = dict(state.student.named_parameters())
    for field in fields[1:] if adam else fields:
        leaves = by_name[field]
        extra, missing = sorted(set(leaves) - set(named)), sorted(set(named) - set(leaves))
        if extra or missing:
            raise ValueError(f"{path}: optimizer_state {field}: leaves with no parameter "
                             f"{extra}, parameters with no leaf {missing}")
        for name, p in named.items():
            if leaves[name].shape != p.shape:
                raise ValueError(f"{path}: optimizer_state {field} {name}: shape "
                                 f"{tuple(leaves[name].shape)}, the parameter's {tuple(p.shape)}")
    name_of = {p: n for n, p in named.items()}
    sd = opt.state_dict()
    out: Dict[int, Dict[str, torch.Tensor]] = {}
    for group, saved in zip(opt.param_groups, sd["param_groups"]):
        for p, i in zip(group["params"], saved["params"]):
            out[i] = {f: by_name[f][name_of[p]] for f in fields if f != "count"}
        if adam:
            first = group["params"][0]
            out[saved["params"][0]]["step"] = torch.tensor(
                by_name["count"], dtype=torch.int32, device=first.device)
    return {"state": out, "param_groups": sd["param_groups"]}


def _fit(value: torch.Tensor, like: torch.Tensor, path: str, what: str) -> torch.Tensor:
    """`value` on `like`'s device where its shape and dtype are `like`'s,
    else a ValueError naming it."""
    if tuple(value.shape) != tuple(like.shape) or value.dtype != like.dtype:
        raise ValueError(f"{path}: {what}: {value.dtype} {tuple(value.shape)}, the state's "
                         f"{like.dtype} {tuple(like.shape)}")
    return value.to(like.device)


def _load_model(model: torch.nn.Module, sd: Dict[str, torch.Tensor], path: str,
                what: str) -> None:
    try:
        model.load_state_dict(strip_module_prefix(sd), strict=True)
    except RuntimeError as e:  # missing, unexpected or misshapen keys, by name
        raise ValueError(f"{path}: {what} does not fit the model: {e}") from None


def load_model_variables(
    path: str,
    prefer_teacher: bool = True,
    device: Union[str, torch.device] = "cpu",
) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint on `device`, `teacher_state` preferred
    (reference eval.py:123), else `model_state`: a reference-format `.pth`
    or the JAX package's `.ckpt` (`read_checkpoint`)."""
    ckpt = read_checkpoint(path, device, keys=MODEL_KEYS)
    key = "teacher_state" if prefer_teacher and "teacher_state" in ckpt else "model_state"
    log.info(f"=> load checkpoint[{key}] from {path}")
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
    """Restore `state` in place from `path` (the port's `.pth` or the JAX
    package's `.ckpt`, `read_checkpoint`), on the state's device, in the
    order of u2pl_tpu/utils/checkpoint.py:124-157: the student, the step,
    the optimizer, then the teacher, the bank and the prototype where the
    file and the state have them.  A model, optimizer leaf, bank field or
    prototype that does not fit the state raises, naming it.  Returns
    (state, epoch, best_miou)."""
    payload = read_checkpoint(path, _device(state))
    _load_model(state.student, payload["model_state"], path, "model_state")
    state.step.fill_(int(payload.get("step", 0)))
    opt = payload["optimizer_state"]
    if "param_groups" not in opt:  # the JAX package's, by parameter name
        opt = _optimizer_state_dict(state, opt, path)
    state.optimizer.load_state_dict(opt)
    if "teacher_state" in payload and state.teacher is not None:
        _load_model(state.teacher, payload["teacher_state"], path, "teacher_state")
    if "memobank" in payload and state.bank is not None:
        for f in BANK_FIELDS:
            like = getattr(state.bank, f)
            like.copy_(_fit(payload["memobank"][f], like, path, f"memobank {f}"))
    if "prototype" in payload and state.prototype is not None:
        state.prototype.copy_(_fit(payload["prototype"], state.prototype, path, "prototype"))
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
    utils.py:583-636): student `model_state` and teacher `teacher_state`
    of a `.pth` or a `.ckpt` (`read_checkpoint`;
    u2pl_tpu/utils/checkpoint.py:160), size-mismatched keys dropped; never
    the optimizer state or the step, so the epoch-derived schedules
    (drop_percent, alpha_t, poly LR) restart from 0."""
    ckpt = read_checkpoint(path, _device(state), keys=MODEL_KEYS)
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
        # the port's latest, else the JAX package's: a run begun there goes on here
        for name in (CKPT_NAME, JAX_CKPT_NAME):
            latest = os.path.join(save_path, name)
            if os.path.exists(latest):
                log.info(f"Resume model from: '{latest}'")
                _, epoch, best = load_checkpoint(latest, state)
                return True, epoch, best
        log.info(f"No checkpoint found in '{os.path.join(save_path, CKPT_NAME)}' or "
                 f"'{JAX_CKPT_NAME}' beside it")
    elif cfg_saver.pretrain:
        if os.path.exists(cfg_saver.pretrain):
            log.info(f"Load pretrain weights from: '{cfg_saver.pretrain}'")
            load_pretrain_weights(cfg_saver.pretrain, state)
            return True, 0, 0.0
        log.info(f"No pretrain checkpoint at '{cfg_saver.pretrain}'")
    return False, 0, 0.0
