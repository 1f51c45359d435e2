"""Flax variables -> PyTorch state dict (the inverse of
u2pl_tpu/utils/convert_torch.py:torch_to_flax).

Walks a flax {params, batch_stats} tree of numpy arrays, names each leaf
with `_translate` (flax path -> reference torch key; a copy of the JAX
package's mapping in u2pl_tpu/utils/convert_torch.py, so the port needs
nothing of that package) and transposes conv kernels HWIO -> OIHW.  The
result loads into the port's SegModel with `load_state_dict(strict=True)`;
published U²PL `.pth` files load the same way after `strip_module_prefix`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flax_to_torch", "strip_module_prefix"]


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the DDP 'module.' prefix (reference utils.py:494-499)."""
    out = {}
    for k, v in state_dict.items():
        out[k[7:] if k.startswith("module.") else k] = v
    return out


def _translate(path: Tuple[str, ...]) -> str:
    """Flax variable path (module names + leaf) -> torch state-dict key."""
    parts = [p for p in path if p != "Conv_0"]
    leaf = parts[-1]
    mods = parts[:-1]

    torch_mods = []
    i = 0
    while i < len(mods):
        m = mods[i]
        if m == "encoder":
            torch_mods.append("encoder")
        elif m == "decoder":
            torch_mods.append("decoder")
        elif m == "auxor":
            torch_mods.append("auxor")
            rest = mods[i + 1 :]
            sub = {"conv1": "aux.0", "bn1": "aux.1", "out": "aux.4"}[rest[0]]
            torch_mods.append(sub)
            i = len(mods)
            continue
        elif m.startswith("stem_conv"):
            torch_mods.append({"stem_conv1": "conv1.0", "stem_conv2": "conv1.3",
                               "stem_conv3": "conv1.6"}[m])
        elif m.startswith("stem_bn"):
            torch_mods.append({"stem_bn1": "conv1.1", "stem_bn2": "conv1.4"}[m])
        elif re.fullmatch(r"layer\d+_\d+", m):
            stage, blk = m[5:].split("_")
            torch_mods.append(f"layer{stage}.{blk}")
        elif m in ("conv1", "conv2", "conv3", "bn1", "bn2", "bn3") and torch_mods and (
            torch_mods[-1].startswith("layer") or torch_mods[-1] == "encoder"
        ):
            torch_mods.append(m)
        elif m == "ds_conv":
            torch_mods.append("downsample.0")
        elif m == "ds_bn":
            torch_mods.append("downsample.1")
        elif m == "aspp":
            torch_mods.append("aspp")
        elif m == "img_conv":
            torch_mods.append("conv1.1")
        elif m == "img_bn":
            torch_mods.append("conv1.2")
        elif m == "conv1x1":
            torch_mods.append("conv2.0")
        elif m == "bn1x1":
            torch_mods.append("conv2.1")
        elif m.startswith("conv_d"):
            torch_mods.append(f"conv{3 + int(m[6:])}.0")
        elif m.startswith("bn_d"):
            torch_mods.append(f"conv{3 + int(m[4:])}.1")
        elif m == "low_conv":
            torch_mods.append("low_conv.0")
        elif m == "low_bn":
            torch_mods.append("low_conv.1")
        elif m == "head_conv":
            torch_mods.append("head.0")
        elif m == "head_bn":
            torch_mods.append("head.1")
        elif m == "head_out":
            torch_mods.append("head.4")
        elif m.startswith("cls_") or m.startswith("rep_"):
            prefix = "classifier" if m.startswith("cls_") else "representation"
            sub = {"conv1": "0", "bn1": "1", "conv2": "4", "bn2": "5", "out": "8"}[
                m.split("_", 1)[1]
            ]
            torch_mods.append(f"{prefix}.{sub}")
        else:
            raise KeyError(f"no torch mapping for flax module {m!r} in {path}")
        i += 1

    torch_leaf = {
        "kernel": "weight",
        "bias": "bias",
        "scale": "weight",
        "mean": "running_mean",
        "var": "running_var",
    }[leaf]
    return ".".join(torch_mods + [torch_leaf])


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{params, batch_stats} numpy tree -> reference-keyed torch state dict,
    with `num_batches_tracked = 0` for every BatchNorm."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(variables):
        subpath = path[1:]  # drop the 'params' / 'batch_stats' collection
        arr = np.array(val, np.float32)  # a copy: `val` may be a read-only view
        if subpath[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        key = _translate(subpath)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_mean"):
            bn = key[: -len(".running_mean")]
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
