"""Flax variables -> PyTorch state dict (the inverse of
u2pl_tpu/utils/convert_torch.py:torch_to_flax).

Walks a flax {params, batch_stats} tree of numpy arrays, names each leaf
with the JAX package's own `_translate` (flax path -> reference torch key)
and transposes conv kernels HWIO -> OIHW.  The result loads into the port's
SegModel with `load_state_dict(strict=True)`; published U²PL `.pth` files
load the same way after `strip_module_prefix`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from u2pl_tpu.utils.convert_torch import _translate, strip_module_prefix

__all__ = ["flax_to_torch", "strip_module_prefix"]


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
        arr = np.asarray(val, np.float32)
        if subpath[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        key = _translate(subpath)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_mean"):
            bn = key[: -len(".running_mean")]
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
