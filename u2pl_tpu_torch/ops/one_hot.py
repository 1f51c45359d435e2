"""One-hot encoding with ignore-label zeroing (port of u2pl_tpu/ops/one_hot.py).

Pixels whose label is the ignore index (or any value outside [0, C), as
`jax.nn.one_hot` gives) produce an all-zero one-hot row.  NCHW: the class
axis is 1, where the JAX function puts it last.
"""

from __future__ import annotations

import torch


def label_onehot(labels: torch.Tensor, num_classes: int, ignore_label: int = 255) -> torch.Tensor:
    """labels (B, H, W) int -> (B, C, H, W) float32; ignored rows all zero."""
    classes = torch.arange(num_classes, device=labels.device).view(1, -1, 1, 1)
    valid = (labels != ignore_label)[:, None]
    return ((labels[:, None] == classes) & valid).to(torch.float32)
