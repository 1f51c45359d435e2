"""Segmentation metrics: per-class intersection / union (port of
u2pl_tpu/evallib/metrics.py).

`intersection_and_union` is the reference's numpy histogram version
(utils.py:568-580); `intersection_and_union_device` counts on the tensor's
device with `torch.bincount` (a stock op: three histograms of at most
num_classes + 1 bins), so validation reads two (K,) vectors back per
validation, not per image.
"""

from __future__ import annotations

import numpy as np
import torch


def intersection_and_union(output, target, num_classes, ignore_index=255):
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    output[target == ignore_index] = ignore_index
    intersection = output[output == target]
    area_intersection, _ = np.histogram(intersection, bins=np.arange(num_classes + 1))
    area_output, _ = np.histogram(output, bins=np.arange(num_classes + 1))
    area_target, _ = np.histogram(target, bins=np.arange(num_classes + 1))
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target


def intersection_and_union_device(
    pred: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = 255
):
    """pred / target: (..., H, W) integer tensors on one device.  Returns
    (inter, union, target_area), each (num_classes,) int64 on that device;
    pixels whose target is `ignore_index`, and values outside [0,
    num_classes), count nowhere."""
    pred = pred.reshape(-1).to(torch.int64)
    target = target.reshape(-1).to(torch.int64)
    pred = torch.where(target == ignore_index, torch.full_like(pred, ignore_index), pred)

    def hist(x, mask):
        return torch.bincount(torch.where(mask, x, torch.full_like(x, num_classes)),
                              minlength=num_classes + 1)[:num_classes]

    def in_range(x):
        return (x >= 0) & (x < num_classes)

    inter = hist(pred, (pred == target) & in_range(pred))
    area_o = hist(pred, in_range(pred))
    area_t = hist(target, in_range(target))
    return inter, area_o + area_t - inter, area_t
