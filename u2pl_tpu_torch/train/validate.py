"""In-training validation (port of u2pl_tpu/train/validate.py; reference
train_semi.py:595-654).

Each val batch (center crops, float32 or uint8 normalized on the device)
goes through the model in eval mode in float32, whatever the model's
compute dtype (JAX validates a float32 `model_eval` on the bf16 trainer's
parameters, train_semi.py:96-99); each image's os4 logits
are resized to its label's size and arg-maxed by kernel B
(`ops.resize.resize_argmax`, one launch per image: no (C, H, W) upsample
is written); the per-class intersection / union counts accumulate on the
device and are read once, at the end.  The ragged last batch needs no
padding.  mIoU = mean(inter / (union + 1e-10)).  Data-parallel: each rank
scores its slice of every val batch (the loader's `process_index`) and the
counts are summed over the ranks (validate.py:137-140; reference
train_semi.py:639-641), so every rank gets the same mIoU.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from u2pl_tpu_torch import dist
from u2pl_tpu_torch.config import Config
from u2pl_tpu_torch.evallib.metrics import intersection_and_union_device
from u2pl_tpu_torch.models.builder import computing_in
from u2pl_tpu_torch.ops.resize import resize_argmax
from u2pl_tpu_torch.train.steps import make_normalizer


@torch.no_grad()
def accumulate_val_sums(model, val_loader, cfg: Config, epoch: int,
                        device: torch.device, group=None) -> Tuple[np.ndarray, np.ndarray]:
    """(inter, union) per class, int64, over the loader's val set: this
    rank's slice, summed over the ranks of `group`."""
    c, ignore = cfg.net.num_classes, cfg.dataset.ignore_label
    normalize = make_normalizer(cfg)
    inter = torch.zeros(c, dtype=torch.int64, device=device)
    union = torch.zeros(c, dtype=torch.int64, device=device)
    model.eval()
    for images, labels in val_loader.epoch(epoch):
        x = normalize(torch.from_numpy(images).to(device).permute(0, 3, 1, 2).contiguous())
        lab = torch.from_numpy(labels).to(device)
        with computing_in(model, torch.float32):
            pred = model(x.float())["pred"]
        for i in range(pred.shape[0]):
            mask = resize_argmax(pred[i].contiguous(), tuple(lab.shape[1:]))
            a, u, _ = intersection_and_union_device(mask, lab[i], c, ignore)
            inter += a
            union += u
    inter, union = dist.all_sum(torch.stack([inter, union]), group)
    return inter.cpu().numpy(), union.cpu().numpy()


def validate(model, val_loader, cfg: Config, epoch: int = 0,
             logger: Optional[logging.Logger] = None, group=None) -> float:
    """mIoU of `model` (eval mode, float32) on the val loader; logs the
    per-class IoU and the mIoU as the reference does."""
    device = next(model.parameters()).device
    inter, union = accumulate_val_sums(model, val_loader, cfg, epoch, device, group)
    iou_class = inter / (union + 1e-10)
    miou = float(np.mean(iou_class))
    if logger is not None:
        for i, iou in enumerate(iou_class):
            logger.info(" * class [{}] IoU {:.2f}".format(i, iou * 100))
        logger.info(" * epoch {} mIoU {:.2f}".format(epoch, miou * 100))
    return miou
