"""Eval-mode forward + align-corners upsample to the input size (port of
u2pl_tpu/evallib/slide.py:make_net_process; reference eval.py:158-181)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from u2pl_tpu_torch.ops.resize import resize_bilinear


def make_net_process(model: torch.nn.Module) -> Callable:
    """Returns f(images NHWC float32 numpy) -> logits (B, C, H, W) on the
    model's device, upsampled to the input size (kernel A on the card).

    The result stays on the device (the serving path's argmax kernel reads
    it there).  Unlike the JAX version there is no compiled program per
    batch shape to reuse, so a partial batch is run as it is, not
    zero-padded."""
    device = next(model.parameters()).device
    model.eval()

    @torch.inference_mode()
    def net_process(images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        x = x.to(device).permute(0, 3, 1, 2).contiguous()
        pred = model(x)["pred"]
        return resize_bilinear(pred, x.shape[2:], align_corners=True)

    return net_process
