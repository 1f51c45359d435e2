"""Entropy-gated unsupervised CE on pseudo-labels, and the per-pixel softmax
statistics of upsampled teacher logits (port of u2pl_tpu/losses/unsup.py and
of u2pl_tpu/train/steps.py:295-301).

`upsample_softmax_stats(logits_os4, size)` returns, per pixel of the
align-corners upsample to `size`, the max softmax probability, the
first-max argmax and the entropy -sum p log(p + 1e-10): kernel D
(`kernels/csrc/upsample_ce.cu`) on the card, which writes nothing of size
(B, C, H, W); its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from u2pl_tpu_torch.losses.ce import upsample_cross_entropy
from u2pl_tpu_torch.ops.resize import _check_cuda_f32, _device_taps, resize_bilinear_plain


def teacher_entropy(prob_logits: torch.Tensor) -> torch.Tensor:
    """-sum p log(p + 1e-10) over the class axis of NCHW logits
    (u2pl_tpu/losses/unsup.py:24)."""
    prob = torch.softmax(prob_logits.float(), dim=1)
    return -torch.sum(prob * torch.log(prob + 1e-10), dim=1)


def upsample_softmax_stats_plain(
    logits: torch.Tensor, size: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D: kernel A's plain resize, then
    exp(max - logsumexp), argmax and `teacher_entropy` over C."""
    up = resize_bilinear_plain(logits, size).float()
    maxprob = torch.exp(up.amax(dim=1) - torch.logsumexp(up, dim=1))
    return maxprob, up.argmax(dim=1).to(torch.int32), teacher_entropy(up)


@torch.no_grad()
def upsample_softmax_stats(
    logits: torch.Tensor, size: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max-prob f32, argmax int32, entropy f32), each (B, H, W), of the
    (B, C, h, w) logits upsampled to `size` (kernel D; no gradient)."""
    if logits.dim() != 4:
        raise ValueError(f"upsample_softmax_stats: expected NCHW, got {tuple(logits.shape)}")
    oh, ow = int(size[0]), int(size[1])
    if logits.device.type == "cpu":
        return upsample_softmax_stats_plain(logits, (oh, ow))
    _check_cuda_f32(logits, 4, "upsample_softmax_stats")
    b, c, h, w = logits.shape
    if b * c * oh * ow >= 2**31:
        raise ValueError("upsample_softmax_stats: the upsampled logits exceed the int32 sizes")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    dev = logits.device
    idx_h, w_h = _device_taps(h, oh, True, dev)
    idx_w, w_w = _device_taps(w, ow, True, dev)
    maxprob = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, oh, ow), dtype=torch.int32, device=dev)
    entropy = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_upsample_softmax_stats(
            logits.data_ptr(), maxprob.data_ptr(), argmax.data_ptr(),
            entropy.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(), idx_w.data_ptr(),
            w_w.data_ptr(), b, c, h, w, oh, ow, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "upsample_softmax_stats launch")
    upsample_softmax_stats.launches += 1
    return maxprob, argmax, entropy


upsample_softmax_stats.launches = 0


def compute_unsupervised_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    entropy: torch.Tensor,
    thresh: torch.Tensor,
    ignore_label: int = 255,
) -> torch.Tensor:
    """The JAX `compute_unsupervised_loss` with the entropy and its drop
    threshold given (as the semi step gives them): pixels whose teacher
    entropy is >= `thresh` among the valid ones are dropped to
    `ignore_label`, and the CE of the os4 `pred` (upsampled inside, kernel C)
    on the rest is weighted by b*h*w / max(kept, 1)."""
    b, h, w = target.shape
    drop = (entropy >= thresh) & (target != ignore_label)
    new_target = torch.where(drop, torch.full_like(target, ignore_label), target)
    kept = (new_target != ignore_label).sum().float()
    total = torch.full((), float(b * h * w), device=pred.device)
    weight = total / torch.clamp(kept, min=1.0)
    return weight * upsample_cross_entropy(pred, new_target, ignore_label)
