"""Entropy-gated unsupervised CE on pseudo-labels, and the per-pixel softmax
statistics of upsampled teacher logits (port of u2pl_tpu/losses/unsup.py and
of u2pl_tpu/train/steps.py:295-301).

`upsample_softmax_stats(logits_os4, size, outputs)` returns, per pixel of
the align-corners upsample to `size`, the max softmax probability, the
first-max argmax and the entropy -sum p log(p + 1e-10), or the part of
them that `outputs` selects: kernel D (`kernels/csrc/upsample_ce.cu`) on
the card, which writes nothing of size (B, C, H, W) and only the outputs
asked for; its plain version on a CPU tensor.  On bf16 logits both take
the statistics of the bf16-rounded upsample (steps.py:289-301, :352), and
the argmax keeps the first of exactly tied classes.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from u2pl_tpu_torch.losses.ce import LOGIT_DTYPES, _stats_launch, upsample_cross_entropy
from u2pl_tpu_torch.ops.resize import (
    F32_BF16,
    _check_cuda,
    _device_taps,
    _sm_count,
    resize_bilinear_plain,
)


def teacher_entropy(prob_logits: torch.Tensor) -> torch.Tensor:
    """-sum p log(p + 1e-10) over the class axis of NCHW logits
    (u2pl_tpu/losses/unsup.py:24)."""
    prob = torch.softmax(prob_logits.float(), dim=1)
    return -torch.sum(prob * torch.log(prob + 1e-10), dim=1)


# the outputs a call of `upsample_softmax_stats` computes: max-prob and
# argmax (the pseudo-labels, steps.py:300-301), the entropy (unsup.py:24),
# or all three
STATS_OUTPUTS = ("prob", "entropy", "all")
MAX_STATS_CLASSES = 32  # kernel D keeps one pixel's C values in registers

Stats = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


def _check_outputs(outputs: str) -> Tuple[bool, bool]:
    if outputs not in STATS_OUTPUTS:
        raise ValueError(f"upsample_softmax_stats: outputs {outputs!r}, not one of {STATS_OUTPUTS}")
    return outputs != "entropy", outputs != "prob"


def upsample_softmax_stats_plain(
    logits: torch.Tensor, size: Tuple[int, int], outputs: str = "all"
) -> Stats:
    """Plain PyTorch version of kernel D: kernel A's plain resize (in the
    logits' dtype), then exp(max - logsumexp), argmax (the first of tied
    maxima) and `teacher_entropy` over C of its f32 cast, each where
    `outputs` asks for it (None in its place otherwise)."""
    prob, ent = _check_outputs(outputs)
    up = resize_bilinear_plain(logits, size).float()
    maxprob = argmax = entropy = None
    if prob:
        maxprob = torch.exp(up.amax(dim=1) - torch.logsumexp(up, dim=1))
        argmax = up.argmax(dim=1).to(torch.int32)
    if ent:
        entropy = teacher_entropy(up)
    return maxprob, argmax, entropy


@torch.no_grad()
def upsample_softmax_stats(
    logits: torch.Tensor, size: Tuple[int, int], outputs: str = "all"
) -> Stats:
    """(max-prob f32, argmax int32, entropy f32), each (B, H, W), of the
    (B, C, h, w) float32 or bfloat16 logits upsampled to `size` (kernel D;
    no gradient).
    `outputs` selects what is computed and written: "prob" (max-prob and
    argmax; entropy None), "entropy" (the others None) or "all"."""
    prob, ent = _check_outputs(outputs)
    if logits.dim() != 4:
        raise ValueError(f"upsample_softmax_stats: expected NCHW, got {tuple(logits.shape)}")
    oh, ow = int(size[0]), int(size[1])
    if logits.device.type == "cpu":
        return upsample_softmax_stats_plain(logits, (oh, ow), outputs)
    _check_cuda(logits, 4, "upsample_softmax_stats", F32_BF16)
    b, c, h, w = logits.shape
    if b * c * oh * ow >= 2**31:
        raise ValueError("upsample_softmax_stats: the upsampled logits exceed the int32 sizes")
    if c > MAX_STATS_CLASSES:
        raise ValueError(f"upsample_softmax_stats: {c} classes (at most {MAX_STATS_CLASSES})")
    dev = logits.device
    plan = _stats_launch(b, c, h, w, oh, ow, logits.dtype, _sm_count(dev))
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    idx_h, w_h = _device_taps(h, oh, True, dev)
    idx_w, w_w = _device_taps(w, ow, True, dev)

    def out(wanted: bool, dtype: torch.dtype) -> Optional[torch.Tensor]:
        return torch.empty((b, oh, ow), dtype=dtype, device=dev) if wanted else None

    maxprob, argmax = out(prob, torch.float32), out(prob, torch.int32)
    entropy = out(ent, torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.u2pl_upsample_softmax_stats(
            logits.data_ptr(), ptr(maxprob), ptr(argmax), ptr(entropy), idx_h.data_ptr(),
            w_h.data_ptr(), idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow,
            *plan, LOGIT_DTYPES[logits.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "upsample_softmax_stats launch")
    upsample_softmax_stats.launches += 1
    upsample_softmax_stats.selections[outputs] += 1
    return maxprob, argmax, entropy


upsample_softmax_stats.launches = 0
upsample_softmax_stats.selections = collections.Counter()  # launches per `outputs`


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
