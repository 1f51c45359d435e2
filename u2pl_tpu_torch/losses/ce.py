"""Cross-entropy with an ignore index on upsampled logits (port of
u2pl_tpu/losses/ce.py and the `_upsample` of u2pl_tpu/train/steps.py:69).

The JAX step upsamples the os4 logits to label size and then takes the CE;
the port fuses the two: `upsample_cross_entropy(logits_os4, labels)` is
`cross_entropy_ignore(_upsample(logits), labels)` with the upsample inside
(kernel C, `kernels/csrc/upsample_ce.cu`, forward and backward), so on the
card the (B, C, H, W) upsampled logits are never stored for the forward.
On a CPU tensor it is the plain version: kernel A's plain resize, then
`log_softmax` and a gather, differentiated by autograd.  Reductions are
float32; the empty valid set gives 0, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from u2pl_tpu_torch.ops.resize import (
    _check_cuda_f32,
    _device_taps,
    resize_bilinear_bwd,
    resize_bilinear_plain,
)

# 19-entry binary class-weight vector used by Criterion(use_weight=True)
# (the JAX package's CITYSCAPES_BINARY_WEIGHT, u2pl_tpu/losses/ce.py:17)
CITYSCAPES_BINARY_WEIGHT = (
    0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0,
    0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0,
)


def cross_entropy_ignore(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE of NCHW `logits` over the pixels whose (B, H, W) label is not
    `ignore_label`; with `class_weight` w: sum(w[y] nll) / sum(w[y]).  The
    JAX `cross_entropy_ignore`, including 0 for an empty valid set."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    if class_weight is not None:
        w = class_weight.to(logp)[safe] * valid
        denom = w.sum()
        return torch.where(
            denom > 0, (nll * w).sum() / torch.clamp(denom, min=1e-12), 0.0
        )
    vf = valid.float()
    denom = vf.sum()
    return torch.where(denom > 0, (nll * vf).sum() / torch.clamp(denom, min=1.0), 0.0)


def upsample_cross_entropy_plain(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel C: kernel A's plain resize of the
    (B, C, h, w) logits to the labels' (H, W), then `cross_entropy_ignore`."""
    up = resize_bilinear_plain(logits, labels.shape[1:])
    return cross_entropy_ignore(up, labels, ignore_label, class_weight)


def upsample_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`cross_entropy_ignore(resize_bilinear(logits, labels' H, W), labels)`
    (kernel C on the card).  logits (B, C, h, w) float32; labels (B, H, W)
    int32; returns a 0-d device tensor, differentiable in `logits` only."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"upsample_cross_entropy: logits {tuple(logits.shape)}, labels "
            f"{tuple(labels.shape)}"
        )
    if logits.device.type == "cpu":
        return upsample_cross_entropy_plain(logits, labels, ignore_label, class_weight)
    return _UpsampleCE.apply(logits, labels, ignore_label, class_weight)


def _check_ce_inputs(logits, labels, class_weight):
    _check_cuda_f32(logits, 4, "upsample_cross_entropy")
    if labels.device != logits.device or labels.dtype != torch.int32:
        raise TypeError("upsample_cross_entropy: labels must be int32 on the logits' device")
    if not labels.is_contiguous():
        raise ValueError("upsample_cross_entropy: the CUDA kernel takes contiguous labels")
    b, c, _, _ = logits.shape
    if b * c * labels.shape[1] * labels.shape[2] >= 2**31:
        raise ValueError("upsample_cross_entropy: the upsampled logits exceed the int32 sizes")
    if class_weight is not None:
        _check_cuda_f32(class_weight, 1, "upsample_cross_entropy class_weight")
        if class_weight.shape[0] != c:
            raise ValueError("upsample_cross_entropy: one class weight per class")


class _UpsampleCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_label, class_weight):
        _check_ce_inputs(logits, labels, class_weight)
        from u2pl_tpu_torch.kernels import check, load

        lib = load()
        b, c, h, w = logits.shape
        oh, ow = labels.shape[1:]
        dev = logits.device
        idx_h, w_h = _device_taps(h, oh, True, dev)
        idx_w, w_w = _device_taps(w, ow, True, dev)
        lse = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
        part = torch.empty(2 * lib.u2pl_upsample_ce_parts(), dtype=torch.float64, device=dev)
        stats = torch.empty(2, dtype=torch.float32, device=dev)  # [loss, denom]
        floor = 1e-12 if class_weight is not None else 1.0
        cw = class_weight.data_ptr() if class_weight is not None else None
        with torch.cuda.device(dev):
            err = lib.u2pl_upsample_ce_fwd(
                logits.data_ptr(), labels.data_ptr(), cw, lse.data_ptr(),
                part.data_ptr(), stats.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
                idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow,
                int(ignore_label), floor, torch.cuda.current_stream(dev).cuda_stream,
            )
        check(lib, err, "upsample_ce_fwd launch")
        upsample_cross_entropy.fwd_launches += 1
        ctx.save_for_backward(logits, labels, lse, stats, class_weight)
        ctx.ignore_label, ctx.floor = int(ignore_label), floor
        return stats[0].clone()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, stats, class_weight = ctx.saved_tensors
        from u2pl_tpu_torch.kernels import check, load

        lib = load()
        b, c, h, w = logits.shape
        oh, ow = labels.shape[1:]
        dev = logits.device
        idx_h, w_h = _device_taps(h, oh, True, dev)
        idx_w, w_w = _device_taps(w, ow, True, dev)
        g = g.to(torch.float32).contiguous()
        gfull = torch.empty((b, c, oh, ow), dtype=torch.float32, device=dev)
        cw = class_weight.data_ptr() if class_weight is not None else None
        with torch.cuda.device(dev):
            err = lib.u2pl_upsample_ce_bwd(
                logits.data_ptr(), labels.data_ptr(), cw, lse.data_ptr(),
                stats.data_ptr(), g.data_ptr(), gfull.data_ptr(), idx_h.data_ptr(),
                w_h.data_ptr(), idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow,
                ctx.ignore_label, ctx.floor, torch.cuda.current_stream(dev).cuda_stream,
            )
        check(lib, err, "upsample_ce_bwd launch")
        upsample_cross_entropy.bwd_launches += 1
        return resize_bilinear_bwd(gfull, (h, w)), None, None, None


upsample_cross_entropy.fwd_launches = 0
upsample_cross_entropy.bwd_launches = 0


def supervised_loss(
    pred: torch.Tensor,
    labels: torch.Tensor,
    aux: Optional[torch.Tensor] = None,
    aux_weight: float = 0.0,
    ignore_label: int = 255,
    use_weight: bool = False,
) -> torch.Tensor:
    """The JAX `supervised_loss` (`Criterion` parity) on os4 `pred` / `aux`
    logits, each upsampled inside `upsample_cross_entropy`: main CE (+ the
    binary-weighted CE when use_weight) + aux_weight * aux CE.

    Reference quirk kept: use_weight only takes effect together with the
    aux head — the non-aux branch ignores it (u2pl_tpu/losses/ce.py:61-71)."""
    loss = upsample_cross_entropy(pred, labels, ignore_label)
    has_aux = aux is not None and aux_weight > 0
    if use_weight and has_aux:
        cw = torch.tensor(CITYSCAPES_BINARY_WEIGHT, dtype=torch.float32, device=pred.device)
        loss = loss + upsample_cross_entropy(pred, labels, ignore_label, cw)
    if has_aux:
        loss = loss + aux_weight * upsample_cross_entropy(aux, labels, ignore_label)
    return loss
