"""Cross-entropy with an ignore index on upsampled logits (port of
u2pl_tpu/losses/ce.py and the `_upsample` of u2pl_tpu/train/steps.py:69).

The JAX step upsamples the os4 logits to label size and then takes the CE;
the port fuses the two: `upsample_cross_entropy(logits_os4, labels)` is
`cross_entropy_ignore(_upsample(logits), labels)` with the upsample inside
(kernel C, `kernels/csrc/upsample_ce.cu`, forward and backward), so on the
card the (B, C, H, W) upsampled logits are never stored: the forward
reduces them per pixel, and the backward, fused with the adjoint resize,
writes the gradient to the os4 logits from one full-resolution row at a
time in shared memory.  On a CPU tensor it is the plain version: kernel
A's plain resize, then `log_softmax` and a gather, differentiated by
autograd (`upsample_ce_bwd_plain` is the backward written out).
Reductions are float32; the empty valid set gives 0, as in JAX.

bfloat16 logits (a bf16 model): JAX's upsample is then the narrow branch
of its resize, each upsampled value rounded to bf16, and the CE takes their
f32 cast (ce.py:36-46); the gradient rounds the full-resolution cotangent
to bf16 (the VJP of that cast), takes the adjoint resize in f32 and gives
bf16 logits' gradients.  Kernel C has a bf16 mode that rounds at those
points; the plain versions round there too.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from u2pl_tpu_torch.ops.resize import (
    F32_BF16,
    _check_cuda,
    _device_ranges,
    _device_taps,
    _ranges_np,
    _sm_count,
    resize_bilinear_bwd_plain,
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


def upsample_ce_bwd_plain(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
    ignore_label: int = 255,
    g: Union[float, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of kernel C's backward: the gradient of
    `g * upsample_cross_entropy(logits, labels)` to the (B, C, h, w) logits.
    It builds the full-resolution gradient coef * (softmax(up) - onehot(y)),
    coef = w[y] g / max(denom, floor) and 0 where y is ignored or outside
    [0, C), then applies A-bwd's plain version.  bf16 logits: `up` is the
    bf16 upsample, the full-resolution gradient is rounded to bf16, the
    adjoint is f32 and the result bf16."""
    c, h, w = logits.shape[1:]
    up = resize_bilinear_plain(logits, labels.shape[1:]).float()
    y = labels.long()
    valid = (y != ignore_label) & (y >= 0) & (y < c)
    safe = torch.where(valid, y, torch.zeros_like(y))
    if class_weight is None:
        wy, floor = valid.float(), 1.0
    else:
        wy, floor = class_weight.to(up)[safe] * valid, 1e-12
    denom = wy.sum()
    g = torch.as_tensor(g, dtype=torch.float32, device=up.device)
    scale = torch.where(denom > 0, g / torch.clamp(denom, min=floor), torch.zeros_like(g))
    onehot = torch.nn.functional.one_hot(safe, c).permute(0, 3, 1, 2).to(up)
    gfull = (torch.softmax(up, dim=1) - onehot) * (wy * scale)[:, None]
    if logits.dtype != torch.float32:
        gfull = gfull.to(logits.dtype).float()
    return resize_bilinear_bwd_plain(gfull, (h, w)).to(logits.dtype)


def upsample_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`cross_entropy_ignore(resize_bilinear(logits, labels' H, W), labels)`
    (kernel C on the card).  logits (B, C, h, w) float32 or bfloat16 (JAX's
    bf16 rounding points, module docstring); labels (B, H, W) int32;
    returns a 0-d f32 device tensor, differentiable in `logits` only."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"upsample_cross_entropy: logits {tuple(logits.shape)}, labels "
            f"{tuple(labels.shape)}"
        )
    if logits.device.type == "cpu":
        return upsample_cross_entropy_plain(logits, labels, ignore_label, class_weight)
    return _UpsampleCE.apply(logits, labels, ignore_label, class_weight)


# the logits' dtypes of kernels C, D and K7 prob (upsample_ce.cu's `dtype`)
LOGIT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_ce_inputs(logits, labels, class_weight):
    _check_cuda(logits, 4, "upsample_cross_entropy", F32_BF16)
    if labels.device != logits.device or labels.dtype != torch.int32:
        raise TypeError("upsample_cross_entropy: labels must be int32 on the logits' device")
    if not labels.is_contiguous():
        raise ValueError("upsample_cross_entropy: the CUDA kernel takes contiguous labels")
    b, c, _, _ = logits.shape
    if b * c * labels.shape[1] * labels.shape[2] >= 2**31:
        raise ValueError("upsample_cross_entropy: the upsampled logits exceed the int32 sizes")
    if class_weight is not None:
        _check_cuda(class_weight, 1, "upsample_cross_entropy class_weight")
        if class_weight.shape[0] != c:
            raise ValueError("upsample_cross_entropy: one class weight per class")


# shared memory a block of the fused backward may use: sm_90's 227 KB
# (kernels/csrc/upsample_ce.cu:kBwdMaxShared)
BWD_MAX_SHARED = 232448


def _bwd_smem(c: int, w: int, ow: int, rows: int, span: int, log_s: int, q: int) -> int:
    """Bytes of shared memory of one block of the fused backward: the column
    taps, one output row of g in the slot layout (classes padded to groups
    of 4), one row of H-lerped inputs, the band's accumulators, one row of
    coef / lse / labels, the column tap weights and the class weights
    (upsample_ce.cu:bwd_smem)."""
    return 8 * ow + 4 * (-(-c // 4) * 4 * (1 << log_s) * q + c * w + c * rows * w + 3 * ow
                         + w * span + 2 * w + c)


@functools.lru_cache(maxsize=64)
def _bwd_plan(b: int, c: int, h: int, w: int, oh: int, ow: int,
              sms: int) -> Tuple[int, int, int, int, int]:
    """The fused backward's launch: (rows, bands, span, log_s, q).

    A block owns `rows` input rows of one image; the rows are the fewest
    for which the B x bands blocks fit in one wave on `sms` SMs (fewer when
    the block's shared memory would exceed BWD_MAX_SHARED).  span: the most
    output columns reaching one input column, made odd so that lanes on
    consecutive input columns read the tap-weight table on distinct banks.
    A g row is stored with output column ox at (ox % S) * q + ox // S,
    S = 2**log_s ~ the upsample factor (at most 8) and q = 32 / S (mod 32),
    so that lanes ~S columns apart hit distinct banks."""
    if w >= 32768:
        raise ValueError(f"upsample_cross_entropy: width {w} exceeds the backward's 16-bit taps")
    counts = np.diff(_ranges_np(w, ow, True), axis=0)[0]
    span = max(int(counts.max()), 1) | 1
    factor = (ow - 1) / max(w - 1, 1)
    log_s = 0
    while log_s < 3 and 2 ** (log_s + 1) <= factor + 0.5:
        log_s += 1
    s = 1 << log_s
    q = -(-ow // s)
    if s > 1:
        q += (32 // s - q) % 32
    rows = -(-h // min(h, max(1, sms // b)))
    while rows > 1 and _bwd_smem(c, w, ow, rows, span, log_s, q) > BWD_MAX_SHARED:
        rows -= 1
    if _bwd_smem(c, w, ow, rows, span, log_s, q) > BWD_MAX_SHARED:
        raise ValueError(f"upsample_cross_entropy: {c} classes at widths {w} -> {ow} exceed "
                         f"the backward's {BWD_MAX_SHARED} bytes of shared memory")
    return rows, -(-h // rows), span, log_s, q


# kernels C fwd and D (upsample_ce.cu: kStatsMaxShared): a block's bytes of
# column taps and H-lerped input rows, and the output pixels it owns
STATS_MAX_SHARED = 224 * 1024
STATS_SPAN = 1024


@functools.lru_cache(maxsize=64)
def _stats_plan(b: int, c: int, w: int, oh: int, ow: int) -> Tuple[int, int, int]:
    """The launch of C's forward and of D: (span, max_rows, smem bytes).

    A block owns `span` consecutive output pixels (STATS_SPAN, halved while
    the input rows they touch, at most span // ow + 2 of C x w floats, and
    the column taps, 16 B per column in groups of 4, exceed
    STATS_MAX_SHARED); max_rows is that row count (upsample_ce.cu:
    stats_plan_ok)."""
    taps, row = 64 * -(-ow // 4), 4 * c * w + 16
    span = STATS_SPAN
    while span > 4 and taps + (span // ow + 2) * row > STATS_MAX_SHARED:
        span //= 2
    max_rows = min(span // ow + 2, b * oh)
    smem = taps + max_rows * row
    if smem > STATS_MAX_SHARED or max_rows * c * w >= 2**24 or ow >= 2**23:
        raise ValueError(f"upsample: {c} classes at widths {w} -> {ow} exceed the kernel's "
                         f"{STATS_MAX_SHARED} bytes of shared memory")
    return span, max_rows, smem


class _UpsampleCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_label, class_weight):
        _check_ce_inputs(logits, labels, class_weight)
        from u2pl_tpu_torch.kernels import check, load

        b, c, h, w = logits.shape
        oh, ow = labels.shape[1:]
        span, max_rows, _ = _stats_plan(b, c, w, oh, ow)
        lib = load()
        dev = logits.device
        idx_h, w_h = _device_taps(h, oh, True, dev)
        idx_w, w_w = _device_taps(w, ow, True, dev)
        lse = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
        part = torch.empty(2 * -(-(b * oh * ow) // span), dtype=torch.float64, device=dev)
        stats = torch.empty(2, dtype=torch.float32, device=dev)  # [loss, denom]
        floor = 1e-12 if class_weight is not None else 1.0
        cw = class_weight.data_ptr() if class_weight is not None else None
        with torch.cuda.device(dev):
            err = lib.u2pl_upsample_ce_fwd(
                logits.data_ptr(), labels.data_ptr(), cw, lse.data_ptr(),
                part.data_ptr(), stats.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
                idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow,
                int(ignore_label), floor, span, max_rows, LOGIT_DTYPES[logits.dtype],
                torch.cuda.current_stream(dev).cuda_stream,
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
        rows, bands, span, log_s, q = _bwd_plan(b, c, h, w, oh, ow, _sm_count(dev))
        idx_h, w_h = _device_taps(h, oh, True, dev)
        idx_w, w_w = _device_taps(w, ow, True, dev)
        rng_h = _device_ranges(h, oh, True, dev)
        rng_w = _device_ranges(w, ow, True, dev)
        g = g.to(torch.float32).contiguous()
        gx = torch.empty_like(logits)
        cw = class_weight.data_ptr() if class_weight is not None else None
        with torch.cuda.device(dev):
            err = lib.u2pl_upsample_ce_bwd(
                logits.data_ptr(), labels.data_ptr(), cw, lse.data_ptr(),
                stats.data_ptr(), g.data_ptr(), gx.data_ptr(), idx_h.data_ptr(),
                w_h.data_ptr(), rng_h.data_ptr(), idx_w.data_ptr(), w_w.data_ptr(),
                rng_w.data_ptr(), b, c, h, w, oh, ow, ctx.ignore_label, ctx.floor,
                rows, bands, span, log_s, q, LOGIT_DTYPES[logits.dtype],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        check(lib, err, "upsample_ce_bwd launch")
        upsample_cross_entropy.bwd_launches += 1
        return gx, None, None, None


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
