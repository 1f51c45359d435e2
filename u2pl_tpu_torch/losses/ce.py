"""Cross-entropy with an ignore index on upsampled logits (port of
u2pl_tpu/losses/ce.py and the `_upsample` of u2pl_tpu/train/steps.py:69).

The JAX step upsamples the os4 logits to label size and then takes the CE;
the port fuses the two: `upsample_cross_entropy(logits_os4, labels)` is
`cross_entropy_ignore(_upsample(logits), labels)` with the upsample inside
(kernel C, `kernels/csrc/upsample_ce.cu`, forward and backward), so on the
card the (B, C, H, W) upsampled logits are never stored: the forward
reduces them per pixel, and the backward, fused with the adjoint resize,
writes the gradient to the os4 logits from a few full-resolution rows of
a group of classes at a time in shared memory.  On a CPU tensor it is the plain version: kernel
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
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from u2pl_tpu_torch.ops.resize import (
    F32_BF16,
    _check_cuda,
    _device_ranges,
    _device_taps,
    _interp_taps_np,
    _ranges_np,
    _sm_count,
    resize_bilinear_bwd_plain,
    resize_bilinear_plain,
    resize_bilinear_rounded,
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
    adjoint is f32 and the result bf16.  float64 logits: every step in
    float64 (the same f32 interpolation weights), a reference."""
    c, h, w = logits.shape[1:]
    up = resize_bilinear_plain(logits, labels.shape[1:])
    up = up if up.dtype == torch.float64 else up.float()
    y = labels.long()
    valid = (y != ignore_label) & (y >= 0) & (y < c)
    safe = torch.where(valid, y, torch.zeros_like(y))
    if class_weight is None:
        wy, floor = valid.to(up.dtype), 1.0
    else:
        wy, floor = class_weight.to(up)[safe] * valid, 1e-12
    denom = wy.sum()
    g = torch.as_tensor(g, dtype=up.dtype, device=up.device)
    scale = torch.where(denom > 0, g / torch.clamp(denom, min=floor), torch.zeros_like(g))
    onehot = torch.nn.functional.one_hot(safe, c).permute(0, 3, 1, 2).to(up)
    gfull = (torch.softmax(up, dim=1) - onehot) * (wy * scale)[:, None]
    if logits.dtype == torch.bfloat16:
        gfull = gfull.to(logits.dtype).float()
    return resize_bilinear_bwd_plain(gfull, (h, w)).to(logits.dtype)


def _adjoint_table(n_in: int, n_out: int, device):
    """(output index, weight, in range), each (span, n_in), per input index
    and slot j: the output indices [start, end) whose taps reach the input
    index (`_ranges_np`) in ascending order, and their weights as
    common.cuh's tap_weight computes them (lo's weight, then hi's added)."""
    lo, hi, frac = _interp_taps_np(n_in, n_out, True)
    w0, w1 = np.float32(1.0) - frac, frac
    start, end = _ranges_np(n_in, n_out, True)
    span = max(int((end - start).max()), 1)
    slot = start[None, :] + np.arange(span)[:, None]
    o = np.minimum(slot, n_out - 1)
    i = np.arange(n_in)[None, :]
    wt = np.where(lo[o] == i, w0[o], np.float32(0.0)).astype(np.float32)
    wt = np.where(hi[o] == i, (wt + w1[o]).astype(np.float32), wt)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(o.astype(np.int64)), to(wt), to(slot < end[None, :])


def upsample_ce_bwd_ordered(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
    ignore_label: int = 255,
    g: Union[float, torch.Tensor] = 1.0,
    lse: Optional[torch.Tensor] = None,
    denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel C's backward in its own arithmetic, in torch ops, for checking
    it (on the card it gives the kernel's bits): the upsample is
    `resize_bilinear_rounded` (bf16: rounded to bf16), lse = m + log(s) with
    s summed over the classes in order (the forward's; or the forward's
    saved `lse`), denom the weights summed in float64 and rounded to f32
    (or the forward's saved one), coef = w[y] * (g / max(denom, floor)) and
    +0 where coef is 0, each g value coef * (exp(v - lse) - [c == y])
    (bf16: rounded to bf16); then the adjoint's sums in the kernel's order:
    per output row the W sum over the output columns reaching each input
    column, ascending from 0, then per input row the H sum over the output
    rows reaching it, ascending from 0, each product and sum rounded on its
    own.  It holds (B, C, OH, OW) and (B, C, OH, w) f32."""
    b, c, h, w = logits.shape
    oh, ow = labels.shape[1:]
    dev = logits.device
    up = resize_bilinear_rounded(logits, (oh, ow)).float()
    if lse is None:
        m = up.amax(dim=1)
        s = torch.zeros_like(m)
        for k in range(c):
            s = s + torch.exp(up[:, k] - m)
        lse = m + torch.log(s)
    y = labels.long()
    valid = (y != ignore_label) & (y >= 0) & (y < c)
    safe = torch.where(valid, y, torch.zeros_like(y))
    if class_weight is None:
        wy, floor = valid.float(), 1.0
    else:
        wy, floor = torch.where(valid, class_weight.float()[safe], torch.zeros_like(up[:, 0])), 1e-12
    if denom is None:
        denom = wy.double().sum().float()
    g = torch.as_tensor(g, dtype=torch.float32, device=dev)
    scale = torch.where(denom > 0, g / torch.clamp(denom, min=floor), torch.zeros_like(g))
    cws = (torch.ones(c, device=dev) if class_weight is None else class_weight.float()) * scale
    coef = torch.where(valid, cws[safe], torch.zeros_like(up[:, 0]))[:, None]
    e = torch.exp(up - lse[:, None])
    onehot = torch.arange(c, device=dev)[None, :, None, None] == y[:, None]
    gfull = torch.where(coef == 0, torch.zeros_like(e), coef * torch.where(onehot, e - 1.0, e))
    if logits.dtype != torch.float32:
        gfull = gfull.to(logits.dtype).float()
    o_w, wt_w, m_w = _adjoint_table(w, ow, dev)
    o_h, wt_h, m_h = _adjoint_table(h, oh, dev)
    s = torch.zeros((b, c, oh, w), device=dev)
    for j in range(o_w.shape[0]):
        s = torch.where(m_w[j], s + wt_w[j] * gfull.index_select(3, o_w[j]), s)
    gx = torch.zeros((b, c, h, w), device=dev)
    for j in range(o_h.shape[0]):
        gx = torch.where(m_h[j][:, None], gx + wt_h[j][:, None] * s.index_select(2, o_h[j]), gx)
    return gx.to(logits.dtype)


def upsample_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = 255,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`cross_entropy_ignore(resize_bilinear(logits, labels' H, W), labels)`
    (kernel C on the card).  logits (B, C, h, w) float32 or bfloat16 (JAX's
    bf16 rounding points, module docstring); labels (B, H, W) int32;
    returns a 0-d f32 device tensor, differentiable in `logits` only.  On
    the card, logits that need a gradient are at most BWD_MAX_THREADS (1024)
    columns wide (the backward's plan, `_bwd_plan`, checked before the
    forward runs)."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"upsample_cross_entropy: logits {tuple(logits.shape)}, labels "
            f"{tuple(labels.shape)}"
        )
    if logits.device.type == "cpu":
        return upsample_cross_entropy_plain(logits, labels, ignore_label, class_weight)
    if torch.is_grad_enabled() and logits.requires_grad:  # a shape the backward refuses
        b, c, h, w = logits.shape
        _bwd_plan(b, c, h, w, *labels.shape[1:], _sm_count(logits.device), logits.element_size())
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


# the fused backward (kernels/csrc/upsample_ce.cu): the shared memory a block
# may use (sm_90's 227 KB, kBwdMaxShared), its most threads a block (at an
# exact column ratio kBwdExactThreads, for two blocks an SM), classes and
# output rows a step (kBwdClasses, kBwdMaxChunk); the plan's blocks an SM
# (one wave of two) and each one's shared memory for that
BWD_MAX_SHARED = 232448
BWD_MAX_THREADS = 1024
BWD_EXACT_THREADS = 512
BWD_CLASSES = 4
BWD_MAX_CHUNK = 4
BWD_BLOCKS_PER_SM = 2
BWD_SHARED_PER_BLOCK = 113 * 1024


class BwdPlan(NamedTuple):
    """The fused backward's launch (`_bwd_plan`)."""

    groups: int  # class groups, the C classes split evenly
    cls: int  # the most classes of a group (the exact-ratio kernel's classes)
    rows: int  # input rows of a band
    bands: int
    chunk: int  # output rows a step (one barrier each)
    threads: int  # a block's: cls x w owner pairs, one or two a thread, whole warps
    span: int  # the most output columns reaching an input column, odd
    gs: int  # a g row's elements: output column ox at ratio + ox, a multiple of 8
    ratio: int  # 4 or 8 where ow - 1 = ratio (w - 1): the owners' taps are constants


def _bwd_smem(c: int, w: int, ow: int, cls: int, chunk: int, span: int, gs: int,
              ratio: int, gbytes: int = 4) -> int:
    """Bytes of shared memory of one block of the fused backward: two steps'
    g rows of `cls` classes, `gbytes` a value (4 in f32, 2 in bf16), two
    steps' row taps (16 B a row), the column taps (8 B a column), two
    steps' labels and lse and H-lerped rows, the class weights and, at no
    exact ratio, the column tap weights (upsample_ce.cu:bwd_smem)."""
    return (2 * gbytes * chunk * cls * gs + 32 * chunk + 8 * ow + 16 * chunk * ow
            + 4 * (2 * chunk * cls * w + c + (0 if ratio else w * span + 2 * w)))


@functools.lru_cache(maxsize=64)
def _bwd_plan(b: int, c: int, h: int, w: int, oh: int, ow: int, sms: int,
              gbytes: int = 4) -> BwdPlan:
    """The fused backward's launch, for g rows of `gbytes` a value (the
    logits' dtype).

    A block owns a group of classes of a band of `rows` input rows of one
    image, with an owner per (class, input column).  At an exact column
    ratio (ow - 1 = 4 or 8 times w - 1: every training shape; w <= 256,
    c >= 3) the kernel is compiled for 3 or 4 classes a group, whichever
    splits the c classes with fewer unused slots (the larger at a tie), and
    a thread owns one pair, or two where the pairs pass BWD_EXACT_THREADS;
    elsewhere up to BWD_CLASSES classes, one pair a thread.  The bands are
    the shortest for which the b x bands x groups blocks fit one wave of
    BWD_BLOCKS_PER_SM on each of `sms` SMs (a second, partial wave costs
    more than the boundary output rows that two bands both walk), and a
    step takes the most output rows (up to BWD_MAX_CHUNK) for which a block
    fits BWD_SHARED_PER_BLOCK, so that two share an SM.  span: the most output columns
    reaching one input column, made odd so that lanes on consecutive input
    columns read the tap-weight table on distinct banks.  A g row holds
    output column ox at ratio + ox, its 2 x ratio owner values read past
    both ends."""
    if w > BWD_MAX_THREADS:
        raise ValueError(f"upsample_cross_entropy: width {w} exceeds the backward's "
                         f"{BWD_MAX_THREADS} owner threads a block")
    counts = np.diff(_ranges_np(w, ow, True), axis=0)[0]
    span = max(int(counts.max()), 1) | 1
    ratio = next((s for s in (4, 8) if c >= 3 and 2 <= w <= BWD_EXACT_THREADS // 2
                  and ow - 1 == s * (w - 1)), 0)
    gs = -(-(ow + 2 * ratio) // 8) * 8
    if ratio:
        cls = min((4, 3), key=lambda n: (-(-c // n) * n - c, -n))
        pairs = 1 if cls * w <= BWD_EXACT_THREADS else 2
    else:
        cls, pairs = min(BWD_CLASSES, c, BWD_MAX_THREADS // w), 1
    groups = -(-c // cls)
    threads = -(-cls * w // (32 * pairs)) * 32
    wave = BWD_BLOCKS_PER_SM * sms
    rows = next((r for r in range(1, h) if b * groups * -(-h // r) <= wave), h)
    chunk = next((k for k in range(BWD_MAX_CHUNK, 0, -1)
                  if _bwd_smem(c, w, ow, cls, k, span, gs, ratio, gbytes)
                  <= BWD_SHARED_PER_BLOCK), 1)
    if _bwd_smem(c, w, ow, cls, chunk, span, gs, ratio, gbytes) > BWD_MAX_SHARED:
        raise ValueError(f"upsample_cross_entropy: {c} classes at widths {w} -> {ow} exceed "
                         f"the backward's {BWD_MAX_SHARED} bytes of shared memory")
    return BwdPlan(groups, cls, rows, -(-h // rows), chunk, threads, span, gs, ratio)


# kernels C fwd and D (upsample_ce.cu: kStatsMaxShared): a block's bytes of
# column taps and H-lerped input rows, and the output pixels it owns
STATS_MAX_SHARED = 224 * 1024
STATS_SPAN = 1024


@functools.lru_cache(maxsize=64)
def _stats_plan(b: int, c: int, w: int, oh: int, ow: int) -> Tuple[int, int, int]:
    """The launch of C's forward, D and K7 prob on f32 logits: (span,
    max_rows, smem bytes); bf16 logits take the span and `_stats_ring`.

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


# the bf16 instance's staged ring (upsample_ce.cu: stats_ring_kernel): at
# most STATS_RING_MAX_SPANS spans a step, blocks of 256 x spans threads
STATS_RING_MAX_SPANS = 4


class RingPlan(NamedTuple):
    spans: int      # spans a step
    rows: int       # output rows a step touches, at most (T and the row tables)
    raw_bytes: int  # the most a step's copies take
    smem: int       # a block's shared memory (upsample_ce.cu: ring_bytes)


def _ring_bytes(c: int, w: int, ow: int, rows: int, raw: int) -> int:
    return 64 * -(-ow // 4) + 48 * rows + ((4 * rows * c * w + 15) & ~15) + raw + 16


def _ring_raw_bytes(b: int, c: int, h: int, w: int, oh: int, ow: int, span: int,
                    step: int) -> int:
    """The most bytes one step's copies take (the kernel's `issue`), of a
    step of `step` pixels from any span's first pixel: per image its output
    rows reach, per class the run of input rows [lo of its first row, hi of
    its last] widened to whole 16-byte blocks, C of them (each (n + 14) & ~7
    elements: the run's start may lie anywhere in its first block)."""
    lo, hi, _ = _interp_taps_np(h, oh, True)
    total = b * oh * ow
    k0 = np.arange(0, total, span, dtype=np.int64)  # a step may start at any span
    k1 = np.minimum(k0 + step, total)
    ra, rb = k0 // ow, (k1 - 1) // ow
    ba, bb = ra // oh, rb // oh
    raw = np.zeros_like(k0)
    for g in range(int((bb - ba).max()) + 1):
        img = ba + g
        has = img <= bb
        oy0 = np.clip(ra - img * oh, 0, oh - 1)
        oy1 = np.clip(rb - img * oh, 0, oh - 1)
        n_el = (hi[oy1].astype(np.int64) - lo[oy0] + 1) * w
        raw += np.where(has, c * 2 * ((n_el + 14) & ~7), 0)
    return int(raw.max())


@functools.lru_cache(maxsize=64)
def _stats_ring(b: int, c: int, h: int, w: int, oh: int, ow: int, sms: int) -> RingPlan:
    """The bf16 instance's launch on `sms` SMs: steps of `spans` spans of
    `_stats_plan`'s span (so C's partial sums are formed over the same
    pixels), a block of 256 x spans threads, one an SM, taking ceil(spans of
    the output / sms) spans: the spans whose steps hold them with the fewest
    idle span slots (ceil(spans a block / spans) x spans; the more spans on a
    tie: at VOC's 1028 spans on 132 SMs 4, 8 spans in 2 steps; at
    Cityscapes' 1155 3, 9 in 3), among those whose block fits
    STATS_MAX_SHARED; its T rows, the raw buffer and the block's bytes.
    It raises where one span's rows and their raw rows do not fit (the f32
    instance, which stages no raw rows, holds more)."""
    span = _stats_plan(b, c, w, oh, ow)[0]
    nparts = -(-(b * oh * ow) // span)
    per_block = -(-nparts // sms)
    best = None
    for spans in range(STATS_RING_MAX_SPANS, 0, -1):
        step = span * spans
        rows = min(step // ow + 2, b * oh)
        raw = _ring_raw_bytes(b, c, h, w, oh, ow, span, step)
        smem = _ring_bytes(c, w, ow, rows, raw)
        slots = -(-per_block // spans) * spans
        if smem <= STATS_MAX_SHARED and rows * c * w < 2**24 and (best is None
                                                                  or slots < best[0]):
            best = (slots, RingPlan(spans, rows, raw, smem))
    if best is not None:
        return best[1]
    raise ValueError(f"upsample: {c} classes at widths {w} -> {ow} exceed the bf16 "
                     f"kernel's {STATS_MAX_SHARED} bytes of shared memory")


def _stats_launch(b: int, c: int, h: int, w: int, oh: int, ow: int, dtype: torch.dtype,
                  sms: int) -> Tuple[int, int, int, int]:
    """The C entries' plan arguments (span, max_rows, spans, raw_bytes): the
    f32 instance's blocks (spans and raw_bytes 0), or the bf16 instance's
    ring on `sms` SMs."""
    span, max_rows, _ = _stats_plan(b, c, w, oh, ow)
    if dtype != torch.bfloat16:
        return span, max_rows, 0, 0
    ring = _stats_ring(b, c, h, w, oh, ow, sms)
    return span, ring.rows, ring.spans, ring.raw_bytes


class _UpsampleCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_label, class_weight):
        _check_ce_inputs(logits, labels, class_weight)
        from u2pl_tpu_torch.kernels import check, load

        b, c, h, w = logits.shape
        oh, ow = labels.shape[1:]
        dev = logits.device
        plan = _stats_launch(b, c, h, w, oh, ow, logits.dtype, _sm_count(dev))
        lib = load()
        idx_h, w_h = _device_taps(h, oh, True, dev)
        idx_w, w_w = _device_taps(w, ow, True, dev)
        lse = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
        part = torch.empty(2 * -(-(b * oh * ow) // plan[0]), dtype=torch.float64, device=dev)
        stats = torch.empty(2, dtype=torch.float32, device=dev)  # [loss, denom]
        floor = 1e-12 if class_weight is not None else 1.0
        cw = class_weight.data_ptr() if class_weight is not None else None
        with torch.cuda.device(dev):
            err = lib.u2pl_upsample_ce_fwd(
                logits.data_ptr(), labels.data_ptr(), cw, lse.data_ptr(),
                part.data_ptr(), stats.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
                idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow,
                int(ignore_label), floor, *plan, LOGIT_DTYPES[logits.dtype],
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
        plan = _bwd_plan(b, c, h, w, oh, ow, _sm_count(dev), logits.element_size())
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
                *plan, LOGIT_DTYPES[logits.dtype],
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
