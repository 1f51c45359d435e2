"""Align-corners bilinear resize: CUDA kernels, their plain versions, and a
host numpy copy (port of u2pl_tpu/ops/resize.py).

Layout: the port is NCHW, so `resize_bilinear` takes (B, C, H, W) where the
JAX function takes NHWC — `resize_bilinear(x.permute(0, 3, 1, 2), size)` is
`u2pl_tpu.ops.resize.resize_bilinear(x, size)` transposed.  `resize_argmax`
takes one image's (C, H, W) logits where the JAX serving path
(`InferEngine.to_mask`) takes (H, W, C).

Every path builds its interpolation weights with the same f64
source-coordinate formula as the JAX package (`_interp_matrix_np`, copied
verbatim below), so the port matches it — and torch's
`F.interpolate(align_corners=True)` — to float32 rounding.
`F.interpolate` itself is not used: it computes source coordinates in f32.

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the hand-written kernel (`kernels/csrc/resize.cu`) or raises —
there is no fallback from the card to the plain version.  Each wrapper
counts its kernel launches in `<wrapper>.launches`; `resize_bilinear`
also per (input shape, output size) in `resize_bilinear.shapes`.

`resize_bilinear` is differentiable: an `autograd.Function` whose backward
is the adjoint resize, kernel A-bwd (`resize_bilinear_bwd`) on the card and
the transposed einsums on the CPU.

bfloat16 (the JAX function under a bf16 model, u2pl_tpu/ops/resize.py:76):
A and A-bwd take bf16 in and give bf16 out, computing in f32.  The wide
branch, at least 64 channels with bf16-exact weights on both axes
(`_wide`: the decoder's os8 -> os4 upsample), rounds the separable
intermediate to bf16 between the two passes; every other bf16 call is the
narrow branch, the f32 path with its output rounded to bf16.

bfloat16 inference (`--dtype bfloat16`): after the forward and its narrow
upsample the JAX package resizes bf16 logits with `resize_bilinear_numpy`,
which widens them to f32 first (u2pl_tpu/ops/resize.py:233) and rounds
nothing after.  So kernel B takes float32 or bfloat16 logits, the latter
widened exactly (its labels are those of the f32 mode on `logits.float()`),
and kernel A has a bf16-in, f32-out mode, chosen by
`resize_bilinear(x, size, out_dtype=torch.float32)`: the f32 mode on the
exact upcast.  Kernel A takes float32 or bfloat16 in.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix_np(
    in_size: int, out_size: int, align_corners: bool
) -> np.ndarray:
    """Dense 1-D linear-interpolation matrix W s.t. out = W @ in.

    align_corners=True : src = i * (in-1)/(out-1)        (torch semantics)
    align_corners=False: src = (i+0.5) * in/out - 0.5    (half-pixel)
    """
    lo, hi, frac = _interp_taps_np(in_size, out_size, align_corners)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    w[rows, lo] += 1.0 - frac
    w[rows, hi] += frac
    return w


def _interp_taps_np(
    in_size: int, out_size: int, align_corners: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) per output index: the two source taps and the f32
    weight of `hi` (`lo` weighs 1 - frac).  Copied from the JAX package's
    `_interp_matrix_np` (u2pl_tpu/ops/resize.py:26-62), edge cases included."""
    if in_size == 1 or out_size == 1:
        if align_corners or out_size == 1:
            # single-pixel edge cases: torch maps everything to src index
            # computed with scale 0 (align_corners, out==1) -> src 0 .. clamp
            if align_corners:
                src = np.zeros(out_size) if in_size == 1 else np.arange(
                    out_size, dtype=np.float64
                ) * ((in_size - 1) / max(out_size - 1, 1))
            else:
                src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        else:
            src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    elif align_corners:
        src = np.arange(out_size, dtype=np.float64) * (
            (in_size - 1) / (out_size - 1)
        )
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
            in_size / out_size
        ) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=256)
def _bf16_exact(in_size: int, out_size: int, align_corners: bool) -> bool:
    """True when every weight of the 1-D interpolation matrix is a bf16
    value (the JAX package's `_bf16_exact`, u2pl_tpu/ops/resize.py:65)."""
    w = torch.from_numpy(_interp_matrix_np(in_size, out_size, align_corners))
    return bool(torch.equal(w.to(torch.bfloat16).to(torch.float32), w))


def _wide(dtype: torch.dtype, c: int, in_hw, out_hw, align_corners: bool) -> bool:
    """Whether a resize of `c` channels (h, w) -> (oh, ow) in `dtype` takes
    JAX's bf16 wide branch (u2pl_tpu/ops/resize.py:101-106)."""
    return (dtype == torch.bfloat16 and c >= 64
            and _bf16_exact(int(in_hw[0]), int(out_hw[0]), align_corners)
            and _bf16_exact(int(in_hw[1]), int(out_hw[1]), align_corners))


def _resize_mode(dtype: torch.dtype, c: int, in_hw, out_hw, align_corners: bool,
                 out_dtype: torch.dtype = None) -> int:
    """The mode code of kernels A and A-bwd (kernels/csrc/resize.cu): 0
    float32, 1 the bf16 narrow branch, 2 the bf16 wide branch, 3 (A only)
    bf16 in and f32 out, with no rounding (`out_dtype` float32)."""
    if dtype == torch.float32:
        return 0
    if out_dtype == torch.float32:
        return 3
    return 2 if _wide(dtype, c, in_hw, out_hw, align_corners) else 1


@functools.lru_cache(maxsize=256)
def _device_taps(
    in_size: int, out_size: int, align_corners: bool, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel tables on `device`: int32 [lo; hi] and f32 [1 - frac; frac],
    each (2, out_size).  When lo == hi (a clamped edge) frac is 0, so the
    two taps sum to the dense matrix's single weight exactly."""
    lo, hi, frac = _interp_taps_np(in_size, out_size, align_corners)
    idx = torch.from_numpy(np.stack([lo, hi]).astype(np.int32))
    w = torch.from_numpy(np.stack([np.float32(1.0) - frac, frac]))
    return idx.to(device), w.to(device)


@functools.lru_cache(maxsize=256)
def _device_taps4(
    in_size: int, out_size: int, align_corners: bool, device: torch.device
) -> torch.Tensor:
    """Kernel A's direct kernel's table on `device`: the same taps packed,
    int32 (out_size, 4) rows of (lo, hi, the bits of 1 - frac, the bits of
    frac), one 16-byte load per output index."""
    lo, hi, frac = _interp_taps_np(in_size, out_size, align_corners)
    w = np.stack([np.float32(1.0) - frac, frac], axis=1).astype(np.float32).view(np.int32)
    taps = np.concatenate([np.stack([lo, hi], axis=1).astype(np.int32), w], axis=1)
    return torch.from_numpy(np.ascontiguousarray(taps)).to(device)


@functools.lru_cache(maxsize=256)
def _device_ranges(
    in_size: int, out_size: int, align_corners: bool, device: torch.device
) -> torch.Tensor:
    """Kernel A-bwd's table on `device`: int32 [start; end], (2, in_size),
    the output indices whose taps reach each input index (`_ranges_np`)."""
    return torch.from_numpy(_ranges_np(in_size, out_size, align_corners)).to(device)


def _ranges_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """int32 [start; end], (2, in_size): output indices [start[i], end[i])
    are those whose taps reach input index i (lo in {i-1, i}; contiguous
    because lo is non-decreasing)."""
    lo, _, _ = _interp_taps_np(in_size, out_size, align_corners)
    i = np.arange(in_size)
    start = np.searchsorted(lo, i - 1, side="left")
    end = np.searchsorted(lo, i, side="right")
    return np.stack([start, end]).astype(np.int32)


def _dense(in_size: int, out_size: int, align_corners: bool, like: torch.Tensor):
    """The f32 interpolation matrix on `like`'s device, widened to float64
    for a float64 `like` (the plain versions' float64 references)."""
    w = torch.from_numpy(_interp_matrix_np(in_size, out_size, align_corners)).to(like.device)
    return w.double() if like.dtype == torch.float64 else w


def _wide_float(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' arithmetic: float64 stays float64 (a
    reference), anything else goes to float32."""
    return x if x.dtype == torch.float64 else x.float()


def resize_bilinear_plain(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = True,
    out_dtype: torch.dtype = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel A: two einsum passes with the dense
    interpolation matrices, H first, as the JAX function does (NCHW); in
    f32, the result cast to `out_dtype` (x's dtype by default), and in the
    bf16 wide branch the intermediate rounded to bf16 too (every product
    there is exact).  bf16 `x` with `out_dtype` float32 is the f32 version
    on the exact upcast; a float64 `x` is resized in float64 (the same f32
    weights), a reference."""
    _, c, h, w = x.shape
    oh, ow = int(size[0]), int(size[1])
    out_dtype = _out_dtype(x, out_dtype)
    wh = _dense(h, oh, align_corners, x)
    ww = _dense(w, ow, align_corners, x)
    y = torch.einsum("oh,bchw->bcow", wh, _wide_float(x))
    if _wide(out_dtype, c, (h, w), (oh, ow), align_corners):
        y = y.to(x.dtype).float()
    y = torch.einsum("pw,bcow->bcop", ww, y)
    return y.to(out_dtype)


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    """Kernel A's output dtype: x's own, or float32 from bfloat16."""
    if out_dtype is None or out_dtype == x.dtype:
        return x.dtype
    if (x.dtype, out_dtype) != (torch.bfloat16, torch.float32):
        raise TypeError(f"resize_bilinear: no mode from {x.dtype} to {out_dtype}; "
                        "out_dtype is the input's dtype, or float32 from bfloat16")
    return out_dtype


def resize_bilinear_rounded(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Kernel A's own arithmetic in torch ops, for checking it: the H pass
    T = a * x[lo_h] + b * x[hi_h] per output row, then the W pass
    p * T[lo_w] + q * T[hi_w], from the kernel's tap tables, each product
    and sum a separate op and so rounded on its own.  On the card it is
    bit-equal to kernel A (and to the upsample inside kernels C, D and
    K7); it holds (B, C, OH, W) f32.  A bf16 `x` gives kernel A's bf16
    mode: T rounded to bf16 in the wide branch, the result in bf16 (the
    upsample of C, D and K7 is the narrow branch)."""
    _, c, h, w = x.shape
    oh, ow = int(size[0]), int(size[1])
    wide = _wide(x.dtype, c, (h, w), (oh, ow), align_corners)
    idx_h, w_h = _device_taps(h, oh, align_corners, x.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, x.device)
    dtype, x = x.dtype, x.float()
    lo_h, hi_h = idx_h[0].long(), idx_h[1].long()
    t = x[:, :, lo_h] * w_h[0][:, None] + x[:, :, hi_h] * w_h[1][:, None]
    if wide:
        t = t.to(dtype).float()
    y = t[..., idx_w[0].long()] * w_w[0] + t[..., idx_w[1].long()] * w_w[1]
    return y if dtype == torch.float32 else y.to(dtype)


def resize_bilinear_bwd_plain(
    gy: torch.Tensor, in_size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of kernel A-bwd: the adjoint of
    `resize_bilinear_plain`, the two einsums with the transposed dense
    matrices in reverse order (W first), as XLA's VJP of the JAX function;
    in the bf16 wide branch the W sum rounded to bf16 (its jaxpr's
    convert_element_type), the result in gy's dtype (float64: a float64
    reference)."""
    _, c, oh, ow = gy.shape
    h, w = int(in_size[0]), int(in_size[1])
    wh = _dense(h, oh, align_corners, gy)
    ww = _dense(w, ow, align_corners, gy)
    g = torch.einsum("pw,bcop->bcow", ww, _wide_float(gy))
    if _wide(gy.dtype, c, (h, w), (oh, ow), align_corners):
        g = g.to(gy.dtype).float()
    g = torch.einsum("oh,bcow->bchw", wh, g)
    return g.to(gy.dtype)


def resize_bilinear_bwd_ordered(
    gy: torch.Tensor, in_size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Kernel A-bwd's own sums in torch ops, for checking it: per output row
    the W sum over the output columns reaching each input column
    (`_ranges_np`), ascending from 0, then per input row the H sum over the
    output rows reaching it, ascending from 0, with common.cuh's
    `tap_weight` values; each product and sum a separate op and so rounded
    on its own.  On the card it is bit-equal to kernel A-bwd.  A bf16 `gy`
    gives its bf16 mode: in f32, the W sums rounded to bf16 in the wide
    branch, the result rounded to bf16 once."""
    _, c, oh, ow = gy.shape
    h, w = int(in_size[0]), int(in_size[1])
    wide = _wide(gy.dtype, c, (h, w), (oh, ow), align_corners)
    dtype, g = gy.dtype, gy.float()

    def table(n_in, n_out):  # (output index, weight, in range) per slot and input index
        lo, hi, frac = _interp_taps_np(n_in, n_out, align_corners)
        w0, w1 = np.float32(1.0) - frac, frac
        start, end = _ranges_np(n_in, n_out, align_corners)
        slots = start[None, :] + np.arange(max(int((end - start).max()), 1))[:, None]
        o = np.minimum(slots, n_out - 1)  # (span, n_in)
        i = np.arange(n_in)[None, :]
        wt = np.where(lo[o] == i, w0[o], np.float32(0.0)).astype(np.float32)
        wt = np.where(hi[o] == i, (wt + w1[o]).astype(np.float32), wt)
        return (torch.from_numpy(o.astype(np.int64)).to(gy.device),
                torch.from_numpy(wt).to(gy.device),
                torch.from_numpy(slots < end[None, :]).to(gy.device))

    o_w, wt_w, m_w = table(w, ow)
    o_h, wt_h, m_h = table(h, oh)
    s = torch.zeros(g.shape[:3] + (w,), device=gy.device)
    for j in range(o_w.shape[0]):
        s = torch.where(m_w[j], s + wt_w[j] * g.index_select(3, o_w[j]), s)
    if wide:
        s = s.to(dtype).float()
    gx = torch.zeros(g.shape[:2] + (h, w), device=gy.device)
    for j in range(o_h.shape[0]):
        gx = torch.where(m_h[j][:, None], gx + wt_h[j][:, None] * s.index_select(2, o_h[j]), gx)
    return gx if dtype == torch.float32 else gx.to(dtype)


def resize_argmax_plain(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of kernel B: resize (C, H, W) logits, then the
    first-maximum argmax over C, as uint8 (h, w).  bf16 logits are widened
    first and resized in f32, as `resize_bilinear_numpy` does: nothing is
    rounded after the upcast."""
    y = resize_bilinear_plain(logits[None].float(), size, align_corners)[0]
    return y.argmax(dim=0).to(torch.uint8)


# kernel A stages 16 B of taps per output column (in groups of 4) and 4 B
# per input column and band row in shared memory (kernels/csrc/resize.cu:
# kResizeMaxShared)
RESIZE_MAX_SHARED = 160 * 1024
# kernel A's plan: about this many outputs a band; with fewer than this many
# blocks an SM in bands, the direct kernel
BAND_OUTPUTS = 4096
FWD_BLOCKS_PER_SM = 4


# kernel A's kernels (resize.cu: kFwdBand, kFwdDirect, kFwdWide2x)
FWD_BAND, FWD_DIRECT, FWD_WIDE_2X = 0, 1, 2


class FwdPlan(NamedTuple):
    """Kernel A's launch (`_fwd_plan`)."""

    kernel: int  # FWD_BAND, FWD_DIRECT or FWD_WIDE_2X
    rows: int = 0  # the band kernel's: output rows of a band, a block each
    bands: int = 0


@functools.lru_cache(maxsize=256)
def _fwd_plan(planes: int, h: int, w: int, oh: int, ow: int, sms: int, mode: int = 0,
              align_corners: bool = True) -> FwdPlan:
    """Kernel A's launch: the band kernel, a block per band of `rows`
    output rows of one plane; the direct kernel; or the bf16 wide branch's
    exact 2x kernel.

    The bf16 wide branch (`mode` 2) of an align-corners n -> 2n - 1 upsample
    on both axes (the decoder's 65² -> 129² and 97² -> 193²) takes the 2x
    kernel: its weights are 1 / 0 and 1/2 / 1/2, so it reads no tap table,
    and a thread writes the 2 x 2 outputs one input element leads.  Every
    other call:

    Bands of about BAND_OUTPUTS outputs and of even height, as many rows as
    shared memory holds at most: at the logits', the decoders' and the eval
    crops' plane counts that grid is tens of blocks an SM.  With few planes
    (a 3-plane request image) it would be one partial wave of blocks whose
    tap staging, H pass and barriers run one after the other, so when the
    planes x bands blocks come to fewer than FWD_BLOCKS_PER_SM on each of
    `sms` SMs the direct kernel takes the call: a thread per output pixel
    for every plane, straight from the input (`_device_taps4`), no shared
    memory."""
    if mode == 2 and align_corners and h >= 2 and w >= 2 and (oh, ow) == (2 * h - 1, 2 * w - 1):
        return FwdPlan(FWD_WIDE_2X)
    quarter = -(-ow // 4)
    target = min(oh, -(-BAND_OUTPUTS // ow))
    even = max(1, (oh + target // 2) // target)
    rows = min(-(-oh // even), (RESIZE_MAX_SHARED - quarter * 64) // (w * 4))
    bands = -(-oh // rows)
    if planes * bands < FWD_BLOCKS_PER_SM * sms:
        return FwdPlan(FWD_DIRECT)
    return FwdPlan(FWD_BAND, rows, bands)


F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


def _check_cuda(x: torch.Tensor, ndim: int, name: str, dtypes=F32) -> None:
    """Raise unless `x` is a contiguous CUDA tensor of `ndim` dims in one
    of `dtypes` (the dtypes the wrapper's kernel has a mode for) whose
    element count fits int32."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D input, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: {x.numel()} elements exceed the int32 sizes")


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = True,
    out_dtype: torch.dtype = None,
) -> torch.Tensor:
    """Bilinear resize of NCHW `x` to spatial `size` (h, w) (kernel A).

    Same values as the JAX `resize_bilinear` on the NHWC transpose; the
    (h, w) == input size case returns `x` itself, as there.  Differentiable
    in `x` (backward: `resize_bilinear_bwd`).  float32, or bfloat16 in the
    JAX package's bf16 branches (module docstring).  `out_dtype` float32
    on bfloat16 `x` is the inference mode: the f32 resize of the exact
    upcast (`resize_bilinear_numpy` on bf16 logits), not differentiable."""
    if x.dim() != 4:
        raise ValueError(f"resize_bilinear: expected NCHW, got {tuple(x.shape)}")
    oh, ow = int(size[0]), int(size[1])
    out_dtype = _out_dtype(x, out_dtype)
    if out_dtype != x.dtype:
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("resize_bilinear: the bfloat16 -> float32 mode has no backward")
        if (oh, ow) == tuple(x.shape[2:]):
            return x.to(out_dtype)
        if x.device.type == "cpu":
            return resize_bilinear_plain(x, (oh, ow), align_corners, out_dtype)
        return _resize_bilinear_cuda(x, (oh, ow), align_corners, out_dtype)
    if (oh, ow) == tuple(x.shape[2:]):
        return x
    return _ResizeBilinear.apply(x, (oh, ow), align_corners)


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_size, ctx.align_corners = tuple(x.shape[2:]), align_corners
        if x.device.type == "cpu":
            return resize_bilinear_plain(x, size, align_corners)
        return _resize_bilinear_cuda(x, size, align_corners)

    @staticmethod
    def backward(ctx, gy):
        return resize_bilinear_bwd(gy.contiguous(), ctx.in_size, ctx.align_corners), None, None


def _resize_bilinear_cuda(x: torch.Tensor, size, align_corners: bool,
                          out_dtype: torch.dtype = None) -> torch.Tensor:
    _check_cuda(x, 4, "resize_bilinear", F32_BF16)
    out_dtype = _out_dtype(x, out_dtype)
    b, c, h, w = x.shape
    oh, ow = size
    if b * c * oh * ow >= 2**31:
        raise ValueError("resize_bilinear: output exceeds the int32 sizes")
    if -(-ow // 4) * 64 + w * 4 > RESIZE_MAX_SHARED:
        raise ValueError(f"resize_bilinear: widths {w} -> {ow} exceed the kernel's "
                         f"{RESIZE_MAX_SHARED} bytes of shared memory")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    idx_h, w_h = _device_taps(h, oh, align_corners, x.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, x.device)
    y = torch.empty((b, c, oh, ow), dtype=out_dtype, device=x.device)
    mode = _resize_mode(x.dtype, c, (h, w), (oh, ow), align_corners, out_dtype)
    plan = _fwd_plan(b * c, h, w, oh, ow, _sm_count(x.device), mode, align_corners)
    taps = (0, 0)  # the direct kernel's packed tables
    if plan.kernel == FWD_DIRECT:
        taps = (_device_taps4(h, oh, align_corners, x.device).data_ptr(),
                _device_taps4(w, ow, align_corners, x.device).data_ptr())
    with torch.cuda.device(x.device):
        err = lib.u2pl_resize_bilinear_ac(
            x.data_ptr(), y.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            idx_w.data_ptr(), w_w.data_ptr(), *taps, b * c, h, w, oh, ow, *plan, mode,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(lib, err, "resize_bilinear_ac launch")
    resize_bilinear.launches += 1
    resize_bilinear.shapes[(tuple(x.shape), (oh, ow))] += 1
    resize_bilinear.modes[mode] += 1
    return y


resize_bilinear.launches = 0
resize_bilinear.shapes = collections.Counter()
resize_bilinear.modes = collections.Counter()  # launches per `_resize_mode` code


# kernel A-bwd (kernels/csrc/resize.cu): the threads per SM (of its 2048)
# that keep enough gy loads in flight
BWD_THREADS_PER_SM = 512
# kernel A-bwd's kernels (resize.cu: kBwdBand, kBwdWide2x)
BWD_BAND, BWD_WIDE_2X = 0, 1
# the 2x adjoint's input rows a thread (1, 2 or 4)
BWD_2X_ROWS = 1


class BwdPlan(NamedTuple):
    """Kernel A-bwd's launch (`_bwd_plan`): a thread per input column of a
    band of `rows` input rows, `bands` = ceil(h / rows) of them a plane."""

    kernel: int  # BWD_BAND or BWD_WIDE_2X
    rows: int
    bands: int
    wspan: int  # the most output columns reaching one input column


@functools.lru_cache(maxsize=64)
def _bwd_plan(planes: int, h: int, w: int, oh: int, ow: int, sms: int, mode: int = 0,
              align_corners: bool = True) -> BwdPlan:
    """Kernel A-bwd's launch.

    The bf16 wide branch (`mode` 2) of an align-corners n -> 2n - 1
    upsample on both axes (the decoder's 129² -> 65² and 193² -> 97²),
    where `_fwd_plan` takes FWD_WIDE_2X, takes the 2x adjoint: its weights
    are 0, 1/2, 1, 1/2, so it reads no table, and a thread sums the 4 x
    (2 BWD_2X_ROWS + 2) gy values that reach BWD_2X_ROWS input rows of one
    column of a plane.  Every other call takes the band kernel:

    A thread owns one input column of a band of `rows` input rows of one
    plane and walks the output rows that reach the band (a band boundary's
    rows are read by both bands).  `rows` is the tallest band for which the
    planes x bands x w threads reach BWD_THREADS_PER_SM on each of `sms`
    SMs, else 1 (the whole plane at the decoder's shapes).  wspan: the most
    output columns reaching one input column (up to 4 the kernel holds the
    tap weights in registers, else it reads them from the tables)."""
    start_w, end_w = _ranges_np(w, ow, align_corners)
    wspan = max(int((end_w - start_w).max()), 1)
    if mode == 2 and align_corners and h >= 2 and w >= 2 and (oh, ow) == (2 * h - 1, 2 * w - 1):
        return BwdPlan(BWD_WIDE_2X, BWD_2X_ROWS, -(-h // BWD_2X_ROWS), wspan)
    target = sms * BWD_THREADS_PER_SM
    rows = next((r for r in range(h, 1, -1) if planes * -(-h // r) * w >= target), 1)
    return BwdPlan(BWD_BAND, rows, -(-h // rows), wspan)


def resize_bilinear_bwd(
    gy: torch.Tensor, in_size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Adjoint of `resize_bilinear`: the gradient (B, C, h, w) of an
    (h, w) -> gy's (H, W) resize, given the output gradient gy (kernel A-bwd:
    gather form, a thread per input column of a band of input rows,
    deterministic; `_bwd_plan`)."""
    if gy.dim() != 4:
        raise ValueError(f"resize_bilinear_bwd: expected NCHW, got {tuple(gy.shape)}")
    h, w = int(in_size[0]), int(in_size[1])
    if gy.device.type == "cpu":
        return resize_bilinear_bwd_plain(gy, (h, w), align_corners)
    _check_cuda(gy, 4, "resize_bilinear_bwd", F32_BF16)
    b, c, oh, ow = gy.shape
    if b * c * h * w >= 2**31:
        raise ValueError("resize_bilinear_bwd: output exceeds the int32 sizes")
    gx = torch.empty((b, c, h, w), dtype=gy.dtype, device=gy.device)
    if gx.numel() == 0:
        return gx
    from u2pl_tpu_torch.kernels import check, load

    mode = _resize_mode(gy.dtype, c, (h, w), (oh, ow), align_corners)
    plan = _bwd_plan(b * c, h, w, oh, ow, _sm_count(gy.device), mode, align_corners)
    lib = load()
    idx_h, w_h = _device_taps(h, oh, align_corners, gy.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, gy.device)
    rng_h = _device_ranges(h, oh, align_corners, gy.device)
    rng_w = _device_ranges(w, ow, align_corners, gy.device)
    with torch.cuda.device(gy.device):
        err = lib.u2pl_resize_bilinear_ac_bwd(
            gy.data_ptr(), gx.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            rng_h.data_ptr(), idx_w.data_ptr(), w_w.data_ptr(), rng_w.data_ptr(),
            b * c, h, w, oh, ow, *plan, mode, torch.cuda.current_stream(gy.device).cuda_stream,
        )
    check(lib, err, "resize_bilinear_ac_bwd launch")
    resize_bilinear_bwd.launches += 1
    return gx


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


resize_bilinear_bwd.launches = 0


def resize_argmax(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Resize one image's (C, H, W) logits to `size` (h, w) and take the
    first-maximum argmax over C -> uint8 (h, w) (kernel B).  On the card no
    (h, w, C) intermediate is ever written.  float32 or bfloat16 logits; bf16
    is widened exactly and resized in f32 (module docstring)."""
    if logits.dim() != 3:
        raise ValueError(f"resize_argmax: expected CHW, got {tuple(logits.shape)}")
    c, h, w = logits.shape
    if c > 255:
        raise ValueError(f"resize_argmax: {c} classes exceed the uint8 labels")
    oh, ow = int(size[0]), int(size[1])
    if logits.device.type == "cpu":
        return resize_argmax_plain(logits, (oh, ow), align_corners)
    _check_cuda(logits, 3, "resize_argmax", F32_BF16)
    if oh * ow >= 2**31:
        raise ValueError("resize_argmax: output exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    idx_h, w_h = _device_taps(h, oh, align_corners, logits.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, logits.device)
    out = torch.empty((oh, ow), dtype=torch.uint8, device=logits.device)
    with torch.cuda.device(logits.device):
        err = lib.u2pl_resize_argmax_ac(
            logits.data_ptr(), out.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            idx_w.data_ptr(), w_w.data_ptr(), c, h, w, oh, ow,
            int(logits.dtype == torch.bfloat16),
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    check(lib, err, "resize_argmax_ac launch")
    resize_argmax.launches += 1
    resize_argmax.dtypes[logits.dtype] += 1
    return out


resize_argmax.launches = 0
resize_argmax.dtypes = collections.Counter()  # launches per logits dtype


def resize_bilinear_numpy(
    x: np.ndarray, size: tuple, align_corners: bool = True
) -> np.ndarray:
    """Host-side (numpy) resize of (H, W, C) or (H, W) arrays — the JAX
    package's `resize_bilinear_numpy`, used to bring request images to the
    serving scale."""
    if x.ndim == 2:
        xx = x[:, :, None]
    else:
        xx = x
    h, w = xx.shape[0], xx.shape[1]
    oh, ow = int(size[0]), int(size[1])
    wh = _interp_matrix_np(h, oh, align_corners)
    ww = _interp_matrix_np(w, ow, align_corners)
    y = np.einsum("oh,hwc->owc", wh, xx.astype(np.float32))
    y = np.einsum("pw,owc->opc", ww, y)
    if x.ndim == 2:
        y = y[:, :, 0]
    return y


@functools.lru_cache(maxsize=256)
def _nearest_index_np(in_size: int, out_size: int) -> np.ndarray:
    """torch mode="nearest" source indices, floor(i * in/out) in f64,
    clipped (the JAX package's `_nearest_index_np`, u2pl_tpu/ops/resize.py:180)."""
    return np.minimum(
        (np.arange(out_size, dtype=np.float64) * (in_size / out_size)).astype(np.int64),
        in_size - 1,
    )


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the two trailing (spatial) axes of `x` to `size`
    (h, w): an index gather, torch `F.interpolate(mode="nearest")`'s
    indices.  NCHW, NHW or HW, any dtype (masks, labels).  No kernel: a
    plain gather on either device."""
    if x.dim() not in (2, 3, 4):
        raise ValueError(f"resize_nearest: expected 2-4 dims, got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    ih = torch.from_numpy(_nearest_index_np(h, oh)).to(x.device)
    iw = torch.from_numpy(_nearest_index_np(w, ow)).to(x.device)
    return x.index_select(-2, ih).index_select(-1, iw)
