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
counts its kernel launches in `<wrapper>.launches`.

`resize_bilinear` is differentiable: an `autograd.Function` whose backward
is the adjoint resize, kernel A-bwd (`resize_bilinear_bwd`) on the card and
the transposed einsums on the CPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

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
def _device_ranges(
    in_size: int, out_size: int, align_corners: bool, device: torch.device
) -> torch.Tensor:
    """Kernel A-bwd's table on `device`: int32 [start; end], (2, in_size),
    the output indices whose taps reach each input index (lo in {i-1, i};
    contiguous because lo is non-decreasing)."""
    lo, _, _ = _interp_taps_np(in_size, out_size, align_corners)
    i = np.arange(in_size)
    start = np.searchsorted(lo, i - 1, side="left")
    end = np.searchsorted(lo, i, side="right")
    return torch.from_numpy(np.stack([start, end]).astype(np.int32)).to(device)


def _dense(in_size: int, out_size: int, align_corners: bool, like: torch.Tensor):
    return torch.from_numpy(_interp_matrix_np(in_size, out_size, align_corners)).to(
        like.device
    )


def resize_bilinear_plain(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of kernel A: two einsum passes with the dense
    interpolation matrices, H first, as the JAX function does (NCHW)."""
    _, _, h, w = x.shape
    oh, ow = int(size[0]), int(size[1])
    wh = _dense(h, oh, align_corners, x)
    ww = _dense(w, ow, align_corners, x)
    y = torch.einsum("oh,bchw->bcow", wh, x.float())
    y = torch.einsum("pw,bcow->bcop", ww, y)
    return y.to(x.dtype)


def resize_bilinear_bwd_plain(
    gy: torch.Tensor, in_size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of kernel A-bwd: the adjoint of
    `resize_bilinear_plain`, the two einsums with the transposed dense
    matrices in reverse order (W first), as XLA's VJP of the JAX function."""
    _, _, oh, ow = gy.shape
    h, w = int(in_size[0]), int(in_size[1])
    wh = _dense(h, oh, align_corners, gy)
    ww = _dense(w, ow, align_corners, gy)
    g = torch.einsum("pw,bcop->bcow", ww, gy.float())
    g = torch.einsum("oh,bcow->bchw", wh, g)
    return g.to(gy.dtype)


def resize_argmax_plain(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of kernel B: resize (C, H, W) logits, then the
    first-maximum argmax over C, as uint8 (h, w)."""
    y = resize_bilinear_plain(logits[None], size, align_corners)[0]
    return y.argmax(dim=0).to(torch.uint8)


def _check_cuda_f32(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D input, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: {x.numel()} elements exceed the int32 sizes")


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of NCHW `x` to spatial `size` (h, w) (kernel A).

    Same values as the JAX `resize_bilinear` on the NHWC transpose; the
    (h, w) == input size case returns `x` itself, as there.  Differentiable
    in `x` (backward: `resize_bilinear_bwd`)."""
    if x.dim() != 4:
        raise ValueError(f"resize_bilinear: expected NCHW, got {tuple(x.shape)}")
    oh, ow = int(size[0]), int(size[1])
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


def _resize_bilinear_cuda(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    _check_cuda_f32(x, 4, "resize_bilinear")
    b, c, h, w = x.shape
    oh, ow = size
    if b * c * oh * ow >= 2**31:
        raise ValueError("resize_bilinear: output exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    idx_h, w_h = _device_taps(h, oh, align_corners, x.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, x.device)
    y = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.u2pl_resize_bilinear_ac(
            x.data_ptr(), y.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            idx_w.data_ptr(), w_w.data_ptr(), b * c, h, w, oh, ow,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(lib, err, "resize_bilinear_ac launch")
    resize_bilinear.launches += 1
    return y


resize_bilinear.launches = 0


def resize_bilinear_bwd(
    gy: torch.Tensor, in_size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Adjoint of `resize_bilinear`: the gradient (B, C, h, w) of an
    (h, w) -> gy's (H, W) resize, given the output gradient gy (kernel A-bwd:
    gather form, deterministic)."""
    if gy.dim() != 4:
        raise ValueError(f"resize_bilinear_bwd: expected NCHW, got {tuple(gy.shape)}")
    h, w = int(in_size[0]), int(in_size[1])
    if gy.device.type == "cpu":
        return resize_bilinear_bwd_plain(gy, (h, w), align_corners)
    _check_cuda_f32(gy, 4, "resize_bilinear_bwd")
    b, c, oh, ow = gy.shape
    if b * c * h * w >= 2**31:
        raise ValueError("resize_bilinear_bwd: output exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    idx_h, w_h = _device_taps(h, oh, align_corners, gy.device)
    idx_w, w_w = _device_taps(w, ow, align_corners, gy.device)
    rng_h = _device_ranges(h, oh, align_corners, gy.device)
    rng_w = _device_ranges(w, ow, align_corners, gy.device)
    gx = torch.empty((b, c, h, w), dtype=gy.dtype, device=gy.device)
    with torch.cuda.device(gy.device):
        err = lib.u2pl_resize_bilinear_ac_bwd(
            gy.data_ptr(), gx.data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            rng_h.data_ptr(), idx_w.data_ptr(), w_w.data_ptr(), rng_w.data_ptr(),
            b * c, h, w, oh, ow, torch.cuda.current_stream(gy.device).cuda_stream,
        )
    check(lib, err, "resize_bilinear_ac_bwd launch")
    resize_bilinear_bwd.launches += 1
    return gx


resize_bilinear_bwd.launches = 0


def resize_argmax(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Resize one image's (C, H, W) logits to `size` (h, w) and take the
    first-maximum argmax over C -> uint8 (h, w) (kernel B).  On the card no
    (h, w, C) intermediate is ever written."""
    if logits.dim() != 3:
        raise ValueError(f"resize_argmax: expected CHW, got {tuple(logits.shape)}")
    c, h, w = logits.shape
    if c > 255:
        raise ValueError(f"resize_argmax: {c} classes exceed the uint8 labels")
    oh, ow = int(size[0]), int(size[1])
    if logits.device.type == "cpu":
        return resize_argmax_plain(logits, (oh, ow), align_corners)
    _check_cuda_f32(logits, 3, "resize_argmax")
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
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    check(lib, err, "resize_argmax_ac launch")
    resize_argmax.launches += 1
    return out


resize_argmax.launches = 0


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
