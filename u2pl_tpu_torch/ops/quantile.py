"""Exact numpy-'linear' percentiles of a masked map, on the device (port of
u2pl_tpu/ops/quantile.py).

np.percentile ('linear') over the n valid values:
    rank = percent/100 * (n-1)
    out  = v[floor(rank)] + (rank - floor(rank)) * (v[ceil(rank)] - v[floor(rank)])
with the same float32 rank arithmetic as the JAX package, so results are
bit-equal to it; an empty mask gives +inf.

`masked_percentiles` runs kernel E (`kernels/csrc/quantile.cu`, a radix
selection, no sort) on the card and its plain version, the masked sort, on
the CPU.  Nothing syncs with the host: the percents come in and the
results go out as device tensors.

`kth_smallest` is OHEM's order statistic (port of
u2pl_tpu/losses/ohem.py:_kth_smallest): the same radix descent on the card
(`u2pl_kth_smallest`, with a rank in place of a percent), a sort and an
index on the CPU; bit-equal to JAX either way.

Both run as one cooperative launch of one block per SM (`_descent_plan`)
over a workspace per device that every call leaves zero (`_workspace`), so
two calls on different streams of one device must not overlap.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


def masked_sort(values: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values sorted with the masked-out ones at +inf, n_valid int32 0-d)."""
    v = values.reshape(-1).float()
    m = mask.reshape(-1)
    n = m.sum().to(torch.int32)
    v = torch.where(m, v, torch.full_like(v, float("inf")))
    return torch.sort(v).values, n


def percentile_from_sorted(
    sorted_vals: torch.Tensor, n: torch.Tensor, percents: torch.Tensor
) -> torch.Tensor:
    """numpy 'linear' percentiles (K,) from a masked sort, in the JAX f32
    arithmetic (u2pl_tpu/ops/quantile.py:34-46)."""
    pct = percents.to(torch.float32)
    nm1 = torch.clamp(n - 1, min=0)
    # a divisor tensor on the percents' device: true division, where a
    # Python scalar divisor may become a multiply by its reciprocal on CUDA
    rank = pct / torch.full_like(pct, 100.0) * nm1.to(torch.float32)
    lo = torch.floor(rank).to(torch.int32)
    hi = torch.minimum(lo + 1, nm1)
    frac = rank - lo.to(torch.float32)
    last = sorted_vals.shape[0] - 1
    v_lo = sorted_vals[torch.clamp(lo, 0, last).long()]
    v_hi = sorted_vals[torch.clamp(hi, 0, last).long()]
    out = v_lo + frac * (v_hi - v_lo)
    return torch.where(n > 0, out, torch.full_like(out, float("inf")))


def masked_percentiles_plain(
    values: torch.Tensor, mask: torch.Tensor, percents: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of kernel E: the masked sort."""
    return percentile_from_sorted(*masked_sort(values, mask), percents)


# quantile.cu: kDigit, kMaxKeyBytes
DESCENT_DIGIT_BITS = 8
DESCENT_KEY_BYTES = 176 * 1024


@functools.lru_cache(maxsize=64)
def _descent_plan(n: int, sms: int) -> Tuple[int, int, int]:
    """The descent's launch for n values on `sms` SMs: (grid, slice, cap).

    One block per SM; block b holds the values [b * slice, min((b + 1) *
    slice, n)), slice the least multiple of 4 (16-byte loads) that covers n
    with the grid, and keeps the first cap of them as keys in shared memory
    (DESCENT_KEY_BYTES); it re-reads the rest at every level."""
    slice_ = 4 * -(-n // (4 * sms))
    return sms, slice_, min(slice_, DESCENT_KEY_BYTES // 4)


def _descent_launch(values: torch.Tensor) -> Tuple[int, int, int]:
    from u2pl_tpu_torch.ops.resize import _sm_count

    return _descent_plan(values.numel(), _sm_count(values.device))


@functools.lru_cache(maxsize=None)
def _workspace(device: torch.device) -> torch.Tensor:
    """The descent's histograms and counters on `device`: zero, and left
    zero by every launch (its last block clears them)."""
    from u2pl_tpu_torch.kernels import load

    return torch.zeros(load().u2pl_quantile_state_words(), dtype=torch.int32, device=device)


def masked_percentiles(
    values: torch.Tensor, mask: torch.Tensor, percents: torch.Tensor
) -> torch.Tensor:
    """numpy-'linear' percentiles of `values[mask]`: values any shape, f32;
    mask the same shape, bool; percents (K,) f32 in [0, 100] on the same
    device (K <= 4 on the card).  Returns (K,) f32, +inf on an empty mask.
    Bit-equal to the JAX `masked_percentiles`."""
    if mask.shape != values.shape or mask.dtype != torch.bool or percents.dim() != 1:
        raise ValueError(
            f"masked_percentiles: values {tuple(values.shape)}, mask "
            f"{tuple(mask.shape)} {mask.dtype}, percents {tuple(percents.shape)}"
        )
    if values.device.type == "cpu":
        return masked_percentiles_plain(values, mask, percents)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(values, values.dim(), "masked_percentiles")
    _check_cuda(percents, 1, "masked_percentiles percents")
    if mask.device != values.device or not mask.is_contiguous():
        raise ValueError("masked_percentiles: a contiguous mask on the values' device")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    k = percents.shape[0]
    if not 0 < k <= lib.u2pl_quantile_max_queries() or values.numel() == 0:
        raise ValueError(f"masked_percentiles: {k} percents of {values.numel()} values")
    dev = values.device
    out = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_masked_percentiles(
            values.data_ptr(), mask.data_ptr(), percents.data_ptr(), out.data_ptr(),
            _workspace(dev).data_ptr(), values.numel(), k, *_descent_launch(values),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "masked_percentiles launch")
    masked_percentiles.launches += 1
    return out


masked_percentiles.launches = 0


def kth_smallest_plain(values: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of `kth_smallest`: a sort and an index."""
    return torch.sort(values.reshape(-1).float()).values[k - 1]


def kth_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The exact 1-based k-th smallest of the f32 `values` (any shape, read
    flat) as a 0-d tensor on their device; nothing is read back to the host.
    Bit-equal to the JAX `_kth_smallest` (ohem.py:35)."""
    n = values.numel()
    if not 1 <= k <= n:
        raise ValueError(f"kth_smallest: k {k} of {n} values")
    if values.device.type == "cpu":
        return kth_smallest_plain(values, k)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(values, values.dim(), "kth_smallest")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    dev = values.device
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_kth_smallest(
            values.data_ptr(), out.data_ptr(), _workspace(dev).data_ptr(), n, int(k),
            *_descent_launch(values), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "kth_smallest launch")
    kth_smallest.launches += 1
    return out


kth_smallest.launches = 0
