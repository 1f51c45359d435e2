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
"""

from __future__ import annotations

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
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(values, values.dim(), "masked_percentiles")
    _check_cuda_f32(percents, 1, "masked_percentiles percents")
    if mask.device != values.device or not mask.is_contiguous():
        raise ValueError("masked_percentiles: a contiguous mask on the values' device")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    k = percents.shape[0]
    if not 0 < k <= lib.u2pl_quantile_max_queries() or values.numel() == 0:
        raise ValueError(f"masked_percentiles: {k} percents of {values.numel()} values")
    dev = values.device
    state = torch.zeros(lib.u2pl_quantile_state_words(), dtype=torch.int32, device=dev)
    out = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_masked_percentiles(
            values.data_ptr(), mask.data_ptr(), percents.data_ptr(), out.data_ptr(),
            state.data_ptr(), values.numel(), k, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "masked_percentiles launch")
    masked_percentiles.launches += 1
    return out


masked_percentiles.launches = 0
