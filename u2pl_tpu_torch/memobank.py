"""Per-class negative-key memory bank as a fixed-shape device ring buffer
(port of u2pl_tpu/memobank.py).

`keys` (C, cap, F) holds each class's ring; `ptr` the next write row,
`occupancy` the stored count and `sizes` the per-class capacity (30,000
keys, 50,000 for class 0, as train_semi.py sizes it).  Storage is the
config's `contrastive.queue_dtype`, bfloat16 by default: the flagship bank
(21, 50000, 256) is 537.6 MB.  Casts to the storage type round to nearest
even, as `astype` does in JAX.

Where JAX returns a new bank, the port updates the tensors of the one it is
given IN PLACE (and returns it): a copy of half a gigabyte per step buys
nothing.  Copy the bank (`clone_bank`) to keep the old one.

`enqueue` / `enqueue_segments` / `sample` are the JAX functions in PyTorch,
with the random draws as an argument.  The train step's write is
`memobank_enqueue`: kernel K5 (`kernels/csrc/memobank.cu`) on the card,
which gathers the selected rows of the teacher's NCHW representation and
writes them into the ring in one pass; on a CPU tensor, the gather and
`enqueue_segments`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

BANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class MemoryBank:
    keys: torch.Tensor  # (C, cap, F) storage ring
    ptr: torch.Tensor  # (C,) int32 next write position
    occupancy: torch.Tensor  # (C,) int32 number of valid keys
    sizes: torch.Tensor  # (C,) int32 effective per-class capacity


def init_memobank(
    num_classes: int,
    feat_dim: int = 256,
    queue_size: int = 30000,
    class0_size: int = 50000,
    dtype: Union[str, torch.dtype] = torch.bfloat16,
    device: Union[str, torch.device] = "cpu",
) -> MemoryBank:
    """An empty bank; `dtype` a torch dtype or a `queue_dtype` name."""
    if isinstance(dtype, str):
        if dtype not in BANK_DTYPES:
            raise NotImplementedError(
                f"contrastive.queue_dtype {dtype!r}: the port stores the bank in "
                f"{sorted(BANK_DTYPES)}"
            )
        dtype = BANK_DTYPES[dtype]
    sizes = torch.full((num_classes,), queue_size, dtype=torch.int32)
    sizes[0] = class0_size
    cap = int(max(queue_size, class0_size))
    return MemoryBank(
        keys=torch.zeros((num_classes, cap, feat_dim), dtype=dtype, device=device),
        ptr=torch.zeros((num_classes,), dtype=torch.int32, device=device),
        occupancy=torch.zeros((num_classes,), dtype=torch.int32, device=device),
        sizes=sizes.to(device),
    )


def clone_bank(bank: MemoryBank) -> MemoryBank:
    return MemoryBank(*(t.clone() for t in (bank.keys, bank.ptr, bank.occupancy, bank.sizes)))


def enqueue(bank: MemoryBank, new_keys: torch.Tensor, valid: torch.Tensor) -> MemoryBank:
    """new_keys (C, K, F) per-class slabs, valid (C, K) bool: ring-write each
    class's valid rows in slab order at `ptr`, keeping the newest `size`
    when one call brings more (memobank.py:50-89).  In place."""
    c, cap, f = bank.keys.shape
    validi = valid.to(torch.int32)
    n_new = validi.sum(dim=1)  # (C,)
    rank = torch.cumsum(validi, dim=1) - 1
    size = bank.sizes[:, None]
    keep = valid & (rank >= n_new[:, None] - size)
    pos = torch.remainder(bank.ptr[:, None] + rank, size)
    rows = (torch.arange(c, device=pos.device)[:, None] * cap + pos)[keep].long()
    bank.keys.view(c * cap, f)[rows] = new_keys[keep].to(bank.keys.dtype)
    bank.ptr.copy_(torch.remainder(bank.ptr + n_new, bank.sizes))
    bank.occupancy.copy_(torch.minimum(bank.occupancy + n_new, bank.sizes))
    return bank


def enqueue_segments(bank: MemoryBank, new_keys: torch.Tensor, n: torch.Tensor) -> MemoryBank:
    """new_keys (C, W, K, F): one prefix-compact slab per data-parallel
    replica (W = 1 on one card); n (C, W) the rows of each slab that are
    keys.  The multi-GPU slice all-gathers the slabs into this layout
    (memobank.py:92-113).  In place."""
    c, w, k, f = new_keys.shape
    valid = torch.arange(k, device=n.device)[None, None, :] < torch.clamp(n, max=k)[:, :, None]
    return enqueue(bank, new_keys.reshape(c, w * k, f), valid.reshape(c, w * k))


def sample(
    bank: MemoryBank, u: torch.Tensor, dtype: Union[torch.dtype, None] = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform with-replacement sample of u.shape[1] keys per class from the
    draws u (C, S) f32 in [0, 1) (memobank.py:116-132).  Returns (samples
    (C, S, F) in `dtype` (None: the storage dtype), nonempty (C,) bool)."""
    occ = torch.clamp(bank.occupancy, min=1).to(torch.float32)
    idx = torch.floor(u * occ[:, None]).long()  # float32, as JAX
    samples = torch.gather(bank.keys, 1, idx[:, :, None].expand(-1, -1, bank.keys.shape[2]))
    if dtype is not None:
        samples = samples.to(dtype)
    return samples, bank.occupancy > 0


def gather_rows(rep: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of an NCHW (B, F, h, w) map at flat pixel indices
    n = b*h*w + y*w + x (any index shape) -> (*idx.shape, F)."""
    b, f, h, w = rep.shape
    return rep.permute(0, 2, 3, 1).reshape(b * h * w, f)[idx.long()]


def memobank_enqueue_plain(
    bank: MemoryBank, rep_teacher: torch.Tensor, sel_idx: torch.Tensor, n_sel: torch.Tensor
) -> MemoryBank:
    """Plain PyTorch version of kernel K5: `new_keys = rep_t_f[sel_idx]`
    (contrastive.py:259), then `enqueue_segments` with W = 1."""
    new_keys = gather_rows(rep_teacher, sel_idx)
    return enqueue_segments(bank, new_keys[:, None], n_sel[:, None])


def memobank_enqueue(
    bank: MemoryBank, rep_teacher: torch.Tensor, sel_idx: torch.Tensor, n_sel: torch.Tensor
) -> MemoryBank:
    """Enqueue, per class c, the teacher representation rows at pixels
    sel_idx[c, :n_sel[c]] into the ring, in that order.  rep_teacher
    (B, F, h, w) float32 NCHW; sel_idx (C, K) int32 flat pixel indices;
    n_sel (C,) int32 (<= K).  In place; the counts stay on the device.

    On the card, kernel K5: each selected row is read straight from the NCHW
    map, cast to the storage dtype and written at its ring row, so the
    (C, K, F) slab is never written; a second launch moves `ptr` and
    `occupancy`."""
    c, cap, f = bank.keys.shape
    if (sel_idx.dim() != 2 or sel_idx.shape[0] != c or n_sel.shape != (c,)
            or rep_teacher.dim() != 4 or rep_teacher.shape[1] != f):
        raise ValueError(
            f"memobank_enqueue: bank {tuple(bank.keys.shape)}, rep {tuple(rep_teacher.shape)}, "
            f"sel_idx {tuple(sel_idx.shape)}, n_sel {tuple(n_sel.shape)}"
        )
    rep_teacher = rep_teacher.detach()
    if rep_teacher.device.type == "cpu":
        return memobank_enqueue_plain(bank, rep_teacher, sel_idx, n_sel)
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(rep_teacher, 4, "memobank_enqueue rep_teacher")
    dev = rep_teacher.device
    for name, t, dt in (("sel_idx", sel_idx, torch.int32), ("n_sel", n_sel, torch.int32),
                        ("ptr", bank.ptr, torch.int32), ("occupancy", bank.occupancy, torch.int32),
                        ("sizes", bank.sizes, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"memobank_enqueue: {name} must be contiguous {dt} on {dev}")
    if bank.keys.device != dev or not bank.keys.is_contiguous():
        raise ValueError("memobank_enqueue: the bank must be contiguous on the rep's device")
    dtype_code = {torch.float32: 0, torch.bfloat16: 1}.get(bank.keys.dtype)
    if dtype_code is None:
        raise TypeError(f"memobank_enqueue: bank dtype {bank.keys.dtype} (float32 or bfloat16)")
    if bank.keys.numel() >= 2**31:
        raise ValueError("memobank_enqueue: the bank exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    b, _, h, w = rep_teacher.shape
    with torch.cuda.device(dev):
        err = lib.u2pl_memobank_enqueue(
            rep_teacher.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(), bank.keys.data_ptr(),
            bank.ptr.data_ptr(), bank.occupancy.data_ptr(), bank.sizes.data_ptr(),
            b, f, h * w, c, sel_idx.shape[1], cap, dtype_code,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "memobank_enqueue launch")
    memobank_enqueue.launches += 1
    return bank


memobank_enqueue.launches = 0
