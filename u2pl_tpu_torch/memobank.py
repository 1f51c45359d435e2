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
`enqueue_segments`.  Under a process group (data-parallel training) every
rank's keys enter every rank's bank, so the write takes K5's two other
modes around the all_gather (u2pl_tpu/losses/contrastive.py:259-273):
`memobank_gather` writes the rank's (C, K, F) slab, and
`memobank_enqueue_slabs` ring-writes the gathered (W, C, K, F) slabs; on
CPU tensors, `gather_rows` and `enqueue_segments`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

BANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the kernels' code of a bank's or a rep's dtype (memobank.cu, infonce.cu)
BANK_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    device: Union[str, torch.device] = "cuda",
) -> MemoryBank:
    """An empty bank on `device` (the card unless the caller names the
    CPU); `dtype` a torch dtype or a `queue_dtype` name."""
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


ENQUEUE_TILES_PER_SM = 2


def _enqueue_tile(pixels: int, sms: int) -> int:
    """K5's tile: the consecutive pixels of the rep one block owns (it
    writes the selected rows at them), ENQUEUE_TILES_PER_SM tiles per SM."""
    return max(1, -(-pixels // (ENQUEUE_TILES_PER_SM * sms)))


def memobank_enqueue(
    bank: MemoryBank, rep_teacher: torch.Tensor, sel_idx: torch.Tensor, n_sel: torch.Tensor
) -> MemoryBank:
    """Enqueue, per class c, the teacher representation rows at pixels
    sel_idx[c, :n_sel[c]] into the ring, in that order.  rep_teacher
    (B, F, h, w) float32 or bfloat16 NCHW (a bf16 row is copied into a bf16
    bank exactly and widened into an f32 one, as JAX's gather in the rep's
    dtype and the bank's cast do); sel_idx (C, K) int32 flat pixel indices;
    n_sel (C,) int32 (<= K).  In place; the counts stay on the device.

    On the card, kernel K5: each selected row is read straight from the NCHW
    map, cast to the storage dtype and written at its ring row, so the
    (C, K, F) slab is never written.  A block owns a tile of
    `_enqueue_tile` consecutive pixels and writes the selected rows there,
    reading the rep in pixel order; the launch's last block moves `ptr` and
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
    from u2pl_tpu_torch.ops.resize import F32_BF16, _check_cuda

    _check_cuda(rep_teacher, 4, "memobank_enqueue rep_teacher", F32_BF16)
    dev = rep_teacher.device
    for name, t, dt in (("sel_idx", sel_idx, torch.int32), ("n_sel", n_sel, torch.int32),
                        ("ptr", bank.ptr, torch.int32), ("occupancy", bank.occupancy, torch.int32),
                        ("sizes", bank.sizes, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"memobank_enqueue: {name} must be contiguous {dt} on {dev}")
    if bank.keys.device != dev or not bank.keys.is_contiguous():
        raise ValueError("memobank_enqueue: the bank must be contiguous on the rep's device")
    dtype_code = BANK_DTYPE_CODES.get(bank.keys.dtype)
    if dtype_code is None:
        raise TypeError(f"memobank_enqueue: bank dtype {bank.keys.dtype} (float32 or bfloat16)")
    if bank.keys.numel() >= 2**31:
        raise ValueError("memobank_enqueue: the bank exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import TICKET_MEMOBANK, check, load, tickets
    from u2pl_tpu_torch.ops.resize import _sm_count

    lib = load()
    b, _, h, w = rep_teacher.shape
    k = sel_idx.shape[1]
    with torch.cuda.device(dev):
        err = lib.u2pl_memobank_enqueue(
            rep_teacher.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(), bank.keys.data_ptr(),
            bank.ptr.data_ptr(), bank.occupancy.data_ptr(), bank.sizes.data_ptr(),
            tickets(dev)[TICKET_MEMOBANK].data_ptr(), b, f, h * w, c, k, cap, dtype_code,
            BANK_DTYPE_CODES[rep_teacher.dtype], _enqueue_tile(b * h * w, _sm_count(dev)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "memobank_enqueue launch")
    memobank_enqueue.launches += 1
    return bank


memobank_enqueue.launches = 0


def memobank_gather_plain(rep_teacher: torch.Tensor, sel_idx: torch.Tensor,
                          n_sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5's gather: the (C, K, F) slab
    `rep_t_f[sel_idx]` (contrastive.py:259) in the rep's dtype, every row
    (the kernel writes the rows below n_sel alone)."""
    return gather_rows(rep_teacher.detach(), sel_idx)


def memobank_gather(rep_teacher: torch.Tensor, sel_idx: torch.Tensor,
                    n_sel: torch.Tensor) -> torch.Tensor:
    """This rank's (C, K, F) slab of keys for the all_gather: row r of class
    c is the teacher representation's row at pixel sel_idx[c, r], in the
    rep's dtype (f32 or bf16), for r < n_sel[c]; the rows past n_sel[c] are
    left unwritten on the card (nothing reads them).  On the card, K5's
    gather mode (memobank.cu: a block per 32 rows of a class)."""
    if sel_idx.dim() != 2 or n_sel.shape != sel_idx.shape[:1] or rep_teacher.dim() != 4:
        raise ValueError(f"memobank_gather: rep {tuple(rep_teacher.shape)}, sel_idx "
                         f"{tuple(sel_idx.shape)}, n_sel {tuple(n_sel.shape)}")
    rep_teacher = rep_teacher.detach()
    if rep_teacher.device.type == "cpu":
        return memobank_gather_plain(rep_teacher, sel_idx, n_sel)
    from u2pl_tpu_torch.ops.resize import F32_BF16, _check_cuda

    _check_cuda(rep_teacher, 4, "memobank_gather rep_teacher", F32_BF16)
    dev = rep_teacher.device
    for name, t in (("sel_idx", sel_idx), ("n_sel", n_sel)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"memobank_gather: {name} must be contiguous int32 on {dev}")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    b, f, h, w = rep_teacher.shape
    c, k = sel_idx.shape
    slab = torch.empty((c, k, f), dtype=rep_teacher.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_memobank_gather(
            rep_teacher.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(), slab.data_ptr(),
            b, f, h * w, c, k, BANK_DTYPE_CODES[rep_teacher.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "memobank_gather launch")
    memobank_gather.launches += 1
    return slab


memobank_gather.launches = 0


def memobank_enqueue_slabs_plain(bank: MemoryBank, slabs: torch.Tensor,
                                 counts: torch.Tensor) -> MemoryBank:
    """Plain PyTorch version of K5's slab enqueue: `enqueue_segments` of the
    (W, C, K, F) slabs as (C, W, K, F) with the (W, C) counts as (C, W)."""
    return enqueue_segments(bank, slabs.transpose(0, 1), counts.t())


def memobank_enqueue_slabs(bank: MemoryBank, slabs: torch.Tensor,
                           counts: torch.Tensor) -> MemoryBank:
    """Ring-write every rank's keys: slabs (W, C, K, F) f32 or bf16, the
    all-gathered `memobank_gather` slabs; counts (W, C) int32, the rows of
    each that are keys.  Class c takes the kept rows in (rank, row) order,
    the newest `size` when they are more (memobank.py:50-113), cast to the
    bank's dtype as `memobank_enqueue` casts them.  In place.  On the card,
    K5's slab mode (memobank.cu: a block per (32 rows, rank, class); its
    last block moves `ptr` and `occupancy`)."""
    c, cap, f = bank.keys.shape
    if slabs.dim() != 4 or slabs.shape[1:] != (c, slabs.shape[2], f) or \
            counts.shape != (slabs.shape[0], c):
        raise ValueError(f"memobank_enqueue_slabs: bank {tuple(bank.keys.shape)}, slabs "
                         f"{tuple(slabs.shape)}, counts {tuple(counts.shape)}")
    if slabs.device.type == "cpu":
        return memobank_enqueue_slabs_plain(bank, slabs, counts)
    from u2pl_tpu_torch.ops.resize import F32_BF16, _check_cuda

    _check_cuda(slabs, 4, "memobank_enqueue_slabs slabs", F32_BF16)
    dev = slabs.device
    for name, t in (("counts", counts), ("ptr", bank.ptr), ("occupancy", bank.occupancy),
                    ("sizes", bank.sizes)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"memobank_enqueue_slabs: {name} must be contiguous int32 on {dev}")
    if bank.keys.device != dev or not bank.keys.is_contiguous():
        raise ValueError("memobank_enqueue_slabs: the bank must be contiguous on the slabs' device")
    dtype_code = BANK_DTYPE_CODES.get(bank.keys.dtype)
    if dtype_code is None:
        raise TypeError(f"memobank_enqueue_slabs: bank dtype {bank.keys.dtype} (float32 or "
                        "bfloat16)")
    if bank.keys.numel() >= 2**31:
        raise ValueError("memobank_enqueue_slabs: the bank exceeds the int32 sizes")
    from u2pl_tpu_torch.kernels import TICKET_MEMOBANK, check, load, tickets

    lib = load()
    w, _, k, _ = slabs.shape
    with torch.cuda.device(dev):
        err = lib.u2pl_memobank_enqueue_slabs(
            slabs.data_ptr(), counts.data_ptr(), bank.keys.data_ptr(), bank.ptr.data_ptr(),
            bank.occupancy.data_ptr(), bank.sizes.data_ptr(),
            tickets(dev)[TICKET_MEMOBANK].data_ptr(), w, f, c, k, cap, dtype_code,
            BANK_DTYPE_CODES[slabs.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "memobank_enqueue_slabs launch")
    memobank_enqueue_slabs.launches += 1
    return bank


memobank_enqueue_slabs.launches = 0
