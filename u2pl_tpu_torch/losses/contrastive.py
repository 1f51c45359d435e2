"""Pixel-wise InfoNCE contrastive loss with per-class negative memory banks
(port of u2pl_tpu/losses/contrastive.py: `compute_contra_memobank_loss`).

The JAX function's reference quirks are kept (its module docstring): with
`strict_reference=True`, position j takes anchors and the prototype of
class j but negatives from the bank of `b_j`, the j-th class that has
low-valid pixels; labeled pixels never become negative keys.

Layout: the port is NCHW.  `rep`, `rep_teacher` (B, F, h, w); `prob_*`
(B, C, h, w); labels and masks (B, h, w).  Pixels are flattened in JAX's
order, n = b*h*w + y*w + x, so per-pixel draws address the same pixels on
both sides.

Random draws are inputs: `draws = (pri, u_anchor, u_neg)`, float32 in
[0, 1):
  pri (C, N)            key-selection priorities of class c's pixels
                        (JAX: uniform(split(kkey, C)[c], (N,))); under
                        `select_keys: radix` int32 holding u32 keys
                        (JAX: bits(split(kkey, C)[c], (N,), uint32));
  u_anchor (C, Q)       anchor draws of POSITION j (split(akey, C)[j]);
  u_neg (C, Q*M)        bank draws of BANK CLASS c (uniform(nkey, (C, Q*M)));
                        position j reads row b_j.

The device functions and their kernels (CUDA C++, sm_90a):
  contra_pixel_masks   K4 (`kernels/csrc/contrastive.cu`): per pixel the
                       stable descending rank of its label class fused with
                       the anchor, negative and low-valid masks and their
                       counts;
  select_keys          K4: per class the k smallest (priority, pixel) pairs
                       of the negative mask, in ascending order (one
                       thread block cluster per class);
  select_keys_radix    K4r: per class the masked pixels whose u32 key is at
                       or under the k-th smallest, the first k in pixel
                       order (`select_keys: radix`; one thread block
                       cluster per class);
  sample_anchors       K4: per position the with-replacement anchor draws
                       mapped to set pixels of the anchor mask (one thread
                       block cluster per position);
  memobank_enqueue     K5 (`memobank.py`, `kernels/csrc/memobank.cu`); under
                       a process group its gather and slab modes around
                       the all_gather (`memobank_gather`,
                       `memobank_enqueue_slabs`);
  contra_infonce       K6 (`kernels/csrc/infonce.cu`): the bank sample, the
                       cosines, the log-softmax CE to the positive and the
                       masked mean, forward and backward.
Each wrapper takes its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor, or raises; `<wrapper>.launches` counts the
launches.  The prototype masked mean stays a matmul (`torch.bmm`), as JAX
leaves it to XLA; under `contrastive.anchor_ema` the blend with the
momentum prototype and the new prototype are torch ops too (`_anchor_ema`),
and K6 takes the blended (C, Q, F) positive, one per draw.

bfloat16 reps (a bf16 model): the prototype is JAX's bf16 x bf16 product
with f32 accumulation (:243-249), here a `bmm` of the f32-widened
operands (exact, where a bf16 `bmm` would round its output); the keys go
to the bank in the rep's dtype (K5); the anchors are the f32 cast of bf16
rows (:286), whose VJP rounds each row's gradient to bf16 and scatter-adds
the rows in bf16 (`_AnchorRows`); with a bf16 bank the cosine is JAX's
dot-first form (:325-360), with an f32 bank normalise-then-dot.  K6 has a
bf16-rep mode of each.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from u2pl_tpu_torch import dist
from u2pl_tpu_torch.config import ContrastiveCfg
from u2pl_tpu_torch.memobank import (
    BANK_DTYPE_CODES,
    MemoryBank,
    gather_rows,
    memobank_enqueue,
    memobank_enqueue_slabs,
    memobank_gather,
    sample,
)
from u2pl_tpu_torch.ops.one_hot import label_onehot

MAX_CLASSES = 32  # contra_pixel_masks: a class fits a byte, its counts 2 x 32 ticket words
MAX_KEYS = 16384  # select_keys keeps <= 16384 survivors per class
FEAT_DIM = 256  # contra_infonce: one warp per anchor, 8 features per lane
MAX_DRAWS = 8192  # contra_infonce's backward keys a tile's draws by j*Q + q < 2^13
EPS = 1e-8  # torch cosine-similarity eps


def _launch(lib, name: str, what: str, dev: torch.device, *args) -> None:
    from u2pl_tpu_torch.kernels import check

    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, f"{what} launch")


def _require(t: torch.Tensor, dev: torch.device, dtype: torch.dtype, what: str) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: a contiguous {dtype} tensor on {dev}, got {t.dtype} on {t.device}")


# ---- ranks and masks (K4: contra_pixel_masks) ------------------------------

def ranks_desc(prob: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """rank[..., c] = position of class c in a stable descending sort of
    `prob` along `dim` (contrastive.py:50): #{c': p[c'] > p[c]} plus
    #{c' < c: p[c'] == p[c]}, as a compare-count."""
    p = prob.movedim(dim, -1)
    c = p.shape[-1]
    gt = p[..., None, :] > p[..., :, None]
    eq = p[..., None, :] == p[..., :, None]
    tri = torch.arange(c, device=p.device)[None, :] < torch.arange(c, device=p.device)[:, None]
    return (gt | (eq & tri)).sum(dim=-1).movedim(-1, dim)


def contra_pixel_masks_plain(
    prob: torch.Tensor,
    labels: torch.Tensor,
    low_mask: torch.Tensor,
    high_mask: torch.Tensor,
    num_labeled: int,
    cfg: ContrastiveCfg,
    ignore_label: int = 255,
):
    """Plain PyTorch version of `contra_pixel_masks`: the JAX formulas
    (contrastive.py:201-238) on the one-hot labels."""
    b, c, h, w = prob.shape
    n = b * h * w
    onehot = label_onehot(labels, c, ignore_label)  # (B, C, h, w)
    low_valid = (onehot * low_mask[:, None].float()) > 0
    high_valid = (onehot * high_mask[:, None].float()) > 0
    ranks = ranks_desc(prob, dim=1)

    def flat(x):  # (B, C, h, w) -> (C, N)
        return x.permute(1, 0, 2, 3).reshape(c, n)

    prob_f, ranks_f, onehot_f = flat(prob), flat(ranks), flat(onehot)
    low_valid_f, high_valid_f = flat(low_valid), flat(high_valid)
    is_labeled = (torch.arange(b, device=prob.device) < num_labeled).repeat_interleave(h * w)
    anchor = (prob_f > cfg.current_class_threshold) & low_valid_f
    neg_high = (prob_f < cfg.current_class_negative_threshold) & high_valid_f
    class_mask_u = (ranks_f >= cfg.low_rank) & (ranks_f < cfg.high_rank)
    class_mask_l = (ranks_f < cfg.low_rank) & (onehot_f == 0)
    negative = neg_high & torch.where(is_labeled[None], class_mask_l, class_mask_u)
    counts = torch.stack([low_valid_f.sum(dim=1), negative.sum(dim=1)]).to(torch.int32)
    return anchor, negative, low_valid_f.to(torch.float32), counts


# contra_pixel_masks's kernel: MASKS_PIXELS consecutive pixels a thread,
# MASKS_THREADS threads a block (kMaskPix, kMaskThreads in contrastive.cu)
MASKS_PIXELS = 4
MASKS_THREADS = 128
MASKS_BLOCKS_PER_SM = 8


def _masks_plan(n: int, c: int, sms: int) -> int:
    """The blocks of `contra_pixel_masks`'s kernel for n pixels and c
    classes on `sms` SMs: thread t of block k takes the group of
    MASKS_PIXELS pixels at (k + i * blocks) * MASKS_THREADS + t, for i =
    0, 1, ... while it is below ceil(n / MASKS_PIXELS).  (The kernel's
    entry stores a group's bytes in one 4-byte store per mask and its
    low-valid values in one 16-byte store where n is a multiple of
    MASKS_PIXELS, so that every class row starts 4-aligned.)  Raises where
    the (c, n) outputs exceed int32 offsets or c the byte a class is held
    in."""
    if n <= 0 or not 0 < c <= MAX_CLASSES or c * n >= 2**31:
        raise ValueError(f"contra_pixel_masks: {c} classes (at most {MAX_CLASSES}) x {n} pixels "
                         f"(under 2^31 values)")
    groups = -(-n // MASKS_PIXELS)
    return max(1, min(-(-groups // MASKS_THREADS), MASKS_BLOCKS_PER_SM * sms))


def contra_pixel_masks(
    prob: torch.Tensor,
    labels: torch.Tensor,
    low_mask: torch.Tensor,
    high_mask: torch.Tensor,
    num_labeled: int,
    cfg: ContrastiveCfg,
    ignore_label: int = 255,
):
    """The per-pixel masks of the contrastive loss.  prob (B, C, h, w) f32
    (the teacher's softmax at the rep's resolution, labeled images first);
    labels (B, h, w) int32 small labels with `ignore_label`; low_mask /
    high_mask (B, h, w) bool; the first `num_labeled` images are labeled.

    Returns (anchor (C, N) bool, negative (C, N) bool, low_valid (C, N) f32
    (the prototype GEMM's operand), counts (2, C) int32: [n_low_valid,
    neg_candidates])."""
    b, c, h, w = prob.shape
    if (labels.shape != (b, h, w) or low_mask.shape != (b, h, w)
            or high_mask.shape != (b, h, w) or not 0 <= num_labeled <= b):
        raise ValueError(
            f"contra_pixel_masks: prob {tuple(prob.shape)}, labels {tuple(labels.shape)}, "
            f"masks {tuple(low_mask.shape)} {tuple(high_mask.shape)}, num_labeled {num_labeled}"
        )
    if prob.device.type == "cpu":
        return contra_pixel_masks_plain(prob, labels, low_mask, high_mask, num_labeled, cfg,
                                        ignore_label)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(prob, 4, "contra_pixel_masks")
    dev = prob.device
    _require(labels, dev, torch.int32, "contra_pixel_masks labels")
    _require(low_mask, dev, torch.bool, "contra_pixel_masks low_mask")
    _require(high_mask, dev, torch.bool, "contra_pixel_masks high_mask")
    from u2pl_tpu_torch.kernels import TICKET_CONTRA_MASKS, load, tickets
    from u2pl_tpu_torch.ops.resize import _sm_count

    lib = load()
    n = b * h * w
    blocks = _masks_plan(n, c, _sm_count(dev))
    anchor = torch.empty((c, n), dtype=torch.bool, device=dev)
    negative = torch.empty((c, n), dtype=torch.bool, device=dev)
    low_valid = torch.empty((c, n), dtype=torch.float32, device=dev)
    counts = torch.empty((2, c), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_pixel_masks", "contra_pixel_masks", dev,
            prob.data_ptr(), labels.data_ptr(), low_mask.data_ptr(), high_mask.data_ptr(),
            anchor.data_ptr(), negative.data_ptr(), low_valid.data_ptr(), counts.data_ptr(),
            tickets(dev)[TICKET_CONTRA_MASKS].data_ptr(), b, num_labeled, c, h * w,
            int(ignore_label), float(cfg.current_class_threshold),
            float(cfg.current_class_negative_threshold), int(cfg.low_rank), int(cfg.high_rank),
            blocks)
    contra_pixel_masks.launches += 1
    return anchor, negative, low_valid, counts


contra_pixel_masks.launches = 0


# ---- key selection (K4: select_keys) ---------------------------------------

def select_keys_plain(mask: torch.Tensor, pri: torch.Tensor, k: int):
    """Plain PyTorch version of `select_keys`: the stable argsort of the
    priorities with masked-out pixels at +inf (contrastive.py:89-103),
    sliced to k.  Entries past n_sel are the argsort's (unselected pixels
    in pixel order, then zeros when N < k); nothing reads them."""
    c, n = mask.shape
    p = torch.where(mask, pri, torch.full_like(pri, float("inf")))
    order = torch.sort(p, dim=1, stable=True).indices[:, :k].to(torch.int32)
    if order.shape[1] < k:
        order = torch.cat([order, order.new_zeros((c, k - order.shape[1]))], dim=1)
    n_sel = torch.clamp(mask.sum(dim=1), max=k).to(torch.int32)
    return order, n_sel


# select_keys's kernel: one cluster of SELECT_CLUSTER blocks per class, each
# holding its slice of the row's keys (u32) and its survivors' pixels (u16)
# in shared memory behind a fixed header (kSelHeader in contrastive.cu)
SELECT_CLUSTER = 8
SELECT_HEADER_BYTES = 2 * 256 * 4 + 8 * 4 + 32 * 4
SELECT_MAX_SHARED = 232448  # a block's shared memory on sm_90 (227 KB)


def _select_plan(c: int, n: int, k: int) -> Tuple[int, int, int]:
    """(slice, pixcap, smem) of `select_keys`'s kernel for a (c, n) mask and
    k keys: block r of a class's cluster owns pixels [r * slice, (r + 1) *
    slice) (slice a multiple of 4, so the 8 blocks cover the row; below
    2^16, its pixels' u16 offsets), holds up to pixcap = min(k, slice)
    survivors, in smem bytes of shared memory.  Raises where a block's
    slice does not fit."""
    if c <= 0 or n <= 0 or not 0 < k <= MAX_KEYS:
        raise ValueError(f"select_keys: {c} classes, {n} pixels, k {k} (k <= {MAX_KEYS})")
    slice_ = -(-n // SELECT_CLUSTER)
    slice_ += -slice_ % 4
    pixcap = min(k, slice_)
    smem = SELECT_HEADER_BYTES + 4 * slice_ + 2 * pixcap
    if slice_ > 65536 or smem > SELECT_MAX_SHARED:
        raise ValueError(f"select_keys: {n} pixels per class need {smem} bytes of shared memory "
                         f"per block (at most {SELECT_MAX_SHARED})")
    return slice_, pixcap, smem


def select_keys(mask: torch.Tensor, pri: torch.Tensor, k: int):
    """Per class c, the indices of the min(k, #mask[c]) pixels of mask[c]
    with the smallest (pri[c, n], n), in ascending order: JAX's
    `_select_keys_argsort` on the same priorities.  mask (C, N) bool; pri
    (C, N) f32.  Returns (sel_idx (C, k) int32, n_sel (C,) int32); only the
    first n_sel[c] entries of row c are keys (zeros follow on the card).

    On the card (k <= 16384, N up to ~390,000 per class): one launch, a
    cluster of 8 blocks per class (`_select_plan`) that finds the k-th
    smallest priority by a radix descent in shared memory and sorts the
    survivors (see `kernels/csrc/contrastive.cu`)."""
    c, n = mask.shape
    if pri.shape != (c, n) or k <= 0:
        raise ValueError(f"select_keys: mask {tuple(mask.shape)}, pri {tuple(pri.shape)}, k {k}")
    if mask.device.type == "cpu":
        return select_keys_plain(mask, pri, k)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(pri, 2, "select_keys pri")
    dev = pri.device
    _require(mask, dev, torch.bool, "select_keys mask")
    if k > MAX_KEYS:
        raise ValueError(f"select_keys: k {k} > {MAX_KEYS} (max_keys_per_class_per_step)")
    slice_, pixcap, smem = _select_plan(c, n, k)
    from u2pl_tpu_torch.kernels import load

    lib = load()
    sel_idx = torch.empty((c, k), dtype=torch.int32, device=dev)
    n_sel = torch.empty((c,), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_select_keys", "select_keys", dev,
            mask.data_ptr(), pri.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(),
            c, n, k, slice_, pixcap, smem)
    select_keys.launches += 1
    return sel_idx, n_sel


select_keys.launches = 0


# ---- radix key selection (K4r: select_keys_radix) -------------------------

def _u32(keys: torch.Tensor) -> torch.Tensor:
    """u32 key bits held in int32 (or int64 in [0, 2^32)) -> int64 in [0, 2^32)."""
    return keys.to(torch.int64) & 0xFFFFFFFF


def select_keys_radix_plain(mask: torch.Tensor, keys: torch.Tensor, k: int):
    """Plain PyTorch version of `select_keys_radix`: JAX's
    `_select_keys_radix` (contrastive.py:126-137) per class, with
    `torch.kthvalue` on the int64 keys for the radix select, then cumsum and
    searchsorted."""
    c, n = mask.shape
    kk = min(k, n)
    kv = torch.where(mask, _u32(keys), torch.full_like(keys, 0xFFFFFFFF, dtype=torch.int64))
    cnt = mask.sum(dim=1)
    thresh = torch.kthvalue(kv, kk, dim=1).values
    sel = torch.where((cnt > kk)[:, None], mask & (kv <= thresh[:, None]), mask)
    cs = torch.cumsum(sel.to(torch.int32), dim=1)
    ranks = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device).expand(c, k).contiguous()
    idx = torch.searchsorted(cs, ranks, side="left")
    return torch.clamp(idx, 0, n - 1).to(torch.int32), torch.clamp(cnt, max=k).to(torch.int32)


# select_keys_radix's kernel: one cluster of RADIX_CLUSTER blocks of
# RADIX_THREADS threads per class; a block walks its slice in chunks of
# RADIX_CHUNK pixels and holds as many of them as fit in shared memory (their
# u32 keys and 4 mask words each) behind a fixed header (kRxCluster,
# kRxThreads, kRxChunk, kRxHeader, kRxChunkBytes in contrastive.cu)
RADIX_CLUSTER = 8
RADIX_THREADS = 512
RADIX_CHUNK = 128
RADIX_HEADER_BYTES = 2 * 256 * 4 + 16 * 4 + 32 * 4 + RADIX_THREADS * 4
RADIX_CHUNK_BYTES = RADIX_CHUNK * 4 + 16
RADIX_MAX_SHARED = SELECT_MAX_SHARED


def _radix_plan(c: int, n: int, k: int) -> Tuple[int, int, int]:
    """(slice, held, smem) of `select_keys_radix`'s kernel for a (c, n) mask
    and k keys: block r of a class's cluster owns pixels [r * slice, (r + 1)
    * slice) (slice a multiple of 4, so the 8 blocks cover the row and every
    4-pixel quad starts aligned where n % 4 == 0), walked in chunks of
    RADIX_CHUNK pixels, of which the first `held` stay in shared memory, as
    many as fit in smem bytes: every chunk of the slice while it is held
    whole (up to 55,296 pixels a block, rows of ~442,000 pixels); the chunks
    past them are read again from global memory.  No row length is
    refused."""
    if c <= 0 or not 0 < n < 2**31 - 64 or k <= 0:
        raise ValueError(f"select_keys_radix: {c} classes, {n} pixels, k {k}")
    slice_ = -(-n // RADIX_CLUSTER)
    slice_ += -slice_ % 4
    chunks = -(-slice_ // RADIX_CHUNK)
    held = min(chunks, (RADIX_MAX_SHARED - RADIX_HEADER_BYTES) // RADIX_CHUNK_BYTES)
    return slice_, held, RADIX_HEADER_BYTES + held * RADIX_CHUNK_BYTES


def select_keys_radix(mask: torch.Tensor, keys: torch.Tensor, k: int):
    """Per class c, with kk = min(k, N) and cnt = #mask[c]: when cnt > kk
    the masked pixels whose u32 key (keys[c, n], unsigned) is at or under
    the kk-th smallest masked key, else all masked pixels; of those the first
    k in pixel order, padded with N - 1.  JAX's `_select_keys_radix` on the
    same keys.  mask (C, N) bool; keys (C, N) int32 holding u32 bits (or
    int64 in [0, 2^32)).  Returns (sel_idx (C, k) int32, n_sel (C,) int32
    = min(cnt, k)); only the first n_sel[c] entries of row c are keys.

    On the card, kernel K4r: one launch, a cluster of 8 blocks per class
    (`_radix_plan`) that reads its row once, keeps the keys in shared
    memory, finds the threshold by a radix descent only when the class is
    over the cap, and compacts in pixel order (see
    `kernels/csrc/contrastive.cu`)."""
    c, n = mask.shape
    if keys.shape != (c, n) or k <= 0:
        raise ValueError(f"select_keys_radix: mask {tuple(mask.shape)}, keys "
                         f"{tuple(keys.shape)}, k {k}")
    if mask.device.type == "cpu":
        return select_keys_radix_plain(mask, keys, k)
    dev = keys.device
    if keys.dtype == torch.int64:
        keys = (keys - (keys >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
    keys = keys.contiguous()
    _require(keys, dev, torch.int32, "select_keys_radix keys")
    _require(mask, dev, torch.bool, "select_keys_radix mask")
    slice_, held, smem = _radix_plan(c, n, k)
    from u2pl_tpu_torch.kernels import load

    lib = load()
    sel_idx = torch.empty((c, k), dtype=torch.int32, device=dev)
    n_sel = torch.empty((c,), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_select_keys_radix", "select_keys_radix", dev,
            mask.data_ptr(), keys.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(),
            c, n, k, slice_, held, smem)
    select_keys_radix.launches += 1
    return sel_idx, n_sel


select_keys_radix.launches = 0


# ---- anchor draws (K4: sample_anchors) -------------------------------------

def sample_anchors_plain(mask: torch.Tensor, a_j: torch.Tensor, u: torch.Tensor):
    """Plain PyTorch version of `sample_anchors`: JAX's
    `_sample_with_replacement` (contrastive.py:73-86) per position, cumsum
    and searchsorted."""
    m = mask[a_j.long()].to(torch.int32)
    cs = torch.cumsum(m, dim=1, dtype=torch.int32)
    n = cs[:, -1]
    r = torch.floor(u * n[:, None].to(torch.float32)).to(torch.int32)
    idx = torch.searchsorted(cs, r + 1, side="left")
    return torch.clamp(idx, 0, mask.shape[1] - 1).to(torch.int32), n


# sample_anchors's kernel: a cluster of ANCHORS_CLUSTER blocks of
# ANCHORS_THREADS threads per position, each holding the prefixes (int) of
# its slice's runs of ANCHORS_RUN words in shared memory behind a fixed
# header (kAncCluster, kAncThreads, kAncHeader in contrastive.cu)
ANCHORS_CLUSTER = 8
ANCHORS_THREADS = 256
ANCHORS_RUN = 32
ANCHORS_HEADER_BYTES = 256
ANCHORS_MAX_SHARED = SELECT_MAX_SHARED


def _anchors_plan(n: int, address: int) -> Tuple[int, int, int]:
    """(vec, slice, smem) of `sample_anchors`'s kernel for rows of n pixels
    of a mask at byte `address`: a word is vec = gcd(n, 16, address's
    alignment) bytes, so every row, and every word of it, starts
    vec-aligned; block r of a position's cluster owns the words [r * slice,
    (r + 1) * slice) of the row's n / vec, each of its warps ceil(slice /
    ANCHORS_THREADS) runs of ANCHORS_RUN words, the runs' prefixes in smem
    bytes of shared memory.  Raises where they do not fit (rows of more
    than 14,860,288 pixels at 1-byte words)."""
    if n <= 0:
        raise ValueError(f"sample_anchors: {n} pixels")
    vec = math.gcd(math.gcd(n, 16), address & -address if address else 16)
    slice_ = -(-(n // vec) // ANCHORS_CLUSTER)
    runs = -(-slice_ // ANCHORS_THREADS)
    smem = ANCHORS_HEADER_BYTES + 4 * (ANCHORS_THREADS // 32) * runs  # each warp's runs
    if smem > ANCHORS_MAX_SHARED:
        raise ValueError(f"sample_anchors: rows of {n} pixels need {smem} bytes of shared memory "
                         f"per block (at most {ANCHORS_MAX_SHARED})")
    return vec, slice_, smem


def sample_anchors(mask: torch.Tensor, a_j: torch.Tensor, u: torch.Tensor):
    """Position j draws u.shape[1] anchors with replacement from the set
    pixels of mask[a_j[j]]: r = floor(u * n) in f32, then the r-th set
    pixel (N - 1 when there is none).  mask (C, N) bool; a_j (C,) int32;
    u (C, Q) f32.  Returns (anchor_idx (C, Q) int32, n_anchor (C,) int32).

    On the card: one launch, a cluster of 8 blocks per position
    (`_anchors_plan`) that reads its row once and serves each draw from the
    block holding its pixel (see `kernels/csrc/contrastive.cu`)."""
    c, n = mask.shape
    if a_j.shape != (c,) or u.dim() != 2 or u.shape[0] != c:
        raise ValueError(f"sample_anchors: mask {tuple(mask.shape)}, a_j {tuple(a_j.shape)}, "
                         f"u {tuple(u.shape)}")
    if mask.device.type == "cpu":
        return sample_anchors_plain(mask, a_j, u)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(u, 2, "sample_anchors u")
    dev = u.device
    _require(mask, dev, torch.bool, "sample_anchors mask")
    _require(a_j, dev, torch.int32, "sample_anchors a_j")
    vec, slice_, smem = _anchors_plan(n, mask.data_ptr())
    from u2pl_tpu_torch.kernels import load

    lib = load()
    q = u.shape[1]
    idx = torch.empty((c, q), dtype=torch.int32, device=dev)
    count = torch.empty((c,), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_sample_anchors", "sample_anchors", dev,
            mask.data_ptr(), a_j.data_ptr(), u.data_ptr(), idx.data_ptr(), count.data_ptr(),
            c, n, q, vec, slice_, smem)
    sample_anchors.launches += 1
    return idx, count


sample_anchors.launches = 0


# ---- the InfoNCE tail (K6: contra_infonce) ---------------------------------

class _AnchorRows(torch.autograd.Function):
    """`rep_f[idx].astype(f32)` of a bf16 NCHW rep with JAX's VJP: each
    (C, Q) row's f32 cotangent rounded to bf16 (the astype), then the
    gather's scatter-add into a bf16 zero map, the rows added in their
    (C, Q) order, each add rounded to bf16 (XLA's scatter-add on the CPU,
    tests/test_torch_bf16.py)."""

    @staticmethod
    def forward(ctx, rep, idx):
        ctx.save_for_backward(idx)
        ctx.rep_shape, ctx.rep_dtype = tuple(rep.shape), rep.dtype
        return gather_rows(rep, idx).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, f, h, w = ctx.rep_shape
        rows = g.reshape(-1, f).to(ctx.rep_dtype)
        flat = idx.reshape(-1).long()
        # each update's rank among the earlier updates of its pixel: the
        # updates of one rank hit distinct pixels, so rank by rank the adds
        # run in the scatter's order
        order = torch.argsort(flat, stable=True)
        ranked = flat[order]
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.numel(), device=flat.device) - torch.searchsorted(
            ranked, ranked)
        out = torch.zeros((b * h * w, f), dtype=ctx.rep_dtype, device=g.device)
        for k in range(int(rank.max()) + 1 if flat.numel() else 0):
            sel = rank == k
            at = flat[sel]
            out[at] = (out[at].float() + rows[sel].float()).to(ctx.rep_dtype)
        return out.view(b, h, w, f).permute(0, 3, 1, 2).contiguous(), None


def anchor_rows(rep: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The f32 anchor rows rep_f[idx] of an NCHW rep, (*idx.shape, F),
    differentiable in `rep` as JAX's gather and astype are (a float64 rep:
    its float64 rows)."""
    if rep.dtype != torch.bfloat16:
        return gather_rows(rep, idx)
    return _AnchorRows.apply(rep, idx)


def contra_infonce_plain(
    rep: torch.Tensor,
    anchor_idx: torch.Tensor,
    positive: torch.Tensor,
    bank: MemoryBank,
    b_j: torch.Tensor,
    u_neg: torch.Tensor,
    active: torch.Tensor,
    valid_seg: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """Plain PyTorch version of `contra_infonce`: the JAX function
    (contrastive.py:283-378): gather, sample, normalize, dot, log-softmax
    (the f32 path), or with a bf16 rep and a bf16 bank its dot-first path;
    differentiated by autograd (`anchor_rows`).  Materialises
    (C, Q, 1 + M, F) f32.  A float64 rep takes the f32 path's arithmetic in
    float64 (the bank's keys widened exactly): a reference without the f32
    roundings of either route, which chip_smoke.py holds K6 against."""
    c, q = anchor_idx.shape
    f = rep.shape[1]
    anchor = anchor_rows(rep, anchor_idx)  # (C, Q, F) f32
    negs = sample(bank, u_neg, dtype=None)[0][b_j.long()]  # the bank of class b_j
    negs = negs.to(anchor.dtype).reshape(c, q, -1, f)
    pos = positive.to(anchor.dtype).reshape(c, -1, 1, f).expand(c, q, 1, f)
    norm = torch.linalg.vector_norm
    if rep.dtype == torch.bfloat16 and bank.keys.dtype == torch.bfloat16:
        # dot-first: bf16 products, exact in f32, summed in f32; the norms
        # apart (contrastive.py:325-360)
        a_norm = torch.clamp(norm(anchor, dim=-1, keepdim=True), min=EPS)
        # the anchor's cast to bf16 (exact here): its VJP rounds the
        # negatives' part of the anchor gradient to bf16
        dot_neg = torch.einsum("cqf,cqkf->cqk", anchor.to(torch.bfloat16).float(), negs)
        neg_norm = torch.clamp(torch.sqrt(torch.einsum("cqkf,cqkf->cqk", negs, negs)), min=EPS)
        dot_pos = torch.einsum("cqf,cqkf->cqk", anchor, pos)
        pos_norm = torch.clamp(norm(pos, dim=-1), min=EPS)
        logits = torch.cat([dot_pos / pos_norm, dot_neg / neg_norm], dim=-1) / a_norm / temperature
    else:
        all_feat = torch.cat([pos, negs], dim=2)
        a_n = anchor / torch.clamp(norm(anchor, dim=-1, keepdim=True), min=EPS)
        f_n = all_feat / torch.clamp(norm(all_feat, dim=-1, keepdim=True), min=EPS)
        logits = torch.einsum("cqf,cqkf->cqk", a_n, f_n) / temperature
    ce = -torch.log_softmax(logits, dim=-1)[..., 0].mean(dim=-1)  # (C,)
    vs = valid_seg.to(torch.float32)
    loss = torch.where(active, ce, torch.zeros_like(ce)).sum() / torch.clamp(vs, min=1.0)
    return torch.where(valid_seg > 1, loss, torch.zeros_like(loss))


def contra_infonce(
    rep: torch.Tensor,
    anchor_idx: torch.Tensor,
    positive: torch.Tensor,
    bank: MemoryBank,
    b_j: torch.Tensor,
    u_neg: torch.Tensor,
    active: torch.Tensor,
    valid_seg: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """The InfoNCE loss of the anchors: per position j and draw q, the anchor
    row rep[anchor_idx[j, q]] (NCHW, f32 or bf16) against the positive
    `positive[j]` ((C, F)), or `positive[j, q]` ((C, Q, F): the anchor_ema
    blend, one positive per draw; no gradient flows to it either way) and
    M = u_neg.shape[1] / Q bank keys of class b_j, rows
    floor(u_neg[b_j, q*M + m] * max(occ, 1)); cosines (eps 1e-8) over
    `temperature`, CE to the positive, the mean over q, summed over the
    `active` positions and divided by max(valid_seg, 1); 0 when
    valid_seg <= 1.  A 0-d device tensor, differentiable in `rep`.

    On the card, kernel K6: one warp per anchor gathers its 1 + M rows
    (each bank row one 16-byte load per lane, `_infonce_group` rows issued
    at a time), never writing the sample; an online softmax gives the CE
    and the anchor's gradient direction in one pass.  The loss is a
    fixed-order sum by the launch's last block, read by nobody on the
    host.  The backward sums each pixel's draws' stored directions in a
    fixed order, scales them once and writes the whole rep gradient in one
    pass, zero off the anchors (no float atomics, no zero fill first);
    C * Q is at most MAX_DRAWS on the card."""
    c, q = anchor_idx.shape
    if (positive.shape not in ((c, rep.shape[1]), (c, q, rep.shape[1])) or b_j.shape != (c,)
            or active.shape != (c,)
            or u_neg.dim() != 2 or u_neg.shape[0] != c or u_neg.shape[1] % q):
        raise ValueError(
            f"contra_infonce: rep {tuple(rep.shape)}, anchor_idx {tuple(anchor_idx.shape)}, "
            f"positive {tuple(positive.shape)}, u_neg {tuple(u_neg.shape)}"
        )
    if rep.device.type == "cpu":
        return contra_infonce_plain(rep, anchor_idx, positive, bank, b_j, u_neg, active,
                                    valid_seg, temperature)
    return _ContraInfoNCE.apply(rep, anchor_idx, positive, bank.keys, bank.occupancy, b_j,
                                u_neg, active, valid_seg, float(temperature))


class _ContraInfoNCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rep, anchor_idx, positive, keys, occupancy, b_j, u_neg, active,
                valid_seg, temperature):
        from u2pl_tpu_torch.ops.resize import F32_BF16, _check_cuda

        _check_cuda(rep, 4, "contra_infonce rep", F32_BF16)
        _check_cuda(positive, positive.dim(), "contra_infonce positive")
        _check_cuda(u_neg, 2, "contra_infonce u_neg")
        dev = rep.device
        for name, t, dt in (("anchor_idx", anchor_idx, torch.int32), ("occupancy", occupancy, torch.int32),
                            ("b_j", b_j, torch.int32), ("active", active, torch.bool),
                            ("valid_seg", valid_seg, torch.int32)):
            _require(t, dev, dt, f"contra_infonce {name}")
        b, f, h, w = rep.shape
        c, q = anchor_idx.shape
        cap = keys.shape[1]
        if f != FEAT_DIM or keys.shape != (c, cap, f) or valid_seg.numel() != 1:
            raise ValueError(f"contra_infonce: F must be {FEAT_DIM}; bank {tuple(keys.shape)}")
        _check_draws(c, q)
        if keys.device != dev or not keys.is_contiguous():
            raise ValueError("contra_infonce: the bank must be contiguous on the rep's device")
        dtype_code = BANK_DTYPE_CODES.get(keys.dtype)
        if dtype_code is None:
            raise TypeError(f"contra_infonce: bank dtype {keys.dtype} (float32 or bfloat16)")
        if rep.numel() >= 2**31 or keys.numel() >= 2**31:
            raise ValueError("contra_infonce: the rep or the bank exceeds the int32 sizes")
        from u2pl_tpu_torch.kernels import TICKET_INFONCE_FWD, load, tickets

        lib = load()
        m = u_neg.shape[1] // q
        # a (C, Q, F) positive: the kernel's per-draw instance (Q > 1; at
        # Q = 1 the two are one layout)
        per_query = positive.dim() == 3 and q > 1
        ce = torch.empty((c, q), dtype=torch.float32, device=dev)
        # a bf16 rep on a bf16 bank: the negatives' part of each direction
        # apart, at gdir[1] (infonce.cu: kSplit)
        split = rep.dtype == keys.dtype == torch.bfloat16
        gdir = torch.empty((2, c, q, f) if split else (c, q, f), dtype=torch.float32, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        ticket = tickets(dev)[TICKET_INFONCE_FWD]
        _launch(lib, "u2pl_contra_infonce_fwd", "contra_infonce_fwd", dev,
                rep.data_ptr(), anchor_idx.data_ptr(), positive.data_ptr(), keys.data_ptr(),
                occupancy.data_ptr(), b_j.data_ptr(), u_neg.data_ptr(), active.data_ptr(),
                valid_seg.data_ptr(), ce.data_ptr(), gdir.data_ptr(), loss.data_ptr(),
                ticket.data_ptr(), b, f, h * w, c, q, m, cap, dtype_code,
                BANK_DTYPE_CODES[rep.dtype], _infonce_group(keys.dtype),
                q if per_query else 1, float(temperature))
        contra_infonce.fwd_launches += 1
        if per_query:
            contra_infonce.fwd_pq_launches += 1
        ctx.save_for_backward(anchor_idx, active, valid_seg, gdir)
        ctx.rep_shape, ctx.rep_dtype = tuple(rep.shape), rep.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        anchor_idx, active, valid_seg, gdir = ctx.saved_tensors
        grad_rep = _infonce_bwd_cuda(anchor_idx, active, valid_seg, gdir, g, ctx.rep_shape,
                                     ctx.rep_dtype)
        return grad_rep, None, None, None, None, None, None, None, None, None


INFONCE_ROW_REGS = 32  # registers a lane of K6 fwd spends on the bank rows in flight


def _infonce_group(dtype: torch.dtype) -> int:
    """K6 fwd's bank rows per group: a warp has two groups in flight (one
    being reduced, the next loading), which must fit INFONCE_ROW_REGS
    registers a lane (a lane's 8 features of a row: 4 registers in bf16, 8
    in f32): 4 rows in bf16, 2 in f32.  The kernel takes each dtype at
    this size only (a template instance each); a group divides the 32 keys
    whose rows the lanes compute at once."""
    regs = {torch.bfloat16: 4, torch.float32: 8}[dtype]
    return INFONCE_ROW_REGS // (2 * regs)


def _check_draws(c: int, q: int) -> None:
    if c * q > MAX_DRAWS:
        raise ValueError(
            f"contra_infonce: {c} positions x {q} queries = {c * q} draws exceed the "
            f"backward kernel's {MAX_DRAWS}"
        )


INFONCE_MAX_TILE = 1020  # K6 bwd's pixels a tile (kernels/csrc/infonce.cu: kMaxTile)
INFONCE_BWD_BLOCKS_PER_SM = 2


def _infonce_bwd_tile(pixels: int, sms: int) -> int:
    """K6 bwd's tile: the pixels of one image a block writes, all 256
    planes.  About INFONCE_BWD_BLOCKS_PER_SM blocks on each of `sms` SMs
    over the `pixels` = B * h * w of the rep (an even grid keeps the write
    stream balanced), a multiple of 4, at most INFONCE_MAX_TILE."""
    tile = -(-pixels // (INFONCE_BWD_BLOCKS_PER_SM * sms))
    return min(INFONCE_MAX_TILE, max(4, (tile + 3) & ~3))


def _infonce_bwd_cuda(anchor_idx, active, valid_seg, gdir, g, rep_shape,
                      rep_dtype=torch.float32) -> torch.Tensor:
    """K6's backward on the card: the (B, F, h, w) gradient of the rep, in
    its dtype (f32 or bf16, module docstring), from the forward's stored
    directions `gdir` (C, Q, F), or (2, C, Q, F) with the negatives' parts
    apart (a bf16 rep on a bf16 bank), and the loss's output gradient `g`;
    the kernel writes every element (torch.empty, no zero fill)."""
    b, f, h, w = rep_shape
    c, q = anchor_idx.shape
    _check_draws(c, q)
    dev = gdir.device
    from u2pl_tpu_torch.kernels import load
    from u2pl_tpu_torch.ops.resize import _sm_count

    lib = load()
    g = g.to(torch.float32).contiguous()
    # per-pixel sums past the kernel's shared memory
    sums = torch.empty((c * q, f), dtype=torch.float32, device=dev)
    grad_rep = torch.empty((b, f, h, w), dtype=rep_dtype, device=dev)
    _launch(lib, "u2pl_contra_infonce_bwd", "contra_infonce_bwd", dev,
            anchor_idx.data_ptr(), active.data_ptr(), valid_seg.data_ptr(), gdir.data_ptr(),
            g.data_ptr(), sums.data_ptr(), grad_rep.data_ptr(), b, f, h * w, c, q,
            _infonce_bwd_tile(b * h * w, _sm_count(dev)), BANK_DTYPE_CODES[rep_dtype],
            int(gdir.dim() == 4))
    contra_infonce.bwd_launches += 1
    return grad_rep


contra_infonce.fwd_launches = 0  # every forward launch, either positive
contra_infonce.fwd_pq_launches = 0  # those with a (C, Q, F) positive (anchor_ema)
contra_infonce.bwd_launches = 0


# ---- the loss ---------------------------------------------------------------

def valid_classes_first(class_valid: torch.Tensor) -> torch.Tensor:
    """`argsort(~class_valid)` (stable): the valid classes in ascending
    order, then the others; as a rank scatter, (C,) int32."""
    v = class_valid.to(torch.int32)
    n_valid = v.sum()
    rank = torch.where(class_valid, torch.cumsum(v, 0) - 1, n_valid + torch.cumsum(1 - v, 0) - 1)
    order = torch.empty_like(v)
    order[rank] = torch.arange(v.shape[0], dtype=torch.int32, device=v.device)
    return order


def compute_contra_memobank_loss(
    rep: torch.Tensor,
    label_l: torch.Tensor,
    label_u: torch.Tensor,
    prob_l: torch.Tensor,
    prob_u: torch.Tensor,
    low_mask: torch.Tensor,
    high_mask: torch.Tensor,
    cfg: ContrastiveCfg,
    bank: MemoryBank,
    rep_teacher: torch.Tensor,
    draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    ignore_label: int = 255,
    strict_reference: bool = True,
    return_info: bool = False,
    group=None,
    prototype: Optional[torch.Tensor] = None,
    i_iter=0,
):
    """The JAX `compute_contra_memobank_loss` (contrastive.py:168-398): with
    `group` None, `axis_name=None` on one device; with a `dist.Group`, under
    the data axis: every rank's (C, K, F) key slab and (C,) counts are
    all-gathered (:259-273) and written in rank order into every rank's
    bank, and the loss's value is the ranks' mean while its gradient is
    d(local / W) (:380-392, the reference's in-place all_reduce).  rep (B,
    F, h, w) the student's representation (gradients flow); label_l /
    label_u (B_l / B_u, h, w)
    int32 small labels with `ignore_label` (one-hot inside); prob_l / prob_u
    (B_*, C, h, w) the teacher's softmax; low_mask / high_mask (B, h, w)
    bool; rep_teacher (B, F, h, w) (no gradient); draws as the module
    docstring says.

    `prototype` (C, Q, 1, F) float32, the state's momentum prototype, when
    the step runs `contrastive.anchor_ema` (JAX passes it then, steps.py:477),
    and `i_iter` the global step (an int or a 0-d device tensor): each
    position's positive blends with its bank class's prototype slot
    (:303-321, `_anchor_ema`) and K6 takes one positive per draw.

    Returns (bank, loss), or (new_prototype, bank, loss) with a `prototype`;
    with `return_info`, an info dict {"neg_candidates": (C,) int32} after
    them.  The bank is updated in place; the new prototype is a new tensor."""
    num_labeled = label_l.shape[0]
    c = prob_l.shape[1]
    pri, u_anchor, u_neg = draws
    prob = torch.cat([prob_l, prob_u]).detach().to(torch.float32).contiguous()
    labels = torch.cat([label_l, label_u]).to(torch.int32).contiguous()
    low = low_mask.to(torch.bool).contiguous()
    high = high_mask.to(torch.bool).contiguous()
    rep_teacher = rep_teacher.detach()

    anchor_mask, negative_mask, low_valid, counts = contra_pixel_masks(
        prob, labels, low, high, num_labeled, cfg, ignore_label
    )
    n_low_valid, neg_candidates = counts[0], counts[1]
    class_valid = n_low_valid > 0
    valid_seg = class_valid.sum().to(torch.int32)

    # class prototypes: the low-valid masked mean of the teacher's rep
    # (contrastive.py:243-247), a (C, N) x (N, F) product per image
    b, f, h, w = rep_teacher.shape
    lv = low_valid.view(c, b, h * w).transpose(0, 1)  # (B, C, hw)
    proto = torch.bmm(lv, rep_teacher.view(b, f, h * w).transpose(1, 2).to(torch.float32)).sum(0)
    proto = proto / torch.clamp(n_low_valid[:, None].to(torch.float32), min=1.0)

    # enqueue this step's negative keys, then sample the bank (:250-292)
    select = select_keys_radix if cfg.select_keys == "radix" else select_keys
    sel_idx, n_sel = select(negative_mask, pri, cfg.max_keys_per_class_per_step)
    if group is None:
        memobank_enqueue(bank, rep_teacher, sel_idx, n_sel)
    else:
        slab = memobank_gather(rep_teacher, sel_idx, n_sel)
        memobank_enqueue_slabs(bank, dist.all_gather(slab, group), dist.all_gather(n_sel, group))

    b_j = valid_classes_first(class_valid)
    a_j = torch.arange(c, dtype=torch.int32, device=b_j.device) if strict_reference else b_j
    anchor_idx, n_anchor = sample_anchors(anchor_mask, a_j, u_anchor)
    positive = proto[a_j.long()].contiguous()
    active = (
        (torch.arange(c, device=b_j.device) < valid_seg)
        & (n_anchor > 0)
        & (bank.occupancy[b_j.long()] > 0)
    )
    if prototype is not None:
        positive, new_prototype = _anchor_ema(positive, prototype, b_j, active, i_iter)
    loss = contra_infonce(rep, anchor_idx, positive, bank, b_j, u_neg, active, valid_seg,
                          cfg.temperature)
    if group is not None:
        # value: the ranks' mean; gradient: d(local / W), as torch's
        # untracked in-place all_reduce gives it (contrastive.py:380-392)
        local = loss / float(group.size)
        loss = local - local.detach() + dist.all_mean(loss.detach(), group)
    out = (bank, loss) if prototype is None else (new_prototype, bank, loss)
    if return_info:
        out = out + ({"neg_candidates": neg_candidates},)
    return out


def _anchor_ema(positive: torch.Tensor, prototype: torch.Tensor, b_j: torch.Tensor,
                active: torch.Tensor, i_iter) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchor_ema blend (contrastive.py:303-321, reference
    loss_helper.py:209-218): position j's positive, broadcast to its Q draws,
    blended with the momentum prototype of its BANK class b_j (not of its
    anchor class a_j), (1 - d) * positive + d * prototype[b_j] in float32
    (two products, then the sum, as JAX), with d = min(1 - 1 / max(i_iter,
    1), 0.999) on the device; no blend while the whole prototype is zero.
    Returns (the (C, Q, F) positive, the new (C, Q, 1, F) prototype: zeros
    but at the active positions' slots b_j, which take the blend)."""
    c, q, _, f = prototype.shape
    pos = positive[:, None, :].expand(c, q, f)
    it = torch.as_tensor(i_iter, device=prototype.device).to(torch.float32)
    decay = torch.minimum(1.0 - 1.0 / torch.clamp(it, min=1.0), torch.full_like(it, 0.999))
    momentum = prototype[b_j.long()].reshape(c, q, f)
    blended = torch.where(prototype.ne(0).any(), (1.0 - decay) * pos + decay * momentum, pos)
    new_prototype = torch.zeros_like(prototype)
    # b_j is a permutation of the classes: every slot is written once
    new_prototype[b_j.long()] = torch.where(
        active[:, None, None], blended, torch.zeros_like(blended)).reshape(c, q, 1, f)
    return blended.contiguous(), new_prototype
