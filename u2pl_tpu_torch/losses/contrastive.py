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
                       stable descending ranks over C fused with the anchor,
                       negative and low-valid masks and their counts;
  select_keys          K4: per class the k smallest (priority, pixel) pairs
                       of the negative mask, in ascending order;
  select_keys_radix    K4r: per class the masked pixels whose u32 key is at
                       or under the k-th smallest, the first k in pixel
                       order (`select_keys: radix`);
  sample_anchors       K4: per position the with-replacement anchor draws
                       mapped to set pixels of the anchor mask;
  memobank_enqueue     K5 (`memobank.py`, `kernels/csrc/memobank.cu`);
  contra_infonce       K6 (`kernels/csrc/infonce.cu`): the bank sample, the
                       cosines, the log-softmax CE to the positive and the
                       masked mean, forward and backward.
Each wrapper takes its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor, or raises; `<wrapper>.launches` counts the
launches.  The prototype masked mean stays a matmul (`torch.bmm`), as JAX
leaves it to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from u2pl_tpu_torch.config import ContrastiveCfg
from u2pl_tpu_torch.memobank import MemoryBank, gather_rows, memobank_enqueue, sample
from u2pl_tpu_torch.ops.one_hot import label_onehot

MAX_CLASSES = 32  # contra_pixel_masks keeps one pixel's C probabilities in registers
MAX_KEYS = 16384  # select_keys sorts <= 16384 (priority, pixel) pairs in shared memory
FEAT_DIM = 256  # contra_infonce: one warp per anchor, 8 features per lane
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
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(prob, 4, "contra_pixel_masks")
    dev = prob.device
    _require(labels, dev, torch.int32, "contra_pixel_masks labels")
    _require(low_mask, dev, torch.bool, "contra_pixel_masks low_mask")
    _require(high_mask, dev, torch.bool, "contra_pixel_masks high_mask")
    if c > MAX_CLASSES:
        raise ValueError(f"contra_pixel_masks: {c} classes (at most {MAX_CLASSES})")
    from u2pl_tpu_torch.kernels import load

    lib = load()
    n = b * h * w
    anchor = torch.empty((c, n), dtype=torch.bool, device=dev)
    negative = torch.empty((c, n), dtype=torch.bool, device=dev)
    low_valid = torch.empty((c, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((2, c), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_pixel_masks", "contra_pixel_masks", dev,
            prob.data_ptr(), labels.data_ptr(), low_mask.data_ptr(), high_mask.data_ptr(),
            anchor.data_ptr(), negative.data_ptr(), low_valid.data_ptr(), counts.data_ptr(),
            b, num_labeled, c, h * w, int(ignore_label), float(cfg.current_class_threshold),
            float(cfg.current_class_negative_threshold), int(cfg.low_rank), int(cfg.high_rank))
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


def select_keys(mask: torch.Tensor, pri: torch.Tensor, k: int):
    """Per class c, the indices of the min(k, #mask[c]) pixels of mask[c]
    with the smallest (pri[c, n], n), in ascending order: JAX's
    `_select_keys_argsort` on the same priorities.  mask (C, N) bool; pri
    (C, N) f32.  Returns (sel_idx (C, k) int32, n_sel (C,) int32); only the
    first n_sel[c] entries of row c are keys.

    On the card (k <= 16384): a radix selection of the k-th smallest 64-bit
    key (priority order bits, pixel) per class, a compaction of the keys at
    or under it, and a shared-memory sort of the <= k survivors."""
    c, n = mask.shape
    if pri.shape != (c, n) or k <= 0:
        raise ValueError(f"select_keys: mask {tuple(mask.shape)}, pri {tuple(pri.shape)}, k {k}")
    if mask.device.type == "cpu":
        return select_keys_plain(mask, pri, k)
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(pri, 2, "select_keys pri")
    dev = pri.device
    _require(mask, dev, torch.bool, "select_keys mask")
    if k > MAX_KEYS:
        raise ValueError(f"select_keys: k {k} > {MAX_KEYS} (max_keys_per_class_per_step)")
    from u2pl_tpu_torch.kernels import load

    lib = load()
    sel_idx = torch.empty((c, k), dtype=torch.int32, device=dev)
    n_sel = torch.empty((c,), dtype=torch.int32, device=dev)
    state = torch.zeros(lib.u2pl_select_keys_state_words(c, k), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_select_keys", "select_keys", dev,
            mask.data_ptr(), pri.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(),
            state.data_ptr(), c, n, k)
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


def select_keys_radix(mask: torch.Tensor, keys: torch.Tensor, k: int):
    """Per class c, with kk = min(k, N) and cnt = #mask[c]: when cnt > kk
    the masked pixels whose u32 key (keys[c, n], unsigned) is at or under
    the kk-th smallest masked key, else all masked pixels; of those the first
    k in pixel order, padded with N - 1.  JAX's `_select_keys_radix` on the
    same keys.  mask (C, N) bool; keys (C, N) int32 holding u32 bits (or
    int64 in [0, 2^32)).  Returns (sel_idx (C, k) int32, n_sel (C,) int32
    = min(cnt, k)); only the first n_sel[c] entries of row c are keys.

    On the card, kernel K4r: a 32-bit radix select of the threshold (four
    8-bit histogram levels per class), then one block per class compacts
    its row in pixel order."""
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
    from u2pl_tpu_torch.kernels import load

    lib = load()
    sel_idx = torch.empty((c, k), dtype=torch.int32, device=dev)
    n_sel = torch.empty((c,), dtype=torch.int32, device=dev)
    state = torch.zeros(lib.u2pl_select_keys_radix_state_words(c), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_select_keys_radix", "select_keys_radix", dev,
            mask.data_ptr(), keys.data_ptr(), sel_idx.data_ptr(), n_sel.data_ptr(),
            state.data_ptr(), c, n, k)
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


def sample_anchors(mask: torch.Tensor, a_j: torch.Tensor, u: torch.Tensor):
    """Position j draws u.shape[1] anchors with replacement from the set
    pixels of mask[a_j[j]]: r = floor(u * n) in f32, then the r-th set
    pixel (N - 1 when there is none).  mask (C, N) bool; a_j (C,) int32;
    u (C, Q) f32.  Returns (anchor_idx (C, Q) int32, n_anchor (C,) int32).

    On the card: one block per position counts the row, then scans it once,
    chunk by chunk, compacting the set pixels of each chunk into shared
    memory where the draws that fall in the chunk read their pixel."""
    c, n = mask.shape
    if a_j.shape != (c,) or u.dim() != 2 or u.shape[0] != c:
        raise ValueError(f"sample_anchors: mask {tuple(mask.shape)}, a_j {tuple(a_j.shape)}, "
                         f"u {tuple(u.shape)}")
    if mask.device.type == "cpu":
        return sample_anchors_plain(mask, a_j, u)
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(u, 2, "sample_anchors u")
    dev = u.device
    _require(mask, dev, torch.bool, "sample_anchors mask")
    _require(a_j, dev, torch.int32, "sample_anchors a_j")
    from u2pl_tpu_torch.kernels import load

    lib = load()
    q = u.shape[1]
    idx = torch.empty((c, q), dtype=torch.int32, device=dev)
    count = torch.empty((c,), dtype=torch.int32, device=dev)
    _launch(lib, "u2pl_contra_sample_anchors", "sample_anchors", dev,
            mask.data_ptr(), a_j.data_ptr(), u.data_ptr(), idx.data_ptr(), count.data_ptr(),
            c, n, q)
    sample_anchors.launches += 1
    return idx, count


sample_anchors.launches = 0


# ---- the InfoNCE tail (K6: contra_infonce) ---------------------------------

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
    """Plain PyTorch version of `contra_infonce`: the JAX f32 path
    (contrastive.py:283-378): gather, sample, normalize, dot, log-softmax;
    differentiated by autograd.  Materialises (C, Q, 1 + M, F) f32."""
    c, q = anchor_idx.shape
    f = rep.shape[1]
    anchor = gather_rows(rep, anchor_idx).to(torch.float32)  # (C, Q, F)
    negs = sample(bank, u_neg, dtype=None)[0][b_j.long()]  # the bank of class b_j
    negs = negs.to(torch.float32).reshape(c, q, -1, f)
    pos = positive[:, None, None, :].expand(c, q, 1, f)
    all_feat = torch.cat([pos, negs], dim=2)
    a_n = anchor / torch.clamp(torch.linalg.vector_norm(anchor, dim=-1, keepdim=True), min=EPS)
    f_n = all_feat / torch.clamp(torch.linalg.vector_norm(all_feat, dim=-1, keepdim=True), min=EPS)
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
    row rep[anchor_idx[j, q]] (NCHW, f32) against the positive
    `positive[j]` and M = u_neg.shape[1] / Q bank keys of class b_j, rows
    floor(u_neg[b_j, q*M + m] * max(occ, 1)); cosines (eps 1e-8) over
    `temperature`, CE to the positive, the mean over q, summed over the
    `active` positions and divided by max(valid_seg, 1); 0 when
    valid_seg <= 1.  A 0-d device tensor, differentiable in `rep`.

    On the card, kernel K6: one warp per anchor gathers its 1 + M rows
    (each bank row one 16-byte load per lane), never writing the sample; an
    online softmax gives the CE and the anchor's gradient direction in one
    pass.  The loss is a fixed-order two-stage sum, read by nobody on the
    host.  The backward scales the stored directions and sums each pixel's
    duplicate draws in a fixed order into the rep gradient (no float
    atomics)."""
    c, q = anchor_idx.shape
    if (positive.shape != (c, rep.shape[1]) or b_j.shape != (c,) or active.shape != (c,)
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
        from u2pl_tpu_torch.ops.resize import _check_cuda_f32

        _check_cuda_f32(rep, 4, "contra_infonce rep")
        _check_cuda_f32(positive, 2, "contra_infonce positive")
        _check_cuda_f32(u_neg, 2, "contra_infonce u_neg")
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
        if keys.device != dev or not keys.is_contiguous():
            raise ValueError("contra_infonce: the bank must be contiguous on the rep's device")
        dtype_code = {torch.float32: 0, torch.bfloat16: 1}.get(keys.dtype)
        if dtype_code is None:
            raise TypeError(f"contra_infonce: bank dtype {keys.dtype} (float32 or bfloat16)")
        if rep.numel() >= 2**31 or keys.numel() >= 2**31:
            raise ValueError("contra_infonce: the rep or the bank exceeds the int32 sizes")
        from u2pl_tpu_torch.kernels import load

        lib = load()
        m = u_neg.shape[1] // q
        ce = torch.empty((c, q), dtype=torch.float32, device=dev)
        gdir = torch.empty((c, q, f), dtype=torch.float32, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        _launch(lib, "u2pl_contra_infonce_fwd", "contra_infonce_fwd", dev,
                rep.data_ptr(), anchor_idx.data_ptr(), positive.data_ptr(), keys.data_ptr(),
                occupancy.data_ptr(), b_j.data_ptr(), u_neg.data_ptr(), active.data_ptr(),
                valid_seg.data_ptr(), ce.data_ptr(), gdir.data_ptr(), loss.data_ptr(),
                b, f, h * w, c, q, m, cap, dtype_code, float(temperature))
        contra_infonce.fwd_launches += 1
        ctx.save_for_backward(anchor_idx, active, valid_seg, gdir)
        ctx.rep_shape = tuple(rep.shape)
        return loss

    @staticmethod
    def backward(ctx, g):
        anchor_idx, active, valid_seg, gdir = ctx.saved_tensors
        b, f, h, w = ctx.rep_shape
        c, q = anchor_idx.shape
        dev = gdir.device
        from u2pl_tpu_torch.kernels import load

        lib = load()
        g = g.to(torch.float32).contiguous()
        grad_rep = torch.zeros((b, f, h, w), dtype=torch.float32, device=dev)
        _launch(lib, "u2pl_contra_infonce_bwd", "contra_infonce_bwd", dev,
                anchor_idx.data_ptr(), active.data_ptr(), valid_seg.data_ptr(), gdir.data_ptr(),
                g.data_ptr(), grad_rep.data_ptr(), b, f, h * w, c, q)
        contra_infonce.bwd_launches += 1
        return grad_rep, None, None, None, None, None, None, None, None, None


contra_infonce.fwd_launches = 0
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
):
    """The JAX `compute_contra_memobank_loss` with `axis_name=None`
    (contrastive.py:168-398) on one device.  rep (B, F, h, w) the student's
    representation (gradients flow); label_l / label_u (B_l / B_u, h, w)
    int32 small labels with `ignore_label` (one-hot inside); prob_l / prob_u
    (B_*, C, h, w) the teacher's softmax; low_mask / high_mask (B, h, w)
    bool; rep_teacher (B, F, h, w) (no gradient); draws as the module
    docstring says.

    Returns (bank, loss) or, with `return_info`, (bank, loss, {"neg_candidates":
    (C,) int32}); the bank is updated in place.  `anchor_ema` is not ported."""
    if cfg.anchor_ema:
        raise NotImplementedError(
            "contrastive.anchor_ema: true is not ported yet (ROADMAP.md queue 1)"
        )
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
    memobank_enqueue(bank, rep_teacher, sel_idx, n_sel)

    b_j = valid_classes_first(class_valid)
    a_j = torch.arange(c, dtype=torch.int32, device=b_j.device) if strict_reference else b_j
    anchor_idx, n_anchor = sample_anchors(anchor_mask, a_j, u_anchor)
    positive = proto[a_j.long()].contiguous()
    active = (
        (torch.arange(c, device=b_j.device) < valid_seg)
        & (n_anchor > 0)
        & (bank.occupancy[b_j.long()] > 0)
    )
    loss = contra_infonce(rep, anchor_idx, positive, bank, b_j, u_neg, active, valid_seg,
                          cfg.temperature)
    if return_info:
        return bank, loss, {"neg_candidates": neg_candidates}
    return bank, loss
