"""The contrastive loss of the port against the JAX package, on the CPU.

The same numpy inputs and JAX's own random draws go through
`u2pl_tpu.losses.contrastive` and `u2pl_tpu_torch.losses.contrastive` (the
plain PyTorch versions of kernels K4-K6, which the CUDA kernels are held
against on the card in tests/test_torch_cuda.py).  The draws are replayed
from the key JAX's function is given: split(rng, 4) -> (_, kkey, akey,
nkey); the key-selection priorities of class c are uniform(split(kkey,
C)[c], (N,)) (under `select_keys: radix` its u32 keys bits(split(kkey,
C)[c], (N,), uint32), held as int32 bits), the anchor draws of position j
uniform(split(akey, C)[j], (Q,)), the bank draws uniform(nkey, (C, Q*M))
(contrastive.py:250-290).

Bounds: selections, anchor draws, masks, counts and the bank bit-equal;
the loss rtol 1e-5 and its gradient with respect to `rep` within 1e-5 of
the gradient's largest magnitude (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.losses import contrastive as jc
from u2pl_tpu.memobank import enqueue as jax_enqueue
from u2pl_tpu.memobank import init_memobank as jax_init_memobank
from u2pl_tpu.ops.one_hot import label_onehot as jax_onehot
from u2pl_tpu.ops.resize import resize_nearest as jax_resize_nearest
from test_torch_memobank import assert_equal
from test_torch_memobank import port as port_bank
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.losses import contrastive as tc
from u2pl_tpu_torch.ops.one_hot import label_onehot
from u2pl_tpu_torch.ops.resize import resize_nearest

C, F, H, W = 5, 256, 9, 9
B_L = B_U = 2
B = B_L + B_U
N = B * H * W


def contra_raw(**kw):
    return {
        "negative_high_entropy": True, "low_rank": 1, "high_rank": 3,
        "current_class_threshold": 0.3, "current_class_negative_threshold": 1,
        "low_entropy_threshold": 20, "num_negatives": 4, "num_queries": 8,
        "temperature": 0.5, "max_keys_per_class_per_step": 16, **kw,
    }


def cfgs(**kw):
    raw = {"trainer": {"contrastive": contra_raw(**kw)}}
    return jax_parse_config(raw).trainer.contrastive, parse_config(raw).trainer.contrastive


def jax_keys(keys, n):
    """The u32 keys `_select_keys_radix` draws from each key of `keys`, as
    int32 bits: bits(key, (n,), uint32) (contrastive.py:129)."""
    return np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32)) for k in keys]).view(np.int32)


def jax_draws(rng, num_queries, num_neg, c=C, n=N, select_keys="argsort"):
    """(pri, u_anchor, u_neg) as compute_contra_memobank_loss draws them
    from the key `rng` it is given, for c classes and n pixels; under
    `select_keys: radix`, pri holds class c's u32 keys."""
    _, kkey, akey, nkey = jax.random.split(rng, 4)
    if select_keys == "radix":
        pri = jax_keys(jax.random.split(kkey, c), n)
    else:
        pri = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(kkey, c)])
    u_a = np.stack([np.asarray(jax.random.uniform(k, (num_queries,)))
                    for k in jax.random.split(akey, c)])
    u_n = np.asarray(jax.random.uniform(nkey, (c, num_queries * num_neg)))
    return tuple(torch.from_numpy(np.array(a)) for a in (pri, u_a, u_n))


def inputs(seed, n_classes_present=C, high_frac=0.7):
    """NCHW numpy inputs: rep, rep_teacher, prob (softmax of peaked logits),
    small labels (~10% ignored), low / high masks."""
    rng = np.random.RandomState(seed)
    rep = rng.randn(B, F, H, W).astype(np.float32)
    rep_t = (rep + 0.3 * rng.randn(B, F, H, W)).astype(np.float32)
    logits = (2.5 * rng.randn(B, C, H, W)).astype(np.float32)
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, n_classes_present, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.1] = 255
    low = rng.rand(B, H, W) < 0.8
    high = rng.rand(B, H, W) < high_frac
    low[:B_L] = labels[:B_L] != 255
    high[:B_L] = labels[:B_L] != 255
    return rep, rep_t, prob, labels, low, high


def nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def banks(seed, fill=True, dtype=jnp.bfloat16):
    """A JAX bank pre-filled with seeded keys (wrapped once for class 1),
    and the port's copy of it."""
    bank = jax_init_memobank(C, F, queue_size=12, class0_size=20, dtype=dtype)
    if fill:
        rng = np.random.RandomState(seed)
        keys = rng.randn(C, 16, F).astype(np.float32)
        valid = np.arange(16)[None, :] < np.array([5, 16, 0, 3, 9])[:, None]
        bank = jax_enqueue(bank, jnp.asarray(keys), jnp.asarray(valid))
    return bank, port_bank(bank)


# ---- stock ops ---------------------------------------------------------------

@pytest.mark.parametrize("size", [(9, 9), (4, 7), (17, 13)])
def test_resize_nearest_and_onehot_match_jax(size):
    rng = np.random.RandomState(0)
    lab = rng.randint(0, C, (2, 33, 29)).astype(np.int32)
    lab[rng.rand(*lab.shape) < 0.1] = 255
    mask = rng.rand(2, 33, 29) < 0.5
    ref = jax_resize_nearest(jnp.asarray(lab), size)
    got = resize_nearest(torch.from_numpy(lab), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(mask), size).numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(mask), size)))
    np.testing.assert_array_equal(label_onehot(got, C).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_onehot(ref, C)))


# ---- K4 pieces -----------------------------------------------------------------

def test_ranks_desc_matches_jax_with_ties():
    rng = np.random.RandomState(1)
    p = rng.rand(500, C).astype(np.float32)
    p[::3, 1] = p[::3, 3]  # ties between classes
    p[::7] = 0.2  # all tied
    p[5, [0, 2, 4]] = 0.9
    ref = np.asarray(jc._ranks_desc(jnp.asarray(p)))
    got = tc.ranks_desc(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the compare-count is the stable descending sort's rank
    order = torch.sort(torch.from_numpy(p), dim=1, descending=True, stable=True).indices
    np.testing.assert_array_equal(torch.argsort(order, dim=1).numpy(), ref)


def jax_masks(prob, labels, low, high, cfg, num_labeled=B_L):
    """compute_contra_memobank_loss's masks and counts (contrastive.py:201-238),
    the JAX expressions on JAX's own ops, for NCHW numpy inputs."""
    b, c, h, w = prob.shape
    n = b * h * w
    onehot = jax_onehot(jnp.asarray(labels), c)
    low_valid = onehot * jnp.asarray(low, jnp.float32)[..., None]
    high_valid = onehot * jnp.asarray(high, jnp.float32)[..., None]
    p = nhwc(prob)
    ranks = jc._ranks_desc(p)
    pf, rf = p.reshape(n, c), ranks.reshape(n, c)
    lvf, hvf, ohf = (x.reshape(n, c) for x in (low_valid > 0, high_valid > 0, onehot))
    is_l = jnp.repeat(jnp.arange(b) < num_labeled, h * w)
    anchor = (pf > cfg.current_class_threshold) & lvf
    neg_high = (pf < cfg.current_class_negative_threshold) & hvf
    cm_u = (rf >= cfg.low_rank) & (rf < cfg.high_rank)
    cm_l = (rf < cfg.low_rank) & (ohf == 0)
    negative = neg_high & jnp.where(is_l[:, None], cm_l, cm_u)
    return [np.asarray(x) for x in (anchor.T, negative.T, lvf.T, lvf.sum(0), negative.sum(0))]


def label_rank_masks(prob, labels, low, high, num_labeled, cfg, ignore=255):
    """The masks and counts from each pixel's label class alone, as K4
    masks' kernel computes them (contrastive.cu:pixel_masks_kernel): a pixel
    with a label L in [0, C) other than `ignore` is low-valid at L where
    `low`, an anchor where also p[L] > delta_p, and, on an unlabeled image
    only, a negative where `high`, p[L] < delta_n and the stable descending
    rank of L (#{d: p_d > p_L} + #{d < L: p_d == p_L}) is in [low_rank,
    high_rank); every other entry is 0.  NCHW numpy in, (C, N) out."""
    b, c, h, w = prob.shape
    n = b * h * w
    p = np.moveaxis(prob, 1, 0).reshape(c, n)
    lab, lo, hi = labels.reshape(n), low.reshape(n), high.reshape(n)
    valid = (lab >= 0) & (lab < c) & (lab != ignore)
    cls = np.where(valid, lab, 0)
    pl = p[cls, np.arange(n)]
    d = np.arange(c)[:, None]
    rank = ((p > pl) | ((d < cls) & (p == pl))).sum(0)
    unlabeled = np.repeat(np.arange(b) >= num_labeled, h * w)
    lv = valid & lo
    anc = lv & (pl > cfg.current_class_threshold)
    neg = (valid & hi & unlabeled & (pl < cfg.current_class_negative_threshold)
           & (rank >= cfg.low_rank) & (rank < cfg.high_rank))
    at = d == cls
    anchor, negative, low_valid = at & anc, at & neg, at & lv
    return [anchor, negative, low_valid, low_valid.sum(1), negative.sum(1)]


@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_masks_exact(seed):
    jcfg, cfg = cfgs()
    _, _, prob, labels, low, high = inputs(seed)
    prob[0, :, 0, :3] = 0.2  # tied probabilities
    ref = jax_masks(prob, labels, low, high, jcfg)
    anchor, negative, low_valid, counts = tc.contra_pixel_masks(
        torch.from_numpy(prob), torch.from_numpy(labels), torch.from_numpy(low),
        torch.from_numpy(high), B_L, cfg)
    got = [anchor, negative, low_valid > 0, counts[0], counts[1]]
    for name, g, r in zip(("anchor", "negative", "low_valid", "n_low_valid", "neg_cand"), got, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert ref[1].any() and ref[0].any() and not ref[1][:, : B_L * H * W].any()



def _mask_case(seed, c, b=3, h=5, w=7):
    """Seeded NCHW inputs for the mask cases: a softmax with ties at the
    label class (half the pixels' label class tied with a lower class, some
    pixels all tied), labels in [0, C), in [C, 255) and 255, low / high
    masks."""
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(b, c, h, w)).astype(np.float32)
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, c, (b, h, w)).astype(np.int32)
    bb, yy, xx = np.nonzero(rng.rand(b, h, w) < 0.5)
    lab = labels[bb, yy, xx]
    lower = np.where(lab > 0, lab - 1, np.minimum(lab + 1, c - 1))
    prob[bb, lab, yy, xx] = prob[bb, lower, yy, xx]  # ties at the label class
    prob[:, :, 0, :2] = np.float32(1.0 / c)  # every class tied
    labels[rng.rand(b, h, w) < 0.1] = 255
    labels[rng.rand(b, h, w) < 0.1] = c + 7  # in [C, 255): no class
    labels[0, 0, 0] = c
    low = rng.rand(b, h, w) < 0.7
    high = rng.rand(b, h, w) < 0.7
    return prob, labels, low, high


# (C, num_labeled of 3 images, low_rank, high_rank, delta_n)
MASK_CASES = [
    (5, 1, 1, 3, 1.0),
    (5, 0, 0, 5, 1.0),  # no labeled image; ranks at 0 and at C
    (5, 3, 1, 3, 1.0),  # every image labeled: no negatives
    (1, 1, 0, 1, 2.0),  # one class: rank 0 and p = 1 everywhere
    (1, 0, 1, 2, 1.0),  # low_rank above the only rank
    (32, 1, 3, 20, 0.3),
    (32, 2, 0, 32, 1.0),
    (21, 1, 21, 40, 1.0),  # ranks at and above C: no negatives
    (19, 0, 3, 19, 0.05),
]


@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_pixel_masks_from_the_label_class_rank_alone(case):
    """The premise of K4 masks' kernel: the label class's rank alone gives
    every mask and count.  label_rank_masks (the kernel's algebra) against
    contra_pixel_masks_plain (the all-class ranks) and the JAX masks, with
    ties at the label class, labels in [C, 255) and 255, no and every image
    labeled, C 1 and 32, low_rank / high_rank at 0, at C and above C."""
    c, num_labeled, low_rank, high_rank, delta_n = MASK_CASES[case]
    jcfg, cfg = cfgs(low_rank=low_rank, high_rank=high_rank, current_class_threshold=0.2,
                     current_class_negative_threshold=delta_n)
    prob, labels, low, high = _mask_case(case, c)
    ref = jax_masks(prob, labels, low, high, jcfg, num_labeled)
    mine = label_rank_masks(prob, labels, low, high, num_labeled, cfg)
    anchor, negative, low_valid, counts = tc.contra_pixel_masks_plain(
        torch.from_numpy(prob), torch.from_numpy(labels), torch.from_numpy(low),
        torch.from_numpy(high), num_labeled, cfg)
    plain = [anchor.numpy(), negative.numpy(), low_valid.numpy() > 0, counts[0].numpy(),
             counts[1].numpy()]
    assert low_valid.dtype == torch.float32 and set(np.unique(low_valid.numpy())) <= {0.0, 1.0}
    for name, m, p, r in zip(("anchor", "negative", "low_valid", "n_low_valid", "neg_cand"),
                             mine, plain, ref):
        np.testing.assert_array_equal(m, r, err_msg=name)
        np.testing.assert_array_equal(p, r, err_msg=name)
    assert ref[2].any() and ref[0].any()
    any_neg = num_labeled < 3 and low_rank < min(high_rank, c)
    assert ref[4].any() == any_neg, ref[4]


def _select_cases():
    rng = np.random.RandomState(2)
    few = rng.rand(C, 200) < 0.03  # under the cap
    many = rng.rand(C, 200) < 0.6  # over the cap
    ties = np.floor(rng.rand(C, 200) * 4).astype(np.float32) / 4  # tied priorities
    return [("under the cap", few, None), ("over the cap", many, None),
            ("tied priorities", many, ties), ("empty class", many & (np.arange(C) != 2)[:, None], None)]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("k", [16, 300])
def test_select_keys_bit_equal_to_argsort(case, k):
    name, mask, pri = _select_cases()[case]
    keys = jax.random.split(jax.random.PRNGKey(case), C)
    if pri is None:
        pri = np.stack([np.asarray(jax.random.uniform(kk, (mask.shape[1],))) for kk in keys])
    ref_idx, ref_valid = [], []
    with pytest.MonkeyPatch.context() as mp:
        for c in range(C):  # JAX draws its own priorities: hand it these
            mp.setattr(jax.random, "uniform", lambda key, shape, _p=pri[c]: jnp.asarray(_p))
            i, v = jc._select_keys_argsort(jnp.asarray(mask[c]), keys[c], k)
            ref_idx.append(np.asarray(i))
            ref_valid.append(np.asarray(v))
    idx, n_sel = tc.select_keys(torch.from_numpy(mask), torch.from_numpy(pri), k)
    assert idx.shape == (C, k) and idx.dtype == torch.int32
    for c in range(C):
        n = int(ref_valid[c].sum())
        assert int(n_sel[c]) == n == min(int(mask[c].sum()), k), (name, c)
        np.testing.assert_array_equal(idx[c, :n].numpy(), ref_idx[c][:n], err_msg=f"{name} {c}")


def _radix_cases(n=300):
    """(name, mask (C, n), keys (C, n) int32 bits or None for JAX's own)."""
    rng = np.random.RandomState(5)
    many = rng.rand(C, n) < 0.6
    few = rng.rand(C, n) < 0.03
    ties = (rng.randint(0, 6, (C, n)) * 0x2AAAAAAA).astype(np.uint32).view(np.int32)
    top = jax_keys(jax.random.split(jax.random.PRNGKey(77), C), n)
    top[:, :40] = -1  # 0xFFFFFFFF on valid pixels
    return [("over the cap", many, None), ("under the cap", few, None),
            ("ties at the threshold", many, ties), ("valid 0xFFFFFFFF keys", many, top),
            ("empty class", many & (np.arange(C) != 3)[:, None], None)]


# the flagship's (8 x 129²) and the Cityscapes configs' (4 x 193²) pixels
# per class, and the card tests' sizes
SELECT_PLAN_N = [133128, 148996, 1000, 37, 1, 8 * 97 * 97]


@pytest.mark.parametrize("n", SELECT_PLAN_N)
@pytest.mark.parametrize("k", [1, 16, 64, 700, 8192, 12288, 16384])
def test_select_plan_covers_every_pixel(n, k):
    """`select_keys`'s cluster plan: the 8 blocks' slices (multiples of 4
    pixels, u16 offsets) partition [0, n); each block can hold every
    survivor it may get, min(k, slice); the shared memory fits a block, for
    1 to 32 classes (the plan does not depend on them)."""
    for c in range(1, 33):
        slice_, pixcap, smem = tc._select_plan(c, n, k)
        assert slice_ % 4 == 0 and 0 < slice_ <= 65536
        owned = np.zeros(n, np.int32)
        for r in range(tc.SELECT_CLUSTER):
            owned[r * slice_: min((r + 1) * slice_, n)] += 1
        assert (owned == 1).all()
        assert pixcap >= min(k, slice_)
        assert smem == tc.SELECT_HEADER_BYTES + 4 * slice_ + 2 * pixcap
        assert smem <= tc.SELECT_MAX_SHARED
    with pytest.raises(ValueError, match="k"):
        tc._select_plan(21, n, tc.MAX_KEYS + 1)
    with pytest.raises(ValueError, match="shared memory"):
        tc._select_plan(21, 4_000_000, k)


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("k", [16, 170, 400])
def test_select_keys_radix_bit_equal(case, k):
    """`select_keys_radix_plain` (K4r's plain version) against JAX's
    `_select_keys_radix` with JAX's own u32 keys (or planted ones, handed to
    its `bits`): idx and valid bit-equal, the pad past the selection N - 1.
    k 16: every non-empty class over the cap; 170: 'many' over, 'few' under;
    400: more than the N = 300 pixels."""
    name, mask, keys = _radix_cases()[case]
    rng_keys = jax.random.split(jax.random.PRNGKey(30 + case), C)
    if keys is None:
        keys = jax_keys(rng_keys, mask.shape[1])
    ref_idx, ref_valid = [], []
    with pytest.MonkeyPatch.context() as mp:
        for c in range(C):  # hand JAX these keys
            mp.setattr(jax.random, "bits",
                       lambda key, shape, dtype, _k=keys[c]: jnp.asarray(_k.view(np.uint32)))
            i, v = jc._select_keys_radix(jnp.asarray(mask[c]), rng_keys[c], k)
            ref_idx.append(np.asarray(i))
            ref_valid.append(np.asarray(v))
    idx, n_sel = tc.select_keys_radix(torch.from_numpy(mask), torch.from_numpy(keys), k)
    assert idx.shape == (C, k) and idx.dtype == torch.int32 and n_sel.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.stack(ref_idx), err_msg=name)
    valid = np.arange(k)[None, :] < n_sel.numpy()[:, None]
    np.testing.assert_array_equal(valid, np.stack(ref_valid), err_msg=name)
    # int64 keys in [0, 2^32) select the same
    wide = torch.from_numpy(keys.view(np.uint32).astype(np.int64))
    assert torch.equal(tc.select_keys_radix(torch.from_numpy(mask), wide, k)[0], idx)
    cnt = mask.sum(1)
    for c in range(C):
        assert int(n_sel[c]) == min(cnt[c], k)
        assert (idx[c, n_sel[c]:] == mask.shape[1] - 1).all() if cnt[c] <= k else True
    if name == "ties at the threshold" and k == 16:
        # more keys at or under the threshold than k: the lower-indexed kept
        kv = np.where(mask, keys.view(np.uint32), 0xFFFFFFFF)
        t = np.sort(kv, axis=1)[:, k - 1]
        assert ((kv <= t[:, None]).sum(1) > k).any()


def _radix_walk(mask, keys, k, slice_, held):
    """select_keys_radix_kernel on one row, in its layout: the 8 blocks of
    the cluster, each its slice in chunks of 128 pixels (lane l of a chunk's
    warp its pixels 4 l .. 4 l + 3), its masked count and its histogram of
    the keys' top byte from the one read; the counts summed over the
    cluster; when the row is over the cap, the descent's 4 levels of 8 bits,
    each level's blocks' histograms of the keys under the prefix summed (as
    through distributed shared memory) and the digit picked where the
    exclusive scan of the bins passes the rank kk - 1; the selection as 4
    ballot words per chunk; the blocks' counts and bases; per segment of
    512 chunks an exclusive scan of the chunks' counts, and each lane's
    selected pixels written at its block's, chunk's and lower lanes' count,
    below k; N - 1 from min(total, k) on.  The held chunks and the re-read
    ones hold the same values, so `held` only checks the plan.  Returns
    (idx, n_sel, the pixels each block read)."""
    n = mask.shape[0]
    u32 = keys.view(np.uint32).astype(np.int64)
    kk = min(k, n)
    blocks = []
    for rank in range(tc.RADIX_CLUSTER):
        base = rank * slice_
        ln = max(0, min(slice_, n - base))
        chunks = -(-ln // tc.RADIX_CHUNK)
        m = np.zeros(chunks * tc.RADIX_CHUNK, bool)
        kv = np.zeros(chunks * tc.RADIX_CHUNK, np.int64)
        m[:ln], kv[:ln] = mask[base:base + ln], u32[base:base + ln]
        blocks.append({"base": base, "read": range(base, base + ln), "chunks": chunks,
                       "m": m, "k": kv, "hist": np.bincount(kv[m] >> 24, minlength=256)})
        assert held <= -(-slice_ // tc.RADIX_CHUNK)
    counts = [int(b["m"].sum()) for b in blocks]
    cnt = sum(counts)
    t, every = 0xFFFFFFFF, cnt <= kk
    if not every:
        rem, prefix = kk - 1, 0
        for level in range(4):
            shift = 24 - 8 * level
            if level:
                for b in blocks:
                    under = b["m"] & ((b["k"] >> (shift + 8)) == (prefix >> (shift + 8)))
                    b["hist"] = np.bincount((b["k"][under] >> shift) & 255, minlength=256)
            tot = sum(b["hist"] for b in blocks)
            below = np.cumsum(tot) - tot
            digit = int(np.nonzero((below <= rem) & (rem < below + tot))[0][0])
            prefix |= digit << shift
            rem -= int(below[digit])
        t = prefix
    for b in blocks:
        b["sel"] = b["m"] & (every | (b["k"] <= t))
    sel_counts = counts if every else [int(b["sel"].sum()) for b in blocks]
    total = sum(sel_counts)
    out = np.full(k, -1, np.int64)
    lanes = np.arange(32)
    lt = (1 << lanes) - 1  # the lanes below each lane
    for rank, b in enumerate(blocks):
        seg_base = sum(sel_counts[:rank])
        bits = b["sel"].reshape(b["chunks"], 32, 4)  # (chunk, lane, u)
        words = (bits.astype(np.int64) << lanes[None, :, None]).sum(1)  # (chunk, u): ballots
        for s0 in range(0, b["chunks"], tc.RADIX_THREADS):
            if seg_base >= k:
                break
            w = words[s0:s0 + tc.RADIX_THREADS]
            cc = np.bitwise_count(w).sum(1)
            ex = np.cumsum(cc) - cc
            for j in range(w.shape[0]):
                at0 = seg_base + int(ex[j])
                if at0 >= k:
                    continue
                at = at0 + np.bitwise_count(w[j][None, :] & lt[:, None]).sum(1)  # per lane
                for lane in range(32):
                    a = int(at[lane])
                    for u in range(4):
                        if (w[j, u] >> lane) & 1:
                            if a < k:
                                out[a] = b["base"] + (s0 + j) * tc.RADIX_CHUNK + 4 * lane + u
                            a += 1
            seg_base += int(cc.sum())
    out[min(total, k):] = n - 1
    assert (out >= 0).all()
    return out, min(cnt, k), [b["read"] for b in blocks]


def _radix_walk_cases():
    """(name, mask (C, n), keys (C, n) int32 or None for JAX's own): the
    planted cases of `_radix_cases`, and 4 rows of 5003 pixels, several
    chunks per block: 40 keys tied at the rank-100 key (139 at or under it
    at k 100), 60 masked keys 0xFFFFFFFF (the threshold itself at k 1500),
    a sparse row under the cap from k 400 with one masked 0xFFFFFFFF, an
    empty row."""
    cases = _radix_cases()
    rng = np.random.RandomState(9)
    n = 5003
    mask = rng.rand(4, n) < np.array([0.4, 0.3, 0.05, 0.0])[:, None]
    keys = rng.randint(-2**31, 2**31, (4, n)).astype(np.int32)
    u32 = keys.view(np.uint32)
    on = np.nonzero(mask[0])[0]
    t = np.sort(u32[0, on])[99]
    keys[0, on[rng.permutation(on.size)[:40]]] = np.uint32(t).view(np.int32)  # ties at t
    on1 = np.nonzero(mask[1])[0]
    keys[1, on1[-60:]] = -1  # the threshold is 0xFFFFFFFF at k 1500
    keys[2, np.nonzero(mask[2])[0][0]] = -1  # taken once the row is under the cap
    cases.append(("chunks: ties, 0xFFFFFFFF, under the cap, empty", mask, keys))
    return cases


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("k", [16, 100, 400, 1500, 6000])
def test_select_keys_radix_walk_bit_equal(case, k):
    """K4r's cluster algorithm, walked as the kernel walks it
    (`_radix_walk`, on `_radix_plan`'s slices), against JAX's
    `_select_keys_radix` (its `bits` handed the same keys) and
    `select_keys_radix_plain`: idx and n_sel bit-equal, every pixel read
    once; k from under every class's count to past N."""
    name, mask, keys = _radix_walk_cases()[case]
    c, n = mask.shape
    rng_keys = jax.random.split(jax.random.PRNGKey(40 + case), c)
    if keys is None:
        keys = jax_keys(rng_keys, n)
    slice_, held, smem = tc._radix_plan(c, n, k)
    plain_idx, plain_n = tc.select_keys_radix_plain(torch.from_numpy(mask),
                                                     torch.from_numpy(keys), k)
    with pytest.MonkeyPatch.context() as mp:
        for j in range(c):
            idx, n_sel, read = _radix_walk(mask[j], keys[j], k, slice_, held)
            assert sorted(p for r in read for p in r) == list(range(n))
            mp.setattr(jax.random, "bits",
                       lambda key, shape, dtype, _k=keys[j]: jnp.asarray(_k.view(np.uint32)))
            ref_idx, ref_valid = jc._select_keys_radix(jnp.asarray(mask[j]), rng_keys[j], k)
            np.testing.assert_array_equal(idx, np.asarray(ref_idx), err_msg=f"{name} {j}")
            assert n_sel == int(np.asarray(ref_valid).sum()) == int(plain_n[j]), (name, j)
            np.testing.assert_array_equal(idx, plain_idx[j].numpy(), err_msg=f"{name} {j}")


@pytest.mark.parametrize("n,density,k", [(1_000_003, 0.001, 1500), (1_000_003, 0.3, 9000),
                                         (600_000, 0.002, 1100), (1, 1.0, 3)])
def test_select_keys_radix_walk_past_shared_memory(n, density, k):
    """Rows whose slices are not held whole (1,000,003 and 600,000 pixels:
    8 blocks of 977 / 586 chunks, 432 held) and whose compaction runs in
    two segments of 512 chunks, under and over the cap; and a row of one
    pixel: the walk bit-equal to `select_keys_radix_plain`."""
    rng = np.random.RandomState(n % 97)
    mask = rng.rand(1, n) < density
    keys = rng.randint(-2**31, 2**31, (1, n)).astype(np.int32)
    slice_, held, smem = tc._radix_plan(1, n, k)
    assert smem <= tc.RADIX_MAX_SHARED
    if n > 1:
        assert held < -(-slice_ // tc.RADIX_CHUNK) and slice_ > tc.RADIX_THREADS * tc.RADIX_CHUNK
    idx, n_sel, read = _radix_walk(mask[0], keys[0], k, slice_, held)
    ref_idx, ref_n = tc.select_keys_radix_plain(torch.from_numpy(mask), torch.from_numpy(keys), k)
    assert sum(len(r) for r in read) == n
    assert n_sel == int(ref_n[0])
    np.testing.assert_array_equal(idx, ref_idx[0].numpy())


@pytest.mark.parametrize("density", [0.0, 0.002, 0.3, 1.0])
def test_sample_anchors_bit_equal(density):
    rng = np.random.RandomState(3)
    mask = rng.rand(C, 700) < density
    a_j = np.array([3, 0, 4, 1, 2], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    ref = [jc._sample_with_replacement(jnp.asarray(mask[a]), kk, 64) for a, kk in zip(a_j, keys)]
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kk, (64,))) for kk in keys]))
    idx, n = tc.sample_anchors(torch.from_numpy(mask), torch.from_numpy(a_j), u)
    np.testing.assert_array_equal(idx.numpy(), np.stack([np.asarray(r[0]) for r in ref]))
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in ref])


# ---- the loss ------------------------------------------------------------------

def run_both(seed, strict=True, fill=True, n_classes_present=C, high_frac=0.7, **kw):
    jcfg, cfg = cfgs(**kw)
    rep, rep_t, prob, labels, low, high = inputs(seed, n_classes_present, high_frac)
    jbank, bank = banks(seed, fill)
    rng = jax.random.PRNGKey(100 + seed)
    onehot = jax_onehot(jnp.asarray(labels), C)

    def jax_loss(rep_nhwc):
        bank_out, loss, info = jc.compute_contra_memobank_loss(
            rep_nhwc, onehot[:B_L], onehot[B_L:], nhwc(prob[:B_L]), nhwc(prob[B_L:]),
            jnp.asarray(low, jnp.float32)[..., None], jnp.asarray(high, jnp.float32)[..., None],
            jcfg, jbank, nhwc(rep_t), rng, strict_reference=strict, return_info=True)
        return loss, (bank_out, info)

    (ref_loss, (ref_bank, ref_info)), ref_g = jax.value_and_grad(jax_loss, has_aux=True)(nhwc(rep))
    rep_t_ = torch.from_numpy(rep).requires_grad_(True)
    draws = jax_draws(rng, cfg.num_queries, cfg.num_negatives, select_keys=cfg.select_keys)
    lab = torch.from_numpy(labels)
    pt = torch.from_numpy(prob)
    out_bank, loss, info = tc.compute_contra_memobank_loss(
        rep_t_, lab[:B_L], lab[B_L:], pt[:B_L], pt[B_L:], torch.from_numpy(low),
        torch.from_numpy(high), cfg, bank, torch.from_numpy(rep_t), draws,
        strict_reference=strict, return_info=True)
    assert out_bank is bank
    loss.backward()
    return (float(ref_loss), np.moveaxis(np.asarray(ref_g), -1, 1), ref_bank, ref_info), (
        loss.item(), rep_t_.grad.numpy(), bank, info)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_gradient_bank_match_jax(seed, strict):
    (rl, rg, rbank, rinfo), (gl, gg, gbank, ginfo) = run_both(seed, strict)
    assert rl > 0
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    assert np.abs(rg).max() > 0
    np.testing.assert_allclose(gg, rg, rtol=0, atol=1e-5 * np.abs(rg).max())
    np.testing.assert_array_equal(ginfo["neg_candidates"].numpy(), np.asarray(rinfo["neg_candidates"]))
    assert_equal(gbank, rbank)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_loss_in_float64_matches_jax(seed):
    """A float64 rep takes the plain f32 path's arithmetic in float64 (the
    reference the card's K6 is held against): a float64 loss and gradient
    within the f32 bounds of JAX's, the selections and the bank bit-equal."""
    (rl, rg, rbank, rinfo), _ = run_both(seed)
    _, cfg = cfgs()
    rep, rep_t, prob, labels, low, high = inputs(seed)
    bank = banks(seed)[1]
    t = torch.from_numpy
    rep64 = t(rep).double().requires_grad_(True)
    draws = jax_draws(jax.random.PRNGKey(100 + seed), cfg.num_queries, cfg.num_negatives)
    bank, loss, info = tc.compute_contra_memobank_loss(
        rep64, t(labels[:B_L]), t(labels[B_L:]), t(prob[:B_L]), t(prob[B_L:]), t(low), t(high),
        cfg, bank, t(rep_t), draws, return_info=True)
    (g,) = torch.autograd.grad(loss, rep64)
    assert loss.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), rl, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), rg, rtol=0, atol=1e-5 * np.abs(rg).max())
    np.testing.assert_array_equal(info["neg_candidates"].numpy(), np.asarray(rinfo["neg_candidates"]))
    assert_equal(bank, rbank)


def test_loss_matches_jax_over_the_key_cap():
    """More negative candidates than max_keys_per_class_per_step, and a
    bank that wraps."""
    (rl, rg, rbank, rinfo), (gl, gg, gbank, ginfo) = run_both(2, max_keys_per_class_per_step=4)
    assert (np.asarray(rinfo["neg_candidates"]) > 4).any()
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    np.testing.assert_allclose(gg, rg, rtol=0, atol=1e-5 * np.abs(rg).max())
    assert_equal(gbank, rbank)


@pytest.mark.parametrize("cap", [4, 16])
def test_loss_matches_jax_with_radix_keys(cap):
    """`select_keys: radix`: JAX's u32 keys through K4r's plain version; at
    cap 4 classes are over it, at 16 not; the bank bit-equal."""
    (rl, rg, rbank, rinfo), (gl, gg, gbank, ginfo) = run_both(
        2, max_keys_per_class_per_step=cap, select_keys="radix")
    assert ((np.asarray(rinfo["neg_candidates"]) > cap).any()) == (cap == 4)
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    np.testing.assert_allclose(gg, rg, rtol=0, atol=1e-5 * np.abs(rg).max())
    np.testing.assert_array_equal(ginfo["neg_candidates"].numpy(), np.asarray(rinfo["neg_candidates"]))
    assert_equal(gbank, rbank)


@pytest.mark.parametrize("case", ["one valid class", "empty bank"])
def test_zero_loss_cases(case):
    if case == "one valid class":
        res = run_both(3, n_classes_present=1)
    else:  # no negatives anywhere and nothing stored: every position inactive
        res = run_both(4, fill=False, high_frac=0.0)
    (rl, rg, rbank, _), (gl, gg, gbank, _) = res
    assert rl == 0.0 and gl == 0.0
    assert not np.any(rg) and not np.any(gg)
    assert_equal(gbank, rbank)


def test_anchor_ema_raises():
    _, cfg = cfgs(anchor_ema=True)
    rep, rep_t, prob, labels, low, high = inputs(0)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="anchor_ema"):
        tc.compute_contra_memobank_loss(
            t(rep), t(labels[:B_L]), t(labels[B_L:]), t(prob[:B_L]), t(prob[B_L:]), t(low),
            t(high), cfg, banks(0)[1], t(rep_t), jax_draws(jax.random.PRNGKey(0), 8, 4))
