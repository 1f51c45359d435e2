"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

(`--noconftest`: tests/conftest.py pins JAX to the CPU and imports it.)
"""

import pytest
import torch

from u2pl_tpu_torch.ops import resize as tr

pytestmark = pytest.mark.cuda

# the (in, out) list of tests/test_ops.py:19-26, plus the decoder's upsample
SIZES = [
    ((129, 129), (513, 513)),
    ((513, 513), (129, 129)),
    ((97, 65), (513, 513)),
    ((7, 9), (33, 17)),
    ((33, 17), (7, 9)),
    ((1, 5), (4, 10)),
    ((65, 65), (129, 129)),
]

ARGMAX_SHAPES = [
    ((21, 513, 513), (375, 500)),
    ((21, 513, 513), (500, 333)),
    ((21, 33, 17), (7, 9)),
    ((5, 1, 5), (4, 10)),
]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain version
    return torch.device("cuda")


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_kernel_a_matches_plain(insz, outsz, align):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 3, insz[0], insz[1], device=dev, generator=g)
    n = tr.resize_bilinear.launches
    got = tr.resize_bilinear(x, outsz, align)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1
    ref = tr.resize_bilinear_plain(x, outsz, align)
    # products and sums rounded one by one in both: only the matmul's
    # FMA/summation order differs, well inside 1e-5 for |x| < 6
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("chw,outsz", ARGMAX_SHAPES)
def test_kernel_b_matches_plain(chw, outsz):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*chw, device=dev, generator=g)
    n = tr.resize_argmax.launches
    got = tr.resize_argmax(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_argmax.launches == n + 1
    ref = tr.resize_argmax_plain(x, outsz)
    # labels may differ only where the two best classes are within f32
    # rounding of each other
    top2 = tr.resize_bilinear_plain(x[None], outsz)[0].topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * top2[0].abs().clamp(min=1.0)
    assert not ((got != ref) & ~near_tie).any()


def test_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    x = torch.randn(2, 3, 8, 8, device=dev)
    with pytest.raises(TypeError):
        tr.resize_bilinear(x.double(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_bilinear(x.transpose(2, 3), (4, 4))
    with pytest.raises(TypeError):
        tr.resize_argmax(x[0].half(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_argmax(torch.randn(256, 4, 4, device=dev), (8, 8))


# ---- the training slice's kernels: A-bwd, C, D, E, K3 ----------------------

BWD_SHAPES = [
    ((2, 8, 65, 65), (129, 129)),  # decoder upsample, narrowed
    ((2, 5, 129, 129), (513, 513)),  # logits upsample
    ((2, 3, 33, 17), (7, 9)),  # a downsample
    ((2, 3, 1, 5), (4, 10)),
]


@pytest.mark.parametrize("shape,outsz", BWD_SHAPES)
def test_kernel_a_bwd_matches_plain_adjoint(shape, outsz):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    y = tr.resize_bilinear(x, outsz)
    assert y.requires_grad  # kernel A keeps the autograd graph
    gy = torch.randn(y.shape, device=dev, generator=g)
    n = tr.resize_bilinear_bwd.launches
    (gx,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert tr.resize_bilinear_bwd.launches == n + 1
    ref = tr.resize_bilinear_bwd_plain(gy, shape[2:])
    # gather-form sums vs a matmul's order: within 1e-5 of the gradient's max
    assert (gx - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    again = tr.resize_bilinear_bwd(gy, shape[2:])
    assert torch.equal(again, gx)  # deterministic: no atomics


def _labels(g, b, h, w, c, dev, ignore_frac=0.1):
    lab = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    drop = torch.rand((b, h, w), device=dev, generator=g) < ignore_frac
    return torch.where(drop, torch.full_like(lab, 255), lab)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (33, 25))])
def test_kernel_c_matches_plain(shape, outsz, weighted):
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, shape[0], *outsz, shape[1], dev)
    cw = torch.rand(shape[1], device=dev, generator=g) if weighted else None
    n = (ce.upsample_cross_entropy.fwd_launches, ce.upsample_cross_entropy.bwd_launches)
    loss = ce.upsample_cross_entropy(x, lab, 255, cw)
    (gx,) = torch.autograd.grad(loss * 3.0, x)
    torch.cuda.synchronize()
    assert (ce.upsample_cross_entropy.fwd_launches, ce.upsample_cross_entropy.bwd_launches) == (
        n[0] + 1, n[1] + 1,
    )
    xp = x.detach().clone().requires_grad_(True)
    ref = ce.upsample_cross_entropy_plain(xp, lab, 255, cw)
    (gref,) = torch.autograd.grad(ref * 3.0, xp)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (gx - gref).abs().max().item() <= 1e-6 * max(gref.abs().max().item(), 1e-30)


def test_kernel_c_all_ignored_is_zero():
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    x = torch.randn(2, 5, 9, 9, device=dev, requires_grad=True)
    lab = torch.full((2, 33, 33), 255, dtype=torch.int32, device=dev)
    loss = ce.upsample_cross_entropy(x, lab)
    (gx,) = torch.autograd.grad(loss, x)
    assert loss.item() == 0.0 and not gx.any()


@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (33, 25))])
def test_kernel_d_matches_plain(shape, outsz):
    from u2pl_tpu_torch.losses import unsup

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*shape, device=dev, generator=g) * 3
    n = unsup.upsample_softmax_stats.launches
    mp, am, ent = unsup.upsample_softmax_stats(x, outsz)
    torch.cuda.synchronize()
    assert unsup.upsample_softmax_stats.launches == n + 1
    rmp, ram, rent = unsup.upsample_softmax_stats_plain(x, outsz)
    assert ((mp - rmp).abs() <= 1e-5 * rmp.abs()).all()
    assert ((ent - rent).abs() <= 1e-5 * rent.abs().clamp(min=1e-3)).all()
    top2 = tr.resize_bilinear_plain(x, outsz).topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs().clamp(min=1.0)
    assert am.dtype == torch.int32 and not ((am != ram) & ~near_tie).any()


def _percentile_cases(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    v = torch.rand(1000, device=dev, generator=g)
    m = torch.rand(1000, device=dev, generator=g) < 0.85
    dup = torch.randint(0, 7, (5000,), device=dev, generator=g).float() * 0.25 - 0.5
    one = torch.zeros(300, dtype=torch.bool, device=dev)
    one[17] = True
    return [
        ("random", v, m),
        ("duplicates", dup, torch.rand(5000, device=dev, generator=g) < 0.5),
        ("empty", v, torch.zeros_like(m)),
        ("n=1", v[:300], one),
        ("all", v, torch.ones_like(m)),
    ]


def test_kernel_e_bit_equal_to_plain():
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    pct = torch.tensor([0.0, 37.5, 80.0, 100.0], device=dev)
    for name, v, m in _percentile_cases(dev):
        n = quantile.masked_percentiles.launches
        got = quantile.masked_percentiles(v, m, pct)
        torch.cuda.synchronize()
        assert quantile.masked_percentiles.launches == n + 1
        ref = quantile.masked_percentiles_plain(v, m, pct)
        assert torch.equal(got, ref), (name, got, ref)


@pytest.mark.parametrize("mode", ["cutmix", "cutout"])
def test_kernel_k3_bit_equal_to_plain(mode):
    from u2pl_tpu_torch.ops import mixing

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.randn(3, 3, 33, 29, device=dev, generator=g)
    lab = torch.randint(0, 21, (3, 33, 29), device=dev, generator=g, dtype=torch.int32)
    prob = torch.rand(3, 33, 29, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, 3, 33, 29)
    n = mixing.generate_unsup_data.launches
    got = mixing.generate_unsup_data(img, lab, prob, boxes, mode)
    torch.cuda.synchronize()
    assert mixing.generate_unsup_data.launches == n + 1
    ref = mixing.generate_unsup_data_plain(img, lab, prob, boxes, mode)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _classmix_inputs(dev, b, c, h, w, seed=13):
    """Images, pseudo-labels (some 255, sample 1 a single class), max-probs
    and the (B, C) draws, with ties among a sample's draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn(b, 3, h, w, device=dev, generator=g)
    lab = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(b, h, w, device=dev, generator=g) < 0.05] = 255
    lab[1 % b] = 3
    prob = torch.rand(b, h, w, device=dev, generator=g)
    u = torch.rand(b, c, device=dev, generator=g)
    u[0, 1::3] = u[0, 0]  # tied draws
    return img, lab, prob, u


@pytest.mark.parametrize("b,c,h,w", [(4, 21, 513, 513), (3, 5, 33, 29), (1, 64, 9, 7)])
def test_kernel_k3c_classmix_bit_equal_to_plain(b, c, h, w):
    from u2pl_tpu_torch.ops import mixing

    dev = _cuda()
    img, lab, prob, u = _classmix_inputs(dev, b, c, h, w)
    n = mixing.generate_unsup_data.classmix_launches
    got = mixing.generate_unsup_data(img, lab, prob, u, "classmix")
    torch.cuda.synchronize()
    assert mixing.generate_unsup_data.classmix_launches == n + 1
    ref = mixing.generate_unsup_data_plain(img, lab, prob, u, "classmix")
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


# ---- the contrastive slice's kernels: K4, K5, K6 -----------------------------

# (B, B_l, C, h, w): the flagship's os4 batch, and an odd one
CONTRA_SHAPES = [(8, 4, 21, 129, 129), (3, 1, 5, 9, 7)]


def _contra_inputs(dev, b, b_l, c, h, w, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    prob = torch.softmax(3 * torch.randn(b, c, h, w, device=dev, generator=g), dim=1)
    prob[0, :, 0, :4] = 1.0 / c  # tied probabilities
    labels = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    labels[torch.rand(b, h, w, device=dev, generator=g) < 0.1] = 255
    low = torch.rand(b, h, w, device=dev, generator=g) < 0.8
    high = torch.rand(b, h, w, device=dev, generator=g) < 0.6
    return g, prob, labels, low, high


def _contra_cfg(**kw):
    from u2pl_tpu_torch.config import parse_config

    raw = {"low_rank": 3, "high_rank": 20, "num_negatives": 50, "num_queries": 256, **kw}
    return parse_config({"trainer": {"contrastive": raw}}).trainer.contrastive


@pytest.mark.parametrize("shape", CONTRA_SHAPES)
def test_kernel_pixel_masks_bit_equal(shape):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    b, b_l, c, h, w = shape
    _, prob, labels, low, high = _contra_inputs(dev, *shape)
    cfg = _contra_cfg(low_rank=1 if c < 8 else 3, high_rank=3 if c < 8 else 20)
    n = tc.contra_pixel_masks.launches
    got = tc.contra_pixel_masks(prob, labels, low, high, b_l, cfg)
    torch.cuda.synchronize()
    assert tc.contra_pixel_masks.launches == n + 1
    ref = tc.contra_pixel_masks_plain(prob, labels, low, high, b_l, cfg)
    for name, x, y in zip(("anchor", "negative", "low_valid", "counts"), got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert ref[0].any() and ref[1].any()


def _select_inputs(dev, c, n, density, ties, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    pri = torch.rand(c, n, device=dev, generator=g)
    if ties:
        pri = torch.floor(pri * 16) / 16
    return mask, pri


@pytest.mark.parametrize("c,n,k,density,ties", [
    (21, 133128, 8192, 0.3, False),  # the flagship: over the cap
    (21, 133128, 16384, 0.05, False),  # the largest k, under the cap
    (21, 133128, 8192, 0.3, True),  # tied priorities across the threshold
    (5, 1000, 16, 0.5, False),
    (5, 1000, 700, 0.5, True),
    (3, 37, 64, 1.0, False),  # fewer pixels than k
])
def test_kernel_select_keys_bit_equal(c, n, k, density, ties):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask, pri = _select_inputs(dev, c, n, density, ties)
    mask[c - 1] = False  # an empty class
    cnt = tc.select_keys.launches
    idx, n_sel = tc.select_keys(mask, pri, k)
    torch.cuda.synchronize()
    assert tc.select_keys.launches == cnt + 1
    ref_idx, ref_n = tc.select_keys_plain(mask, pri, k)
    assert torch.equal(n_sel, ref_n)
    for j in range(c):
        m = int(ref_n[j])
        assert torch.equal(idx[j, :m], ref_idx[j, :m]), j


def _radix_inputs(dev, c, n, density, seed=8):
    """A (C, N) mask and u32 keys in int32: class 0 with a planted tie at
    its rank-k key, class 1 with a masked key 0xFFFFFFFF, the last class
    empty."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    keys = torch.randint(0, 2**32, (c, n), device=dev, generator=g, dtype=torch.int64)
    keys[0, ::7] = keys[0, 0]  # many equal keys in class 0
    keys[1, :5] = 0xFFFFFFFF
    mask[1, :5] = True
    mask[c - 1] = False
    return mask, keys.to(torch.int32)


@pytest.mark.parametrize("c,n,k,density", [
    (21, 133128, 8192, 0.3),  # the flagship: over the cap
    (21, 133128, 8192, 0.03),  # under the cap
    (5, 1000, 16, 0.5),
    (5, 1000, 143, 1.0),  # the planted tie lands at the threshold
    (3, 37, 64, 1.0),  # fewer pixels than k
])
def test_kernel_select_keys_radix_bit_equal(c, n, k, density):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask, keys = _radix_inputs(dev, c, n, density)
    cnt = tc.select_keys_radix.launches
    idx, n_sel = tc.select_keys_radix(mask, keys, k)
    torch.cuda.synchronize()
    assert tc.select_keys_radix.launches == cnt + 1
    ref_idx, ref_n = tc.select_keys_radix_plain(mask, keys, k)
    assert torch.equal(n_sel, ref_n) and torch.equal(idx, ref_idx)


@pytest.mark.parametrize("c,n,q,density", [(21, 133128, 256, 0.02), (5, 9000, 64, 0.3),
                                           (4, 100, 33, 0.0)])
def test_kernel_sample_anchors_bit_equal(c, n, q, density):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(8)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    mask[0] = False
    a_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    u = torch.rand(c, q, device=dev, generator=g)
    u[:, 0] = 0.99999994  # the largest draw below 1
    cnt = tc.sample_anchors.launches
    got = tc.sample_anchors(mask, a_j, u)
    torch.cuda.synchronize()
    assert tc.sample_anchors.launches == cnt + 1
    ref = tc.sample_anchors_plain(mask, a_j, u)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _prefilled_bank(dev, c, f, queue, class0, dtype, seed=9):
    from u2pl_tpu_torch.memobank import init_memobank

    bank = init_memobank(c, f, queue, class0, dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    bank.keys.copy_(torch.randn(bank.keys.shape, device=dev, generator=g).to(dtype))
    bank.occupancy.copy_(torch.minimum(
        torch.randint(0, class0 + 1, (c,), device=dev, generator=g, dtype=torch.int32), bank.sizes))
    bank.ptr.copy_(torch.remainder(bank.occupancy + 7, bank.sizes).to(torch.int32))
    return bank


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,h,w,k,queue,class0", [
    (8, 21, 129, 129, 8192, 30000, 50000),  # the flagship bank, wrapping
    (2, 5, 9, 7, 16, 12, 20),  # k close to the queue: the ring wraps within one write
    (2, 3, 5, 5, 40, 12, 20),  # k beyond the queue: only the newest `size` rows land
])
def test_kernel_memobank_enqueue_bit_equal(dtype, b, c, h, w, k, queue, class0):
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(10)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g)
    bank = _prefilled_bank(dev, c, 256, queue, class0, dtype)
    n = b * h * w
    sel = torch.stack([torch.randperm(n, device=dev, generator=g)[:k] if k <= n else
                       torch.randint(0, n, (k,), device=dev, generator=g) for _ in range(c)])
    sel = sel.to(torch.int32)
    n_sel = torch.randint(0, k + 1, (c,), device=dev, generator=g, dtype=torch.int32)
    n_sel[0] = k
    ref = memobank_enqueue_plain(clone_bank(bank), rep, sel, n_sel)
    cnt = memobank_enqueue.launches
    got = memobank_enqueue(bank, rep, sel, n_sel)
    torch.cuda.synchronize()
    assert memobank_enqueue.launches == cnt + 1
    for name in ("keys", "ptr", "occupancy"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("b,c,h,w,q,m,cap", [(8, 21, 129, 129, 256, 50, 50000),
                                             (3, 5, 9, 7, 16, 4, 20)])
def test_kernel_infonce_fwd_bwd_match_plain(b, c, h, w, q, m, cap):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    n = b * h * w
    bank = _prefilled_bank(dev, c, 256, min(cap, 30000), cap, torch.bfloat16)
    bank.occupancy[1] = 0  # an empty bank class
    rep = torch.randn(b, 256, h, w, device=dev, generator=g, requires_grad=True)
    # disjoint anchor pixels per position, with repeated draws within one
    pix = torch.randperm(n, device=dev, generator=g)[: c * 8].view(c, 8)
    anchor_idx = pix.gather(1, torch.randint(0, 8, (c, q), device=dev, generator=g)).to(torch.int32)
    positive = torch.randn(c, 256, device=dev, generator=g)
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    u_neg = torch.rand(c, q * m, device=dev, generator=g)
    valid_seg = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    active = (torch.arange(c, device=dev) < valid_seg) & (bank.occupancy[b_j.long()] > 0)
    args = (anchor_idx, positive, bank, b_j, u_neg, active, valid_seg, 0.5)
    cnt = (tc.contra_infonce.fwd_launches, tc.contra_infonce.bwd_launches)
    loss = tc.contra_infonce(rep, *args)
    (grad,) = torch.autograd.grad(loss * 3.0, rep)
    torch.cuda.synchronize()
    assert (tc.contra_infonce.fwd_launches, tc.contra_infonce.bwd_launches) == (cnt[0] + 1, cnt[1] + 1)
    rp = rep.detach().clone().requires_grad_(True)
    ref = tc.contra_infonce_plain(rp, *args)
    (gref,) = torch.autograd.grad(ref * 3.0, rp)
    assert ref.item() > 0
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (grad - gref).abs().max().item() <= 1e-6 * gref.abs().max().item()
    again = torch.autograd.grad(tc.contra_infonce(rep, *args) * 3.0, rep)[0]
    assert torch.equal(again, grad)  # deterministic: no float atomics
    # valid_seg <= 1: zero loss, zero gradient
    zero = tc.contra_infonce(rep, *args[:6], torch.tensor(1, dtype=torch.int32, device=dev), 0.5)
    (gz,) = torch.autograd.grad(zero, rep)
    assert zero.item() == 0.0 and not gz.any()


def test_contrastive_kernels_refuse_what_they_do_not_take():
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask = torch.ones(3, 10, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        tc.select_keys(mask, torch.rand(3, 10, device=dev), tc.MAX_KEYS + 1)
    with pytest.raises(ValueError):
        tc.select_keys(mask.to(torch.uint8), torch.rand(3, 10, device=dev), 4)
    with pytest.raises(ValueError):
        tc.sample_anchors(mask, torch.arange(3, device=dev), torch.rand(3, 4, device=dev))


# ---- the Cityscapes slice's kernels: K7 (OHEM) --------------------------------

# (B, C, h, w) logits -> (H, W) labels: the Cityscapes main and aux heads, an odd one
OHEM_SHAPES = [((2, 19, 193, 193), (769, 769)), ((2, 19, 97, 97), (769, 769)),
               ((3, 5, 9, 7), (33, 25))]


def _ohem_inputs(dev, shape, outsz, ignore_frac=0.05, seed=12):
    """Logits whose label's class leads at most pixels (classes constant on
    4x4 cells of the logits' grid, the class +4, the rest -4, plus noise), so
    p_y spreads from ~0 to ~1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape
    cells = torch.randint(0, c, (b, -(-h // 4), -(-w // 4)), device=dev, generator=g,
                          dtype=torch.int32)
    lab_s = tr.resize_nearest(cells, (h, w))
    onehot = torch.nn.functional.one_hot(lab_s.long(), c).permute(0, 3, 1, 2).float()
    x = (8 * onehot - 4 + 0.3 * torch.randn(shape, device=dev, generator=g)).contiguous()
    lab = tr.resize_nearest(lab_s, outsz).contiguous()
    lab[torch.rand(lab.shape, device=dev, generator=g) < ignore_frac] = 255
    return x, lab


@pytest.mark.parametrize("shape,outsz", OHEM_SHAPES)
def test_kernel_ohem_target_prob_matches_plain(shape, outsz):
    from u2pl_tpu_torch.losses import ohem

    dev = _cuda()
    x, lab = _ohem_inputs(dev, shape, outsz)
    n = ohem.ohem_target_prob.launches
    p, nv = ohem.ohem_target_prob(x, lab)
    torch.cuda.synchronize()
    assert ohem.ohem_target_prob.launches == n + 1
    ref, nv_ref = ohem.ohem_target_prob_plain(x, lab)
    assert nv.dtype == torch.int32 and torch.equal(nv, nv_ref)
    # exp(x_y - max) / sum on kernel A's upsampled logits: the plain softmax
    # of the same logits (measured bit-equal); the plain version's matmul
    # resize rounds the logits (|x| < 6) up to 9.5e-7 apart
    via_a, _ = ohem._target_prob(tr.resize_bilinear(x, outsz), lab, 255)
    assert ((p - via_a).abs() <= 1e-6 * via_a).all()
    assert ((p - ref).abs() <= 2e-6 * ref).all()
    assert torch.equal(p[lab == 255], torch.ones_like(p[lab == 255]))


def _kth_cases(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    n = 2 * 769 * 769
    p = torch.rand(n, device=dev, generator=g)
    p[torch.rand(n, device=dev, generator=g) < 0.3] = 0.5  # a tie block
    p[torch.rand(n, device=dev, generator=g) < 0.05] = 1.0  # the ignored-pixel filler
    dup = torch.randint(0, 7, (5000,), device=dev, generator=g).float() * 0.25 - 0.5
    return [(p, k) for k in (1, 100000, n // 2, n)] + [(dup, k) for k in (1, 2500, 5000)] + [
        (torch.ones(333, device=dev), 100)]


def test_kernel_kth_smallest_bit_equal_to_plain():
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    for v, k in _kth_cases(dev):
        n = quantile.kth_smallest.launches
        got = quantile.kth_smallest(v, k)
        torch.cuda.synchronize()
        assert quantile.kth_smallest.launches == n + 1
        ref = quantile.kth_smallest_plain(v, k)
        assert got.dim() == 0 and torch.equal(got, ref), (v.numel(), k, got, ref)
    with pytest.raises(ValueError):
        quantile.kth_smallest(torch.rand(10, device=dev), 11)


@pytest.mark.parametrize("min_kept,ignore_frac", [(10, 0.05), (100000, 0.05), (100000, 0.95),
                                                  (100000, 1.0)])
def test_kernel_ohem_keep_labels_bit_equal(min_kept, ignore_frac):
    """thresh sets the threshold, the k-th value does, fewer valid pixels
    than min_kept (every valid pixel kept), an all-ignored map."""
    from u2pl_tpu_torch.losses import ohem
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    x, lab = _ohem_inputs(dev, *OHEM_SHAPES[0], ignore_frac=ignore_frac)
    p, nv = ohem.ohem_target_prob_plain(x, lab)
    kth = quantile.kth_smallest_plain(p, min(p.numel(), min_kept))
    n = ohem.ohem_keep_labels.launches
    got = ohem.ohem_keep_labels(lab, p, kth, nv, 0.7, min_kept)
    torch.cuda.synchronize()
    assert ohem.ohem_keep_labels.launches == n + 1
    ref = ohem.ohem_keep_labels_plain(lab, p, kth, nv, 0.7, min_kept)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    if 0 < int(nv) < min_kept:
        assert int((got != 255).sum()) == int(nv)


@pytest.mark.parametrize("shape,outsz,use_weight", [
    (*OHEM_SHAPES[1], False), (*OHEM_SHAPES[1], True), (*OHEM_SHAPES[2], False)])
def test_ohem_cross_entropy_matches_plain(shape, outsz, use_weight):
    """The whole OHEM loss through the kernels: its value against the plain
    route, rel 1e-5; its gradient against the plain CE of the same kept
    labels, 1e-6 of the max (the kept set may differ from the plain route's
    on pixels within rounding of the threshold)."""
    from u2pl_tpu_torch.losses import ce, ohem
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    x, lab = _ohem_inputs(dev, shape, outsz)
    min_kept = lab.numel() // 10
    xk, xp, xs = (x.clone().requires_grad_(True) for _ in range(3))
    loss = ohem.ohem_cross_entropy(xk, lab, 0.7, min_kept, 255, use_weight)
    (gk,) = torch.autograd.grad(loss * 3.0, xk)
    ref = ohem.ohem_cross_entropy_plain(xp, lab, 0.7, min_kept, 255, use_weight)
    p, nv = ohem.ohem_target_prob(x, lab)
    kept = ohem.ohem_keep_labels(lab, p, quantile.kth_smallest(p, min_kept), nv, 0.7, min_kept)
    same = ce.upsample_cross_entropy_plain(xs, kept, 255, ohem._class_weight(use_weight, dev))
    (gs,) = torch.autograd.grad(same * 3.0, xs)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (gk - gs).abs().max().item() <= 1e-6 * gs.abs().max().item()
