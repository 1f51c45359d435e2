"""Kernel C's backward, fused with its adjoint resize: the plain version
against JAX, and the fused kernel's band plan, on the CPU.

`upsample_ce_bwd_plain` is held against `jax.grad` of
`u2pl_tpu.losses.ce.cross_entropy_ignore` applied to
`u2pl_tpu.train.steps._upsample` (f32, within 1e-6 of the gradient's max);
the card tests (`tests/test_torch_cuda.py`) hold the kernel against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.losses.ce import cross_entropy_ignore as jax_ce
from u2pl_tpu.train.steps import _upsample
from u2pl_tpu_torch.losses import ce
from u2pl_tpu_torch.ops.resize import _interp_matrix_np, _ranges_np

# (B, C, h, w) logits -> (H, W) labels: scale 4, scale 8, odd sizes
SHAPES = [
    ((2, 5, 9, 9), (33, 33)),
    ((2, 3, 13, 13), (97, 97)),
    ((2, 5, 17, 23), (65, 90)),
    ((3, 4, 9, 7), (33, 25)),
]
# the main path's shapes (VOC sup / unsup CE, Cityscapes OHEM main and aux
# heads) and the card tests' shapes, as (B, C, h, w, H, W)
PLAN_SHAPES = [
    (4, 21, 129, 129, 513, 513),
    (2, 19, 193, 193, 769, 769),
    (2, 19, 97, 97, 769, 769),
    (2, 21, 33, 33, 129, 129),
    (3, 5, 9, 7, 33, 25),
    (2, 3, 13, 13, 97, 97),
    (8, 3, 37, 37, 145, 145),
    (2, 5, 17, 23, 65, 90),
]


def _windows(h, oh, rows):
    """[(iy0, iy1, oy_begin, oy_end)] per band of `rows` input rows: the
    output rows the fused backward walks for input rows [iy0, iy1), read
    from A-bwd's range table as the kernel reads it
    (upsample_ce.cu: rng_h[iy0] .. rng_h[H + iy1 - 1])."""
    rng = _ranges_np(h, oh, True)
    return [(i, min(i + rows, h), int(rng[0, i]), int(rng[1, min(i + rows, h) - 1]))
            for i in range(0, h, rows)]


def _inputs(shape, hw, seed, ignore_frac):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    lab = rng.randint(0, shape[1], (shape[0],) + hw).astype(np.int32)
    lab[rng.rand(*lab.shape) < ignore_frac] = 255
    return x, lab


def _jax_grad(x, lab, cw, g):
    def loss(xn):
        return g * jax_ce(_upsample(xn, lab.shape[1:]), jnp.asarray(lab), 255,
                          None if cw is None else jnp.asarray(cw))

    return np.asarray(jax.grad(loss)(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("ignore_frac", [0.1, 0.9])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,hw", SHAPES)
def test_upsample_ce_bwd_plain_matches_jax_grad(shape, hw, weighted, ignore_frac):
    x, lab = _inputs(shape, hw, seed=shape[1] + shape[2], ignore_frac=ignore_frac)
    # weights in 64ths: their f32 sum over the pixels is exact in any order,
    # so the two packages' different summation orders of the denominator
    # (each ~1e-6 off at 10^4 pixels of arbitrary weights) do not enter
    cw = (np.random.RandomState(1).randint(1, 65, shape[1]) / 64).astype(np.float32) \
        if weighted else None
    ref = _jax_grad(x, lab, cw, 0.75)
    got = ce.upsample_ce_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(lab),
        None if cw is None else torch.from_numpy(cw), 255, torch.tensor(0.75),
    ).numpy()
    assert got.shape == x.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("weighted", [False, True])
def test_upsample_ce_bwd_plain_all_ignored_is_zero(weighted):
    x, lab = _inputs((2, 5, 9, 9), (33, 33), seed=3, ignore_frac=1.1)
    cw = torch.ones(5) if weighted else None
    got = ce.upsample_ce_bwd_plain(torch.from_numpy(x), torch.from_numpy(lab), cw)
    assert not got.any()
    assert not _jax_grad(x, lab, None if cw is None else cw.numpy(), 1.0).any()


def test_upsample_ce_bwd_plain_counts_labels_past_c_as_ignored():
    x, lab = _inputs((2, 5, 9, 9), (33, 33), seed=4, ignore_frac=0.1)
    past = lab.copy()
    past[:, ::3] = 7  # >= C: no class, so no gradient, as if ignored
    ign = lab.copy()
    ign[:, ::3] = 255
    got = ce.upsample_ce_bwd_plain(torch.from_numpy(x), torch.from_numpy(past))
    want = ce.upsample_ce_bwd_plain(torch.from_numpy(x), torch.from_numpy(ign))
    assert torch.equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,hw", SHAPES[:2])
def test_upsample_ce_bwd_plain_matches_autograd_of_the_plain_loss(shape, hw, weighted):
    x, lab = _inputs(shape, hw, seed=5, ignore_frac=0.1)
    cw = torch.rand(shape[1], generator=torch.Generator().manual_seed(2)) if weighted else None
    xt = torch.from_numpy(x).requires_grad_(True)
    (ref,) = torch.autograd.grad(
        2.5 * ce.upsample_cross_entropy_plain(xt, torch.from_numpy(lab), 255, cw), xt)
    got = ce.upsample_ce_bwd_plain(torch.from_numpy(x), torch.from_numpy(lab), cw, 255, 2.5)
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("b,c,h,w,oh,ow", PLAN_SHAPES)
def test_bwd_bands_cover_every_output_row_their_inputs_reach(b, c, h, w, oh, ow, sms):
    plan = ce._bwd_plan(b, c, h, w, oh, ow, sms)
    assert ce._bwd_smem(c, w, ow, plan.cls, plan.chunk, plan.span, plan.gs,
                        plan.ratio) <= ce.BWD_MAX_SHARED
    assert plan.gs % 8 == 0 and plan.gs >= ow + 2 * plan.ratio and plan.span % 2 == 1
    assert plan.span >= int(np.diff(_ranges_np(w, ow, True), axis=0).max())
    windows = _windows(h, oh, plan.rows)
    assert len(windows) == plan.bands
    assert [iy for iy0, iy1, _, _ in windows for iy in range(iy0, iy1)] == list(range(h))
    dense = _interp_matrix_np(h, oh, True)  # (oh, h)
    rng = _ranges_np(h, oh, True)
    for iy0, iy1, ob, oe in windows:
        for iy in range(iy0, iy1):
            reach = np.nonzero(dense[:, iy])[0]
            assert ((reach >= ob) & (reach < oe)).all()
            assert ob <= rng[0, iy] and rng[1, iy] <= oe  # A-bwd's whole range


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("b,c,h,w,oh,ow", PLAN_SHAPES + [(2, 1, 5, 300, 9, 1197),
                                                          (1, 40, 3, 1000, 5, 3997)])
def test_bwd_plan_writes_each_image_class_row_once(b, c, h, w, oh, ow, sms):
    """The blocks, walked as the kernel decodes blockIdx.x (class group
    fastest, then band, then image): every (image, class, input row) is
    written by exactly one owner thread, a block's classes fit its owners
    (at most `cls`, `threads` a whole number of warps), and the ratio is
    the exact column ratio the owners' constant taps assume (widths past
    BWD_EXACT_THREADS take the tables)."""
    plan = ce._bwd_plan(b, c, h, w, oh, ow, sms)
    assert 1 <= plan.cls <= ce.BWD_CLASSES and 1 <= plan.chunk <= ce.BWD_MAX_CHUNK
    assert plan.groups == -(-c // plan.cls) and plan.bands == -(-h // plan.rows)
    assert plan.threads % 32 == 0 and plan.threads <= ce.BWD_MAX_THREADS
    # the exact-ratio kernel: 3 or 4 classes a group, blocks of at most
    # BWD_EXACT_THREADS, a thread owning two (class, column) pairs where
    # one each would not fit; elsewhere one pair a thread
    exact = [s for s in (4, 8)
             if c >= 3 and 2 <= w <= ce.BWD_EXACT_THREADS // 2 and ow - 1 == s * (w - 1)]
    assert plan.ratio == (exact[0] if exact else 0)
    if plan.ratio:
        assert plan.cls in (3, 4) and plan.threads <= ce.BWD_EXACT_THREADS
        pairs = 1 if plan.cls * w <= ce.BWD_EXACT_THREADS else 2
        assert plan.threads == -(-plan.cls * w // (32 * pairs)) * 32
    else:
        assert plan.cls * w <= plan.threads
    written = np.zeros((b, c, h), dtype=np.int64)
    for block in range(b * plan.bands * plan.groups):
        grp, bb = block % plan.groups, block // plan.groups
        img, band = bb // plan.bands, bb % plan.bands
        c0, c1 = grp * c // plan.groups, (grp + 1) * c // plan.groups
        assert 1 <= c1 - c0 <= plan.cls
        iy0 = band * plan.rows
        written[img, c0:c1, iy0:min(iy0 + plan.rows, h)] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("gbytes", [2, 4])
@pytest.mark.parametrize("b,c,h,w,oh,ow,sms,plan", [
    # VOC: 7 groups of 3 classes x 9 bands of 15 rows x 4 images, 416 threads
    (4, 21, 129, 129, 513, 513, 132, (7, 3, 15, 9, 4, 416, 9, 528, 4)),
    # Cityscapes main head: 5 groups (3 / 4 classes) x 25 bands of 8 rows x 2
    # images; 4 x 193 owners, two a thread: 416 threads
    (2, 19, 193, 193, 769, 769, 132, (5, 4, 8, 25, 3, 416, 9, 784, 4)),
    # Cityscapes aux head (x 8): 25 bands of 4 rows
    (2, 19, 97, 97, 769, 769, 132, (5, 4, 4, 25, 3, 416, 17, 792, 8)),
    # 37 rows of 3 classes, 8 images: bands of 2 rows, the last of 1
    (8, 3, 37, 37, 145, 145, 132, (1, 3, 2, 19, 4, 128, 9, 160, 4)),
])
def test_bwd_plan_fills_one_wave(b, c, h, w, oh, ow, sms, plan, gbytes):
    """The plan at the path's shapes: the fewest band rows whose blocks (b x
    bands x groups) fit one wave of BWD_BLOCKS_PER_SM a SM, and the most
    output rows a step for which a block's shared memory (g rows of
    `gbytes` a value) lets two share an SM: f32 takes shorter steps at the
    Cityscapes heads."""
    got = ce._bwd_plan(b, c, h, w, oh, ow, sms, gbytes)
    chunk = plan[4] if gbytes == 2 or plan[4] == 4 else 2
    assert tuple(got) == plan[:4] + (chunk,) + plan[5:]
    wave = ce.BWD_BLOCKS_PER_SM * sms
    assert b * got.bands * got.groups <= wave
    if got.rows > 1:
        assert b * -(-h // (got.rows - 1)) * got.groups > wave
    assert ce._bwd_smem(c, w, ow, got.cls, got.chunk, got.span, got.gs, got.ratio,
                        gbytes) <= ce.BWD_SHARED_PER_BLOCK
    if got.chunk < ce.BWD_MAX_CHUNK:
        assert ce._bwd_smem(c, w, ow, got.cls, got.chunk + 1, got.span, got.gs, got.ratio,
                            gbytes) > ce.BWD_SHARED_PER_BLOCK


@pytest.mark.parametrize("c", [1, 3, 21])
@pytest.mark.parametrize("gbytes", [2, 4])
def test_bwd_plan_takes_widths_up_to_a_block_of_owner_threads(c, gbytes):
    """An owner thread per input column of a class: widths up to
    BWD_MAX_THREADS are planned, one more is refused, whatever the
    classes."""
    w = ce.BWD_MAX_THREADS
    assert ce._bwd_plan(1, c, 2, w, 3, w, 132, gbytes).threads <= ce.BWD_MAX_THREADS
    with pytest.raises(ValueError, match="owner threads"):
        ce._bwd_plan(1, c, 2, w + 1, 3, w + 1, 132, gbytes)


def _assert_bf16_flips(got, want, max_frac=0.01):
    """Equal but at bf16 rounding boundaries, there one bf16 ulp (of each
    (image, class) plane's largest) apart, in at most `max_frac` of the
    elements (tests/test_torch_cuda.py:assert_bf16_flips with row_dim (2, 3))."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    a, b = got.float(), want.float()
    diff = a != b
    scale = torch.maximum(a.abs(), b.abs()).amax(dim=(2, 3), keepdim=True).expand_as(a)
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    assert ((a - b).abs() <= ulp)[diff].all()
    assert diff.float().mean().item() <= max_frac


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,hw", SHAPES)
def test_upsample_ce_bwd_ordered_matches_plain(shape, hw, weighted):
    """The kernel's ordered formula against the plain version: f32 within
    1e-6 of the gradient's max (the two differ in summation order and in
    exp(v - lse) against softmax); bf16 equal but at bf16 rounding
    boundaries (the full-resolution terms, rounded apart there)."""
    x, lab = _inputs(shape, hw, seed=shape[1] + 7, ignore_frac=0.1)
    cw = torch.rand(shape[1], generator=torch.Generator().manual_seed(3)) if weighted else None
    xt, lt = torch.from_numpy(x), torch.from_numpy(lab)
    got = ce.upsample_ce_bwd_ordered(xt, lt, cw, 255, 0.75)
    want = ce.upsample_ce_bwd_plain(xt, lt, cw, 255, 0.75)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    xb = (xt * 2).to(torch.bfloat16)
    _assert_bf16_flips(ce.upsample_ce_bwd_ordered(xb, lt, cw, 255, 0.75),
                       ce.upsample_ce_bwd_plain(xb, lt, cw, 255, 0.75))


def test_upsample_ce_bwd_ordered_takes_the_forwards_lse_and_denom():
    """Given the forward's lse and denominator (here the plain ones), the
    formula uses them: the same gradient as computing its own, and a scaled
    denominator scales the gradient."""
    x, lab = _inputs((2, 5, 9, 9), (33, 33), seed=9, ignore_frac=0.2)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lab)
    up = ce.resize_bilinear_rounded(xt, (33, 33))
    lse = torch.logsumexp(up, dim=1)
    denom = (lt != 255).float().sum()
    own = ce.upsample_ce_bwd_ordered(xt, lt)
    given = ce.upsample_ce_bwd_ordered(xt, lt, lse=lse, denom=denom)
    assert (own - given).abs().max().item() <= 1e-6 * own.abs().max().item()
    half = ce.upsample_ce_bwd_ordered(xt, lt, lse=lse, denom=2 * denom)
    assert torch.allclose(half * 2, given, rtol=1e-6, atol=0)
    allign = ce.upsample_ce_bwd_ordered(xt, torch.full_like(lt, 255))
    assert not allign.any()
