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
    rows, bands, span, log_s, q = ce._bwd_plan(b, c, h, w, oh, ow, sms)
    assert ce._bwd_smem(c, w, ow, rows, span, log_s, q) <= ce.BWD_MAX_SHARED
    assert (1 << log_s) * q >= ow and span % 2 == 1
    assert span >= int(np.diff(_ranges_np(w, ow, True), axis=0).max())
    windows = _windows(h, oh, rows)
    assert len(windows) == bands
    assert [iy for iy0, iy1, _, _ in windows for iy in range(iy0, iy1)] == list(range(h))
    dense = _interp_matrix_np(h, oh, True)  # (oh, h)
    rng = _ranges_np(h, oh, True)
    for iy0, iy1, ob, oe in windows:
        for iy in range(iy0, iy1):
            reach = np.nonzero(dense[:, iy])[0]
            assert ((reach >= ob) & (reach < oe)).all()
            assert ob <= rng[0, iy] and rng[1, iy] <= oe  # A-bwd's whole range


@pytest.mark.parametrize("b,c,h,w,oh,ow,sms,rows", [
    (4, 21, 129, 129, 513, 513, 132, 4),  # VOC: 33 bands x 4 images, one wave
    (2, 19, 193, 193, 769, 769, 132, 3),  # Cityscapes main head: 130 blocks
    (2, 19, 97, 97, 769, 769, 132, 2),  # Cityscapes aux head: 98 blocks
    (8, 3, 37, 37, 145, 145, 132, 3),  # 37 rows: a 1-row band at the edge
])
def test_bwd_plan_fills_one_wave(b, c, h, w, oh, ow, sms, rows):
    plan = ce._bwd_plan(b, c, h, w, oh, ow, sms)
    assert plan[0] == rows and b * plan[1] <= sms
