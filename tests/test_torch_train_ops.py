"""The training slice's ops in the port against their JAX twins, on the CPU.

On CPU tensors every wrapper takes its plain PyTorch version, which is held
here against the JAX function on the same numpy inputs; the CUDA kernels
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerances: the CE value and its gradient rtol 1e-5 (float32
sums in other orders); the softmax statistics rtol 1e-5; percentiles,
mixing and LR schedules exactly or to float32 rounding, as stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from u2pl_tpu.config import LRSchedulerCfg as JaxLRSchedulerCfg
from u2pl_tpu.config import OptimizerCfg as JaxOptimizerCfg
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.losses.ce import cross_entropy_ignore as jax_ce
from u2pl_tpu.losses.unsup import teacher_entropy as jax_entropy
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops import mixing as jmix
from u2pl_tpu.ops.quantile import masked_percentile as jax_masked_percentile
from u2pl_tpu.ops.quantile import masked_percentiles as jax_masked_percentiles
from u2pl_tpu.train.lr import lr_at as jax_lr_at
from u2pl_tpu.train.optim import apply_updates_with_lr, make_optimizer as jax_make_optimizer
from u2pl_tpu.train.steps import _upsample
from u2pl_tpu.utils.convert_torch import torch_to_flax
from u2pl_tpu_torch.config import LRSchedulerCfg, OptimizerCfg, parse_config
from u2pl_tpu_torch.losses import ce, unsup
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.ops import mixing, quantile
from u2pl_tpu_torch.ops.resize import resize_bilinear_plain
from u2pl_tpu_torch.train.lr import lr_at
from u2pl_tpu_torch.train.optim import make_optimizer
from u2pl_tpu_torch.train.steps import epoch_scalars
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

# (B, C, h, w) os4 logits -> (H, W) labels
CE_SHAPES = [((2, 5, 9, 9), (33, 33)), ((2, 21, 17, 13), (65, 49)), ((1, 3, 4, 6), (13, 21))]


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _ce_inputs(shape, hw, seed, ignore_frac=0.1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    lab = rng.randint(0, shape[1], (shape[0],) + hw).astype(np.int32)
    lab[rng.rand(*lab.shape) < ignore_frac] = 255
    return x, lab


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,hw", CE_SHAPES)
def test_upsample_ce_value_and_grad_match_jax(shape, hw, weighted):
    x, lab = _ce_inputs(shape, hw, seed=shape[1])
    cw = np.random.RandomState(1).rand(shape[1]).astype(np.float32) if weighted else None

    def jax_loss(xn):
        return jax_ce(_upsample(xn, hw), jnp.asarray(lab), 255,
                      None if cw is None else jnp.asarray(cw))

    ref, ref_g = jax.value_and_grad(jax_loss)(jnp.asarray(x.transpose(0, 2, 3, 1)))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ce.upsample_cross_entropy(
        xt, torch.from_numpy(lab), 255, None if cw is None else torch.from_numpy(cw)
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    g, rg = _nhwc(xt.grad), np.asarray(ref_g)
    np.testing.assert_allclose(g, rg, rtol=1e-5, atol=1e-5 * np.abs(rg).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_upsample_ce_all_ignored_is_zero(weighted):
    x, lab = _ce_inputs((2, 5, 9, 9), (33, 33), seed=3, ignore_frac=1.1)
    cw = torch.ones(5) if weighted else None
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ce.upsample_cross_entropy(xt, torch.from_numpy(lab), 255, cw)
    loss.backward()
    ref = jax_ce(_upsample(jnp.asarray(x.transpose(0, 2, 3, 1)), (33, 33)), jnp.asarray(lab))
    assert loss.item() == float(ref) == 0.0
    assert not xt.grad.any()


def test_supervised_loss_aux_and_use_weight_quirk():
    from u2pl_tpu.losses.ce import supervised_loss as jax_sup

    rng = np.random.RandomState(4)
    pred = rng.randn(2, 19, 9, 9).astype(np.float32)
    aux = rng.randn(2, 19, 5, 5).astype(np.float32)
    lab = rng.randint(0, 19, (2, 33, 33)).astype(np.int32)
    lab[:, :3] = 255
    up = lambda a: _upsample(jnp.asarray(a.transpose(0, 2, 3, 1)), (33, 33))  # noqa: E731
    for aux_w, use_weight in [(0.4, True), (0.4, False), (0.0, True)]:
        ref = jax_sup(up(pred), jnp.asarray(lab), up(aux) if aux_w else None, aux_w, 255, use_weight)
        got = ce.supervised_loss(
            torch.from_numpy(pred), torch.from_numpy(lab),
            torch.from_numpy(aux) if aux_w else None, aux_w, 255, use_weight,
        )
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@pytest.mark.parametrize("shape,hw", CE_SHAPES)
def test_upsample_softmax_stats_match_jax_step(shape, hw):
    x = (np.random.RandomState(5).randn(*shape) * 3).astype(np.float32)
    pt = _upsample(jnp.asarray(x.transpose(0, 2, 3, 1)), hw)
    ref_mp = jnp.exp(pt.max(axis=-1) - jax.nn.logsumexp(pt, axis=-1))  # steps.py:300
    ref_am = pt.argmax(axis=-1).astype(jnp.int32)  # steps.py:301
    ref_ent = jax_entropy(pt)
    mp, am, ent = unsup.upsample_softmax_stats(torch.from_numpy(x), hw)
    # the two upsamples agree to float32 rounding (0 to 1e-6 here); the
    # messages carry the margins, so a failure elsewhere says which one moved
    up_diff = float(np.abs(np.moveaxis(np.asarray(pt), -1, 1)
                           - resize_bilinear_plain(torch.from_numpy(x), hw).numpy()).max())
    # each side against float64 statistics of JAX's own upsample (each was
    # 3.4e-7 from it where this test was once seen failing): names the side
    # that moved
    p64 = np.moveaxis(np.asarray(pt, np.float64), -1, 1)
    top = p64.max(axis=1)
    lse = top + np.log(np.exp(p64 - top[:, None]).sum(axis=1))
    mp64 = np.exp(top - lse)
    prob64 = np.exp(p64 - lse[:, None])
    ent64 = -(prob64 * np.log(prob64 + 1e-10)).sum(axis=1)
    sides = {"port": (mp.numpy(), ent.numpy()), "jax": (np.asarray(ref_mp), np.asarray(ref_ent))}
    for side, (side_mp, side_ent) in sides.items():
        np.testing.assert_allclose(side_mp, mp64, rtol=1e-5,
                                   err_msg=f"{side} max-prob off the float64 reference")
        np.testing.assert_allclose(side_ent, ent64, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{side} entropy off the float64 reference")
    np.testing.assert_allclose(mp.numpy(), np.asarray(ref_mp), rtol=1e-5,
                               err_msg=f"upsample max abs diff {up_diff}")
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref_ent), rtol=1e-5, atol=1e-6,
                               err_msg=f"upsample max abs diff {up_diff}")
    assert am.dtype == torch.int32
    # argmax: equal off near-ties, the rule of the card tests (top-2 gap
    # <= 1e-5 relative); the smallest gap at these inputs is 2.5e-4
    top2 = np.sort(np.asarray(pt), axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 1e-5 * np.maximum(np.abs(top2[..., 1]), 1.0)
    off = (am.numpy() != np.asarray(ref_am)) & ~near_tie
    assert not off.any(), (
        f"{int(off.sum())} argmax mismatches off near-ties; {int(near_tie.sum())} near-ties; "
        f"upsample max abs diff {up_diff}"
    )


@pytest.mark.parametrize("outputs", ["prob", "entropy"])
@pytest.mark.parametrize("shape,hw", CE_SHAPES)
def test_upsample_softmax_stats_output_selection(shape, hw, outputs):
    """`outputs` selects what kernel D computes: the selected tensors are
    the all-outputs call's (bit-equal), the others None, and they match the
    JAX step's at those points (steps.py:300-301 for "prob", unsup.py:24 for
    "entropy"), rtol 1e-5 as above."""
    x = (np.random.RandomState(6).randn(*shape) * 3).astype(np.float32)
    xt = torch.from_numpy(x)
    full = unsup.upsample_softmax_stats(xt, hw)
    got = unsup.upsample_softmax_stats(xt, hw, outputs=outputs)
    plain = unsup.upsample_softmax_stats_plain(xt, hw, outputs)
    keep = (True, True, False) if outputs == "prob" else (False, False, True)
    assert tuple(t is not None for t in got) == keep
    for g, p, f, kept in zip(got, plain, full, keep):
        if kept:
            assert torch.equal(g, f) and torch.equal(p, f)
        else:
            assert g is None and p is None
    pt = _upsample(jnp.asarray(x.transpose(0, 2, 3, 1)), hw)
    if outputs == "prob":
        ref_mp = jnp.exp(pt.max(axis=-1) - jax.nn.logsumexp(pt, axis=-1))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_mp), rtol=1e-5)
        assert got[1].dtype == torch.int32
    else:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jax_entropy(pt)), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="outputs"):
        unsup.upsample_softmax_stats(xt, hw, outputs="argmax")


def test_unsupervised_loss_matches_jax():
    from u2pl_tpu.losses.unsup import compute_unsupervised_loss as jax_unsup

    rng = np.random.RandomState(6)
    pred = rng.randn(2, 5, 9, 9).astype(np.float32)
    teach = rng.randn(2, 5, 9, 9).astype(np.float32)
    target = rng.randint(0, 5, (2, 33, 33)).astype(np.int32)
    target[:, :4] = 255
    up = lambda a: _upsample(jnp.asarray(a.transpose(0, 2, 3, 1)), (33, 33))  # noqa: E731
    ent = jax_entropy(up(teach))
    thr = jax_masked_percentiles(ent, jnp.asarray(target) != 255, jnp.asarray([85.0]))[0]
    ref = jax_unsup(up(pred), jnp.asarray(target), 85.0, up(teach), 255, entropy=ent, thresh=thr)
    got = unsup.compute_unsupervised_loss(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(np.array(ent)),
        torch.tensor(float(thr)), 255,
    )
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


# ---- masked percentiles: bit-equal -----------------------------------------

def _step_percents():
    """drop_percent of steps.py:356-359 for every epoch of a few schedules,
    as JAX forms them in float32 (and the port's `epoch_scalars` must too)."""
    out = []
    for epochs, drop in [(80, 80.0), (40, 80.0), (200, 60.0), (3, 80.0)]:
        for epoch in range(epochs):
            e = jnp.asarray(epoch, jnp.float32)
            out.append(float(100.0 - (100.0 - drop) * (1.0 - e / epochs)))
    return np.asarray(out, np.float32)


def test_epoch_scalars_match_jax_bit_for_bit():
    cfg = parse_config({"trainer": {"epochs": 80, "sup_only_epoch": 1,
                                    "unsupervised": {"drop_percent": 80}}})
    spe = 3
    for it in [0, 2, 3, 5, 7, 100, 239]:
        got_pct, got_decay = epoch_scalars(torch.tensor(it, dtype=torch.int32), spe, cfg)
        i = jnp.asarray(it, jnp.int32)
        epoch = (i // spe).astype(jnp.float32)
        ref_pct = 100.0 - (100.0 - 80.0) * (1.0 - epoch / 80)
        decay = jnp.minimum(1.0 - 1.0 / (i.astype(jnp.float32) - spe * 1 + 1.0), 0.99)
        decay = jnp.where(i // spe == 1, 0.0, decay)
        assert got_pct.numpy().tobytes() == np.asarray(ref_pct, np.float32).tobytes(), it
        if it >= spe:  # warmup iterations have no meaningful decay
            np.testing.assert_array_equal(got_decay.numpy(), np.asarray(decay))


def _percentile_maps():
    rng = np.random.RandomState(7)
    yield "random", rng.rand(4, 33, 33).astype(np.float32), rng.rand(4, 33, 33) < 0.85
    yield "negative", rng.randn(3000).astype(np.float32), rng.rand(3000) < 0.5
    dup = (rng.randint(0, 6, 2000) * 0.125).astype(np.float32)
    yield "duplicates", dup, rng.rand(2000) < 0.7
    yield "empty", rng.rand(500).astype(np.float32), np.zeros(500, bool)
    one = np.zeros(500, bool)
    one[123] = True
    yield "n=1", rng.rand(500).astype(np.float32), one
    yield "n=2", rng.rand(500).astype(np.float32), one | (np.arange(500) == 7)


@pytest.mark.parametrize("name,values,mask", list(_percentile_maps()), ids=lambda v: v if isinstance(v, str) else "")
def test_masked_percentiles_bit_equal_to_jax(name, values, mask):
    pct = np.concatenate([[0.0, 37.5, 80.0, 100.0], _step_percents()[::37]]).astype(np.float32)
    ref = np.asarray(jax_masked_percentiles(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(pct)))
    got = quantile.masked_percentiles(torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(pct))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == ref.tobytes(), (name, got.numpy(), ref)
    one = np.asarray(jax_masked_percentile(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(pct[2])))
    assert got.numpy()[2].tobytes() == one.tobytes()


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(0, 512),
    levels=st.integers(1, 50),
    seed=st.integers(0, 2**31 - 1),
)
def test_masked_percentiles_property_bit_equal(n, levels, seed):
    # one map size (no retrace per example); n of its 512 values are valid
    rng = np.random.RandomState(seed)
    values = (rng.randint(0, levels, 512) / levels - 0.3).astype(np.float32)
    mask = rng.permutation(512) < n
    pct = _step_percents()[rng.randint(0, 300, 4)]
    ref = np.asarray(jax_masked_percentiles(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(pct)))
    got = quantile.masked_percentiles(torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(pct))
    assert got.numpy().tobytes() == ref.tobytes()


# ---- the radix descent of kernel E and K7 kth (kernels/csrc/quantile.cu),
# walked in PyTorch in the kernel's digit layout --------------------------

def _order_keys(v: torch.Tensor) -> torch.Tensor:
    """u2pl_tpu/ops/quantile.py:_order_keys as int64 tensors of u32 keys."""
    bits = v.float().reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >> 31 == 1, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def _keys_to_f32(keys: torch.Tensor) -> torch.Tensor:
    bits = torch.where(keys >> 31 == 0, ~keys & 0xFFFFFFFF, keys & 0x7FFFFFFF)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _descend(keys: torch.Tensor, rank: int) -> tuple[int, int, int]:
    """quantile.cu's descent for one 0-based rank: (the rank-th smallest
    key, the count of keys <= it, the smallest greater key or 0xFFFFFFFF),
    the last two from the last level's histogram and the smallest key above
    its group, as the kernel takes them."""
    prefix, rem, up = 0, rank, 32
    levels = -(-32 // quantile.DESCENT_DIGIT_BITS)
    for level in range(levels):
        shift = max(0, 32 - quantile.DESCENT_DIGIT_BITS * (level + 1))
        group = keys if level == 0 else keys[(keys >> up) == (prefix >> up)]
        hist = torch.bincount((group >> shift) & ((1 << (up - shift)) - 1),
                              minlength=1 << (up - shift))
        csum = torch.cumsum(hist, 0)
        sel = int(torch.searchsorted(csum, torch.tensor(rem), right=True))
        rem -= int(csum[sel] - hist[sel])
        prefix |= sel << shift
        if level < levels - 1:
            up = shift
    later = torch.nonzero(hist[sel + 1:])
    if later.numel():
        nxt = (prefix & ~((1 << up) - 1)) | (sel + 1 + int(later[0]))
    else:
        above = keys[(keys >> up) > (prefix >> up)]
        nxt = int(above.min()) if above.numel() else 0xFFFFFFFF
    return prefix, rank - rem + int(hist[sel]), nxt


def _descent_percentiles(
    values: torch.Tensor, mask: torch.Tensor, percents: torch.Tensor
) -> torch.Tensor:
    """Kernel E's algorithm, digit by digit: its ranks, its descent and its
    interpolation in float32."""
    keys = torch.where(mask.reshape(-1), _order_keys(values),
                       torch.full((values.numel(),), 0xFF800000, dtype=torch.int64))
    n = mask.sum().to(torch.int32)
    pct = percents.to(torch.float32)
    nm1 = torch.clamp(n - 1, min=0)
    rank = pct / torch.full_like(pct, 100.0) * nm1.to(torch.float32)
    lo = torch.floor(rank).to(torch.int32)
    hi = torch.minimum(lo + 1, nm1)
    frac = rank - lo.to(torch.float32)
    out = []
    for q in range(pct.shape[0]):
        key, le, nxt = _descend(keys, min(max(int(lo[q]), 0), keys.numel() - 1))
        v_lo, v_nxt = _keys_to_f32(torch.tensor([key, nxt]))
        v_hi = v_lo if le > int(hi[q]) or int(hi[q]) == int(lo[q]) else v_nxt
        out.append(v_lo + frac[q] * (v_hi - v_lo))
    out = torch.stack(out)
    return torch.where(n > 0, out, torch.full_like(out, float("inf")))


def _descent_kth_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """K7 kth's algorithm: the descent at the rank k - 1."""
    key, _, _ = _descend(_order_keys(values), k - 1)
    return _keys_to_f32(torch.tensor([key]))[0]


@pytest.mark.parametrize("name,values,mask", list(_percentile_maps()), ids=lambda v: v if isinstance(v, str) else "")
def test_descent_percentiles_bit_equal_to_jax(name, values, mask):
    """Kernel E's descent walked digit by digit (its layout, the count of
    keys <= the selected one and the next greater key from the last
    level's histogram) against the JAX masked_percentiles."""
    pct = np.concatenate([[0.0, 37.5, 80.0, 100.0], _step_percents()[::37]]).astype(np.float32)
    ref = np.asarray(jax_masked_percentiles(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(pct)))
    got = _descent_percentiles(torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(pct))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == ref.tobytes(), (name, got.numpy(), ref)


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(0, 512),
    levels=st.integers(1, 50),
    seed=st.integers(0, 2**31 - 1),
)
def test_descent_percentiles_property_bit_equal(n, levels, seed):
    rng = np.random.RandomState(seed)
    values = (rng.randint(0, levels, 512) / levels - 0.3).astype(np.float32)
    mask = rng.permutation(512) < n
    pct = _step_percents()[rng.randint(0, 300, 4)]
    ref = np.asarray(jax_masked_percentiles(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(pct)))
    got = _descent_percentiles(torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(pct))
    assert got.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("name,values,mask", list(_percentile_maps()), ids=lambda v: v if isinstance(v, str) else "")
def test_descent_kth_smallest_bit_equal_to_jax(name, values, mask):
    """K7 kth's descent against the JAX _kth_smallest at k = 1, the middle
    and n (a masked value is +inf there, as OHEM's ignored pixels are 1.0)."""
    from u2pl_tpu.losses.ohem import _kth_smallest

    v = np.where(mask, values, np.float32(np.inf)).astype(np.float32).reshape(-1)
    for k in sorted({1, v.size // 2, v.size}):
        ref = np.asarray(_kth_smallest(jnp.asarray(v), k))
        got = _descent_kth_smallest(torch.from_numpy(v), k)
        assert got.numpy().tobytes() == ref.tobytes(), (name, k)


# ---- CutMix / Cutout: bit-equal with JAX's own draws -----------------------

def _jax_box_uniforms(k_mix, b):
    """The uniforms `_cutout_box_mask` draws for each of the b samples."""
    out = []
    for key in jax.random.split(k_mix, b):
        out.append([float(jax.random.uniform(r, ())) for r in jax.random.split(key, 3)])
    return torch.tensor(out, dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["cutmix", "cutout"])
@pytest.mark.parametrize("hw", [(33, 33), (65, 49)])
def test_generate_unsup_data_bit_equal_to_jax(mode, seed, hw):
    b = 3
    k_mix = jax.random.PRNGKey(seed)
    rng = np.random.RandomState(seed)
    img = rng.randn(b, hw[0], hw[1], 3).astype(np.float32)
    lab = rng.randint(0, 21, (b,) + hw).astype(np.int32)
    prob = rng.rand(b, *hw).astype(np.float32)
    ref = jmix.generate_unsup_data(k_mix, jnp.asarray(img), jnp.asarray(lab), jnp.asarray(prob),
                                   mode, num_classes=21)
    boxes = mixing.boxes_from_uniforms(_jax_box_uniforms(k_mix, b), *hw)
    for i, key in enumerate(jax.random.split(k_mix, b)):
        inside = np.asarray(jmix._cutout_box_mask(key, hw[0], hw[1], 2.0)) == 0
        np.testing.assert_array_equal(mixing.box_masks(boxes, *hw)[i].numpy(), inside)
    got = mixing.generate_unsup_data(
        torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lab),
        torch.from_numpy(prob), boxes, mode,
    )
    np.testing.assert_array_equal(_nhwc(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_classmix_raises_not_ported():
    """ClassMix is ported (tests/test_torch_mixing.py holds it against JAX):
    it takes (B, C) draws, and what still raises is a malformed call or an
    unknown mode."""
    x = torch.zeros(2, 3, 4, 4)
    lab, prob = torch.zeros(2, 4, 4, dtype=torch.int32), torch.zeros(2, 4, 4)
    out = mixing.generate_unsup_data(x, lab, prob, torch.rand(2, 5), "classmix")
    assert [tuple(t.shape) for t in out] == [(2, 3, 4, 4), (2, 4, 4), (2, 4, 4)]
    with pytest.raises(ValueError, match="draws"):
        mixing.generate_unsup_data(x, lab, prob, torch.rand(3, 5), "classmix")
    with pytest.raises(ValueError, match="unknown"):
        mixing.generate_unsup_data(x, lab, prob, torch.rand(2, 5), "mixup")


def test_draw_boxes_uses_only_the_generator():
    state = torch.random.get_rng_state()
    a = mixing.draw_boxes(torch.Generator().manual_seed(3), 64, 513, 513)
    b = mixing.draw_boxes(torch.Generator().manual_seed(3), 64, 513, 513)
    assert torch.equal(torch.random.get_rng_state(), state) and torch.equal(a, b)
    y0, x0, h, w = a.unbind(1)
    assert a.dtype == torch.int32
    assert ((w >= 257) & (w <= 512) & (x0 >= 0) & (x0 + w <= 513)).all()
    assert ((y0 >= 0) & (y0 + h <= 513) & (h >= 257)).all()


# ---- LR schedules and the optimizer -----------------------------------------

@pytest.mark.parametrize("sched", [
    dict(mode="poly", power=0.9),
    dict(mode="cosine", targetlr=1e-5),
    dict(mode="multistep"),
    dict(mode="multistep", milestones=(2, 5)),
], ids=["poly", "cosine", "multistep", "multistep_milestones"])
def test_lr_at_matches_jax(sched):
    for it in [0, 1, 7, 33, 59, 119]:
        ref = jax_lr_at(JaxLRSchedulerCfg(**sched), 0.01, jnp.asarray(it, jnp.int32), 120, 12)
        got = lr_at(LRSchedulerCfg(**sched), 0.01, torch.tensor(it, dtype=torch.int32), 120, 12)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, err_msg=str(it))


@pytest.fixture(scope="module")
def resnet10_variables():
    from test_torch_model import small_net_raw

    raw = {"net": small_net_raw(aux=True)}
    model = build_jax_model(jax_parse_config(raw).net)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)))
    return parse_config(raw), jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("kind,nesterov", [("SGD", False), ("SGD", True), ("Adam", False)])
def test_optimizer_three_steps_match_optax(resnet10_variables, kind, nesterov):
    cfg, variables = resnet10_variables
    model = build_model(cfg.net, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt_kw = dict(type=kind, lr=0.01, momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(JaxOptimizerCfg(**opt_kw), params, head_lr_multiplier=10.0)
    opt_state = tx.init(params)

    @jax.jit
    def jax_update(grads, opt_state, params, lr):
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates_with_lr(params, updates, lr), opt_state

    opt = make_optimizer(OptimizerCfg(**opt_kw), model, head_lr_multiplier=10.0)
    assert [g["lr_mult"] for g in opt.param_groups] == [1.0, 10.0]
    sched = LRSchedulerCfg(mode="poly", power=0.9)
    rng = np.random.RandomState(8)
    named = dict(model.named_parameters())
    for it in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), variables["params"]
        )
        # a parameter without a gradient counts a zero one, as in optax
        rep_bias = grads["decoder"]["rep_out"]["Conv_0"]
        rep_bias["bias"] = np.zeros_like(rep_bias["bias"])
        for name, g in flax_to_torch({"params": grads}).items():
            named[name].grad = None if name == "decoder.representation.8.bias" else g
        lr = jax_lr_at(JaxLRSchedulerCfg(mode="poly", power=0.9), 0.01, jnp.asarray(it), 30)
        params, opt_state = jax_update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params, lr
        )
        opt.step(lr_at(sched, 0.01, torch.tensor(it), 30))
        ref = torch_to_flax(model.state_dict(), {"params": variables["params"]})["params"]
        for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(ref)
        ):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {it} {jax.tree_util.keystr(path)}")
