"""The port's OHEM cross-entropy (u2pl_tpu_torch/losses/ohem.py and
ops/quantile.kth_smallest) against the JAX package's (u2pl_tpu/losses/ohem.py),
on the CPU, where every wrapper takes its plain version.

The JAX loss takes logits upsampled to label size (the JAX step's
`_upsample`); the port's takes them at their own stride and upsamples
inside, so each case feeds the same numpy logits to `_upsample` + the JAX
loss and to the port.  Tolerances: the loss rtol 1e-5 and its gradient
within 1e-6 of the gradient's max (float32 sums in other orders; measured
~1e-7 and ~2e-7); the k-th smallest bit-equal; the kept labels equal.
The logits are smooth (random at stride 4, upsampled), and most labels are
the upsampled argmax, so p_y spreads from ~0 to ~1 and the selection is
live: `min_kept` 1200 puts the k-th value above thresh 0.7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.losses import ohem as jo
from u2pl_tpu.train.steps import _upsample
from u2pl_tpu_torch.losses import ohem as to
from u2pl_tpu_torch.ops import quantile
from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

B, C, HW = 2, 19, 33
THRESH = 0.7


def ohem_case(seed, shape=(B, C, 9, 9), scale=8.0, ignore_frac=0.1):
    """(NCHW logits at stride 4, labels (B, HW, HW) int32): 70% of the labels
    the argmax of the upsampled logits, the rest random, some ignored."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    up = np.stack([resize_bilinear_numpy(xi.transpose(1, 2, 0), (HW, HW)) for xi in x])
    lab = up.argmax(-1).astype(np.int32)
    other = rng.rand(*lab.shape) < 0.3
    lab[other] = rng.randint(0, shape[1], lab.shape)[other]
    lab[rng.rand(*lab.shape) < ignore_frac] = 255
    return x, lab


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def jax_ohem_value_and_grads(xs, lab, loss_fn):
    """The JAX loss of the upsampled logits in `xs` and its gradient to each
    (NCHW, as the port's)."""
    def f(*xn):
        return loss_fn(*(_upsample(a, (HW, HW)) for a in xn), jnp.asarray(lab))

    ref, grads = jax.value_and_grad(f, argnums=tuple(range(len(xs))))(*map(_nhwc, xs))
    return float(ref), [np.asarray(g).transpose(0, 3, 1, 2) for g in grads]


def port_value_and_grads(xs, lab, loss_fn):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    loss = loss_fn(*ts, torch.from_numpy(lab))
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in ts]


def assert_close(got, ref):
    (lg, gg), (lr, gr) = got, ref
    np.testing.assert_allclose(lg, lr, rtol=1e-5)
    for a, b in zip(gg, gr):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("use_weight", [False, True])
@pytest.mark.parametrize("min_kept", [10, 50, 1200, 10000])
def test_ohem_cross_entropy_matches_jax(min_kept, use_weight):
    """min_kept 10 and 50: the threshold is thresh; 1200: the k-th value,
    above thresh; 10000: more than the valid pixels, so every one is kept."""
    x, lab = ohem_case(0)
    ref = jax_ohem_value_and_grads(
        [x], lab, lambda up, y: jo.ohem_cross_entropy(up, y, THRESH, min_kept, 255, use_weight))
    got = port_value_and_grads(
        [x], lab, lambda t, y: to.ohem_cross_entropy(t, y, THRESH, min_kept, 255, use_weight))
    assert_close(got, ref)
    p_y, num_valid = to.ohem_target_prob(torch.from_numpy(x), torch.from_numpy(lab))
    kth = float(quantile.kth_smallest(p_y, min(p_y.numel(), min_kept)))
    if min_kept == 1200:
        assert kth > THRESH and min_kept <= int(num_valid)
    if min_kept == 10000:
        assert min_kept > int(num_valid)


def test_ohem_supervised_loss_aux_pair_matches_jax():
    """The main head (os4, weighted) and the aux head (os8, never weighted),
    each upsampled inside, against `ohem_supervised_loss`; both gradients."""
    x, lab = ohem_case(1)
    aux = (np.random.RandomState(2).randn(B, C, 5, 5) * 3).astype(np.float32)
    kw = dict(aux_weight=0.4, thresh=THRESH, min_kept=1200, ignore_label=255, use_weight=True)
    ref = jax_ohem_value_and_grads(
        [x, aux], lab, lambda p, a, y: jo.ohem_supervised_loss(p, y, a, **kw))
    got = port_value_and_grads(
        [x, aux], lab, lambda p, a, y: to.ohem_supervised_loss(p, y, a, **kw))
    assert_close(got, ref)
    # use_weight reaches the main head only: the unweighted aux term is the
    # difference of the pair and the main head alone
    y = torch.from_numpy(lab)
    main = to.ohem_cross_entropy(torch.from_numpy(x), y, THRESH, 1200, 255, True)
    aux_only = to.ohem_cross_entropy(torch.from_numpy(aux), y, THRESH, 1200)
    np.testing.assert_allclose(got[0], main.item() + 0.4 * aux_only.item(), rtol=1e-6)


@pytest.mark.parametrize("use_weight", [False, True])
def test_ohem_all_ignored_is_zero(use_weight):
    x, _ = ohem_case(3)
    lab = np.full((B, HW, HW), 255, np.int32)
    ref = jax_ohem_value_and_grads(
        [x], lab, lambda up, y: jo.ohem_cross_entropy(up, y, THRESH, 50, 255, use_weight))
    got = port_value_and_grads(
        [x], lab, lambda t, y: to.ohem_cross_entropy(t, y, THRESH, 50, 255, use_weight))
    assert ref[0] == got[0] == 0.0
    assert not got[1][0].any() and not ref[1][0].any()


@pytest.mark.parametrize("min_kept", [10, 1200, 10000])
def test_target_prob_and_kept_labels_match_jax(min_kept):
    """The pieces the kernels replace, against the JAX lines they port
    (ohem.py:66-82): p_y rtol 1e-6, num_valid exact, the k-th value of
    the port's p_y bit-equal to JAX's `_kth_smallest` of it, and the kept
    labels equal (no p_y here lies within rounding of the threshold)."""
    x, lab = ohem_case(4)
    up = _upsample(_nhwc(x), (HW, HW))
    flat = up.reshape(-1, C)
    y = jnp.asarray(lab).reshape(-1)
    valid = y != 255
    p_ref = jnp.take_along_axis(jax.nn.softmax(flat, axis=-1), jnp.where(valid, y, 0)[:, None],
                                axis=-1)[:, 0]
    p_ref = np.asarray(jnp.where(valid, p_ref, 1.0)).reshape(lab.shape)

    p_y, num_valid = to.ohem_target_prob(torch.from_numpy(x), torch.from_numpy(lab))
    np.testing.assert_allclose(p_y.numpy(), p_ref, rtol=1e-6)
    assert int(num_valid) == int(valid.sum()) and num_valid.dtype == torch.int32
    k = min(p_y.numel(), min_kept)
    kth = quantile.kth_smallest(p_y, k)
    want = np.asarray(jo._kth_smallest(jnp.asarray(p_y.numpy().reshape(-1)), k))
    assert kth.numpy().tobytes() == want.tobytes()

    kept = to.ohem_keep_labels(torch.from_numpy(lab), p_y, kth, num_valid, THRESH, min_kept)
    threshold = np.maximum(np.float32(THRESH), np.float32(want))
    apply = 0 < int(num_valid) and min_kept <= int(num_valid)
    keep = (lab != 255) & ((p_y.numpy() <= threshold) if apply else True)
    np.testing.assert_array_equal(kept.numpy(), np.where(keep, lab, 255))
    assert kept.dtype == torch.int32


def test_kth_smallest_bit_equal_to_jax():
    """The tie-heavy cases of tests/test_losses.py:134 (a tie block at 0.5,
    the ignored-pixel filler 1.0, k == n and k == 1): the port's
    `kth_smallest` (its plain version on the CPU) bit-equal to JAX's."""
    rng = np.random.RandomState(7)
    for n, k in [(1000, 100), (5000, 1000), (4096, 4096), (333, 1)]:
        p = rng.rand(n).astype(np.float32)
        p[rng.rand(n) < 0.3] = np.float32(0.5)
        p[rng.rand(n) < 0.1] = np.float32(1.0)
        want = np.asarray(jo._kth_smallest(jnp.asarray(p), k))
        for fn in (quantile.kth_smallest, quantile.kth_smallest_plain):
            got = fn(torch.from_numpy(p), k)
            assert got.dim() == 0 and got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes(), (n, k, fn.__name__)
    with pytest.raises(ValueError):
        quantile.kth_smallest(torch.zeros(4), 5)


def test_ohem_sup_step_matches_jax():
    """`make_sup_step` on the Cityscapes-shaped OHEM config with the aux
    head (thresh 0.1, min_kept 1700; on these 4 images the threshold is
    thresh) against JAX's, in tests/test_torch_train_step.py's pattern."""
    from test_torch_train_step import assert_sup_step_close, city_raw_cfg, sup_step_case

    assert_sup_step_close(sup_step_case(city_raw_cfg()), "ohem sup step")
