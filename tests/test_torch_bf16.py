"""The port under `net.dtype: bfloat16` against the JAX package's bf16
policy, on the CPU (every wrapper takes its plain version there).

Each case runs the JAX function on bf16 inputs and the port's on the same
numpy inputs and weights (`flax_to_torch`).  The tolerance is measured,
not chosen: for each compared tensor E_ref is the gap of JAX bf16 to JAX
f32 on the same inputs (tests/test_bf16.py's measure), and the port in bf16
must lie within 0.5 x E_ref of JAX bf16, in mean and in max abs
(`hold_half`), which a port that silently computed in f32 fails.  Where the
arithmetic is exact the port is held to the bit: the wide resize's
forward, the anchor rows' scatter-add order, K5's copy.  Where one f32 ulp
can flip a bf16 rounding (the narrow resize, its VJP, the statistics of
the rounded upsample) the port is held to: equal except at bf16 rounding
boundaries, each difference at most 1 bf16 ulp and its f32 value within a
few f32 ulps of the midpoint between two bf16 values, with the count of
such elements asserted small and reported (`hold_boundaries`); the
statistics are then held equal (rtol 1e-6) at every pixel whose upsampled
values all agree.

`pytest -s tests/test_torch_bf16.py` prints what each comparison measured
(the port's gap and E_ref), the values CHANGES.md records.
"""

import concurrent.futures
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_contrastive import B_L, C as CC
from test_torch_contrastive import banks, cfgs, inputs, jax_draws, nhwc
from test_torch_model import perturbed_flax_variables, small_net_raw
from test_torch_train_step import CONTRA, city_raw_cfg, raw_cfg
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.losses import contrastive as jc
from u2pl_tpu.losses import ohem as jo
from u2pl_tpu.losses.ce import cross_entropy_ignore as jax_ce
from u2pl_tpu.losses.unsup import teacher_entropy as jax_entropy
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.one_hot import label_onehot as jax_onehot
from u2pl_tpu.ops.resize import resize_bilinear as jax_resize
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.losses import ce as tce
from u2pl_tpu_torch.losses import contrastive as tc
from u2pl_tpu_torch.losses import ohem as to
from u2pl_tpu_torch.losses import unsup as tu
from u2pl_tpu_torch.memobank import memobank_enqueue_plain
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.models.builder import computing_in
from u2pl_tpu_torch.models.decoder import Dropout2d
from u2pl_tpu_torch.ops import resize as tr
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

BF16 = ml_dtypes.bfloat16
MEASURED = {}  # name -> what the comparison measured


@pytest.fixture(scope="module", autouse=True)
def report():
    yield
    for name, m in MEASURED.items():
        print(f"[bf16] {name}: " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                                             else f"{k} {v}" for k, v in m.items()))


def f64(a):
    if torch.is_tensor(a):
        a = a.detach().float().numpy()
    return np.asarray(np.asarray(a).astype(np.float32), np.float64)


def gaps(a, b):
    d = np.abs(f64(a) - f64(b))
    return float(d.mean()), float(d.max())


def hold_half(name, port, jbf, jf32, rounded=False):
    """The port's bf16 result within half of JAX's own bf16-to-f32 gap, in
    mean and in max abs.  `rounded`: a tensor rounded to bf16 element by
    element (a gradient, a model output), where one f32 ulp upstream can
    move an element by one bf16 ulp: there the max is held per element,
    each beyond half the gap at most 1 bf16 ulp off, and such elements
    counted (at most 1% of the tensor)."""
    e_mean, e_max = gaps(jbf, jf32)
    g_mean, g_max = gaps(port, jbf)
    m = MEASURED[name] = {"port_mean": g_mean, "port_max": g_max, "ref_mean": e_mean,
                          "ref_max": e_max}
    assert e_max > 0, f"{name}: JAX's bf16 equals its f32, there is no bf16 gap to hold to"
    assert g_mean <= 0.5 * e_mean, (name, m)
    if not rounded:
        assert g_max <= 0.5 * e_max, (name, m)
        return
    a, b = f64(port), f64(jbf)
    over = np.abs(a - b) > 0.5 * e_max
    m["one_ulp_flips"] = int(over.sum())
    assert np.all((np.abs(a - b) <= bf16_ulp(np.maximum(np.abs(a), np.abs(b))))[over]), (name, m)
    assert over.sum() <= 0.01 * over.size, (name, m)


def bf16_ulp(x):
    x = np.abs(f64(x))
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def near_midpoint(v32, slack):
    """Whether each f32 value lies within `slack` (absolute, per element) of
    the midpoint of the two bf16 values around it, where a few f32 ulps can
    flip its rounding."""
    v = f64(v32)
    lo = f64(np.asarray(v, np.float32).astype(BF16))
    step = bf16_ulp(lo)
    other = np.where(v >= lo, lo + step, lo - step)
    return np.abs(v - (lo + other) / 2) <= slack


def hold_boundaries(name, port, jbf, unrounded, scale, max_frac=0.01):
    """bf16 results equal but at bf16 rounding boundaries.  The two sides'
    f32 values before rounding may differ by a few f32 ulps of the summed
    terms (`scale`: their magnitude), so each differing element is at most
    1 bf16 ulp plus that slack off, its unrounded value (JAX's f32 path)
    within that slack of a rounding midpoint, and few of them differ.
    Returns the mask of the differing elements."""
    a, b = f64(port), f64(jbf)
    diff = a != b
    n = int(diff.sum())
    MEASURED[name] = {"differing": n, "of": int(diff.size)}
    slack = 8 * np.finfo(np.float32).eps * (np.abs(f64(unrounded)) + float(scale))
    assert np.all((np.abs(a - b) <= bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + slack)[diff]), name
    assert np.all(near_midpoint(unrounded, slack)[diff]), name
    assert n <= max_frac * diff.size, (name, n)
    return diff


def to_bf16_np(a):
    return np.asarray(a, np.float32).astype(BF16).astype(np.float32)


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


# ---- the resize, both branches, forward and VJP -----------------------------

RESIZES = {  # name -> (B, C, h, w, oh, ow): wide 64 channels x2, narrow 5 classes x4
    "wide": (2, 64, 9, 9, 17, 17),
    "narrow": (2, 5, 9, 9, 33, 33),
    "wide_ratio_not_exact": (1, 64, 9, 7, 20, 13),
}


def _resize_case(key, seed=0):
    b, c, h, w, oh, ow = RESIZES[key]
    rng = np.random.RandomState(seed)
    x = to_bf16_np(rng.randn(b, c, h, w) * 3)
    g = to_bf16_np(rng.randn(b, c, oh, ow))
    return x, g, (oh, ow)


def _jax_resize_vjp(x, g, size, dtype):
    def f(xn):
        return jax_resize(xn, size)
    y, vjp = jax.vjp(f, jnp.asarray(np.moveaxis(x, 1, -1), dtype))
    (gx,) = vjp(jnp.asarray(np.moveaxis(g, 1, -1), dtype))
    return nchw(y.astype(jnp.float32)), nchw(gx.astype(jnp.float32))


@pytest.mark.parametrize("key", list(RESIZES))
def test_resize_branches_forward_and_vjp(key):
    x, g, size = _resize_case(key)
    c, (h, w) = x.shape[1], x.shape[2:]
    wide = tr._wide(torch.bfloat16, c, (h, w), size, True)
    assert wide == (key == "wide")
    y_bf, gx_bf = _jax_resize_vjp(x, g, size, jnp.bfloat16)
    y_32, gx_32 = _jax_resize_vjp(x, g, size, jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = tr.resize_bilinear(xt, size)
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    if wide:  # every product exact: the port's two passes are JAX's, bit for bit
        np.testing.assert_array_equal(f64(y), f64(y_bf))
    else:
        hold_boundaries(f"resize {key} forward", y, y_bf, y_32, np.abs(x).max())
    hold_boundaries(f"resize {key} VJP", xt.grad, gx_bf, _wide_vjp_unrounded(g, x, size, wide)
                    if wide else gx_32, 4 * np.abs(g).max())
    # kernel A's own arithmetic in its bf16 mode (what the card is held to)
    rounded = tr.resize_bilinear_rounded(torch.from_numpy(x).to(torch.bfloat16), size)
    assert rounded.dtype == torch.bfloat16
    if wide:
        np.testing.assert_array_equal(f64(rounded), f64(y_bf))
    else:
        hold_boundaries(f"resize {key} kernel A's arithmetic", rounded, y_bf, y_32,
                        np.abs(x).max())


def _wide_vjp_unrounded(g, x, size, wide):
    """The wide VJP's result before its last rounding (the W sum rounded,
    the H sum in f32), in f32: the value whose rounding the port and JAX
    may take to neighbouring bf16 values."""
    h, w = x.shape[2:]
    wh = tr._interp_matrix_np(h, size[0], True)
    ww = tr._interp_matrix_np(w, size[1], True)
    s = to_bf16_np(np.einsum("pw,bcop->bcow", ww, g))
    return np.einsum("oh,bcow->bchw", wh, s).astype(np.float32)


# ---- CE, statistics, OHEM ----------------------------------------------------

HW = 33


def logits_case(seed, c=5, scale=4.0):
    rng = np.random.RandomState(seed)
    x = to_bf16_np(rng.randn(2, c, 9, 9) * scale)
    lab = rng.randint(0, c, (2, HW, HW)).astype(np.int32)
    lab[rng.rand(2, HW, HW) < 0.1] = 255
    return x, lab


def _jax_up(x, dtype):
    return jax_resize(jnp.asarray(np.moveaxis(x, 1, -1), dtype), (HW, HW))


@pytest.mark.parametrize("weighted", [False, True])
def test_ce_value_and_gradient(weighted):
    x, lab = logits_case(1, c=19)
    cw = np.asarray(tce.CITYSCAPES_BINARY_WEIGHT, np.float32) if weighted else None

    def jax_loss(xn):
        return jax_ce(jax_resize(xn, (HW, HW)), jnp.asarray(lab), 255,
                      None if cw is None else jnp.asarray(cw))

    refs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        v, gr = jax.value_and_grad(jax_loss)(jnp.asarray(np.moveaxis(x, 1, -1), dt))
        refs[dt] = (float(v), nchw(gr.astype(jnp.float32)))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    loss = tce.upsample_cross_entropy(xt, torch.from_numpy(lab), 255,
                                      None if cw is None else torch.from_numpy(cw))
    loss.backward()
    assert loss.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    name = f"CE{' weighted' if weighted else ''}"
    hold_half(f"{name} value", loss.item(), refs[jnp.bfloat16][0], refs[jnp.float32][0])
    hold_half(f"{name} gradient", xt.grad, refs[jnp.bfloat16][1], refs[jnp.float32][1],
              rounded=True)
    # the written-out backward (kernel C's plain version) is autograd's, bit for bit
    gplain = tce.upsample_ce_bwd_plain(xt.detach(), torch.from_numpy(lab),
                                       None if cw is None else torch.from_numpy(cw))
    assert gplain.dtype == torch.bfloat16
    hold_half(f"{name} gradient, upsample_ce_bwd_plain", gplain, refs[jnp.bfloat16][1],
              refs[jnp.float32][1], rounded=True)


def _agreeing_pixels(port_up, jax_up):
    """Pixels whose C upsampled bf16 values the port and JAX agree on."""
    return np.all(f64(port_up) == f64(jax_up), axis=1)


def test_softmax_stats_of_the_rounded_upsample():
    x, _ = logits_case(2, c=21, scale=2.0)
    x[:, 3] = x[:, 5]  # exact ties between classes 3 and 5: argmax keeps 3
    up_bf = _jax_up(x, jnp.bfloat16)
    up_32 = _jax_up(x, jnp.float32)
    pt32 = up_bf.astype(jnp.float32)
    ref_mp = np.asarray(jnp.exp(pt32.max(-1) - jax.nn.logsumexp(pt32, -1)))
    ref_am = np.asarray(up_bf.argmax(-1))
    ref_en = np.asarray(jax_entropy(up_bf))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    mp, am, en = tu.upsample_softmax_stats(xt, (HW, HW), outputs="all")
    port_up = tr.resize_bilinear_plain(xt, (HW, HW))
    hold_boundaries("stats: the upsample", port_up, nchw(up_bf.astype(jnp.float32)), nchw(up_32),
                    np.abs(x).max())
    ok = _agreeing_pixels(port_up, nchw(up_bf.astype(jnp.float32)))
    MEASURED["stats: pixels with a flipped upsampled value"] = {"n": int((~ok).sum())}
    np.testing.assert_array_equal(am.numpy()[ok], ref_am[ok])
    np.testing.assert_allclose(mp.numpy()[ok], ref_mp[ok], rtol=1e-6)
    np.testing.assert_allclose(en.numpy()[ok], ref_en[ok], rtol=1e-6, atol=1e-7)
    tied = (f64(up_bf[..., 3]) == f64(up_bf.max(-1))) & ok
    assert tied.sum() > 0 and np.all(am.numpy()[tied] == 3)


def test_ohem_target_prob_and_loss():
    x, lab = logits_case(3, c=19, scale=3.0)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p_y, nv = to.ohem_target_prob(xt, torch.from_numpy(lab))
    up_bf = _jax_up(x, jnp.bfloat16)
    flat = up_bf.reshape(-1, 19).astype(jnp.float32)
    prob = jax.nn.softmax(flat, -1)
    lab_f = lab.reshape(-1)
    valid = lab_f != 255
    ref = np.where(valid, np.asarray(prob)[np.arange(lab_f.size), np.where(valid, lab_f, 0)], 1.0)
    ok = _agreeing_pixels(tr.resize_bilinear_plain(xt, (HW, HW)),
                          nchw(up_bf.astype(jnp.float32))).reshape(-1)
    np.testing.assert_allclose(p_y.numpy().reshape(-1)[ok], ref[ok], rtol=1e-6)
    assert int(nv) == int(valid.sum())

    def jax_loss(xn, an):
        return jo.ohem_supervised_loss(jax_resize(xn, (HW, HW)), jnp.asarray(lab),
                                       jax_resize(an, (HW, HW)), 0.4, 0.7, 600, 255, True)

    refs = {}
    aux = to_bf16_np(np.random.RandomState(4).randn(*x.shape) * 3)
    for dt in (jnp.bfloat16, jnp.float32):
        v, gr = jax.value_and_grad(jax_loss, argnums=(0, 1))(
            *(jnp.asarray(np.moveaxis(a, 1, -1), dt) for a in (x, aux)))
        refs[dt] = (float(v), [nchw(g.astype(jnp.float32)) for g in gr])
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (x, aux)]
    loss = to.ohem_supervised_loss(ts[0], torch.from_numpy(lab), ts[1], 0.4, 0.7, 600, 255, True)
    loss.backward()
    hold_half("OHEM + aux value", loss.item(), refs[jnp.bfloat16][0], refs[jnp.float32][0])
    for i, head in enumerate(("main", "aux")):
        hold_half(f"OHEM {head} gradient", ts[i].grad, refs[jnp.bfloat16][1][i],
                  refs[jnp.float32][1][i], rounded=True)


# ---- contrastive ---------------------------------------------------------------

def test_anchor_rows_scatter_in_xla_order():
    """`rep_f[idx].astype(f32)`'s VJP: JAX scatter-adds the bf16-rounded
    rows in (C, Q) order, each add rounded to bf16 (not summed in f32 and
    rounded once, nor in another order); `_AnchorRows` is bit-equal to it
    with many duplicate draws and rows of very different magnitudes."""
    rng = np.random.RandomState(5)
    b, f, h, w = 2, 16, 3, 3
    idx = rng.randint(0, 4, (6, 8)).astype(np.int32)  # 48 draws on 4 pixels
    g = (rng.randn(6, 8, f) * 10.0 ** rng.randint(-3, 3, (6, 8, 1))).astype(np.float32)
    rep = to_bf16_np(rng.randn(b, f, h, w))

    def jf(r):
        return r.reshape(-1, f)[jnp.asarray(idx)].astype(jnp.float32)

    _, vjp = jax.vjp(jf, jnp.asarray(np.moveaxis(rep, 1, -1), jnp.bfloat16))
    ref = nchw(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    rt = torch.from_numpy(rep).to(torch.bfloat16).requires_grad_(True)
    rows = tc.anchor_rows(rt, torch.from_numpy(idx))
    assert rows.dtype == torch.float32
    np.testing.assert_array_equal(rows.detach().numpy(), nhwc_rows(rep, idx))
    rows.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(f64(rt.grad), f64(ref))
    # the same sums in f32, rounded once, differ: the order is what is tested
    once = np.zeros((b * h * w, f), np.float32)
    np.add.at(once, idx.reshape(-1), to_bf16_np(g.reshape(-1, f)))
    assert not np.array_equal(to_bf16_np(once), np.moveaxis(ref, 1, -1).reshape(-1, f))


def nhwc_rows(rep, idx):
    return np.moveaxis(rep, 1, -1).reshape(-1, rep.shape[1])[idx]


def _contra_run(rep_dtype, bank_dtype, seed=0, momentum=None):
    """(loss, rep gradient) of the JAX loss with `rep_dtype` reps on a
    `bank_dtype` bank (float32: on the data before its bf16 rounding), and
    the port's inputs; with a (C, Q, 1, F) `momentum` prototype (anchor_ema,
    at i_iter ANCHOR_EMA_ITER) also JAX's new prototype, after the gradient."""
    jcfg, cfg = cfgs(anchor_ema=momentum is not None)
    rep, rep_t, prob, labels, low, high = inputs(seed)
    if rep_dtype == jnp.bfloat16:  # the f32 reference takes the unrounded data
        rep, rep_t = to_bf16_np(rep), to_bf16_np(rep_t)
    jbank, bank = banks(seed, dtype=bank_dtype)
    rng = jax.random.PRNGKey(100 + seed)
    onehot = jax_onehot(jnp.asarray(labels), CC)
    ema = {} if momentum is None else {"prototype": jnp.asarray(momentum),
                                       "i_iter": jnp.asarray(ANCHOR_EMA_ITER, jnp.int32)}

    def jax_loss(rep_nhwc):
        *proto, _, loss = jc.compute_contra_memobank_loss(
            rep_nhwc, onehot[:B_L], onehot[B_L:], nhwc(prob[:B_L]), nhwc(prob[B_L:]),
            jnp.asarray(low, jnp.float32)[..., None], jnp.asarray(high, jnp.float32)[..., None],
            jcfg, jbank, nhwc(rep_t).astype(rep_dtype), rng, **ema)
        return loss, proto

    (v, proto), gr = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        nhwc(rep).astype(rep_dtype))
    ref = (float(v), nchw(gr.astype(jnp.float32))) + tuple(np.asarray(p) for p in proto)
    return ref, (rep, rep_t, prob, labels, low, high, bank, rng, cfg)


@pytest.mark.parametrize("bank_dtype", ["bfloat16", "float32"])
def test_contrastive_loss_and_gradient(bank_dtype):
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[bank_dtype]
    ref_bf, args = _contra_run(jnp.bfloat16, jdt)
    ref_32, _ = _contra_run(jnp.float32, jdt)
    rep, rep_t, prob, labels, low, high, bank, rng, cfg = args
    rt = torch.from_numpy(rep).to(torch.bfloat16).requires_grad_(True)
    draws = jax_draws(rng, cfg.num_queries, cfg.num_negatives)
    lab, pt = torch.from_numpy(labels), torch.from_numpy(prob)
    seen = []
    original = tc.sample_anchors

    def recording(mask, a_j, u):
        idx, n = original(mask, a_j, u)
        seen.append(idx)
        return idx, n

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tc, "sample_anchors", recording)
        _, loss = tc.compute_contra_memobank_loss(
            rt, lab[:B_L], lab[B_L:], pt[:B_L], pt[B_L:], torch.from_numpy(low),
            torch.from_numpy(high), cfg, bank,
            torch.from_numpy(rep_t).to(torch.bfloat16), draws)
    loss.backward()
    flat = seen[0].reshape(-1)
    assert flat.unique().numel() < flat.numel()  # duplicate anchor draws
    assert rt.grad.dtype == torch.bfloat16
    hold_half(f"contrastive loss, {bank_dtype} bank", loss.item(), ref_bf[0], ref_32[0])
    hold_half(f"contrastive rep gradient, {bank_dtype} bank", rt.grad, ref_bf[1], ref_32[1],
              rounded=True)


ANCHOR_EMA_ITER = 37


@pytest.mark.parametrize("bank_dtype", ["bfloat16", "float32"])
def test_contrastive_anchor_ema(bank_dtype):
    """`contrastive.anchor_ema` on a bf16 rep: the blended (C, Q, F) float32
    positive through the dot-first path (bf16 bank) or normalise-then-dot
    (f32 bank); loss and rep gradient within half of JAX's bf16-vs-f32 gap
    as above, the new prototype (f32, from the bf16 teacher rep's f32-
    accumulated prototype) rtol 1e-5, atol 1e-6 of JAX's bf16 run."""
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[bank_dtype]
    momentum = np.random.RandomState(8).randn(CC, 8, 1, 256).astype(np.float32)
    ref_bf, args = _contra_run(jnp.bfloat16, jdt, momentum=momentum)
    ref_32, _ = _contra_run(jnp.float32, jdt, momentum=momentum)
    rep, rep_t, prob, labels, low, high, bank, rng, cfg = args
    rt = torch.from_numpy(rep).to(torch.bfloat16).requires_grad_(True)
    draws = jax_draws(rng, cfg.num_queries, cfg.num_negatives)
    lab, pt = torch.from_numpy(labels), torch.from_numpy(prob)
    proto, _, loss = tc.compute_contra_memobank_loss(
        rt, lab[:B_L], lab[B_L:], pt[:B_L], pt[B_L:], torch.from_numpy(low),
        torch.from_numpy(high), cfg, bank, torch.from_numpy(rep_t).to(torch.bfloat16), draws,
        prototype=torch.from_numpy(momentum), i_iter=torch.tensor(ANCHOR_EMA_ITER))
    loss.backward()
    assert rt.grad.dtype == torch.bfloat16 and proto.dtype == torch.float32
    hold_half(f"anchor_ema loss, {bank_dtype} bank", loss.item(), ref_bf[0], ref_32[0])
    hold_half(f"anchor_ema rep gradient, {bank_dtype} bank", rt.grad, ref_bf[1], ref_32[1],
              rounded=True)
    np.testing.assert_allclose(proto.numpy(), ref_bf[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bank_dtype", [torch.bfloat16, torch.float32])
def test_memobank_enqueue_of_a_bf16_rep_is_exact(bank_dtype):
    """K5's plain version on a bf16 rep: a bf16 bank takes the rows bit for
    bit, an f32 bank their widened values (JAX gathers in the rep's dtype
    and the bank casts on write)."""
    from u2pl_tpu_torch.memobank import init_memobank

    rng = np.random.RandomState(6)
    rep = torch.from_numpy(rng.randn(2, 16, 5, 5).astype(np.float32)).to(torch.bfloat16)
    sel = torch.from_numpy(rng.randint(0, 50, (3, 7)).astype(np.int32))
    n_sel = torch.tensor([7, 3, 0], dtype=torch.int32)
    bank = init_memobank(3, 16, queue_size=10, class0_size=10, dtype=bank_dtype, device="cpu")
    memobank_enqueue_plain(bank, rep, sel, n_sel)
    rows = rep.permute(0, 2, 3, 1).reshape(-1, 16)[sel.long()]
    assert bank.keys.dtype == bank_dtype
    assert torch.equal(bank.keys[0, :7], rows[0].to(bank_dtype))
    assert torch.equal(bank.keys[1, :3], rows[1, :3].to(bank_dtype))
    assert torch.equal(bank.keys[0, :7].float(), rows[0].float())


# ---- the model -------------------------------------------------------------------

def _with_dtype(raw_net, dtype):
    return {**raw_net, "dtype": dtype}


@pytest.fixture(scope="module")
def model_case():
    """flax's model (aux head) in bf16 and in f32 on one set of perturbed
    weights, the port's bf16 model on them, and a 33² image."""
    raws = {dt: {"net": _with_dtype(small_net_raw(aux=True), dt)} for dt in ("bfloat16", "float32")}
    jmodels = {dt: build_jax_model(jax_parse_config(r).net) for dt, r in raws.items()}

    class JitInit:
        init = staticmethod(jax.jit(jmodels["float32"].init, static_argnames="train"))

    variables = perturbed_flax_variables(JitInit)
    tmodel = build_model(parse_config(raws["bfloat16"]).net, device="cpu")
    assert tmodel.dtype == torch.bfloat16
    tmodel.load_state_dict(flax_to_torch(variables), strict=True)
    for m in tmodel.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    x = np.random.RandomState(12).randn(2, 33, 33, 3).astype(np.float32)
    return jmodels, variables, tmodel, x


def _flax_forward(jmodel, variables, x, train, jit):
    """(outputs, the encoder's layer1 output, the BN statistics after a
    train-mode forward as a torch state dict, or None).  bf16 runs op by
    op (`jit` False), as the jaxpr reads: under `jit` XLA may keep excess
    precision inside a fusion (its default `xla_allow_excess_precision`)
    and skip some of the bf16 roundings the jaxpr has."""
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    apply = functools.partial(jmodel.apply, train=train, mutable=mutable,
                              capture_intermediates=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, v, **kw: v)
        out, mut = (jax.jit(apply) if jit else apply)(variables, jnp.asarray(x))
    layer1 = nchw(mut["intermediates"]["encoder"]["layer1_0"]["__call__"][0].astype(jnp.float32))
    stats = flax_to_torch({"params": variables["params"], "batch_stats": mut["batch_stats"]}) \
        if train else None
    return out, layer1, stats


@pytest.mark.parametrize("train", [False, True])
def test_model_forward(model_case, train):
    """The eval- and train-mode forward, and the BN running statistics after
    one train-mode forward; parameters stay f32.

    Where the rounding points decide, the port is held to 0.5 x E_ref: the
    encoder's layer1 output (the stem, its BNs and the first block).  The
    outputs (pred, rep, aux) lie tens of layers deeper: there the two
    frameworks' f32 sums in other orders flip a bf16 rounding in ~0.25% of
    a 1x1 conv's outputs (measured at layer3's 512-channel convs), and the
    network amplifies those flips as it amplifies rounding noise, so the
    port's gap to JAX's bf16 is a random share of E_ref (measured 0.05 to
    0.84 over four weight / batch variants of this model).  The outputs are
    held below E_ref, nearer JAX's bf16 than JAX's f32 is, and the share
    reported; each layer kind's rounding is held to 0.5 x E_ref on one
    input in `test_layers_round_where_flax_rounds`."""
    jmodels, variables, tmodel, x = model_case
    refs = {dt: _flax_forward(jm, variables, x, train, jit=dt == "float32")
            for dt, jm in jmodels.items()}
    tmodel.load_state_dict(flax_to_torch(variables), strict=True)
    tmodel.train(train)
    layer1 = []
    hook = tmodel.encoder.layer1.register_forward_hook(lambda m, i, o: layer1.append(o))
    try:
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    finally:
        hook.remove()
    mode = "train" if train else "eval"
    hold_half(f"model {mode} layer1", layer1[0], refs["bfloat16"][1], refs["float32"][1],
              rounded=True)
    for k in ("pred", "rep", "aux"):
        assert out[k].dtype == torch.bfloat16, k
        ref_bf, ref_32 = (nchw(refs[dt][0][k].astype(jnp.float32)) for dt in ("bfloat16", "float32"))
        e_mean, e_max = gaps(ref_bf, ref_32)
        g_mean, g_max = gaps(out[k], ref_bf)
        MEASURED[f"model {mode} {k}"] = {"port_mean": g_mean, "port_max": g_max,
                                         "ref_mean": e_mean, "ref_max": e_max,
                                         "share_mean": g_mean / e_mean}
        assert g_mean < e_mean and g_max < e_max, (k, MEASURED[f"model {mode} {k}"])
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    if train:
        sd = tmodel.state_dict()
        stem = ("encoder.conv1.1.", "encoder.conv1.4.", "encoder.bn1.", "encoder.layer1.")
        for k in [k for k in refs["bfloat16"][2] if k.endswith(("running_mean", "running_var"))]:
            assert sd[k].dtype == torch.float32
            if k.startswith(stem):
                hold_half(f"model train BN {k}", sd[k], refs["bfloat16"][2][k].numpy(),
                          refs["float32"][2][k].numpy())
            else:
                assert gaps(sd[k], refs["bfloat16"][2][k]) < gaps(refs["bfloat16"][2][k],
                                                                  refs["float32"][2][k]), k
    # a float32 forward of the same model (validation): the f32 model's outputs
    tmodel.eval()
    with torch.no_grad(), computing_in(tmodel, torch.float32):
        out32 = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert tmodel.dtype == torch.bfloat16 and out32["pred"].dtype == torch.float32
    if not train:
        ref = np.asarray(refs["float32"][0]["pred"])
        np.testing.assert_allclose(out32["pred"].numpy(), nchw(ref), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()))


LAYERS = ("aspp_eval", "aspp_train", "aux_head_eval")


@pytest.mark.parametrize("kind", LAYERS)
def test_layers_round_where_flax_rounds(kind):
    """One module of each kind of layer on the same bf16 input in both
    packages, held to 0.5 x E_ref (E_ref: the flax module in f32 on the f32
    input): the ASPP (the f32 image-pool mean cast to bf16, 1x1 and dilated
    3x3 convs, BN in eval and train mode with its running statistics) and
    the aux head (a 3x3 conv with its bias added apart, BN, a 1x1 conv with
    bias); weights and BN statistics perturbed as in test_torch_model.py."""
    from u2pl_tpu.models.decoder import ASPP as JaxASPP
    from u2pl_tpu.models.decoder import AuxHead as JaxAux
    from u2pl_tpu_torch.models.decoder import ASPP, AuxHead

    train = kind.endswith("train")
    rng = np.random.RandomState(14)
    x = rng.randn(2, 9, 9, 64).astype(np.float32) * 2
    if kind.startswith("aspp"):
        make = lambda dt: JaxASPP(16, (2, 4, 6), dtype=dt)  # noqa: E731
        port, prefix = ASPP(64, 16, (2, 4, 6)), ("decoder", "aspp")
    else:
        make = lambda dt: JaxAux(5, dtype=dt)  # noqa: E731
        port, prefix = AuxHead(64, 5), ("auxor",)
    variables = make(jnp.float32).init(jax.random.PRNGKey(3), jnp.asarray(x))

    def perturb(tree, name=None):
        if hasattr(tree, "items"):
            return {k: perturb(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "kernel":
            return a
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    variables = perturb(variables)
    wrapped = {col: functools.reduce(lambda t, k: {k: t}, reversed(prefix), tree)
               for col, tree in variables.items()}
    strip = ".".join(prefix) + "."
    port.load_state_dict({k[len(strip):]: v for k, v in flax_to_torch(wrapped).items()},
                         strict=True)
    port.train(train)
    outs, stats = {}, {}
    for dt in (jnp.bfloat16, jnp.float32):
        xin = jnp.asarray(x, dt)
        if train:
            outs[dt], mut = make(dt).apply(variables, xin, train=True, mutable=["batch_stats"])
            stats[dt] = flax_to_torch({"batch_stats": functools.reduce(
                lambda t, k: {k: t}, reversed(prefix), mut["batch_stats"])})
        else:
            outs[dt] = make(dt).apply(variables, xin, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(np.moveaxis(x, -1, 1)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    hold_half(f"layer {kind}", got, nchw(outs[jnp.bfloat16].astype(jnp.float32)),
              nchw(outs[jnp.float32]), rounded=True)
    if train:
        psd = port.state_dict()
        for k, v in stats[jnp.bfloat16].items():
            if k.endswith(("running_mean", "running_var")):
                hold_half(f"layer {kind} {k}", psd[k[len(strip):]], v.numpy(),
                          stats[jnp.float32][k].numpy())


def test_dropout_divides_in_bf16():
    """flax's Dropout under bf16 divides by 1 - p rounded to bf16, in bf16;
    the port's Dropout2d on the same mask (all channels kept) gives it bit
    for bit, and keeps the keep probability's draw float32."""
    x = to_bf16_np(np.random.RandomState(13).randn(2, 4, 3, 3) * 3)
    ref = np.asarray((jnp.asarray(x, jnp.bfloat16) / 0.9).astype(jnp.float32))
    m = Dropout2d(1e-30).train()  # keeps every channel; divides by 1 - p
    m.p = 0.1
    g = torch.Generator().manual_seed(0)
    m.generator = g
    keep = torch.bernoulli(torch.full((2, 4, 1, 1), 0.9), generator=torch.Generator().manual_seed(0))
    y = m(torch.from_numpy(x).to(torch.bfloat16))
    kept = keep.bool().expand(2, 4, 3, 3).numpy()
    np.testing.assert_array_equal(f64(y)[kept], f64(ref)[kept])
    assert np.all(f64(y)[~kept] == 0)


# ---- the steps ---------------------------------------------------------------------

def _bf16_trajectory(raw, steps=3):
    """JAX's trajectory (warmup, first semi epoch, epoch 2) under
    `net.dtype: bfloat16`; the port's bf16 step runs from JAX's state
    before each step.  Returns (before, jax_after, port_after), each
    `after` a list of (scalar metrics, student, teacher, bank) per step."""
    from test_torch_train_step import (
        BANK, B, HW as THW, _jax_snapshot, _np_bank, _np_tree, _port_state, batches, jax_contra,
        jax_mix)
    from u2pl_tpu.config import head_lr_multiplier as jax_head_lr_multiplier
    from u2pl_tpu.dist import make_mesh
    from u2pl_tpu.memobank import init_memobank as jax_init_memobank
    from u2pl_tpu.train.optim import make_optimizer as jax_make_optimizer
    from u2pl_tpu.train.state import TrainState, copy_student_to_teacher as jax_copy
    from u2pl_tpu.train.steps import make_semi_step as jax_semi_step
    from u2pl_tpu.train.steps import make_semi_warmup_step as jax_warmup_step
    from u2pl_tpu_torch.ops.mixing import boxes_from_uniforms
    from u2pl_tpu_torch.train.steps import run_steps

    raw = {**raw, "net": {**raw["net"], "dtype": "bfloat16"}}
    jcfg, cfg = jax_parse_config(raw), parse_config(raw)
    contra = jcfg.trainer.contrastive
    data = batches()[:steps]
    seed = next(s for s in range(64)
                if all(jax_mix(jax.random.PRNGKey(s), i)[0] for i in (1, 2)))
    rng = jax.random.PRNGKey(seed)
    init_model = build_jax_model(jcfg.net)
    variables = _np_tree(jax.jit(lambda k, x: init_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, THW, THW, 3))))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bstats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = jax_make_optimizer(jcfg.trainer.optimizer, params,
                            head_lr_multiplier=jax_head_lr_multiplier(jcfg))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=bstats,
        opt_state=tx.init(params), teacher_params=jax.tree_util.tree_map(jnp.copy, params),
        teacher_batch_stats=jax.tree_util.tree_map(jnp.copy, bstats),
        bank=jax_init_memobank(5, 256, **BANK) if contra else None,
        prototype=jnp.zeros((5, contra.num_queries, 1, 256)) if contra else None)
    before, jax_after = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        model = build_jax_model(jcfg.net, axis_name="data")
        mesh = make_mesh(1)
        args = (state, *(jnp.asarray(a) for a in data[0]), rng)
        # the two programs compile side by side (XLA compiles outside the GIL)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            warmup, semi = pool.map(lambda make: make(jcfg, model, tx, 1, mesh).lower(*args).compile(),
                                    (jax_warmup_step, jax_semi_step))
        for i, (img_l, lab_l, img_u) in enumerate(data):
            before.append(_jax_snapshot(state))
            if i == 1:
                state = jax_copy(state)
            state, m = (warmup if i == 0 else semi)(
                state, jnp.asarray(img_l), jnp.asarray(lab_l), jnp.asarray(img_u), rng)
            m = jax.device_get(m)
            jax_after.append((
                {k: float(v) for k, v in m.items() if np.ndim(v) == 0},
                flax_to_torch({"params": _np_tree(state.params)}),
                flax_to_torch({"params": _np_tree(state.teacher_params),
                               "batch_stats": _np_tree(state.teacher_batch_stats)}),
                _np_bank(state.bank) if contra else None))

    port = []
    side = ((THW - 1) // 2 + 1) // 2 + 1
    for i, (img_l, lab_l, img_u) in enumerate(data):
        tstate = _port_state(cfg, before[i], i)
        assert tstate.student.dtype == tstate.teacher.dtype == torch.bfloat16
        mix = contra_draws = None
        if i > 0:
            coin, u = jax_mix(rng, i)
            mix = (torch.tensor(coin), boxes_from_uniforms(u, THW, THW))
            if contra:
                contra_draws = jax_contra(rng, i, 2 * B * side * side, contra.select_keys)
        batch = (torch.from_numpy(img_l).permute(0, 3, 1, 2).contiguous(),
                 torch.from_numpy(lab_l), torch.from_numpy(img_u).permute(0, 3, 1, 2).contiguous())
        ((_, m),) = run_steps(tstate, [batch], 1, cfg, start_iter=i, mixes=[mix],
                              contras=[contra_draws])
        assert all(p.dtype == torch.float32 for p in tstate.student.parameters())
        bank = tstate.bank
        port.append((
            {k: float(v) for k, v in m.items() if v.dim() == 0},
            {k: v.detach().clone() for k, v in tstate.student.state_dict().items()},
            {k: v.detach().clone() for k, v in tstate.teacher.state_dict().items()},
            None if bank is None else {"keys": bank.keys.float().numpy(), "ptr": bank.ptr.numpy(),
                                       "occupancy": bank.occupancy.numpy()}))
    return [flax_to_torch({"params": b["params"]}) for b in before], jax_after, port


@pytest.fixture(scope="module")
def semi_trajectory():
    return _bf16_trajectory(raw_cfg(contrastive=CONTRA))


def _flat(d, keys):
    return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in keys])


# whole-step bounds, twice what JAX's own bf16 step moved from its f32 step
# on the same state (see test_semi_trajectory): losses and thresholds
# (measured up to 2.1% on the VOC trajectory, the contrastive loss 32% at
# step 1), updates in L2 relative to the update (VOC 0.21-0.25, the
# Cityscapes sup step 0.44)
STEP_LOSS_RTOL = 5e-2
CON_LOSS_RTOL = 0.65
STEP_THRESH_ATOL = 1e-3  # entropy, in nats (log 5 = 1.6 at most): the low thresholds are ~1e-7
STEP_UPDATE_L2 = 0.5
CITY_STEP_UPDATE_L2 = 0.9


def check_step(name, trajectory, i):
    """Step i of a bf16 trajectory against JAX's: the losses and the entropy
    thresholds within STEP_LOSS_RTOL (con_loss CON_LOSS_RTOL; the
    thresholds also within STEP_THRESH_ATOL: a low threshold of ~1e-7 nats
    moves by its own size between any two bf16 runs), the student's and the teacher's
    updates and the teacher's BN statistics within STEP_UPDATE_L2 of the
    reference's L2 norm (update: after - before), the bank's ptr and
    occupancy within one key a class and its keys within STEP_UPDATE_L2 of
    their norm."""
    before, jax_after, port = trajectory
    (mj, sj, tj, bank_j), (mp, sp, tp, bank_p) = jax_after[i], port[i]
    for k in ("sup_loss", "uns_loss", "con_loss", "drop_thresh", "low_thresh", "high_thresh"):
        if k in mj:
            MEASURED[f"{name} step {i} {k}"] = {"port": mp[k], "jax": mj[k]}
            atol = STEP_THRESH_ATOL if k.endswith("thresh") else 0.0
            rtol = CON_LOSS_RTOL if k == "con_loss" else STEP_LOSS_RTOL
            np.testing.assert_allclose(mp[k], mj[k], rtol=rtol, atol=atol, err_msg=k)
    keys = list(sj)
    tkeys = [k for k in tj if k in keys]
    skeys = [k for k in tj if k.endswith(("running_mean", "running_var"))]
    pairs = {
        "student update": (_flat(sp, keys) - _flat(before[i], keys),
                           _flat(sj, keys) - _flat(before[i], keys)),
        "teacher update": (_flat(tp, tkeys) - _flat(before[i], tkeys),
                           _flat(tj, tkeys) - _flat(before[i], tkeys)),
        "teacher BN statistics": (_flat(tp, skeys), _flat(tj, skeys)),
    }
    if bank_j is not None and i > 0:
        # a pixel at the negative mask's probability threshold flips between
        # any two bf16 runs: the counts may move by one key a class; the
        # keys are held in the classes whose counts agree
        for k in ("ptr", "occupancy"):
            assert np.abs(bank_p[k] - bank_j[k]).max() <= 1, (k, bank_p[k], bank_j[k])
        same = np.flatnonzero((bank_p["occupancy"] == bank_j["occupancy"])
                              & (bank_p["ptr"] == bank_j["ptr"]) & (bank_j["occupancy"] > 0))
        assert same.size > 0
        pairs["bank keys"] = (bank_p["keys"][same].ravel(), bank_j["keys"][same].ravel())
    for what, (a, b) in pairs.items():
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b)) if np.any(b) else float(np.any(a))
        MEASURED[f"{name} step {i} {what}"] = {"rel_l2": rel}
        assert rel <= STEP_UPDATE_L2, (what, rel)


@pytest.mark.parametrize("i", range(3))
def test_semi_trajectory(semi_trajectory, i):
    """The VOC semi trajectory with contrastive (warmup -> first semi epoch
    -> epoch 2) in bf16 against JAX's `make_semi_step` on `make_mesh(1)`.

    A whole train-mode step of this small random-init network is chaotic in
    bf16: its BNs normalise near-constant channels of 2-image batches, and
    any bf16-sized difference grows to ~4% of the logits (JAX's bf16
    against its own f32: 4.3% of |pred| at 33^2 and 65^2, 2 to 8 images;
    the port against JAX bf16: 1.03 to 1.14 times that), and XLA's jit
    keeps excess precision inside fusions, so JAX's compiled step skips
    some of its own jaxpr's roundings.  So the step is not held to 0.5 x
    E_ref, which its modules are: the bounds are twice what JAX's bf16
    step moved from its f32 step on the same state (the constants above;
    the port measured 0.23-0.27 of the update, losses within 2.7e-2, the
    contrastive loss 1.4e-2): losses and thresholds within 5e-2 relative,
    the contrastive loss (bimodal here: its anchors sit under a ~1e-7
    entropy threshold) within 0.65, updates, BN statistics and bank keys
    within 0.5 of the reference's L2 norm; the bank's ptr and occupancy
    within one key a class."""
    check_step("semi", semi_trajectory, i)


def test_cityscapes_sup_step_with_ohem_and_aux():
    """One `make_sup_step` of the Cityscapes shape (OHEM on the main and aux
    heads, the aux head, the x1 head LR) in bf16 against JAX's, from flax's
    init: the loss within STEP_LOSS_RTOL, the update within
    CITY_STEP_UPDATE_L2 of its norm: twice what JAX's bf16 step moved from
    its f32 step here (0.44; the port measured 0.47, the loss 1e-3)."""
    from test_torch_train_step import sup_step_case

    raw = city_raw_cfg()
    raw["net"] = {**raw["net"], "dtype": "bfloat16"}
    got, ref, sd, after, before = sup_step_case(raw)
    MEASURED["city sup step loss"] = {"port": float(got["sup_loss"]), "jax": float(ref["sup_loss"])}
    np.testing.assert_allclose(float(got["sup_loss"]), float(ref["sup_loss"]), rtol=STEP_LOSS_RTOL)
    keys = list(after)
    assert any(k.startswith("auxor.") for k in keys)
    a, b = (_flat(d, keys) - _flat(before, keys) for d in (sd, after))
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    MEASURED["city sup step update"] = {"rel_l2": rel}
    assert rel <= CITY_STEP_UPDATE_L2


def test_semi_step_runs_in_bf16(monkeypatch):
    """A bf16 semi step (contrastive on) hands bf16 tensors to every kernel
    wrapper with a bf16 mode, and float32 to the others: the step does not
    silently compute in f32."""
    from u2pl_tpu_torch import memobank as tm
    from u2pl_tpu_torch.train import steps as ts
    from u2pl_tpu_torch.train.state import create_train_state

    raw = raw_cfg(contrastive=CONTRA)
    raw["net"] = {**raw["net"], "dtype": "bfloat16"}
    cfg = parse_config(raw)
    seen = {}

    def recording(mod, name, arg=0):
        original = getattr(mod, name)

        def wrapper(*a, **kw):
            seen.setdefault(name, set()).add(a[arg].dtype)
            return original(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    recording(tce, "upsample_cross_entropy")
    recording(tu, "upsample_softmax_stats")
    recording(tc, "contra_infonce")
    recording(tc, "memobank_enqueue", arg=1)
    recording(ts.quantile, "masked_percentiles")
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state.bank = tm.init_memobank(5, 256, queue_size=64, class0_size=96, device="cpu")
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 33, 33).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, 5, (2, 33, 33)).astype(np.int32))
    step = ts.make_semi_step(cfg, 1)
    state.step.fill_(1)
    m = step(state, img, lab, img.flip(-1), generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v).all() for v in m.values())
    for name in ("upsample_cross_entropy", "upsample_softmax_stats", "contra_infonce",
                 "memobank_enqueue"):
        assert seen[name] == {torch.bfloat16}, (name, seen.get(name))
    assert seen["masked_percentiles"] == {torch.float32}
    assert all(p.dtype == torch.float32 for p in state.student.parameters())
    assert all(p.dtype == torch.float32 for p in state.teacher.parameters())


def test_train_semi_one_epoch_in_bf16(tmp_path, monkeypatch):
    """`u2pl_tpu_torch.train_semi` for one semi epoch on the synthetic VOC
    workspace with the flagship config (`net.dtype: bfloat16`) cut as
    tests/test_torch_cli.py cuts it: it logs that it trains in bfloat16,
    validates with a float32 forward (kernel B's logits are f32) and saves
    float32 parameters."""
    from test_torch_cli import CONTRA as CLI_CONTRA
    from test_torch_cli import SMALL, VOC, run
    from u2pl_tpu_torch import memobank, train_semi
    from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config
    from u2pl_tpu_torch.train import state as state_mod
    from u2pl_tpu_torch.train import validate
    from u2pl_tpu_torch.utils.checkpoint import CKPT_NAME

    monkeypatch.setenv("U2PL_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setattr(state_mod, "init_memobank",
                        functools.partial(memobank.init_memobank, queue_size=64, class0_size=96))
    logits = []
    original = validate.resize_argmax
    monkeypatch.setattr(validate, "resize_argmax",
                        lambda x, size: logits.append(x.dtype) or original(x, size))
    root = str(tmp_path)
    paths = make_voc_workspace(root, 8, 8, 3, size=(40, 52), num_classes=5, seed=0)
    cfg = write_config(VOC, paths, os.path.join(root, "exp"),
                       {**SMALL, **CLI_CONTRA, "trainer.epochs": 1, "trainer.sup_only_epoch": 0})
    summary, lines = run(train_semi, cfg)
    text = "\n".join(lines)
    assert summary["steps"] == 4 and "training in bfloat16" in text
    assert summary["state"].student.dtype == torch.bfloat16
    assert logits and set(logits) == {torch.float32}
    ckpt = torch.load(os.path.join(os.path.dirname(cfg), "checkpoints", CKPT_NAME),
                      weights_only=False)
    for part in ("model_state", "teacher_state"):
        assert all(v.dtype in (torch.float32, torch.int64) for v in ckpt[part].values()), part
