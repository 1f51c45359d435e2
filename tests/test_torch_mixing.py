"""ClassMix of the port against the JAX package, on the CPU.

`class_half_mask_plain` and `generate_unsup_data(mode="classmix")` (the
plain version of kernel K3c, which tests/test_torch_cuda.py holds the CUDA
kernel against on the card) take JAX's own draws: sample i's (C,) uniforms
are uniform(split(k_mix, B)[i], (C,)) (u2pl_tpu/ops/mixing.py:55, :79).
Everything is bit-equal: a selection, then a select of one of two inputs.
The cases: labels with 255 (clipped to class C-1 before marking, as JAX
does), a sample with a single class (n_present // 2 = 0: nothing kept from
it, every pixel from its partner), the batch's last sample mixing with
sample 0, and draws with ties (broken by class index, as the stable double
argsort does).  `_classmix_walk` walks K3c's one cooperative launch
(`_classmix_plan`'s blocks, the presence pass sample by sample, the
selection of each sample by a thread per (b, c), the blend's offsets) and
holds it bit-equal to JAX and the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.ops import mixing as jmix
from u2pl_tpu_torch.ops import mixing

C = 6


def jax_uniforms(k_mix, b, c=C):
    """The (B, C) float32 draws `generate_unsup_data` makes for classmix."""
    return np.stack([np.asarray(jax.random.uniform(k, (c,))) for k in jax.random.split(k_mix, b)])


def batch(seed, b, hw=(17, 13), c=C):
    """Images NHWC, pseudo-labels (5% 255; sample 1 a single class when
    b > 1) and max-probs."""
    rng = np.random.RandomState(seed)
    img = rng.randn(b, *hw, 3).astype(np.float32)
    lab = rng.randint(0, c, (b,) + hw).astype(np.int32)
    lab[rng.rand(b, *hw) < 0.05] = 255
    if b > 1:
        lab[1] = 2
    prob = rng.rand(b, *hw).astype(np.float32)
    return img, lab, prob


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_half_mask_bit_equal_to_jax(seed):
    _, lab, _ = batch(seed, 3)
    k_mix = jax.random.PRNGKey(seed)
    u = jax_uniforms(k_mix, 3)
    got = mixing.class_half_mask_plain(torch.from_numpy(lab), torch.from_numpy(u), C)
    for i, key in enumerate(jax.random.split(k_mix, 3)):
        ref = np.asarray(jmix._class_half_mask(key, jnp.asarray(lab[i]), C))
        np.testing.assert_array_equal(got[i].numpy(), ref, err_msg=f"sample {i}")
    assert not got[1].any()  # one class present: k = 0


def test_class_half_mask_ties_and_ignore_label():
    """Tied draws, handed to JAX through its uniform; a map of 255s and one
    other class (two present classes once 255 counts as C-1)."""
    lab = np.full((2, 9, 7), 255, np.int32)
    lab[0, :4] = 0
    lab[0, 4:6] = 3
    lab[1, :, :3] = 1
    u = np.array([[0.5, 0.1, 0.5, 0.5, 0.9, 0.5], [0.25, 0.25, 0.7, 0.1, 0.1, 0.25]], np.float32)
    got = mixing.class_half_mask_plain(torch.from_numpy(lab), torch.from_numpy(u), C)
    for i in range(2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda key, shape, _u=u[i]: jnp.asarray(_u))
            ref = np.asarray(jmix._class_half_mask(jax.random.PRNGKey(0), jnp.asarray(lab[i]), C))
        np.testing.assert_array_equal(got[i].numpy(), ref, err_msg=f"sample {i}")
    # sample 0: classes {0, 3, 5 (the 255s)}, draws 0.5 / 0.5 / 0.5: the tie
    # goes to the lowest class index, so one class is kept, class 0
    np.testing.assert_array_equal(got[0].numpy(), (lab[0] == 0).astype(np.int32))
    # sample 1: classes {1, 5}, draws 0.25 / 0.25: class 1 is kept
    np.testing.assert_array_equal(got[1].numpy(), (lab[1] == 1).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 3, 4])
def test_generate_unsup_data_classmix_bit_equal_to_jax(seed, b):
    img, lab, prob = batch(seed, b)
    k_mix = jax.random.PRNGKey(10 + seed)
    ref = jmix.generate_unsup_data(k_mix, jnp.asarray(img), jnp.asarray(lab), jnp.asarray(prob),
                                   "classmix", num_classes=C)
    u = torch.from_numpy(jax_uniforms(k_mix, b))
    got = mixing.generate_unsup_data(
        torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lab),
        torch.from_numpy(prob), u, "classmix")
    np.testing.assert_array_equal(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if b > 1:  # the single-class sample takes every pixel from its partner
        np.testing.assert_array_equal(got[1][1].numpy(), lab[2 % b])
        # the last sample's partner is sample 0
        keep = mixing.class_half_mask_plain(torch.from_numpy(lab), u, C)[-1].numpy() == 1
        np.testing.assert_array_equal(got[1][-1].numpy(), np.where(keep, lab[-1], lab[0]))


def test_draw_mix_shapes_and_generator_only():
    state = torch.random.get_rng_state()
    a = mixing.draw_mix(torch.Generator().manual_seed(4), "classmix", 4, 513, 513, 21)
    b = mixing.draw_mix(torch.Generator().manual_seed(4), "classmix", 4, 513, 513, 21)
    assert torch.equal(torch.random.get_rng_state(), state) and torch.equal(a, b)
    assert a.shape == (4, 21) and a.dtype == torch.float32 and ((a >= 0) & (a < 1)).all()
    boxes = mixing.draw_mix(torch.Generator().manual_seed(4), "cutmix", 4, 513, 513, 21)
    assert boxes.shape == (4, 4) and boxes.dtype == torch.int32


def _classmix_walk(img, lab, prob, u, sms):
    """unsup_class_mix_kernel in its layout, on NCHW numpy inputs (3
    channels): block g of `_classmix_plan`'s grid owns the positions [g *
    span, (g + 1) * span) of the H x W plane in every sample; each sample's
    presence the OR of 1 << clip(label, 0, C - 1) over the block's
    positions (a block's words ORed into the grid's); then per sample and
    class, as a thread per (b, c) does, rank = #{present d: u[d] < u[c], or
    u[d] = u[c] and d < c} and the class kept when rank < n_present // 2;
    then the blend of each position, the samples walked in order, each
    sample's pixel loaded once and written as sample b's own or sample b -
    1's partner (sample 0's kept for sample B - 1), the labels from the held
    ones (the first `held` positions) or read again.  Returns (keep (B, H,
    W), outputs, times each position was taken, times each input pixel was
    loaded)."""
    b, ci, h, w = img.shape
    c = u.shape[1]
    hw = h * w
    grid, span, held, smem = mixing._classmix_plan(b, h, w, c, sms)
    assert smem == 4 * b * (c + held) <= mixing.MIX_MAX_SHARED
    flat = lab.reshape(b, hw)
    present = [0] * b
    taken = np.zeros(hw, np.int32)
    loaded = np.zeros((b, hw), np.int32)
    for g in range(grid):
        p0, p1 = min(g * span, hw), min(hw, g * span + span)
        taken[p0:p1] += 1
        for bb in range(b):
            for cl in np.unique(np.clip(flat[bb, p0:p1], 0, c - 1)):
                present[bb] |= 1 << int(cl)
    sel = [0] * b
    for j in range(b * c):
        sb, cc = divmod(j, c)
        if (present[sb] >> cc) & 1:
            rank = sum(1 for d in range(c) if (present[sb] >> d) & 1
                       and (u[sb, d] < u[sb, cc] or (u[sb, d] == u[sb, cc] and d < cc)))
            if rank < bin(present[sb]).count("1") // 2:
                sel[sb] |= 1 << cc
    img_p, prob_p = img.reshape(b, ci, hw), prob.reshape(b, hw)
    outs = (np.empty_like(img_p), np.empty_like(flat), np.empty_like(prob_p))
    keep = np.zeros((b, hw), bool)
    for g in range(grid):
        q = np.arange(min(g * span, hw), min(hw, g * span + span))

        def load(bb):  # one sample's pixels at the block's positions
            loaded[bb, q] += 1
            return img_p[bb][:, q], prob_p[bb, q], flat[bb, q]

        first = load(0)
        cur = first
        for bb in range(b):
            bn = 0 if bb + 1 == b else bb + 1
            nxt = first if bn == 0 else load(bn)
            kp = ((np.array(sel[bb], dtype=object) >> np.clip(cur[2], 0, c - 1)) & 1).astype(bool)
            outs[0][bb][:, q] = np.where(kp, cur[0], nxt[0])
            outs[1][bb, q] = np.where(kp, cur[2], nxt[2])
            outs[2][bb, q] = np.where(kp, cur[1], nxt[1])
            keep[bb, q] = kp
            cur = nxt
    return keep.reshape(b, h, w), (outs[0].reshape(img.shape), outs[1].reshape(lab.shape),
                                   outs[2].reshape(prob.shape)), taken, loaded


@pytest.mark.parametrize("b,h,w,c,sms", [(4, 65, 65, 21, 132), (4, 65, 65, 21, 7),
                                         (2, 129, 129, 19, 1), (3, 17, 13, 6, 132),
                                         (1, 33, 29, 64, 4), (5, 40, 33, 64, 3),
                                         (64, 9, 7, 64, 132)])
def test_classmix_walk_bit_equal_to_jax(b, h, w, c, sms):
    """K3c walked as the kernel walks it, over 33 or 14 blocks of 65²
    positions, a span past the held labels (129² on one SM: 2 blocks of
    8,321 positions, 8,192 held), one block, B = 1 (its own partner), C =
    64 and B = 64: the kept classes equal JAX's
    `_class_half_mask` per sample (its uniform handed the same draws) and
    `class_half_mask_plain`; the outputs equal `generate_unsup_data_plain`;
    every pixel taken once.  The draws tie (sample 0), sample 1 is one
    class, the last sample is all 255 (only class C - 1 present: nothing
    kept)."""
    rng = np.random.RandomState(b * 100 + c)
    img = rng.randn(b, 3, h, w).astype(np.float32)
    lab = rng.randint(0, c, (b, h, w)).astype(np.int32)
    lab[rng.rand(b, h, w) < 0.05] = 255
    if b > 1:
        lab[1] = 2
        lab[-1] = 255
    prob = rng.rand(b, h, w).astype(np.float32)
    u = rng.rand(b, c).astype(np.float32)
    u[0, 1::3] = u[0, 0]
    keep, outs, taken, loaded = _classmix_walk(img, lab, prob, u, sms)
    assert (taken == 1).all() and (loaded == 1).all()
    for i in range(b):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda key, shape, _u=u[i]: jnp.asarray(_u))
            ref = np.asarray(jmix._class_half_mask(jax.random.PRNGKey(0), jnp.asarray(lab[i]), c))
        np.testing.assert_array_equal(keep[i].astype(np.int32), ref, err_msg=f"sample {i}")
    plain = mixing.class_half_mask_plain(torch.from_numpy(lab), torch.from_numpy(u), c)
    np.testing.assert_array_equal(keep.astype(np.int32), plain.numpy())
    got = mixing.generate_unsup_data_plain(torch.from_numpy(img), torch.from_numpy(lab),
                                           torch.from_numpy(prob), torch.from_numpy(u), "classmix")
    for a, r in zip(outs, got):
        np.testing.assert_array_equal(a, r.numpy())
    if b > 1:
        assert not keep[1].any() and not keep[-1].any()
