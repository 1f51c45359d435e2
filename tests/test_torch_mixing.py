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
argsort does).
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
