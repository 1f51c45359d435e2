"""The port's model in train mode against the flax model, on the CPU.

Covers the two faults the training slice exposed in the serving port:
  * BatchNorm running variance: torch's `BatchNorm2d` moves it towards the
    unbiased batch variance, flax towards the biased one (the ASPP
    image-pool BN, over a (B, 1, 1, C) map, was off by B/(B-1), 2x here);
  * the resize's gradient: kernel A had none on the card.  Its CPU path,
    the same autograd Function, is held here against `jax.vjp`; the card's
    A-bwd against it in tests/test_torch_cuda.py.
Dropout is neutralised on both sides (flax `Dropout` patched to identity,
the port's at p = 0), as tests/test_golden_step.py does.

Tolerances of the train-mode forward: rtol 1e-5 on the running statistics
and rtol 1e-4 on pred/rep, each with an atol proportional to the tensor's
largest magnitude (1e-5 and 3e-5 of it).  In train mode every BN divides by
the batch std of a few hundred values, which amplifies the two frameworks'
f32 convolution summation orders (the same probe with flax's E[x²] - E[x]²
variance in the port's BN moves nothing): 3.8e-4 on logits up to 23 here.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import perturbed_flax_variables, small_net_raw
from test_torch_resize import SIZES
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.models.decoder import Dropout2d
from u2pl_tpu_torch.ops import resize as tr
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch


def zero_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def train_forward():
    raw = {"net": small_net_raw(aux=False)}
    cfg = parse_config(raw)
    jmodel = build_jax_model(jax_parse_config(raw).net)

    class JitInit:  # perturbed_flax_variables with a compiled init
        init = staticmethod(jax.jit(jmodel.init, static_argnames="train"))

    variables = perturbed_flax_variables(JitInit)
    x = np.random.RandomState(11).randn(2, 33, 33, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        ref, mut = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = zero_dropout(build_model(cfg.net))
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    want_stats = flax_to_torch({"batch_stats": jax.device_get(mut["batch_stats"])})
    return ref, got, want_stats, model.state_dict()


def test_bn_running_stats_match_flax_batch_stats(train_forward):
    _, _, want, sd = train_forward
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(k.endswith("running_mean") for k in sd)
    for k in keys:
        w = want[k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=k)
    # the one that differed by n/(n-1) = 2 under torch's own BatchNorm2d
    assert "decoder.aspp.conv1.2.running_var" in keys


def test_train_mode_outputs_match_flax(train_forward):
    ref, got, _, _ = train_forward
    assert sorted(got) == sorted(ref) == ["pred", "rep"]
    for key in got:
        r = np.asarray(ref[key])
        np.testing.assert_allclose(
            got[key].permute(0, 2, 3, 1).numpy(), r, rtol=1e-4, atol=3e-5 * np.abs(r).max(),
            err_msg=key,
        )


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_resize_vjp_matches_jax(insz, outsz, align):
    rng = np.random.RandomState(12)
    x = rng.randn(2, insz[0], insz[1], 3).astype(np.float32)
    gy = rng.randn(2, outsz[0], outsz[1], 3).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: jax_resize_bilinear(a, outsz, align_corners=align), jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    y = tr.resize_bilinear(xt, outsz, align)
    assert y.requires_grad
    y.backward(torch.from_numpy(gy).permute(0, 3, 1, 2))
    np.testing.assert_allclose(
        y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5
    )
    assert tr.resize_bilinear_bwd.launches == 0  # the CPU path launches nothing


def test_dropout2d_draws_whole_channels_from_the_generator():
    x = torch.randn(4, 64, 5, 5)
    drop = Dropout2d(0.25).train()
    state = torch.random.get_rng_state()
    drop.generator = torch.Generator().manual_seed(5)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(5)
    b = drop(x)
    assert torch.equal(a, b) and torch.equal(torch.random.get_rng_state(), state)
    kept = (a != 0).flatten(2)
    assert (kept.all(-1) | ~kept.any(-1)).all()  # a channel is kept or dropped whole
    k = kept.all(-1)
    assert 0 < int(k.sum()) < k.numel()
    torch.testing.assert_close(a[k], (x / 0.75)[k], rtol=0, atol=0)
    drop.generator = None
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    assert torch.equal(drop.eval()(x), x)


def test_model_forward_hands_the_generator_to_dropout():
    cfg = parse_config({"net": small_net_raw(aux=True)})
    model = build_model(cfg.net).train()
    x = torch.randn(2, 3, 33, 33)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    outs = [model(x, generator=torch.Generator().manual_seed(9))["pred"] for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert all(m.generator is None for m in model.modules() if isinstance(m, Dropout2d))
