"""Port model (u2pl_tpu_torch/models) against the flax model, on one set of
weights: flax init with every BN statistic, scale and bias and every conv
bias perturbed, carried across with `flax_to_torch`, loaded strictly.

Eval mode, float32, on the CPU.  Tolerance rtol = atol = 1e-4: the two
frameworks' f32 convolutions sum in different orders, and resnet10 at 65²
keeps that difference under it (the resnet18 variant scales atol with its
larger logits, see test_forward_matches_flax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.pooling import max_pool_ceil
from u2pl_tpu.utils.convert_torch import _translate, torch_to_flax
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

HW = 65
C = 5


def small_net_raw(aux: bool, v3_basic: bool = False) -> dict:
    """resnet10 + DeepLabv3+ (inner 16, dilations [2, 4, 6]); `v3_basic`
    swaps in resnet18 (basic blocks) + plain DeepLabv3."""
    net = {
        "num_classes": C,
        "sync_bn": False,
        "ema_decay": 0.99,
        "encoder": {
            "type": "u2pl.models.resnet." + ("resnet18" if v3_basic else "resnet10"),
            "kwargs": {
                "multi_grid": True,
                "fpn": True,
                "replace_stride_with_dilation": [False, True, True],
            },
        },
        "decoder": {
            "type": "u2pl.models.decoder.dec_deeplabv3_plus",
            "kwargs": {"inner_planes": 16, "dilations": [2, 4, 6]},
        },
    }
    if aux:
        net["aux_loss"] = {"aux_plane": 1024, "loss_weight": 0.4}
    if v3_basic:
        net["decoder"]["type"] = "u2pl.models.decoder.dec_deeplabv3"
    return net


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def perturbed_flax_variables(model, seed: int = 0) -> dict:
    """flax init at HW² with everything but the conv kernels perturbed from
    a numpy seed, so a swapped or missed BN/bias mapping shows up."""
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)), train=False
    )
    rng = np.random.RandomState(seed)

    def perturb(tree, name=None):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: perturb(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "kernel":
            return a
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    return perturb(variables)


VARIANTS = {  # id -> (aux head, resnet18 + DeepLabv3)
    "plain": (False, False),
    "aux": (True, False),
    "v3_basic_aux": (True, True),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    aux, v3_basic = VARIANTS[request.param]
    raw = {"net": small_net_raw(aux, v3_basic)}
    cfg = parse_config(raw)
    jmodel = build_jax_model(jax_parse_config(raw).net)
    variables = perturbed_flax_variables(jmodel)
    tmodel = build_model(cfg.net)
    tmodel.load_state_dict(flax_to_torch(variables), strict=True)
    return jmodel, variables, tmodel.eval(), aux, v3_basic


def test_forward_matches_flax(pair):
    jmodel, variables, tmodel, aux, v3_basic = pair
    x = np.random.RandomState(1).randn(2, HW, HW, 3).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = ["pred"] + ([] if v3_basic else ["rep"]) + (["aux"] if aux else [])
    assert sorted(got) == sorted(ref) == sorted(want)
    for key in got:
        g = got[key].permute(0, 2, 3, 1).numpy()
        r = np.asarray(ref[key])
        assert g.shape == r.shape, key
        # resnet18's residual sums (no zero-init, perturbed BN) push logits
        # to ~160, where f32 cancellation leaves ~3e-4: atol scales with them
        atol = 1e-4 * (max(1.0, np.abs(r).max() / 10) if v3_basic else 1.0)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=atol, err_msg=key)


def test_state_dict_keys_are_translate_keys(pair):
    jmodel, variables, tmodel = pair[:3]
    want = {_translate(p[1:]) for p in _leaf_paths(variables)}
    bns = {k[: -len(".running_mean")] for k in want if k.endswith(".running_mean")}
    want |= {f"{bn}.num_batches_tracked" for bn in bns}
    assert set(tmodel.state_dict()) == want
    assert set(flax_to_torch(variables)) == want


def test_flax_to_torch_inverts_torch_to_flax(pair):
    _, variables, tmodel = pair[:3]
    back = torch_to_flax(tmodel.state_dict(), variables)
    for path in _leaf_paths(variables):
        a, b = variables, back
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))


@pytest.mark.parametrize("size", [33, 65, 66, 129, 257])
def test_ceil_maxpool_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size + 1, 4).astype(np.float32)
    ref = np.asarray(max_pool_ceil(jnp.asarray(x), kernel=3, stride=2, pad=1))
    pool = torch.nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True)
    got = pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_init_draws_only_from_the_generator():
    cfg = parse_config({"net": small_net_raw(False)})
    state = torch.random.get_rng_state()
    a = build_model(cfg.net, generator=torch.Generator().manual_seed(7)).state_dict()
    b = build_model(cfg.net, generator=torch.Generator().manual_seed(7)).state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
