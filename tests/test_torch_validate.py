"""In-training validation of the port (u2pl_tpu_torch/train/validate.py,
evallib/metrics.py) against the JAX package, on the CPU.

The IoU counts are equal to JAX's on the same predictions.  `validate` runs
the flax model's weights (`flax_to_torch`, as tests/test_torch_model.py
carries them) over the same val batches as the JAX `validate`: two full
batches and a ragged one, float32 and uint8 images.  Where no pixel's top-2
upsampled logits lie within 1e-4 of each other (checked on JAX's logits),
both argmaxes agree, so the counts are equal and the mIoU is held to 1e-6.
Kernel B (`resize_argmax`; its plain version on the CPU) runs once per
image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import C, HW, perturbed_flax_variables, small_net_raw
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.evallib import metrics as jax_metrics
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.resize import resize_bilinear as jax_resize
from u2pl_tpu.train import validate as jax_validate
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.evallib import metrics
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.train import validate as tv
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

NEAR_TIE = 1e-4
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


@pytest.mark.parametrize("seed", range(4))
def test_iou_counts_equal_to_jax(seed):
    """Predictions with values past num_classes, targets with 255."""
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, C + 2, (3, 17, 23)).astype(np.int32)
    target = rng.randint(0, C, (3, 17, 23)).astype(np.int32)
    target[rng.rand(*target.shape) < 0.1] = 255
    ref = jax_metrics.intersection_and_union_device(jnp.asarray(pred), jnp.asarray(target), C, 255)
    got = metrics.intersection_and_union_device(torch.from_numpy(pred), torch.from_numpy(target),
                                                C, 255)
    for name, g, r in zip(("inter", "union", "target"), got, ref):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    for name, g, r in zip(("inter", "union", "target"),
                          metrics.intersection_and_union(pred, target, C),
                          jax_metrics.intersection_and_union(pred, target, C)):
        np.testing.assert_array_equal(g, r, err_msg=f"numpy {name}")


class Loader:
    """The val loader's surface: `epoch(i)` yields (NHWC images, labels)."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def epoch(self, epoch):
        return iter(self.batches)


def val_batches(seed, u8):
    """Two batches of 2 and a ragged one of 1, at HW², labels ~10% 255."""
    rng = np.random.RandomState(seed)
    out = []
    for b in (2, 2, 1):
        if u8:
            img = rng.randint(0, 256, (b, HW, HW, 3)).astype(np.uint8)
        else:
            img = rng.randn(b, HW, HW, 3).astype(np.float32)
        lab = rng.randint(0, C, (b, HW, HW)).astype(np.int32)
        lab[rng.rand(*lab.shape) < 0.1] = 255
        out.append((img, lab))
    return out


def top2_gap(jmodel, variables, batches):
    """The least gap between the two largest upsampled logits of any pixel,
    on JAX's forward (normalized as JAX's val step does)."""
    forward = jax.jit(lambda v, x: jax_resize(jmodel.apply(v, x, train=False)["pred"], (HW, HW),
                                              align_corners=True))
    gaps = []
    for img, _ in batches:
        x = jnp.asarray(img, jnp.float32)
        if img.dtype == np.uint8:
            x = (x - jnp.asarray(MEAN)) / jnp.asarray(STD)
        up = np.asarray(forward(variables, x))
        top = np.sort(up, axis=-1)
        gaps.append((top[..., -1] - top[..., -2]).min())
    return min(gaps)


class JitInit:
    """The flax model's init compiled whole (one XLA program in place of
    one per op), for `perturbed_flax_variables`."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")


@pytest.fixture(scope="module")
def models():
    raw = {"net": small_net_raw(False),
           "dataset": {"type": "pascal_semi", "ignore_label": 255, "mean": MEAN, "std": STD}}
    jcfg, cfg = jax_parse_config(raw), parse_config(raw)
    jmodel = build_jax_model(jcfg.net)
    variables = perturbed_flax_variables(JitInit(jmodel))
    tmodel = build_model(cfg.net, device="cpu")
    tmodel.load_state_dict(flax_to_torch(variables), strict=True)
    return jmodel, variables, jcfg, tmodel, cfg


@pytest.mark.parametrize("u8", [False, True])
def test_validate_matches_jax(models, u8, monkeypatch):
    jmodel, variables, jcfg, tmodel, cfg = models
    seed = next(s for s in range(20)
                if top2_gap(jmodel, variables, val_batches(s, u8)) > NEAR_TIE)
    batches = val_batches(seed, u8)
    loader = Loader(batches, 2)
    calls = []
    resize_argmax = tv.resize_argmax

    def counting(logits, size):
        calls.append((tuple(logits.shape), tuple(size)))
        return resize_argmax(logits, size)

    monkeypatch.setattr(tv, "resize_argmax", counting)
    inter, union = tv.accumulate_val_sums(tmodel, loader, cfg, 0, torch.device("cpu"))
    assert calls == [((C, HW // 4 + 1, HW // 4 + 1), (HW, HW))] * 5  # one per image
    sums = []  # JAX's (inter, union), as its validate reduces them across processes
    monkeypatch.setattr(jax_validate, "all_sum_across_processes",
                        lambda x: (sums.append(np.asarray(x)), x)[1])
    ref = jax_validate.validate(jmodel, variables["params"], variables["batch_stats"], loader,
                                jcfg, 0)
    np.testing.assert_array_equal(inter, sums[0])
    np.testing.assert_array_equal(union, sums[1])

    miou = tv.validate(tmodel, loader, cfg, 0)
    assert 0.0 < miou < 1.0
    np.testing.assert_allclose(miou, ref, rtol=0, atol=1e-6)
    assert not tmodel.training
