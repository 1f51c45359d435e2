"""The port's semi-supervised trainer against the JAX steps, on the CPU: a
golden trajectory through warmup -> the first semi epoch -> epoch 2.

JAX runs `make_semi_warmup_step` / `make_semi_step` on `make_mesh(1)` for
three steps (resnet10 + DeepLabv3+, inner 16, dilations [2, 4, 6], 5
classes, no aux; 2 labeled + 2 unlabeled 33² images per step; contrastive
off, `apply_aug: cutmix`, steps_per_epoch 1, sup_only_epoch 1), with the
per-step student -> teacher copy of the first semi epoch as train_semi.py
does it.  The port takes each step through `train.steps.run_steps` from
JAX's state before that step (student and teacher parameters and BN
statistics, the SGD trace), so every step of the trajectory, with its
branch, copy and EMA decay, is held against JAX's own step.  Dropout is
neutralised on both sides (flax `Dropout` patched to identity, the port's at
p = 0), as tests/test_golden_step.py does, and the port's CutMix coin and
boxes are JAX's own draws, replayed from the step's key schedule
(steps.py:275-281, mixing.py:33-37); the key is chosen so that both semi
steps mix.

Why from JAX's state and not free-running: the warmup's ASPP image-pool BN
normalises 2 values per channel, where its gradient is mathematically ~0
and in float32 only rounding noise; those noise-sized differences grow to
~4% of some tensors' updates two steps on, in JAX against itself too
(rerun from weights moved by 1e-7).  The batches are smooth images labeled
by their own colour (a learnable target): with random labels the gradient
is a small residual that float32 rounding dominates (JAX's own float32
gradient is then ~4e-3 from its float64 one at 4+4 images, where the port's
float64 gradient equals JAX's float64 one to 3e-7).

Tolerances, per step: the losses rtol 1e-4 and the drop threshold rtol
1e-5 (measured ~1e-6 and 9e-6); the teacher's BN running statistics rtol
1e-4; the student's parameter update and the teacher's parameters in the L2
pattern of test_golden_step.py:_delta_close: per tensor within 3e-2 of the
reference update's norm (plus 1e-6 RMS per element, for the conv biases
that feed a BN, whose gradient is rounding noise), over all tensors within
1e-2.  A semi step takes the argmax of the teacher's logits as
pseudo-labels, and near-tied pixels flip between any two float32
implementations: the losses do not move, the gradient does.  Measured: a
median of 3.3e-3 over tensors and 1.2e-2 at worst, where JAX against itself
from weights moved by 1e-7 also moved 3.2e-3 (median).

The Cityscapes-shaped trajectory (`city_trajectory`) runs the same three
steps on `dataset.type: cityscapes_semi` (the x1 head LR), with the aux head
(`small_net_raw(aux=True)`, loss weight 0.4) and `criterion: ohem` at thresh
0.1 and min_kept 1700 of the 2178 labeled pixels (1980 valid): the small
net's p_y spread from ~1e-8 to 1, the 1700-th smallest lies at 0.46-0.91 and
sets the threshold (JAX's own k-th values are recorded and asserted > thresh
on both heads of every step), so ~1700 pixels per head are kept where thresh
alone would keep ~1400.  It is held to the bounds above; its drop threshold,
an entropy percentile of the same teacher forward as the contrastive
trajectory's thresholds, to their THRESH_RTOL (measured 1.0e-5 and 1.5e-5).

The contrastive-on trajectory (`contra_trajectory`) runs the same three
steps with the contrastive block of tests/test_train_step.py (a 64/96-key
bf16 bank, 8 queries, 4 negatives, 16 keys per class and step); the port's
contrastive draws are JAX's own, replayed from k_contra.  Its entropy
thresholds and bank keys are held by what JAX moves against itself, not by
float32 rounding: the teacher's train-mode forward normalises 4 images (2 at
the ASPP image pool's BN, 4 values per channel), and from teacher weights
moved by 1e-7 JAX's own representation moves by up to 9.6e-5 (|rep| <= 5.5)
and a pixel's entropy by up to 2.9e-4 relative (median 2.5e-5); the port
differs from JAX by 7.8e-5 and 2.1e-4 (measured at steps 1 and 2).  So the
thresholds are held to rtol 3e-4 and each bank key to one bfloat16 ulp plus
1e-4; the selections (neg_cand, ptr, occupancy) are exact, and con_loss
within rtol 1e-4 (measured 6e-7).

The variant trajectory (`variant_trajectory`) is the contrastive one with
`apply_aug: classmix` and `contrastive.select_keys: radix`: the port's
ClassMix uniforms and u32 keys are JAX's own, replayed; it is held to the
contrastive trajectory's bounds.

The anchor_ema trajectory (`ema_trajectory`) is the contrastive one with
`contrastive.anchor_ema` and a third semi step, each port step from JAX's
state with its prototype: zero into the first semi step, then not.  It is
held to the contrastive trajectory's bounds, the new prototype (a masked
mean of the teacher's representation, blended) to PROTO_ATOL = KEY_ATOL
(measured 1.7e-6 to 2.9e-6 against values up to 1.8).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_contrastive import jax_draws
from test_torch_model import small_net_raw
from u2pl_tpu.config import head_lr_multiplier as jax_head_lr_multiplier
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.dist import make_mesh
from u2pl_tpu.losses import ohem as jax_ohem
from u2pl_tpu.memobank import init_memobank as jax_init_memobank
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.train.optim import make_optimizer as jax_make_optimizer
from u2pl_tpu.train.state import TrainState, copy_student_to_teacher as jax_copy
from u2pl_tpu.train.steps import make_semi_step as jax_semi_step
from u2pl_tpu.train.steps import make_semi_warmup_step as jax_warmup_step
from u2pl_tpu.train.steps import make_sup_step as jax_sup_step
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.memobank import MemoryBank
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.models.decoder import Dropout2d
from u2pl_tpu_torch.ops.mixing import boxes_from_uniforms
from u2pl_tpu_torch.train.steps import run_steps
from u2pl_tpu_torch.train.state import create_train_state
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

HW = 33
B = 2
STEPS = 3  # warmup, first semi epoch, epoch 2
EMA_STEPS = 4  # the anchor_ema trajectory: warmup, then three semi steps
TENSOR_L2 = 3e-2
GLOBAL_L2 = 1e-2
# contrastive trajectory: what JAX moves against itself from teacher
# weights moved by 1e-7 (module docstring)
THRESH_RTOL = 3e-4
KEY_ATOL = 1e-4
PROTO_ATOL = KEY_ATOL  # the anchor_ema prototype: a mean of teacher reps, as the keys are
OHEM_THRESH = 0.1  # city_raw_cfg: below the 1700-th smallest p_y


# the contrastive block of tests/test_train_step.py, 5 classes
CONTRA = {
    "negative_high_entropy": True, "low_rank": 1, "high_rank": 3,
    "current_class_threshold": 0.3, "current_class_negative_threshold": 1,
    "low_entropy_threshold": 20, "num_negatives": 4, "num_queries": 8,
    "temperature": 0.5, "max_keys_per_class_per_step": 16,
}
BANK = {"queue_size": 64, "class0_size": 96}  # tests/test_train_step.py:98


def raw_cfg(contrastive=None, **unsup):
    trainer_extra = {"contrastive": contrastive} if contrastive else {}
    return {
        "dataset": {"type": "pascal_semi", "batch_size": B, "ignore_label": 255},
        "criterion": {"type": "CELoss", "kwargs": {}},
        "trainer": {
            "epochs": 4,
            "sup_only_epoch": 1,
            "optimizer": {"type": "SGD",
                          "kwargs": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.0001}},
            "lr_scheduler": {"mode": "poly", "kwargs": {"power": 0.9}},
            "unsupervised": {"drop_percent": 80, "apply_aug": "cutmix", **unsup},
            **trainer_extra,
        },
        "net": small_net_raw(aux=False),
    }


def city_raw_cfg():
    """The Cityscapes shape of `raw_cfg`: the x1 head LR of
    `cityscapes_semi`, the aux head, OHEM with a live selection (module
    docstring) and the Cityscapes configs' weight decay."""
    raw = raw_cfg()
    raw["dataset"]["type"] = "cityscapes_semi"
    raw["net"] = small_net_raw(aux=True)
    raw["criterion"] = {"type": "ohem", "kwargs": {"thresh": OHEM_THRESH, "min_kept": 1700}}
    raw["trainer"]["optimizer"]["kwargs"]["weight_decay"] = 0.0005
    return raw


def batches(steps=STEPS):
    """Smooth colour fields (a 4x4 random grid, upsampled) with a little
    noise, labeled by quantising their first channel into the 5 classes:
    a learnable target, so the gradient is not a small residual of random
    labels that float32 rounding would dominate."""
    from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

    rng = np.random.RandomState(21)

    def images():
        x = np.stack([resize_bilinear_numpy(rng.randn(4, 4, 3).astype(np.float32), (HW, HW))
                      for _ in range(B)]) * 2
        return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)

    out = []
    for _ in range(steps):
        img_l = images()
        lab_l = np.clip(((img_l[..., 0] + 2) * 5 / 4).astype(np.int32), 0, 4)
        lab_l[:, :3] = 255
        out.append((img_l, lab_l, images()))
    return out


def _dev_rng(rng, i_iter):
    return jax.random.fold_in(jax.random.fold_in(rng, i_iter), 0)


def jax_mix(rng, i_iter, mode="cutmix"):
    """The semi step's coin and mix uniforms at `i_iter`, replayed: three
    per sample for the CutMix box, (5,) per sample for ClassMix."""
    _, _, _, k_coin, k_mix = jax.random.split(_dev_rng(rng, i_iter), 5)
    coin = bool(jax.random.uniform(k_coin, ()) < 0.5)
    if mode == "classmix":
        u = [np.asarray(jax.random.uniform(k, (5,))) for k in jax.random.split(k_mix, B)]
        return coin, torch.from_numpy(np.stack(u))
    u = [[float(jax.random.uniform(r, ())) for r in jax.random.split(k, 3)]
         for k in jax.random.split(k_mix, B)]
    return coin, torch.tensor(u, dtype=torch.float32)


def jax_contra(rng, i_iter, n_pixels, select_keys="argsort"):
    """The semi step's contrastive draws at `i_iter`, replayed from k_contra
    (steps.py:281) as compute_contra_memobank_loss splits it (:250-290)."""
    k_contra = jax.random.split(_dev_rng(rng, i_iter), 5)[2]
    return jax_draws(k_contra, CONTRA["num_queries"], CONTRA["num_negatives"], 5, n_pixels,
                     select_keys)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _np_bank(bank):
    return {"keys": np.array(bank.keys.astype(jnp.float32)), "ptr": np.array(bank.ptr),
            "occupancy": np.array(bank.occupancy), "sizes": np.array(bank.sizes)}


def _jax_snapshot(state):
    snap = {
        "params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats),
        "teacher_params": _np_tree(state.teacher_params),
        "teacher_batch_stats": _np_tree(state.teacher_batch_stats),
        "trace": _np_tree(optax.tree_utils.tree_get(state.opt_state, "trace")),
    }
    if state.bank is not None:
        snap["bank"] = _np_bank(state.bank)
        snap["prototype"] = np.array(state.prototype)
    return snap


def _port_state(cfg, snap, step):
    """The port's TrainState at JAX's state `snap` before global step `step`."""
    student = build_model(cfg.net, device="cpu")
    student.load_state_dict(
        flax_to_torch({"params": snap["params"], "batch_stats": snap["batch_stats"]}), strict=True
    )
    for m in student.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    state = create_train_state(cfg, device="cpu", student=student)
    state.teacher.load_state_dict(flax_to_torch(
        {"params": snap["teacher_params"], "batch_stats": snap["teacher_batch_stats"]}
    ), strict=True)
    if step > 0:
        trace = flax_to_torch({"params": snap["trace"]})
        for name, p in state.student.named_parameters():
            state.optimizer.state[p]["trace"] = trace[name].clone()
    state.step.fill_(step)
    if "bank" in snap:
        b = snap["bank"]
        state.bank = MemoryBank(torch.from_numpy(b["keys"]).to(state.bank.keys.dtype),
                                *(torch.from_numpy(b[k]) for k in ("ptr", "occupancy", "sizes")))
        state.prototype.copy_(torch.from_numpy(snap["prototype"]))
    return state


def _trajectory(raw, steps=STEPS, jax_hook=None, port_state=None, port_steps=None):
    """JAX's trajectory of `steps` steps (a warmup, then semi steps) on
    `raw`, and each port step from JAX's state before it: (before,
    jax_after, torch_after, steps), each `after` a list of (scalar metrics,
    student, teacher, extras) per step.  `jax_hook(i, state)` sees JAX's
    state before step i; `port_state(cfg, snapshot, i)` (default
    `_port_state`) makes the port's state before step i; `port_steps`: the
    steps the port takes (default all; the others' entries are None)."""
    cfg, jcfg = parse_config(raw), jax_parse_config(raw)
    contra = jcfg.trainer.contrastive
    mode = jcfg.trainer.unsupervised.apply_aug
    data = batches(steps)
    # a step key whose coin lands heads on every semi step, so the
    # trajectory goes through CutMix
    seed = next(s for s in range(64)
                if all(jax_mix(jax.random.PRNGKey(s), i, mode)[0] for i in range(1, steps)))
    rng = jax.random.PRNGKey(seed)

    init_model = build_jax_model(jcfg.net)
    init = jax.jit(lambda k, x: init_model.init(k, x, train=False))
    variables = _np_tree(init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bstats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = jax_make_optimizer(jcfg.trainer.optimizer, params,
                            head_lr_multiplier=jax_head_lr_multiplier(jcfg))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=bstats,
        opt_state=tx.init(params), teacher_params=jax.tree_util.tree_map(jnp.copy, params),
        teacher_batch_stats=jax.tree_util.tree_map(jnp.copy, bstats),
        bank=jax_init_memobank(5, 256, **BANK) if contra else None,
        prototype=jnp.zeros((5, contra.num_queries, 1, 256)) if contra else None,
    )
    jax_before, jax_after = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        model = build_jax_model(jcfg.net, axis_name="data")
        mesh = make_mesh(1)
        warmup = jax_warmup_step(jcfg, model, tx, 1, mesh)
        semi = jax_semi_step(jcfg, model, tx, 1, mesh)
        for i, (img_l, lab_l, img_u) in enumerate(data):
            jax_before.append(_jax_snapshot(state))
            if jax_hook is not None:
                jax_hook(i, state)
            args = (jnp.asarray(img_l), jnp.asarray(lab_l), jnp.asarray(img_u), rng)
            step_fn = warmup if i == 0 else semi
            if i == 1:
                state = jax_copy(state)
            state, m = step_fn(state, *args)
            m = jax.device_get(m)
            jax_after.append((
                {k: float(v) for k, v in m.items() if np.ndim(v) == 0},
                flax_to_torch({"params": _np_tree(state.params)}),
                flax_to_torch({"params": _np_tree(state.teacher_params),
                               "batch_stats": _np_tree(state.teacher_batch_stats)}),
                {"neg_cand": np.asarray(m["neg_cand"]) if "neg_cand" in m else None,
                 "bank": _np_bank(state.bank) if contra else None,
                 "prototype_before": jax_before[i].get("prototype"),
                 "prototype": np.array(state.prototype) if contra else None},
            ))

    torch_after, steps = [], []
    # os4 side: the stride-2 stem conv, then the ceil-mode 3x3/2 max-pool
    side = ((HW - 1) // 2 + 1) // 2 + 1  # 33 -> 17 -> 9
    n_pixels = 2 * B * side * side
    for i, (img_l, lab_l, img_u) in enumerate(data):
        if port_steps is not None and i not in port_steps:
            torch_after.append(None)
            steps.append(None)
            continue
        tstate = (port_state or _port_state)(cfg, jax_before[i], i)
        mix = contra_draws = None
        if i > 0:
            coin, u = jax_mix(rng, i, mode)
            mix = (torch.tensor(coin), u if mode == "classmix" else boxes_from_uniforms(u, HW, HW))
            if contra:
                contra_draws = jax_contra(rng, i, n_pixels, contra.select_keys)
        batch = (torch.from_numpy(img_l).permute(0, 3, 1, 2).contiguous(),
                 torch.from_numpy(lab_l), torch.from_numpy(img_u).permute(0, 3, 1, 2).contiguous())
        ((it, m),) = run_steps(tstate, [batch], 1, cfg, start_iter=i, mixes=[mix],
                               contras=[contra_draws])
        steps.append((it, int(tstate.step)))
        bank = tstate.bank
        torch_after.append((
            {k: float(v) for k, v in m.items() if v.dim() == 0},
            {k: v.detach().clone() for k, v in tstate.student.state_dict().items()},
            {k: v.detach().clone() for k, v in tstate.teacher.state_dict().items()},
            {"neg_cand": m["neg_cand"].numpy() if "neg_cand" in m else None,
             "bank": None if bank is None else {
                 "keys": bank.keys.float().numpy(), "ptr": bank.ptr.numpy(),
                 "occupancy": bank.occupancy.numpy()},
             "prototype": None if bank is None else tstate.prototype.numpy().copy()},
        ))
    before = [flax_to_torch({"params": b["params"]}) for b in jax_before]
    return before, jax_after, torch_after, steps


@pytest.fixture(scope="module")
def trajectory():
    return _trajectory(raw_cfg())


@pytest.fixture(scope="module")
def contra_trajectory():
    return _trajectory(raw_cfg(contrastive=CONTRA))


@pytest.fixture(scope="module")
def ema_trajectory():
    """The contrastive trajectory with `contrastive.anchor_ema`, a warmup
    and three semi steps: the prototype zero into the first, then not."""
    return _trajectory(raw_cfg(contrastive={**CONTRA, "anchor_ema": True}), steps=EMA_STEPS)


@pytest.fixture(scope="module")
def variant_trajectory():
    """The contrastive trajectory with `apply_aug: classmix` and
    `contrastive.select_keys: radix`."""
    return _trajectory(raw_cfg(contrastive={**CONTRA, "select_keys": "radix"},
                               apply_aug="classmix"))


def recording_kth(kths):
    """A stand-in for the JAX `_kth_smallest` that appends each k-th value
    it selects to `kths` (a debug callback out of the compiled step)."""
    original = jax_ohem._kth_smallest

    def kth_smallest(p_y, k):
        kth = original(p_y, k)
        jax.debug.callback(lambda v: kths.append(float(v)), kth)
        return kth

    return kth_smallest


@pytest.fixture(scope="module")
def city_trajectory():
    """(the trajectory, the k-th smallest p_y of each OHEM call in JAX and in
    the port: the main and the aux head of each of the three steps)."""
    from u2pl_tpu_torch.ops import quantile

    kths, port_kths = [], []
    plain = quantile.kth_smallest_plain

    def port_kth(p_y, k):
        kth = plain(p_y, k)
        port_kths.append(float(kth))
        return kth

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ohem, "_kth_smallest", recording_kth(kths))
        mp.setattr(quantile, "kth_smallest_plain", port_kth)
        out = _trajectory(city_raw_cfg())
    jax.effects_barrier()
    return out, kths, port_kths


def _delta_close(got, ref, before, name):
    """Per tensor: the L2 of the two updates' difference within TENSOR_L2 of
    the reference update's norm, plus 1e-6 RMS per element for the tensors
    whose gradient is rounding noise; element backstop 0.25 of the largest
    magnitude, as test_golden_step.py.  Returns the two updates for the global check."""
    a, b = (np.asarray(t, np.float64) - before for t in (got, ref))
    nb = np.linalg.norm(b)
    floor = 1e-6 * np.sqrt(b.size)
    assert np.linalg.norm(a - b) <= TENSOR_L2 * nb + floor, (
        f"{name}: L2 {np.linalg.norm(a - b):.3e} vs ||ref|| {nb:.3e}"
    )
    np.testing.assert_allclose(a, b, rtol=0, atol=0.25 * np.abs(b).max() + 1e-5, err_msg=name)
    return a, b


def _global_close(pairs, name):
    diff = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs))
    norm = np.sqrt(sum(np.sum(b ** 2) for _, b in pairs))
    assert diff <= GLOBAL_L2 * norm, f"{name}: global L2 {diff:.3e} vs {norm:.3e}"


def check_losses(trajectory, i, drop_rtol):
    """Step i's losses rtol 1e-4, LR rtol 1e-6, the drop threshold of a semi
    step to `drop_rtol`.  Returns (JAX's, the port's) scalar metrics."""
    _, jax_after, torch_after, steps = trajectory
    assert steps[i] == (i, i + 1)  # (run_steps' i_iter, the device step after it)
    ref, got = jax_after[i][0], torch_after[i][0]
    for k in ("sup_loss", "uns_loss", "con_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6)
    if i > 0:
        assert ref["uns_loss"] > 0
        np.testing.assert_allclose(got["drop_thresh"], ref["drop_thresh"], rtol=drop_rtol)
    return ref, got


def check_student_update(trajectory, i):
    """Step i's student update in the L2 pattern; returns the tensors' names."""
    before, jax_after, torch_after, _ = trajectory
    pairs = [
        _delta_close(torch_after[i][1][k].numpy(), ref.numpy(), before[i][k].numpy(), f"step {i} {k}")
        for k, ref in jax_after[i][1].items()
    ]
    _global_close(pairs, f"step {i} student")
    return list(jax_after[i][1])


def check_teacher_parameters(trajectory, i):
    before, jax_after, torch_after, _ = trajectory
    t_ref, t_got, s_got = jax_after[i][2], torch_after[i][2], torch_after[i][1]
    params = list(jax_after[i][1])
    pairs = []
    for k in params:
        if i == 1:  # first semi epoch: decay 0, teacher == post-step student
            assert torch.equal(t_got[k], s_got[k]), k
        pairs.append(_delta_close(t_got[k].numpy(), t_ref[k].numpy(), before[i][k].numpy(),
                                  f"step {i} teacher {k}"))
    _global_close(pairs, f"step {i} teacher")
    if i == 2:  # epoch 2: a real EMA, the teacher no longer equals the student
        assert any(not torch.equal(t_got[k], s_got[k]) for k in params)


def check_teacher_bn_running_stats(trajectory, i):
    _, jax_after, torch_after, _ = trajectory
    t_ref, t_got = jax_after[i][2], torch_after[i][2]
    keys = [k for k in t_ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        w = t_ref[k].numpy()
        np.testing.assert_allclose(t_got[k].numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"step {i} {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_losses_and_drop_threshold(trajectory, i):
    check_losses(trajectory, i, drop_rtol=1e-5)


@pytest.mark.parametrize("i", range(STEPS))
def test_student_update(trajectory, i):
    check_student_update(trajectory, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_teacher_parameters(trajectory, i):
    check_teacher_parameters(trajectory, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_teacher_bn_running_stats(trajectory, i):
    check_teacher_bn_running_stats(trajectory, i)


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def check_contrastive_losses(trajectory, i):
    """The losses rtol 1e-4; neg_cand exact; the entropy thresholds rtol
    THRESH_RTOL."""
    _, jax_after, torch_after, _ = trajectory
    ref, got = check_losses(trajectory, i, drop_rtol=THRESH_RTOL)
    np.testing.assert_array_equal(torch_after[i][3]["neg_cand"], jax_after[i][3]["neg_cand"])
    if i > 0:
        assert ref["con_loss"] > 0
        for k in ("low_thresh", "high_thresh"):
            np.testing.assert_allclose(got[k], ref[k], rtol=THRESH_RTOL, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_contrastive_losses_and_thresholds(contra_trajectory, i):
    """The losses rtol 1e-4; neg_cand exact; the entropy thresholds rtol
    3e-4 (see the module docstring: JAX against itself moves a pixel's
    entropy by up to 2.9e-4 here; the port moved the thresholds by 9e-6 at
    step 1 and 4.2e-5 at step 2, and the low threshold of step 2, 1.6e-16,
    by 4.9e-5)."""
    check_contrastive_losses(contra_trajectory, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_contrastive_bank(contra_trajectory, i):
    """ptr and occupancy exact; each key within one bfloat16 ulp plus
    KEY_ATOL: the same rows are written, from teacher representations that
    differ as JAX differs from itself (module docstring; measured 7.8e-5
    port vs JAX, 9.6e-5 JAX vs JAX), rounded to bfloat16."""
    check_bank(contra_trajectory, i)


def check_bank(trajectory, i):
    _, jax_after, torch_after, _ = trajectory
    ref, got = jax_after[i][3]["bank"], torch_after[i][3]["bank"]
    for k in ("ptr", "occupancy"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if i > 0:
        assert ref["occupancy"].sum() > 0
    a, b = got["keys"], ref["keys"]
    assert np.all(np.abs(a - b) <= np.maximum(_bf16_ulp(a), _bf16_ulp(b)) + KEY_ATOL), (
        f"step {i}: {int((a != b).sum())} keys differ, max {np.abs(a - b).max()}"
    )


@pytest.mark.parametrize("i", range(STEPS))
def test_contrastive_student_update(contra_trajectory, i):
    """The update in the L2 pattern above; the contrastive loss reaches the
    representation head, so its tensors are held too."""
    keys = check_student_update(contra_trajectory, i)
    assert any(k.startswith("decoder.representation.") for k in keys)


@pytest.mark.parametrize("i", range(STEPS))
def test_classmix_radix_losses_and_bank(variant_trajectory, i):
    """`apply_aug: classmix` with `select_keys: radix`, JAX's own ClassMix
    uniforms and u32 keys replayed: the contrastive trajectory's bounds (the
    same teacher forward decides the pseudo-labels, the thresholds and the
    keys), ptr and occupancy exact."""
    check_contrastive_losses(variant_trajectory, i)
    check_bank(variant_trajectory, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_classmix_radix_update_and_teacher(variant_trajectory, i):
    """The student's update and the teacher in the L2 pattern above."""
    keys = check_student_update(variant_trajectory, i)
    assert any(k.startswith("decoder.representation.") for k in keys)
    check_teacher_parameters(variant_trajectory, i)


@pytest.mark.parametrize("i", range(EMA_STEPS))
def test_anchor_ema_losses_bank_and_prototype(ema_trajectory, i):
    """`contrastive.anchor_ema`: the contrastive trajectory's bounds on the
    losses, thresholds and bank, and the new prototype held as the bank's
    keys are (it is the teacher representation's masked mean, blended):
    within PROTO_ATOL of JAX's.  The warmup leaves it zero; the first semi
    step takes a zero prototype (no blend) and writes its active slots;
    the later ones blend at d = 1 - 1/i_iter."""
    check_contrastive_losses(ema_trajectory, i)
    check_bank(ema_trajectory, i)
    _, jax_after, torch_after, _ = ema_trajectory
    into, ref, got = (jax_after[i][3]["prototype_before"], jax_after[i][3]["prototype"],
                      torch_after[i][3]["prototype"])
    assert got.shape == ref.shape == (5, CONTRA["num_queries"], 1, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROTO_ATOL, err_msg=f"step {i}")
    assert (not into.any()) == (i <= 1)
    assert ref.any() == (i >= 1)
    if i >= 1:  # inactive slots stay zero, active ones are written, alike
        np.testing.assert_array_equal(got.any(axis=(1, 2, 3)), ref.any(axis=(1, 2, 3)))


@pytest.mark.parametrize("i", range(EMA_STEPS))
def test_anchor_ema_update_and_teacher(ema_trajectory, i):
    """The student's update and the teacher in the L2 pattern above."""
    keys = check_student_update(ema_trajectory, i)
    assert any(k.startswith("decoder.representation.") for k in keys)
    check_teacher_parameters(ema_trajectory, i)


def test_cityscapes_ohem_selection_is_live(city_trajectory):
    """JAX's k-th smallest p_y lies above thresh on both heads of every step,
    so the threshold is the k-th value and the selection decides; the port's
    k-th values agree with JAX's to rtol 1e-4, the forward's own bound
    (tests/test_torch_model.py; measured 1.5e-5), each step's pair sorted:
    the order of the callbacks within a step is not fixed."""
    _, kths, port_kths = city_trajectory
    assert len(kths) == len(port_kths) == 2 * STEPS
    assert min(kths) > OHEM_THRESH, kths
    for i in range(STEPS):
        np.testing.assert_allclose(sorted(port_kths[2 * i:2 * i + 2]),
                                   sorted(kths[2 * i:2 * i + 2]), rtol=1e-4)


@pytest.mark.parametrize("i", range(STEPS))
def test_cityscapes_losses(city_trajectory, i):
    check_losses(city_trajectory[0], i, drop_rtol=THRESH_RTOL)


@pytest.mark.parametrize("i", range(STEPS))
def test_cityscapes_student_update(city_trajectory, i):
    """The update in the L2 pattern above, the aux head's tensors included."""
    keys = check_student_update(city_trajectory[0], i)
    assert any(k.startswith("auxor.") for k in keys)


@pytest.mark.parametrize("i", range(STEPS))
def test_cityscapes_teacher(city_trajectory, i):
    """The teacher's parameters (the copy and the EMA) and BN statistics,
    as above."""
    check_teacher_parameters(city_trajectory[0], i)
    check_teacher_bn_running_stats(city_trajectory[0], i)


def sup_step_case(raw):
    """One `make_sup_step` on 4 labeled images (two batches' labeled halves),
    from flax's init, in both packages: (port metrics, JAX metrics, port
    student state_dict, JAX params after, params before)."""
    from u2pl_tpu_torch.train.steps import make_sup_step

    cfg, jcfg = parse_config(raw), jax_parse_config(raw)
    data = batches()
    img = np.concatenate([data[0][0], data[1][0]])
    lab = np.concatenate([data[0][1], data[1][1]])
    model = build_jax_model(jcfg.net)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = _np_tree(init(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3))))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(jcfg.trainer.optimizer, params,
                            head_lr_multiplier=jax_head_lr_multiplier(jcfg))
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        step = jax_sup_step(jcfg, build_jax_model(jcfg.net, axis_name="data"), tx, 2, make_mesh(1))
        state, ref = step(state, jnp.asarray(img), jnp.asarray(lab), jax.random.PRNGKey(0))
    after = flax_to_torch({"params": _np_tree(state.params)})

    snap = {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "teacher_params": variables["params"], "teacher_batch_stats": variables["batch_stats"]}
    tstate = _port_state(cfg, snap, 0)
    tstate.step.fill_(3)
    got = make_sup_step(cfg, 2)(
        tstate, torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lab)
    )
    assert int(tstate.step) == 4
    before = flax_to_torch({"params": variables["params"]})
    return got, ref, tstate.student.state_dict(), after, before


def assert_sup_step_close(case, name):
    """The sup step's loss rtol 1e-4, LR rtol 1e-6, update in the L2 pattern."""
    got, ref, sd, after, before = case
    np.testing.assert_allclose(float(got["sup_loss"]), float(ref["sup_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["lr"]), float(ref["lr"]), rtol=1e-6)
    _global_close([_delta_close(sd[k].numpy(), after[k].numpy(), before[k].numpy(), f"{name} {k}")
                   for k in after], name)


def test_sup_step_matches_jax():
    """One `make_sup_step` on 4 labeled images, from flax's init, in both
    packages; bounds as above."""
    assert_sup_step_close(sup_step_case(raw_cfg()), "sup step")


@pytest.mark.parametrize("contrastive", [None, CONTRA])
def test_semi_step_asks_kernel_d_for_what_it_uses(monkeypatch, contrastive):
    """The semi step's two calls of kernel D (`upsample_softmax_stats`): the
    pseudo-labels take max-prob + argmax and no entropy, the entropy gate
    (and the contrastive thresholds) the entropy alone."""
    from u2pl_tpu_torch.losses import unsup

    cfg = parse_config(raw_cfg(contrastive=contrastive))
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    original = unsup.upsample_softmax_stats

    def recording(logits, size, outputs="all"):
        out = original(logits, size, outputs)
        calls.append((outputs, tuple(t is not None for t in out)))
        return out

    monkeypatch.setattr(unsup, "upsample_softmax_stats", recording)
    img_l, lab_l, img_u = batches()[1]
    batch = (torch.from_numpy(img_l).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lab_l),
             torch.from_numpy(img_u).permute(0, 3, 1, 2).contiguous())
    # iteration 1 of 1-step epochs: the first semi epoch (sup_only_epoch 1)
    ((_, m),) = run_steps(state, [batch], 1, cfg, generator=torch.Generator().manual_seed(1),
                          start_iter=1)
    assert calls == [("prob", (True, True, False)), ("entropy", (False, False, True))]
    assert "drop_thresh" in m and all(bool(torch.isfinite(v).all()) for v in m.values())


def test_unported_branches_raise():
    from u2pl_tpu_torch.train.steps import make_semi_step, make_sup_step

    make_semi_step(parse_config(raw_cfg(contrastive=CONTRA)), 1)  # ported
    # ported: anchor_ema (the ema trajectory above)
    make_semi_step(parse_config(raw_cfg(contrastive={**CONTRA, "anchor_ema": True})), 1)
    # ported: radix key selection and ClassMix (the variant trajectory above)
    make_semi_step(parse_config(raw_cfg(contrastive={**CONTRA, "select_keys": "radix"})), 1)
    make_semi_step(parse_config(raw_cfg(apply_aug="classmix")), 1)
    ohem = raw_cfg()
    ohem["criterion"] = {"type": "ohem", "kwargs": {"thresh": 0.7, "min_kept": 100}}
    make_sup_step(parse_config(ohem), 1)  # ported: the Cityscapes criterion
    make_semi_step(parse_config(ohem), 1)


def test_entry_points_default_to_the_card():
    """`build_model`, `create_train_state` and `init_memobank` put their
    tensors on the card unless the caller names the CPU, and so do the eval
    and infer CLIs unless `--device cpu` is given."""
    import inspect

    from u2pl_tpu_torch import eval as eval_cli
    from u2pl_tpu_torch import infer as infer_cli
    from u2pl_tpu_torch.memobank import init_memobank

    for fn in (build_model, create_train_state, init_memobank):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    for cli in (eval_cli, infer_cli):
        assert cli.get_parser().parse_args([]).device == "cuda", cli.__name__


def test_steps_module_imports_no_jax():
    """Every module of the port, and chip_smoke.py, loads without JAX and
    without the JAX package: nothing named jax, flax, optax or u2pl_tpu(.*)
    in sys.modules after importing them all; chip_smoke.py's imports,
    function-level ones included, name none of them either."""
    code = r"""
import ast, importlib, pkgutil, sys
import u2pl_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(u2pl_tpu_torch.__path__, "u2pl_tpu_torch.")]
assert {"u2pl_tpu_torch.train.steps", "u2pl_tpu_torch.memobank", "u2pl_tpu_torch.dist",
        "u2pl_tpu_torch.losses.ohem", "u2pl_tpu_torch.train_semi", "u2pl_tpu_torch.train_sup",
        "u2pl_tpu_torch.data.loader", "u2pl_tpu_torch.data.native",
        "u2pl_tpu_torch.train.validate", "u2pl_tpu_torch.utils.checkpoint",
        "u2pl_tpu_torch.eval", "u2pl_tpu_torch.infer",
        "u2pl_tpu_torch.utils.msgpack_ckpt"} <= set(mods), mods
for m in mods:
    importlib.import_module(m)
import chip_smoke
tree = ast.parse(open(chip_smoke.__file__).read())
named = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
named += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
forbidden = ("jax", "flax", "optax", "u2pl_tpu")
bad = [m for m in list(sys.modules) + named if m.split(".")[0] in forbidden]
assert not bad, bad
print(len(mods), "modules")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-S", "-c", code], check=True, cwd=root, timeout=120,
                         capture_output=True, text=True,
                         env={**env, "PYTHONPATH": root + os.pathsep + os.pathsep.join(sys.path)})
    assert "modules" in out.stdout
