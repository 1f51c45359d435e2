"""The port's data-parallel train steps at W = 2 against the JAX steps on
`make_mesh(2)`, on the CPU.

The golden trajectory of tests/test_torch_train_step.py (warmup -> the first
semi epoch -> epoch 2, contrastive on, its resnet10 config) with `net.sync_bn`
on and a global batch of 4 + 4 images at 33²: JAX runs
`make_semi_warmup_step` / `make_semi_step` over the mesh's two shards, 2 + 2
images each, SyncBN, the gradient pmean and the bank's all_gather compiled
in.  The port runs each step on 2 gloo ranks (tests/torch_dist_worker.py),
rank r on shard r's images, from JAX's state before the step, with shard r's
CutMix coin and boxes and contrastive draws replayed from JAX's key schedule,
fold_in(fold_in(rng, i), r) (steps.py:275-281); dropout off on both sides.
It is held to that file's bounds, none looser: the losses (summed over the
ranks) rtol 1e-4, the thresholds (their mean) THRESH_RTOL, neg_cand (the
max) exact, the student's update and the teacher's parameters in its L2
pattern, the teacher's BN statistics rtol 1e-4, the bank's ptr and occupancy
exact and its keys within a bf16 ulp plus KEY_ATOL.  After each step the two
ranks' states (models, optimizer trace, bank) are bit-equal.  The sup step
at W = 2: tests/test_torch_dist_sup.py.

With `contrastive.anchor_ema` (`ema_trajectory`) each rank keeps its own
prototype, as each JAX device keeps its own buffer of the P()-specced
state: rank r is fed device r's shard before a step and held to device
r's shard after it (PROTO_ATOL), and the ranks' bit-equality covers the
rest of the state, not the prototype.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contrastive import jax_draws
from test_torch_dist import Ranks, W, assert_bit_equal, post
from test_torch_train_step import (
    BANK, CONTRA, HW, PROTO_ATOL, STEPS, _jax_snapshot, _np_bank, _np_tree, check_bank, check_contrastive_losses, check_student_update,
    check_teacher_bn_running_stats, check_teacher_parameters, raw_cfg,
)
from u2pl_tpu.config import head_lr_multiplier as jax_head_lr_multiplier
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.dist import make_mesh
from u2pl_tpu.memobank import init_memobank as jax_init_memobank
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.train.optim import make_optimizer as jax_make_optimizer
from u2pl_tpu.train.state import TrainState, copy_student_to_teacher as jax_copy
from u2pl_tpu.train.steps import make_semi_step as jax_semi_step
from u2pl_tpu.train.steps import make_semi_warmup_step as jax_warmup_step
from u2pl_tpu_torch.ops.mixing import boxes_from_uniforms
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

B_RANK = 2  # labeled (and unlabeled) images a rank
SIDE = ((HW - 1) // 2 + 1) // 2 + 1  # the os4 side: 33 -> 17 -> 9
N_PIXELS = 2 * B_RANK * SIDE * SIDE  # a rank's rep pixels


def sync_raw(**kw):
    raw = raw_cfg(**kw)
    raw["net"]["sync_bn"] = True
    return raw


def global_batches(b=B_RANK * W, steps=STEPS):
    """The smooth, colour-labeled batches of tests/test_torch_train_step.py
    at b labeled + b unlabeled images a step (the mesh's global batch)."""
    from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

    rng = np.random.RandomState(22)

    def images():
        x = np.stack([resize_bilinear_numpy(rng.randn(4, 4, 3).astype(np.float32), (HW, HW))
                      for _ in range(b)]) * 2
        return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)

    out = []
    for _ in range(steps):
        img_l = images()
        lab_l = np.clip(((img_l[..., 0] + 2) * 5 / 4).astype(np.int32), 0, 4)
        lab_l[:, :3] = 255
        out.append((img_l, lab_l, images()))
    return out


def _shard_rng(rng, i_iter, shard):
    return jax.random.fold_in(jax.random.fold_in(rng, i_iter), shard)


def shard_mix(rng, i_iter, shard):
    """Shard `shard`'s coin and CutMix uniforms at `i_iter` (steps.py:275-281)."""
    _, _, _, k_coin, k_mix = jax.random.split(_shard_rng(rng, i_iter, shard), 5)
    coin = bool(jax.random.uniform(k_coin, ()) < 0.5)
    u = [[float(jax.random.uniform(r, ())) for r in jax.random.split(k, 3)]
         for k in jax.random.split(k_mix, B_RANK)]
    return coin, torch.tensor(u, dtype=torch.float32)


def shard_contra(rng, i_iter, shard):
    k_contra = jax.random.split(_shard_rng(rng, i_iter, shard), 5)[2]
    return jax_draws(k_contra, CONTRA["num_queries"], CONTRA["num_negatives"], 5, N_PIXELS)


def nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def port_snapshot(snap, step):
    """JAX's state `snap` in the port's names, for the worker."""
    out = {"step": step,
           "student": flax_to_torch({"params": snap["params"], "batch_stats": snap["batch_stats"]}),
           "teacher": flax_to_torch({"params": snap["teacher_params"],
                                     "batch_stats": snap["teacher_batch_stats"]}),
           "trace": flax_to_torch({"params": snap["trace"]}) if step > 0 else None}
    if "bank" in snap:
        b = snap["bank"]
        out["bank"] = {"keys": torch.from_numpy(b["keys"]).to(torch.bfloat16),
                       **{k: torch.from_numpy(b[k]) for k in ("ptr", "occupancy", "sizes")}}
    return out


def port_entry(i, snap, batch, rng, prototypes=None):
    """The worker's step i: JAX's state before it, the global batch, and
    each rank's replayed CutMix and contrastive draws (semi steps), and
    under anchor_ema each rank's prototype (`prototypes[r]`)."""
    img_l, lab_l, img_u = batch
    entry = {"kind": "semi", "i": i, "steps_per_epoch": 1, "state": port_snapshot(snap, i),
             "batch": (nchw(img_l), torch.from_numpy(lab_l), nchw(img_u)),
             "mix": [None] * W, "contra": [None] * W}
    if prototypes is not None:
        entry["prototype"] = [torch.from_numpy(p) for p in prototypes]
    if i > 0:
        for r in range(W):
            coin, u = shard_mix(rng, i, r)
            entry["mix"][r] = (torch.tensor(coin), boxes_from_uniforms(u, HW, HW))
            entry["contra"][r] = shard_contra(rng, i, r)
    return entry


def device_prototypes(state, mesh):
    """Each device's own buffer of JAX's `state.prototype`, in the mesh's
    device order: the step's P() spec with check_vma=False leaves each
    device the prototype it computed from its shard (steps.py:576-581)."""
    shards = state.prototype.addressable_shards
    if len(shards) == 1:  # the initial state, on one device before the first step
        return [np.array(shards[0].data)] * W
    by_device = {sh.device: np.array(sh.data) for sh in shards}
    return [by_device[d] for d in mesh.devices.flat]


def _trajectory(tmp_path_factory, raw, steps=STEPS):
    """(before, jax_after, torch_after, steps) in the format of
    tests/test_torch_train_step.py, torch_after from rank 0, and both ranks'
    raw outputs; under anchor_ema each step's extras also hold the devices'
    prototypes before and after it (`device_prototypes`)."""
    jcfg = jax_parse_config(raw)
    ema = jcfg.trainer.contrastive.anchor_ema
    data = global_batches(steps=steps)
    # a step key whose coin lands heads on every semi step on both shards
    seed = next(s for s in range(256) if all(
        shard_mix(jax.random.PRNGKey(s), i, r)[0] for i in range(1, steps) for r in range(W)))
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
        bank=jax_init_memobank(5, 256, **BANK),
        prototype=jnp.zeros((5, CONTRA["num_queries"], 1, 256)),
    )
    # the ranks start now and take step i as soon as JAX's state before it
    # is posted, while JAX compiles and runs the next
    tmp = tmp_path_factory.mktemp("steps")
    ranks = Ranks("steps", {"raw": raw, "posted_steps": len(data)}, tmp)
    try:
        jax_before, jax_after = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
            model = build_jax_model(jcfg.net, axis_name="data")
            mesh = make_mesh(W)
            warmup = jax_warmup_step(jcfg, model, tx, 1, mesh)
            semi = jax_semi_step(jcfg, model, tx, 1, mesh)
            for i, (img_l, lab_l, img_u) in enumerate(data):
                jax_before.append(_jax_snapshot(state))
                into = device_prototypes(state, mesh) if ema else None
                post(tmp, f"step{i}.pt", port_entry(i, jax_before[i], data[i], rng, into))
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
                    {"neg_cand": np.asarray(m["neg_cand"]) if "neg_cand" in m else None,
                     "bank": _np_bank(state.bank),
                     "prototypes": (into, device_prototypes(state, mesh)) if ema else None},
                ))
    except BaseException:
        ranks.kill()
        raise
    ranks = ranks.wait()
    torch_after, steps = [], []
    for out in ranks[0]:
        m, st = out["metrics"], out["state"]
        steps.append(out["steps"])
        torch_after.append((
            {k: v for k, v in m.items() if not torch.is_tensor(v)}, st["student"], st["teacher"],
            {"neg_cand": m["neg_cand"].numpy() if "neg_cand" in m else None,
             "bank": {"keys": st["bank"]["keys"].float().numpy(),
                      "ptr": st["bank"]["ptr"].numpy(),
                      "occupancy": st["bank"]["occupancy"].numpy()}},
        ))
    before = [flax_to_torch({"params": b["params"]}) for b in jax_before]
    return (before, jax_after, torch_after, steps), ranks


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    return _trajectory(tmp_path_factory, sync_raw(contrastive=CONTRA))


@pytest.fixture(scope="module")
def ema_trajectory(tmp_path_factory):
    """`contrastive.anchor_ema` at W = 2: a warmup and 2 semi steps."""
    return _trajectory(tmp_path_factory, sync_raw(contrastive={**CONTRA, "anchor_ema": True}))


@pytest.mark.parametrize("i", range(STEPS))
def test_losses_thresholds_and_bank(trajectory, i):
    """The losses summed over the ranks rtol 1e-4, neg_cand (the ranks' max)
    exact, the thresholds (their mean) THRESH_RTOL; the bank fed by both
    ranks' keys: ptr and occupancy exact, keys within a bf16 ulp + KEY_ATOL."""
    traj, _ = trajectory
    check_contrastive_losses(traj, i)
    check_bank(traj, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_student_update_and_teacher(trajectory, i):
    """The student's update (the gradients' mean over the ranks) and the
    teacher's parameters and SyncBN running statistics."""
    traj, _ = trajectory
    keys = check_student_update(traj, i)
    assert any(k.startswith("decoder.representation.") for k in keys)
    check_teacher_parameters(traj, i)
    check_teacher_bn_running_stats(traj, i)


@pytest.mark.parametrize("i", range(STEPS))
def test_ranks_bit_equal(trajectory, i):
    """Both ranks leave step i with the same models, optimizer trace, bank
    and logged metrics, bit for bit."""
    _, ranks = trajectory
    assert_bit_equal(ranks[0][i]["state"], ranks[1][i]["state"], f"step {i}")
    assert_bit_equal(ranks[0][i]["metrics"], ranks[1][i]["metrics"], f"step {i} metrics")


@pytest.mark.parametrize("i", range(STEPS))
def test_anchor_ema_per_rank_prototype(ema_trajectory, i):
    """anchor_ema at W = 2: the losses, thresholds and bank at the bounds
    above, and each rank's prototype, fed device r's shard of JAX's
    `state.prototype` before the step, within PROTO_ATOL of device r's shard
    after it (not of the array as a whole: each device keeps its own, and so
    does each rank; after the first semi step they differ).  The ranks stay
    bit-equal in everything else."""
    traj, ranks = ema_trajectory
    check_contrastive_losses(traj, i)
    check_bank(traj, i)
    into, after = traj[1][i][3]["prototypes"]
    for r in range(W):
        np.testing.assert_array_equal(ranks[r][i]["prototype_in"].numpy(), into[r])
        np.testing.assert_allclose(ranks[r][i]["prototype"].numpy(), after[r], rtol=0,
                                   atol=PROTO_ATOL, err_msg=f"step {i} rank {r}")
    assert (not into[0].any()) == (i <= 1) and after[0].any() == (i >= 1)
    if i == 2:
        assert not np.array_equal(after[0], after[1])  # the devices' prototypes part
    assert_bit_equal(ranks[0][i]["state"], ranks[1][i]["state"], f"step {i}")
