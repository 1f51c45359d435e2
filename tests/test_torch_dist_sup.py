"""`make_sup_step` at W = 2 against JAX's sup step on `make_mesh(2)`, on
the CPU: one step on a global batch of 4 labeled 33² images, 2 a gloo rank
(tests/torch_dist_worker.py), from flax's init, with SyncBN and the
gradient mean; the bounds of tests/test_torch_train_step.py's sup step (the
loss, summed over the ranks, rtol 1e-4; the update in its L2 pattern), and
the two ranks' students bit-equal.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dist import W, assert_bit_equal, run_ranks
from test_torch_dist_steps import global_batches, nchw, sync_raw
from test_torch_train_step import HW, _np_tree, assert_sup_step_close
from u2pl_tpu.config import head_lr_multiplier as jax_head_lr_multiplier
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.dist import make_mesh
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.train.optim import make_optimizer as jax_make_optimizer
from u2pl_tpu.train.state import TrainState
from u2pl_tpu.train.steps import make_sup_step as jax_sup_step
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch


def test_sup_step_matches_jax(tmp_path):
    """One `make_sup_step` on a global batch of 4 labeled images, 2 a rank,
    from flax's init, against JAX's sup step on make_mesh(2): the loss
    (summed over the ranks) rtol 1e-4, the update in the L2 pattern; the
    ranks' students bit-equal."""
    raw = sync_raw()
    jcfg = jax_parse_config(raw)
    data = global_batches()
    img = np.concatenate([data[0][0][:2], data[1][0][:2]])
    lab = np.concatenate([data[0][1][:2], data[1][1][:2]])
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
        step = jax_sup_step(jcfg, build_jax_model(jcfg.net, axis_name="data"), tx, 2,
                            make_mesh(W))
        state, ref = step(state, jnp.asarray(img), jnp.asarray(lab), jax.random.PRNGKey(0))
    snap = {"step": 3, "student": flax_to_torch(variables), "teacher": None, "trace": None}
    ranks = run_ranks("steps", {"raw": raw, "steps": [
        {"kind": "sup", "steps_per_epoch": 2, "state": snap,
         "batch": (nchw(img), torch.from_numpy(lab))}]}, tmp_path)
    (out0,), (out1,) = ranks
    assert out0["steps"] == (3, 4)
    assert_bit_equal(out0["state"], out1["state"], "sup step")
    after = flax_to_torch({"params": _np_tree(state.params)})
    before = flax_to_torch({"params": variables["params"]})
    assert_sup_step_close((out0["metrics"], jax.device_get(ref), out0["state"]["student"], after,
                           before), "sup step W=2")
