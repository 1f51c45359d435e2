"""The port's memory bank against the JAX package's, on the CPU: the cases of
tests/test_memobank.py, each fed the same keys and draws on both sides and
held bit-equal (keys, ptr, occupancy, samples).  Also the train step's
write, `memobank_enqueue` (kernel K5's plain version on the CPU), against
JAX's gather + `enqueue_segments`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu import memobank as jm
from u2pl_tpu_torch import memobank as tm


def port(bank):
    dtype = torch.bfloat16 if bank.keys.dtype == jnp.bfloat16 else torch.float32
    keys = torch.from_numpy(np.array(bank.keys.astype(jnp.float32))).to(dtype)
    return tm.MemoryBank(keys, *(torch.from_numpy(np.array(a)) for a in
                                 (bank.ptr, bank.occupancy, bank.sizes)))


def assert_equal(got, ref):
    np.testing.assert_array_equal(got.keys.float().numpy(), np.asarray(ref.keys.astype(jnp.float32)))
    for k in ("ptr", "occupancy", "sizes"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax(dtype):
    ref = jm.init_memobank(4, 8, queue_size=5, class0_size=9, dtype=jnp.dtype(dtype))
    got = tm.init_memobank(4, 8, queue_size=5, class0_size=9, dtype=dtype, device="cpu")
    assert got.keys.dtype == getattr(torch, dtype)
    assert_equal(got, ref)
    with pytest.raises(NotImplementedError, match="queue_dtype"):
        tm.init_memobank(4, 8, dtype="float16", device="cpu")


def test_enqueue_and_wraparound():
    ref = jm.init_memobank(2, 4, queue_size=5, class0_size=8, dtype=jnp.float32)
    got = tm.init_memobank(2, 4, queue_size=5, class0_size=8, dtype=torch.float32, device="cpu")

    def slab(start, n, k=6):
        keys = np.zeros((k, 4), np.float32)
        valid = np.zeros((k,), bool)
        keys[:n] = np.arange(start, start + n)[:, None]
        valid[:n] = True
        return keys, valid

    (k0, v0), (k1, v1) = slab(0, 3), slab(100, 6)
    keys, valid = np.stack([k0, k1]), np.stack([v0, v1])
    ref = jm.enqueue(ref, jnp.asarray(keys), jnp.asarray(valid))
    assert tm.enqueue(got, torch.from_numpy(keys), torch.from_numpy(valid)) is got
    assert_equal(got, ref)
    np.testing.assert_array_equal(got.ptr.numpy(), [3, 1])
    np.testing.assert_array_equal(got.keys[1, :5, 0].numpy(), [105, 101, 102, 103, 104])

    # the same draws sample the same keys
    u = jax.random.uniform(jax.random.PRNGKey(0), (2, 64))
    ref_s, ref_ne = jm.sample(ref, jax.random.PRNGKey(0), 64)
    got_s, got_ne = tm.sample(got, torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_ne.numpy(), np.asarray(ref_ne))
    assert set(got_s[0, :, 0].tolist()) <= {0.0, 1.0, 2.0}


def test_empty_class_sampling_flag():
    got = tm.init_memobank(3, 4, queue_size=5, class0_size=5, dtype=torch.float32, device="cpu")
    ref_s, ref_ne = jm.sample(jm.init_memobank(3, 4, 5, 5, jnp.float32), jax.random.PRNGKey(0), 8)
    u = jax.random.uniform(jax.random.PRNGKey(0), (3, 8))
    got_s, got_ne = tm.sample(got, torch.from_numpy(np.array(u)))
    assert not got_ne.any()
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_valid_mask_compaction_preserves_order():
    keys = np.arange(8, dtype=np.float32).repeat(2).reshape(1, 8, 2)
    valid = np.array([[0, 1, 0, 1, 1, 0, 0, 1]], bool)
    ref = jm.enqueue(jm.init_memobank(1, 2, 10, 10, jnp.float32), jnp.asarray(keys), jnp.asarray(valid))
    got = tm.enqueue(tm.init_memobank(1, 2, 10, 10, torch.float32, device="cpu"),
                     torch.from_numpy(keys), torch.from_numpy(valid))
    assert_equal(got, ref)
    np.testing.assert_array_equal(got.keys[0, :4, 0].numpy(), [1, 3, 4, 7])


@pytest.mark.parametrize("trial", range(6))
def test_enqueue_segments_matches_jax(trial):
    """Multi-replica segments (W = 4) and wrap-over past the queue size, in
    bfloat16 storage (round to nearest even on both sides)."""
    rng = np.random.RandomState(trial)
    c, w, k, f = 3, 4, 16, 5
    qsize = [7, 40, 13][trial % 3]
    ref = jm.init_memobank(c, f, queue_size=qsize, class0_size=qsize + 4)
    got = port(ref)
    for shape in [(c, 1, k, f), (c, w, k, f)]:
        keys = rng.randn(*shape).astype(np.float32)
        n = rng.randint(0, k + 1, shape[:2]).astype(np.int32)
        ref = jm.enqueue_segments(ref, jnp.asarray(keys), jnp.asarray(n))
        tm.enqueue_segments(got, torch.from_numpy(keys), torch.from_numpy(n))
        assert_equal(got, ref)


def test_overfull_single_enqueue_keeps_newest_size_keys():
    c, f, qsize = 2, 3, 5
    first = np.arange(c * 2 * f, dtype=np.float32).reshape(c, 2, f)
    keys = (100 + np.arange(c * 12 * f, dtype=np.float32)).reshape(c, 12, f)
    ref = jm.init_memobank(c, f, queue_size=qsize, class0_size=qsize, dtype=jnp.float32)
    got = tm.init_memobank(c, f, queue_size=qsize, class0_size=qsize, dtype=torch.float32,
                           device="cpu")
    for k in (first, keys):
        valid = np.ones(k.shape[:2], bool)
        ref = jm.enqueue(ref, jnp.asarray(k), jnp.asarray(valid))
        tm.enqueue(got, torch.from_numpy(k), torch.from_numpy(valid))
    assert_equal(got, ref)
    np.testing.assert_array_equal(got.occupancy.numpy(), [qsize, qsize])
    for r in range(12 - qsize, 12):  # the newest qsize ranks, in ring order
        np.testing.assert_array_equal(got.keys[:, (2 + r) % qsize].numpy(), keys[:, r])


@pytest.mark.parametrize("k,qsize", [(6, 40), (6, 7), (12, 5)])
def test_memobank_enqueue_matches_jax_gather_and_segments(k, qsize):
    """The train step's write: the selected rows of the teacher's NCHW
    representation (contrastive.py:259), then enqueue_segments (:273)."""
    rng = np.random.RandomState(k + qsize)
    b, f, h, w, c = 2, 8, 3, 5, 3
    rep = rng.randn(b, f, h, w).astype(np.float32)
    sel = np.stack([rng.permutation(b * h * w)[:k] for _ in range(c)]).astype(np.int32)
    n_sel = np.array([k, 0, k // 2], np.int32)
    ref = jm.init_memobank(c, f, queue_size=qsize, class0_size=qsize + 3)
    ref = jm.enqueue_segments(ref, jnp.asarray(rng.randn(c, 1, k, f).astype(np.float32)),
                              jnp.asarray(np.full((c, 1), k - 1, np.int32)))
    got = port(ref)
    rep_f = jnp.asarray(np.moveaxis(rep, 1, -1).reshape(-1, f))
    ref = jm.enqueue_segments(ref, rep_f[jnp.asarray(sel)][:, None], jnp.asarray(n_sel[:, None]))
    assert tm.memobank_enqueue(got, torch.from_numpy(rep), torch.from_numpy(sel),
                               torch.from_numpy(n_sel)) is got
    assert_equal(got, ref)
