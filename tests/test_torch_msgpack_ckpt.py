"""The port's `.ckpt` reader (u2pl_tpu_torch/utils/msgpack_ckpt.py) against
flax's own `msgpack_restore`, on bytes that `flax.serialization.msgpack_serialize`
wrote in the layout of u2pl_tpu/utils/checkpoint.py:save_checkpoint.

Every leaf must be bit-equal: the same dtype, shape and bytes for an
array (a bfloat16 leaf is a `torch.bfloat16` tensor whose bits are
flax's), the same type and value for a scalar, the same keys for a map.
Then `load_model_variables` on such a file: teacher preferred, the state
dict `flax_to_torch` makes of the JAX variables, and a resume from a
`.ckpt` refused.
"""

import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from test_torch_model import C, perturbed_flax_variables, small_net_raw
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.utils import checkpoint as ck
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch
from u2pl_tpu_torch.utils.msgpack_ckpt import msgpack_restore, read_msgpack_ckpt


def assert_bit_equal(ref, got, path="root"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), (path, list(got), list(ref))
        for k in ref:
            assert_bit_equal(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_bit_equal(r, g, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, (path, type(got))
        assert tuple(got.shape) == ref.shape, path
        bits = got.contiguous().view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits, np.asarray(ref).view(np.uint16), err_msg=path)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref), (path, type(got), type(ref))
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, got.shape)
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        if isinstance(ref, float):  # the bits: -0.0 and nan too
            assert struct.pack(">d", got) == struct.pack(">d", ref), (path, got, ref)
        else:
            assert got == ref, (path, got, ref)


def payload_like_save_checkpoint(rng, bank_shape=(3, 40, 8)):
    """A payload in save_checkpoint's layout: scalars, model / teacher
    {params, batch_stats}, an optax state (tuples as "0", "1", ... maps),
    a bf16 bank with its int32 ring fields and the f32 prototype."""
    params = {"conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                       "bias": rng.randn(5).astype(np.float32)}}
    stats = {"bn": {"mean": rng.randn(5).astype(np.float32),
                    "var": rng.rand(5).astype(np.float32)}}
    opt = optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(0.01, momentum=0.9))
    opt_state = opt.init({k: jnp.asarray(v) for k, v in params["conv"].items()})
    c, n, f = bank_shape
    bank = {
        "keys": jnp.asarray(rng.randn(c, n, f), jnp.bfloat16),
        "ptr": rng.randint(0, n, c).astype(np.int32),
        "occupancy": rng.randint(0, n, c).astype(np.int32),
        "sizes": np.full(c, n, np.int32),
    }
    to_np = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return {
        "epoch": 3,
        "best_miou": 0.4375,
        "step": 12,
        "model_state": serialization.to_state_dict({"params": params, "batch_stats": stats}),
        "optimizer_state": serialization.to_state_dict(
            jax.tree_util.tree_map(np.asarray, opt_state)),
        "teacher_state": serialization.to_state_dict({"params": params, "batch_stats": stats}),
        "memobank": to_np(bank),
        "prototype": rng.randn(c, f).astype(np.float32),
    }


def test_every_leaf_type_bit_equal_to_flax():
    rng = np.random.RandomState(0)
    tree = {
        "f32": rng.randn(2, 3).astype(np.float32),
        "f64": rng.randn(4).astype(np.float64),
        "bf16": np.asarray(jnp.asarray(rng.randn(5, 7), jnp.bfloat16)),
        "i32": rng.randint(-2**31, 2**31 - 1, (3, 4)).astype(np.int32),
        "i64": np.array([-2**62, 2**62], np.int64),
        "u8": rng.randint(0, 256, (17,)).astype(np.uint8),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "0d": np.array(2.5, np.float32),
        "np_scalars": {"f32": np.float32(1.25), "i32": np.int32(-7), "i64": np.int64(2**40),
                       "u8": np.uint8(200), "bool": np.bool_(True), "f64": np.float64(-0.0),
                       "bf16": jnp.bfloat16(3.5)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 + 5,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -0.0, 1.5, 1e300, -1e-300, float("inf"), float("nan")],
        "misc": [None, True, False, "", "x" * 31, "y" * 32, "z" * 300, "é" * 70000],
        "bytes": b"\x00\x01" * 200,
        "as_dict_list": serialization.to_state_dict([np.arange(3, dtype=np.int32), (1, 2)]),
        "wide_map": {str(i): i for i in range(70000)},
        "nested": {"a": {"b": {"c": {"d": np.ones((2, 2), np.float32)}}}},
    }
    blob = serialization.msgpack_serialize(tree)
    assert_bit_equal(serialization.msgpack_restore(blob), msgpack_restore(blob))


def test_checkpoint_payload_bit_equal_to_flax(tmp_path):
    payload = payload_like_save_checkpoint(np.random.RandomState(1))
    path = tmp_path / "ckpt.ckpt"
    path.write_bytes(serialization.msgpack_serialize(payload))
    ref = serialization.msgpack_restore(path.read_bytes())
    got = read_msgpack_ckpt(str(path))
    assert_bit_equal(ref, got)
    assert set(got["optimizer_state"]) == {"0", "1"}  # optax's chain: a tuple
    assert got["memobank"]["keys"].dtype == torch.bfloat16


@pytest.mark.parametrize("chunk_bytes", [64, 1000])
def test_chunked_leaves_bit_equal_to_flax(monkeypatch, chunk_bytes):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into flat chunks under
    `__msgpack_chunked_array__`; the reader joins them back."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    rng = np.random.RandomState(2)
    tree = {
        "f32": rng.randn(13, 11).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.randn(7, 9, 5), jnp.bfloat16)),
        "u8": rng.randint(0, 256, (3, 500)).astype(np.uint8),
        "small": np.arange(4, dtype=np.int32),
        "inner": {"i32": rng.randint(0, 9, (600,)).astype(np.int32)},
    }
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert_bit_equal(serialization.msgpack_restore(blob), msgpack_restore(blob))


def test_truncated_or_foreign_bytes_raise():
    blob = serialization.msgpack_serialize({"a": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(blob[:-3])
    with pytest.raises(ValueError, match="after the object"):
        msgpack_restore(blob + b"\x00")
    with pytest.raises(ValueError, match="ext type 5"):
        msgpack_restore(b"\xd4\x05\x00")


@pytest.fixture(scope="module")
def jax_variables():
    raw = {"net": small_net_raw(aux=True)}
    model = build_jax_model(jax_parse_config(raw).net)
    return raw, perturbed_flax_variables(model, seed=4), perturbed_flax_variables(model, seed=5)


def _write(path, payload):
    path.write_bytes(serialization.msgpack_serialize(payload))
    return str(path)


def test_model_from_ckpt_equals_flax_to_torch(tmp_path, jax_variables):
    raw, teacher, student = jax_variables
    path = _write(tmp_path / "ckpt_best.ckpt", {
        "epoch": 1, "best_miou": 0.0, "step": 2,
        "model_state": serialization.to_state_dict(student),
        "teacher_state": serialization.to_state_dict(teacher),
    })
    want = flax_to_torch(teacher)
    got = ck.load_model_variables(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    model = ck.load_eval_variables(build_model(parse_config(raw).net, device="cpu"), path)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert model.decoder.classifier[8].weight.shape[0] == C


def test_teacher_preferred_else_model_state(tmp_path, jax_variables):
    _, teacher, student = jax_variables
    both = _write(tmp_path / "both.ckpt", {
        "epoch": 1, "model_state": serialization.to_state_dict(student),
        "teacher_state": serialization.to_state_dict(teacher)})
    sup = _write(tmp_path / "sup.ckpt", {
        "epoch": 1, "model_state": serialization.to_state_dict(student)})
    k = "decoder.classifier.8.bias"
    t, s = flax_to_torch(teacher)[k], flax_to_torch(student)[k]
    assert not torch.equal(t, s)
    assert torch.equal(ck.load_model_variables(both)[k], t)
    assert torch.equal(ck.load_model_variables(both, prefer_teacher=False)[k], s)
    assert torch.equal(ck.load_model_variables(sup)[k], s)
    with pytest.raises(FileNotFoundError):
        ck.load_model_variables(str(tmp_path / "missing.ckpt"))


def test_resume_from_ckpt_raises(tmp_path, jax_variables):
    _, teacher, _ = jax_variables
    path = _write(tmp_path / "ckpt.ckpt", {"epoch": 1, "model_state":
                                           serialization.to_state_dict(teacher)})
    state = types.SimpleNamespace(student=torch.nn.Linear(1, 1))  # names the device alone
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.load_checkpoint(path, state)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.load_pretrain_weights(path, state)
