"""The port's data-parallel pieces on the CPU: gloo process groups of worker
processes (tests/torch_dist_worker.py, torch only) against the JAX package
on 2 CPU devices.

- SyncBN: the port's `BatchNorm2d` under 2 ranks against flax `BatchNorm`
  with `axis_name` (the JAX package's `make_norm`) under `shard_map` on
  `make_mesh(2)`: outputs, input gradients, each rank's parameter
  gradients and the running statistics, in float32 (rtol / atol 1e-5: the
  two sum E[x] and E[x²] in other orders) and bfloat16 (equal but at bf16
  rounding boundaries, one ulp apart there).
- K5's slab enqueue: the plain version against JAX's `enqueue_segments`,
  bit-equal, for 1, 2, 3 and 8 ranks, f32 / bf16 slabs into f32 / bf16
  banks, rings that wrap and calls whose W x K rows exceed a queue; its
  kernel's blocks walked in their layout (`slab_walk`): each ring row
  written once, the plain version's keys.
- A group of one process gives the bits of no group (3 steps through
  `run_steps` with dropout and the contrastive branch on, SyncBN set).
The steps at W = 2: tests/test_torch_dist_steps.py and test_torch_dist_sup.py;
validation and the loaders: test_torch_dist_data.py; the CLI:
test_torch_dist_cli.py.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from u2pl_tpu.dist import make_mesh
from u2pl_tpu.memobank import MemoryBank as JaxBank
from u2pl_tpu.memobank import enqueue_segments as jax_enqueue_segments
from u2pl_tpu.models.resnet import make_norm
from u2pl_tpu_torch.memobank import MemoryBank, memobank_enqueue_slabs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
W = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class Ranks:
    """The worker's `task` started on `world` ranks of a gloo group
    (`env_of(rank, port)`: extra environment of a rank).  The children start
    without site packages but for this interpreter's path, so they import
    torch and the port alone.  `wait()` returns their outputs in rank order."""

    def __init__(self, task, inp, tmp_path, world=W, env_of=None):
        port = free_port()
        path_in = str(tmp_path / f"{task}_in.pt")
        torch.save(inp, path_in)
        base = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        base.update(PYTHONPATH=os.pathsep.join([ROOT, *sys.path]), OMP_NUM_THREADS="2")
        self.outs = [tmp_path / f"{task}_out{r}.pt" for r in range(world)]
        self.procs = []
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-S", WORKER, task, str(r), str(world), str(port), path_in,
                     str(self.outs[r])],
                    env={**base, **(env_of(r, port) if env_of else {})}, cwd=str(tmp_path),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        except BaseException:
            self.kill()
            raise

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self, timeout=240):
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
        finally:
            self.kill()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-6000:]}"
        return [torch.load(out, weights_only=False) for out in self.outs]


def run_ranks(task, inp, tmp_path, world=W, env_of=None, timeout=240):
    """`Ranks(...).wait()`: the task's outputs in rank order."""
    return Ranks(task, inp, tmp_path, world, env_of).wait(timeout)


def post(tmp_path, name, obj):
    """Hand `obj` to running workers as `name` (written whole, then renamed)."""
    torch.save(obj, tmp_path / f"{name}.tmp")
    os.replace(tmp_path / f"{name}.tmp", tmp_path / name)


def assert_bit_equal(a, b, where=""):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_bit_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), f"{where}: {a} != {b}"


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


# ---- SyncBN -----------------------------------------------------------------

BN_SHAPE = (4, 6, 5, 7)  # the global (N, C, H, W): 2 images a rank


def bn_inputs():
    rng = np.random.RandomState(3)
    n, c, _, _ = BN_SHAPE
    x = (rng.randn(*BN_SHAPE) * 1.5 + rng.randn(1, c, 1, 1) * 2).astype(np.float32)
    return {"x": x, "g": rng.randn(*BN_SHAPE).astype(np.float32),
            "weight": (1 + 0.3 * rng.randn(c)).astype(np.float32),
            "bias": (0.2 * rng.randn(c)).astype(np.float32),
            "running_mean": (0.1 * rng.randn(c)).astype(np.float32),
            "running_var": (1 + 0.1 * rng.rand(c)).astype(np.float32)}


def jax_sync_bn(inp, dtype):
    """flax BatchNorm(axis_name="data") under shard_map on 2 devices: (y,
    the input gradient, each shard's (scale, bias) gradient, the new running
    mean and var), NCHW."""
    bn = make_norm("data", dtype=dtype)(use_running_average=False)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    x, g = nhwc(inp["x"]).astype(dtype), nhwc(inp["g"]).astype(dtype)
    params = {"scale": jnp.asarray(inp["weight"]), "bias": jnp.asarray(inp["bias"])}
    stats = {"mean": jnp.asarray(inp["running_mean"]), "var": jnp.asarray(inp["running_var"])}

    def body(x, g, params, stats):
        def f(x, params):
            y, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return y, mut["batch_stats"]

        y, vjp, new = jax.vjp(f, x, params, has_aux=True)
        gx, gp = vjp(g)
        return y, gx, jax.tree_util.tree_map(lambda a: a[None], gp), new

    out = jax.shard_map(body, mesh=make_mesh(W), in_specs=(P("data"), P("data"), P(), P()),
                        out_specs=(P("data"), P("data"), P("data"), P()),
                        check_vma=False)(x, g, params, stats)
    y, gx, gp, new = jax.device_get(out)
    nchw = lambda a: np.asarray(a, np.float32).transpose(0, 3, 1, 2)  # noqa: E731
    return nchw(y), nchw(gx), np.asarray(gp["scale"]), np.asarray(gp["bias"]), \
        np.asarray(new["mean"]), np.asarray(new["var"])


@pytest.fixture(scope="module")
def sync_bn_runs(tmp_path_factory):
    inp = bn_inputs()
    ranks = run_ranks("bn", {k: torch.from_numpy(v) for k, v in inp.items()},
                      tmp_path_factory.mktemp("bn"))
    return inp, ranks


def _close_bf16(got, want, what):
    """Equal but at bf16 rounding boundaries, one ulp apart there, in at
    most 2% of the elements."""
    diff = got != want
    ulp = np.maximum(bf16_ulp(got), bf16_ulp(want))
    assert np.all(np.abs(got - want)[diff] <= ulp[diff]), what
    assert diff.mean() <= 0.02, (what, diff.mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sync_bn_matches_flax_under_shard_map(sync_bn_runs, dtype):
    """Each rank's output and input gradient are flax's on that shard, its
    scale / bias gradients flax's of that shard (before the steps' gradient
    mean), and both ranks' running statistics flax's global update."""
    inp, ranks = sync_bn_runs
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y, gx, gw, gb, mean, var = jax_sync_bn(inp, jdt)
    n = BN_SHAPE[0] // W
    for r, out in enumerate(ranks):
        o = out[str(dtype)]
        assert o["y"].dtype == o["gx"].dtype == dtype
        got_y, got_gx = o["y"].float().numpy(), o["gx"].float().numpy()
        want_y, want_gx = y[r * n:(r + 1) * n], gx[r * n:(r + 1) * n]
        if dtype == torch.float32:
            np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5, err_msg="y")
            np.testing.assert_allclose(got_gx, want_gx, rtol=1e-5, atol=1e-5, err_msg="grad x")
        else:
            _close_bf16(got_y, want_y, f"rank {r} y")
            _close_bf16(got_gx, want_gx, f"rank {r} grad x")
        np.testing.assert_allclose(o["gw"].numpy(), gw[r], rtol=1e-4, atol=1e-4, err_msg="scale")
        np.testing.assert_allclose(o["gb"].numpy(), gb[r], rtol=1e-4, atol=1e-4, err_msg="bias")
        np.testing.assert_allclose(o["mean"].numpy(), mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["var"].numpy(), var, rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        assert torch.equal(ranks[0][str(dtype)][k], ranks[1][str(dtype)][k])


# ---- K5: the slab enqueue -----------------------------------------------------

def slab_case(w, seed):
    """A (3 classes, 40-row ring, F 8) bank part full, with class 0's ring
    about to wrap, and (w, 3, 16, 8) slabs: class 0 full on every rank (W x
    16 rows: past the 40-row queue from 3 ranks on), class 2 empty on rank 0."""
    rng = np.random.RandomState(seed)
    c, k, f = 3, 16, 8
    keys = rng.randn(c, 40, f).astype(np.float32)
    sizes = np.array([40, 24, 24], np.int32)
    ptr = np.array([35, 20, 3], np.int32)
    occ = np.array([40, 24, 10], np.int32)
    slabs = rng.randn(w, c, k, f).astype(np.float32)
    counts = rng.randint(0, k + 1, (w, c)).astype(np.int32)
    counts[:, 0] = k
    counts[0, 2] = 0
    return keys, ptr, occ, sizes, slabs, counts


@pytest.mark.parametrize("slab_dtype,bank_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_slab_enqueue_bit_equal_to_jax(w, slab_dtype, bank_dtype):
    """Two calls in a row, each bit-equal to JAX's `enqueue_segments` of the
    slabs as (C, W, K, F) with the counts as (C, W): keys, ptr, occupancy."""
    jbank = tbank = None
    for call in range(2):
        keys, ptr, occ, sizes, slabs, counts = slab_case(w, 10 * w + call)
        if jbank is None:
            jbank = JaxBank(jnp.asarray(keys).astype(bank_dtype), jnp.asarray(ptr),
                            jnp.asarray(occ), jnp.asarray(sizes))
            tbank = MemoryBank(torch.from_numpy(keys).to(getattr(torch, bank_dtype)),
                               torch.from_numpy(ptr), torch.from_numpy(occ),
                               torch.from_numpy(sizes))
        js = jnp.asarray(slabs).astype(slab_dtype)
        jbank = jax_enqueue_segments(jbank, js.transpose(1, 0, 2, 3), jnp.asarray(counts).T)
        ts = torch.from_numpy(slabs).to(getattr(torch, slab_dtype))
        assert memobank_enqueue_slabs(tbank, ts, torch.from_numpy(counts)) is tbank
        np.testing.assert_array_equal(tbank.keys.float().numpy(),
                                      np.asarray(jbank.keys.astype(jnp.float32)))
        np.testing.assert_array_equal(tbank.ptr.numpy(), np.asarray(jbank.ptr))
        np.testing.assert_array_equal(tbank.occupancy.numpy(), np.asarray(jbank.occupancy))
    if w >= 3:  # class 0 took more rows than its queue holds
        assert w * 16 > 40


SLAB_ROWS = 32  # memobank.cu: kSlabRows, the slab rows a block of the slab enqueue writes


def slab_walk(keys, ptr, sizes, slabs, counts):
    """K5's slab enqueue walked as its blocks run (memobank.cu:
    mb_enqueue_slabs_kernel): block (tile, w, c) counts the rows before rank
    w's in class c's order and the total, and writes rows [max(tile * 32,
    total - size - before), min(tile * 32 + 32, n)) at ring row (ptr + before
    + r) % size.  Returns the keys and every ring row's number of writes."""
    w_n, c_n, k, _ = slabs.shape
    keys = keys.copy()
    writes = np.zeros(keys.shape[:2], np.int64)
    n = np.minimum(counts, k)
    for c in range(c_n):
        total = int(n[:, c].sum())
        for w in range(w_n):
            before = int(n[:w, c].sum())
            for tile in range(-(-k // SLAB_ROWS)):
                t0 = tile * SLAB_ROWS
                for r in range(max(t0, total - int(sizes[c]) - before),
                               min(t0 + SLAB_ROWS, int(n[w, c]))):
                    row = (int(ptr[c]) + before + r) % int(sizes[c])
                    keys[c, row] = slabs[w, c, r]
                    writes[c, row] += 1
    return keys, writes


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_slab_kernel_blocks_write_each_kept_row_once(w):
    """The slab enqueue's blocks, walked in their layout over K = 80 (three
    tiles, the last partial): every ring row written at most once, and the
    keys those writes leave equal the plain version's (ptr and occupancy
    are the plain version's formula, in the last block)."""
    rng = np.random.RandomState(40 + w)
    keys, ptr, occ, sizes, _, _ = slab_case(w, w)
    slabs = rng.randn(w, 3, 80, 8).astype(np.float32)
    counts = rng.randint(0, 81, (w, 3)).astype(np.int32)
    counts[:, 0] = 80
    counts[-1, 1] = 95  # past K: K rows
    got, writes = slab_walk(keys, ptr, sizes, slabs, counts)
    assert writes.max() <= 1
    bank = MemoryBank(torch.from_numpy(keys), torch.from_numpy(ptr), torch.from_numpy(occ),
                      torch.from_numpy(sizes))
    memobank_enqueue_slabs(bank, torch.from_numpy(slabs), torch.from_numpy(counts))
    np.testing.assert_array_equal(got, bank.keys.numpy())
    kept = np.minimum(np.minimum(counts, 80).sum(0), sizes)
    np.testing.assert_array_equal(writes.sum(1), kept)


# ---- a group of one process ---------------------------------------------------

def test_one_rank_group_is_bit_equal_to_no_group(tmp_path):
    """run_steps from one state, 3 steps (warmup, the first semi epoch, epoch
    2) with dropout, CutMix and the contrastive branch drawn from the step
    generators, SyncBN set: a gloo group of one process gives the metrics,
    models, optimizer state and bank of no group, bit for bit."""
    from test_torch_train_step import CONTRA, batches, raw_cfg
    from u2pl_tpu_torch.config import parse_config
    from u2pl_tpu_torch.train.state import create_train_state

    raw = raw_cfg(contrastive=CONTRA)
    raw["net"]["sync_bn"] = True
    cfg = parse_config(raw)
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    snap = {"step": 0, "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict(), "trace": None,
            "bank": {f: getattr(state.bank, f) for f in ("keys", "ptr", "occupancy", "sizes")}}
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    data = [(nchw(a), torch.from_numpy(b), nchw(c)) for a, b, c in batches()]
    (out,) = run_ranks("one_rank", {"raw": raw, "state": snap, "batches": data,
                                    "steps_per_epoch": 1, "seed": 3, "port": free_port()},
                       tmp_path, world=1)
    assert out["none"]["state"]["step"] == 3
    assert out["none"]["metrics"][2]["con_loss"] > 0
    assert int(out["none"]["state"]["bank"]["occupancy"].sum()) > 0
    assert_bit_equal(out["group"], out["none"], "group of one")
