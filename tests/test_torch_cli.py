"""The port's trainer CLIs end to end on the CPU: `u2pl_tpu_torch.train_semi`
and `train_sup` on a synthetic VOC-layout workspace (`data/synthetic.py`),
in the pattern of tests/test_e2e_cli.py, with `--device cpu` (the kernels'
plain versions).

The config is experiments/pascal/1464/{ours,suponly} as it stands, cut to
resnet10 + a 16-plane decoder, 5 classes, 33² crops, 2 + 2 images per step,
4 steps per epoch and a 64 / 96-row bank (the sizes of
tests/test_torch_train_step.py).  U2PL_ALLOW_RANDOM_INIT=1 stands in for
the ImageNet weights the config requires.

Resume: the checkpoint a 2-epoch run wrote after its first epoch, resumed
with auto_resume, ends bit-equal (student, teacher, optimizer, bank, step)
to the uninterrupted run: every draw of step i comes from a generator
seeded by (seed, i), and process-mode loader workers reseed per batch.
"""

import functools
import json
import logging
import os
import shutil

import pytest
import torch

from u2pl_tpu_torch import dist, memobank, train_semi, train_sup
from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config
from u2pl_tpu_torch.train import state as state_mod
from u2pl_tpu_torch.utils.checkpoint import CKPT_BEST_NAME, CKPT_NAME, JAX_CKPT_NAME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(REPO, "experiments", "pascal", "1464", "ours", "config.yaml")
VOC_SUP = os.path.join(REPO, "experiments", "pascal", "1464", "suponly", "config.yaml")
C = 5
SMALL = {
    "net.num_classes": C, "net.encoder.type": "u2pl.models.resnet.resnet10",
    "net.decoder.kwargs.inner_planes": 16, "net.decoder.kwargs.dilations": [2, 4, 6],
    "dataset.train.crop.size": [33, 33], "dataset.val.crop.size": [33, 33],
    "dataset.batch_size": 2, "dataset.n_sup": 8, "dataset.pool_size": 16,
    "trainer.epochs": 2, "trainer.sup_only_epoch": 1,
}
# process-mode loaders, one spawned worker each (workers reseed per batch)
PROCESS = {"dataset.workers_mode": "process", "dataset.workers": 1}
CONTRA = {"trainer.contrastive.num_queries": 8, "trainer.contrastive.num_negatives": 4,
          "trainer.contrastive.max_keys_per_class_per_step": 16,
          "trainer.contrastive.low_rank": 1, "trainer.contrastive.high_rank": 3}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the runs are small, and the test suite runs
    files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_ws"))
    return root, make_voc_workspace(root, 8, 8, 3, size=(40, 52), num_classes=C, seed=0)


@pytest.fixture(autouse=True)
def small_bank(monkeypatch):
    monkeypatch.setenv("U2PL_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setattr(state_mod, "init_memobank",
                        functools.partial(memobank.init_memobank, queue_size=64, class0_size=96))


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run(module, cfg_path, **kw):
    """module.main on the CPU, seed 2; (summary, the log lines)."""
    rec = Records()
    logging.getLogger("global").addHandler(rec)
    try:
        out = module.main(["--config", cfg_path, "--seed", "2", "--device", "cpu"])
    finally:
        logging.getLogger("global").removeHandler(rec)
    return out, rec.lines


def config(ws, name, src=VOC, **extra):
    root, paths = ws
    contra = CONTRA if src == VOC else {}
    return write_config(src, paths, os.path.join(root, name), {**SMALL, **contra, **extra})


def snapshot(state):
    out = {"student": state.student.state_dict(), "opt": state.optimizer.state_dict(),
           "step": int(state.step)}
    if state.teacher is not None:
        out["teacher"] = state.teacher.state_dict()
    if state.bank is not None:
        out["bank"] = {f: getattr(state.bank, f) for f in ("keys", "ptr", "occupancy")}
    return {k: _clone(v) for k, v in out.items()}


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    return x


def assert_bit_equal(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_bit_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def uninterrupted(ws):
    """2 epochs (warmup, then semi), process-mode workers: (summary, log
    lines, state snapshot, experiment dir, a copy of epoch 0's ckpt.pth)."""
    root, _ = ws
    first = os.path.join(root, "after_epoch_0.pth")
    end_of_epoch = train_semi.end_of_epoch

    def keep_first(cfg, *args, **kw):
        best = end_of_epoch(cfg, *args, **kw)
        if not os.path.exists(first):
            shutil.copyfile(os.path.join(cfg.save_path, CKPT_NAME), first)
        return best

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("U2PL_ALLOW_RANDOM_INIT", "1")
        mp.setattr(state_mod, "init_memobank",
                   functools.partial(memobank.init_memobank, queue_size=64, class0_size=96))
        mp.setattr(train_semi, "end_of_epoch", keep_first)
        cfg = config(ws, "full", **PROCESS)
        summary, lines = run(train_semi, cfg)
    return summary, lines, snapshot(summary["state"]), os.path.dirname(cfg), first


def test_train_semi_end_to_end(uninterrupted):
    summary, lines, snap, exp, _ = uninterrupted
    assert summary["steps"] == 8 and summary["steps_per_epoch"] == 4 and snap["step"] == 8
    assert len(summary["mious"]) == 2 and all(0.0 <= m <= 1.0 for m in summary["mious"])
    assert summary["best_miou"] == max(summary["mious"])
    for name in (CKPT_NAME, CKPT_BEST_NAME):
        assert os.path.isfile(os.path.join(exp, "checkpoints", name)), name
    text = "\n".join(lines)
    # the flagship's net.dtype: bfloat16, as the JAX trainer takes it
    assert "training in bfloat16" in text and "Iter [0/8]" in text  # logged every 10 steps
    assert text.count(" * class [") == 2 * C
    assert " * epoch 0 mIoU" in text and " * epoch 1 mIoU" in text
    assert text.count("Currently, the best val result is") == 2
    ckpt = torch.load(os.path.join(exp, "checkpoints", CKPT_NAME), weights_only=False)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 8 and ckpt["best_miou"] == summary["best_miou"]
    assert {"model_state", "teacher_state", "optimizer_state", "memobank", "prototype"} <= set(ckpt)
    # the bank filled in the semi epoch: its occupancy was saved
    assert int(ckpt["memobank"]["occupancy"].sum()) > 0
    (logdir,) = os.listdir(os.path.join(exp, "log", "events_seg"))
    with open(os.path.join(exp, "log", "events_seg", logdir, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("mIoU val") == 2 and "Con Loss" in tags


def test_resume_is_bit_equal_to_an_uninterrupted_run(ws, uninterrupted):
    """The uninterrupted run's checkpoint after epoch 0, resumed with
    auto_resume in a fresh experiment dir: the same student, teacher,
    optimizer state, bank and step after epoch 1 as the 2-epoch run."""
    _, _, want, _, first = uninterrupted
    cfg = config(ws, "resumed", **PROCESS, **{"saver.auto_resume": True})
    os.makedirs(os.path.join(os.path.dirname(cfg), "checkpoints"))
    shutil.copyfile(first, os.path.join(os.path.dirname(cfg), "checkpoints", CKPT_NAME))
    summary, lines = run(train_semi, cfg)
    assert summary["start_epoch"] == 1 and summary["start_iter"] == 4 and summary["steps"] == 4
    assert any("resumed at epoch 1, step 4" in ln for ln in lines)
    assert_bit_equal(snapshot(summary["state"]), want)


def jax_ckpt_of(pth, cfg_path, out):
    """The state of the port's `.pth` at `pth` as the JAX package's TrainState
    (its `torch_to_flax` for both models and for the SGD trace, the bank and
    the prototype as they are), written to `out` by the JAX package's
    `save_checkpoint` with the file's epoch and best mIoU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from u2pl_tpu.config import head_lr_multiplier, load_config
    from u2pl_tpu.memobank import MemoryBank
    from u2pl_tpu.models import build_model as build_jax_model
    from u2pl_tpu.train.optim import make_optimizer
    from u2pl_tpu.train.state import TrainState
    from u2pl_tpu.utils.checkpoint import save_checkpoint
    from u2pl_tpu.utils.convert_torch import torch_to_flax
    from u2pl_tpu_torch.config import load_config as port_load_config
    from u2pl_tpu_torch.utils.checkpoint import load_checkpoint

    jcfg = load_config(cfg_path)
    tmpl = build_jax_model(jcfg.net).init(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)),
                                          train=False)
    ckpt = torch.load(pth, weights_only=False)
    student, teacher = (torch_to_flax(ckpt[k], tmpl) for k in ("model_state", "teacher_state"))
    port = state_mod.create_train_state(port_load_config(cfg_path), device="cpu")
    load_checkpoint(pth, port)
    trace = {n: port.optimizer.state[p]["trace"] for n, p in port.student.named_parameters()}
    tx = make_optimizer(jcfg.trainer.optimizer, student["params"], head_lr_multiplier(jcfg))
    opt = optax.tree_utils.tree_set(
        tx.init(student["params"]), trace=torch_to_flax(trace, {"params": tmpl["params"]})["params"])
    bank = port.bank
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = TrainState(
        step=jnp.asarray(int(port.step), jnp.int32), params=tree(student["params"]),
        batch_stats=tree(student["batch_stats"]), opt_state=opt,
        teacher_params=tree(teacher["params"]), teacher_batch_stats=tree(teacher["batch_stats"]),
        bank=MemoryBank(jnp.asarray(bank.keys.float().numpy(), jnp.bfloat16),
                        *(jnp.asarray(getattr(bank, f).numpy()) for f in ("ptr", "occupancy",
                                                                          "sizes"))),
        prototype=jnp.asarray(port.prototype.numpy()))
    save_checkpoint(out, state, ckpt["epoch"], ckpt["best_miou"])
    return np.asarray(state.step)


def test_auto_resume_from_the_jax_ckpt(ws, uninterrupted):
    """A folder holding only the JAX package's `ckpt.ckpt` (the uninterrupted
    run's state after epoch 0, written by the JAX package): auto_resume
    starts at its epoch and step, and the run ends bit-equal to the
    uninterrupted one (student, teacher, optimizer, bank, step) but for
    BatchNorm's `num_batches_tracked`, a counter JAX has not (0 after a
    `.ckpt`, so epoch 0's count is missing from it)."""
    _, _, want, _, first = uninterrupted
    cfg = config(ws, "from_jax", **PROCESS, **{"saver.auto_resume": True})
    folder = os.path.join(os.path.dirname(cfg), "checkpoints")
    os.makedirs(folder)
    assert jax_ckpt_of(first, cfg, os.path.join(folder, JAX_CKPT_NAME)) == 4
    assert os.listdir(folder) == [JAX_CKPT_NAME]
    summary, lines = run(train_semi, cfg)
    assert summary["start_epoch"] == 1 and summary["start_iter"] == 4 and summary["steps"] == 4
    assert any(f"Resume model from: '{os.path.join(folder, JAX_CKPT_NAME)}'" in ln for ln in lines)
    assert any("resumed at epoch 1, step 4" in ln for ln in lines)
    got = snapshot(summary["state"])
    want = {k: dict(v) if isinstance(v, dict) else v for k, v in want.items()}
    for model in ("student", "teacher"):
        for k in [k for k in want[model] if k.endswith("num_batches_tracked")]:
            # both models counted epoch 0's 4 train-mode forwards before the file
            assert got[model].pop(k) == want[model].pop(k) - 4, (model, k)
    assert_bit_equal(got, want)


def test_train_sup_end_to_end(ws):
    cfg = config(ws, "sup", src=VOC_SUP, **{"trainer.epochs": 1})
    summary, lines = run(train_sup, cfg)
    assert summary["steps"] == 4 and len(summary["mious"]) == 1 and 0.0 <= summary["mious"][0] <= 1.0
    exp = os.path.dirname(cfg)
    ckpt = torch.load(os.path.join(exp, "checkpoints", CKPT_BEST_NAME), weights_only=False)
    assert "teacher_state" not in ckpt and "memobank" not in ckpt and ckpt["epoch"] == 1
    assert os.path.isfile(os.path.join(exp, "checkpoints", CKPT_NAME))
    assert any("Iter [0/4]" in ln for ln in lines) and any(" * epoch 0 mIoU" in ln for ln in lines)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    """`--profile_dir`: the torch.profiler window the CLI opens around steps
    10-13 ends in a chrome trace there."""
    prof = train_semi._start_profiler()
    torch.ones(8, 8).matmul(torch.ones(8, 8))
    train_semi._stop_profiler(prof, str(tmp_path / "trace"), torch.device("cpu"),
                              logging.getLogger("global"))
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


class SetupReached(Exception):
    pass


@pytest.fixture
def no_launcher(monkeypatch):
    for _, names in dist.LAUNCHERS:
        for name in names:
            monkeypatch.delenv(name, raising=False)
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)


# each launcher's variables for rank 1 of 2, local rank 1 (torchrun's with its
# address; SLURM and Open MPI take localhost and the default port)
LAUNCH_ENV = {
    "WORLD_SIZE": ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
                    "MASTER_ADDR": "127.0.0.9", "MASTER_PORT": "29123"}, "tcp://127.0.0.9:29123"),
    "SLURM_NTASKS": ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "1"},
                     f"tcp://localhost:{dist.DEFAULT_PORT}"),
    "OMPI_COMM_WORLD_SIZE": ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
                              "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
                             f"tcp://localhost:{dist.DEFAULT_PORT}"),
}


class GroupStub:
    def __init__(self):
        self.rank, self.size, self.backend = 1, 2, "gloo"


@pytest.mark.parametrize("module", [train_semi, train_sup], ids=["semi", "sup"])
@pytest.mark.parametrize("var", ["WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"])
def test_multi_process_launch_raises_before_any_state(monkeypatch, no_launcher, module, var):
    """Each launcher's variables reach `init_distributed`: rank 1 of 2 with
    `--device cpu` makes a gloo group at the launch's address with rank 1
    and world size 2, and the setup gets the CPU and that group; with
    `--device cuda`, local rank 1 has no card of its own (one visible) and
    the launch raises before the setup and before any group is made."""
    env, address = LAUNCH_ENV[var]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    made = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: bool(made))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, init_method, rank, world_size:
                        made.append((backend, init_method, rank, world_size)))
    monkeypatch.setattr(dist, "Group", GroupStub)

    def setup(args, logger, device, group):
        raise SetupReached(device, group)

    monkeypatch.setattr(module, "setup", setup)
    with pytest.raises(SetupReached) as reached:
        module.main(["--config", "config.yaml", "--device", "cpu"])
    device, group = reached.value.args
    assert made == [("gloo", address, 1, 2)]
    assert device == torch.device("cpu") and (group.rank, group.size) == (1, 2)

    made.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 of a world of 2 has no card of its own"):
        module.main(["--config", "config.yaml", "--device", "cuda"])
    assert made == []


@pytest.mark.parametrize("module", [train_semi, train_sup], ids=["semi", "sup"])
def test_single_process_launch_still_starts(monkeypatch, no_launcher, module):
    """A world size of 1 under every launcher's variable (a one-process
    torchrun, a one-task SLURM or MPI job) goes on to the setup with no
    group."""
    for _, (_, world, _) in dist.LAUNCHERS:
        monkeypatch.setenv(world, "1")

    def setup(args, logger, device, group):
        assert group is None and device == torch.device("cpu")
        raise SetupReached

    monkeypatch.setattr(module, "setup", setup)
    with pytest.raises(SetupReached):
        module.main(["--config", "config.yaml", "--device", "cpu"])
