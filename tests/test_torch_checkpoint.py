"""Checkpoints of the port (u2pl_tpu_torch/utils/checkpoint.py), on the CPU.

- save -> load is bit-equal: student and teacher parameters and BN buffers,
  the optimizer's state, the bank, the prototype, the step, the epoch and
  best_miou, loaded onto the state's device;
- the JAX package's `load_eval_variables` reads the port's `ckpt_best.pth`
  (reference keys), recovers the flax variables exactly, and its eval
  forward matches the port's within tests/test_torch_model.py's tolerance;
- `saver.pretrain` loads weights only (no optimizer state, no step),
  dropping shape-mismatched tensors; auto_resume comes first;
- the ImageNet warm start loads into both encoders, and a missing file
  raises under `pretrained_required` unless U2PL_ALLOW_RANDOM_INIT is set.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import C, HW, perturbed_flax_variables, small_net_raw
from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.utils.checkpoint import load_eval_variables as jax_load_eval_variables
from u2pl_tpu_torch import memobank
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.train import state as state_mod
from u2pl_tpu_torch.train.steps import make_semi_warmup_step
from u2pl_tpu_torch.utils import checkpoint as ck
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

CONTRA = {"negative_high_entropy": True, "low_rank": 1, "high_rank": 3,
          "current_class_threshold": 0.3, "current_class_negative_threshold": 1,
          "low_entropy_threshold": 20, "num_negatives": 4, "num_queries": 8,
          "temperature": 0.5, "max_keys_per_class_per_step": 16}


def raw_cfg(num_classes=C, optimizer="SGD", **saver):
    net = small_net_raw(False)
    net["num_classes"] = num_classes
    kwargs = {"lr": 0.01, "weight_decay": 1e-4, **({"momentum": 0.9} if optimizer == "SGD" else {})}
    return {"dataset": {"type": "pascal_semi", "batch_size": 2, "ignore_label": 255},
            "trainer": {"epochs": 2, "sup_only_epoch": 1,
                        "optimizer": {"type": optimizer, "kwargs": kwargs},
                        "lr_scheduler": {"mode": "poly", "kwargs": {"power": 0.9}},
                        "unsupervised": {"drop_percent": 80, "apply_aug": "cutmix"},
                        "contrastive": CONTRA},
            "saver": {"snapshot_dir": "checkpoints", **saver},
            "criterion": {"type": "CELoss", "kwargs": {}}, "net": net}


class JitInit:
    """The flax model's init compiled whole (one XLA program in place of
    one per op), for `perturbed_flax_variables`."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames="train")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the models are small, and the test suite runs
    files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_bank(monkeypatch):
    monkeypatch.setattr(state_mod, "init_memobank",
                        functools.partial(memobank.init_memobank, queue_size=64, class0_size=96))


def trained_state(seed, cfg=None):
    """A state after one warmup step (momentum buffers, moved BN
    statistics), with a filled bank, a prototype and step 7."""
    cfg = cfg or parse_config(raw_cfg())
    st = state_mod.create_train_state(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(2, 3, 33, 33).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, C, (2, 33, 33)).astype(np.int32))
    make_semi_warmup_step(cfg, 4)(st, img, lab, img.flip(0), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    st.bank.keys.copy_(torch.randn(st.bank.keys.shape, generator=g))
    st.bank.ptr.copy_(torch.randint(0, 64, st.bank.ptr.shape, generator=g))
    st.bank.occupancy.copy_(torch.randint(0, 64, st.bank.occupancy.shape, generator=g))
    st.prototype.copy_(torch.randn(st.prototype.shape, generator=g))
    st.step.fill_(7)
    return st


def state_tensors(st):
    out = {f"student.{k}": v for k, v in st.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in st.teacher.state_dict().items()})
    for i, p in enumerate(st.student.parameters()):
        for k, v in st.optimizer.state[p].items():
            out[f"opt.{i}.{k}"] = v
    out.update({f"bank.{f}": getattr(st.bank, f) for f in ("keys", "ptr", "occupancy", "sizes")})
    out.update(prototype=st.prototype, step=st.step)
    return out


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_save_load_round_trip_is_bit_equal(tmp_path, optimizer):
    """SGD's momentum, or Adam's moments and its int32 step count."""
    cfg = parse_config(raw_cfg(optimizer=optimizer))
    src = trained_state(0, cfg)
    path = str(tmp_path / ck.CKPT_NAME)
    ck.save_checkpoint(path, src, epoch=3, best_miou=0.4321)
    assert os.listdir(tmp_path) == [ck.CKPT_NAME]  # written atomically, no .tmp left
    dst = trained_state(1, cfg)
    want = state_tensors(src)
    assert any(not torch.equal(want[k], v) for k, v in state_tensors(dst).items())
    out, epoch, best = ck.load_checkpoint(path, dst)
    assert out is dst and epoch == 3 and best == 0.4321
    got = state_tensors(dst)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert dst.optimizer.state_dict()["param_groups"] == src.optimizer.state_dict()["param_groups"]


def test_file_format_and_no_memobank(tmp_path):
    st = trained_state(0)
    path = str(tmp_path / ck.CKPT_BEST_NAME)
    ck.save_checkpoint(path, st, epoch=1, best_miou=0.5, save_memobank=False)
    payload = torch.load(path, weights_only=False)
    assert set(payload) == {"epoch", "best_miou", "step", "model_state", "teacher_state",
                            "optimizer_state", "prototype"}
    assert payload["step"] == 7 and isinstance(payload["epoch"], int)
    assert all(v.device.type == "cpu" for v in payload["model_state"].values())
    # the bank is not restored from a file without it
    other = trained_state(1)
    keys = other.bank.keys.clone()
    ck.load_checkpoint(path, other)
    assert torch.equal(other.bank.keys, keys)


def test_jax_reads_the_ports_checkpoint(tmp_path):
    raw = raw_cfg()
    jmodel = build_jax_model(jax_parse_config(raw).net)
    init = JitInit(jmodel)
    variables = perturbed_flax_variables(init)
    st = trained_state(0)
    sd = flax_to_torch(variables)
    st.student.load_state_dict(sd, strict=True)
    st.teacher.load_state_dict(sd, strict=True)
    path = str(tmp_path / ck.CKPT_BEST_NAME)
    ck.save_checkpoint(path, st, epoch=1, best_miou=0.5)
    loaded = jax_load_eval_variables(init, path, (HW, HW))  # its template init, compiled
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = np.random.RandomState(1).randn(2, HW, HW, 3).astype(np.float32)
    forward = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)["pred"])
    ref = np.asarray(forward(loaded, jnp.asarray(x)))
    model = ck.load_eval_variables(st.teacher, path)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))["pred"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_pretrain_loads_weights_only(tmp_path):
    src = trained_state(0)
    path = str(tmp_path / "pretrain.pth")
    ck.save_checkpoint(path, src, epoch=5, best_miou=0.9)
    cfg = parse_config(raw_cfg(pretrain=path))
    dst = state_mod.create_train_state(cfg, device="cpu",
                                       generator=torch.Generator().manual_seed(3))
    loaded, epoch, best = ck.maybe_resume(cfg.saver, str(tmp_path / "none"), dst)
    assert (loaded, epoch, best) == (True, 0, 0.0)
    for model in ("student", "teacher"):
        want, got = getattr(src, model).state_dict(), getattr(dst, model).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), model
    assert int(dst.step) == 0 and not dst.optimizer.state

    # a checkpoint of a 6-class model: everything but the classifier loads
    six = trained_state(2, parse_config(raw_cfg(num_classes=6)))
    ck.save_checkpoint(path, six, epoch=1, best_miou=0.1)
    before = dst.student.state_dict()
    before = {k: v.clone() for k, v in before.items()}
    ck.load_pretrain_weights(path, dst)
    after, six_sd = dst.student.state_dict(), six.student.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    mismatched = {k for k in after if after[k].shape != six_sd[k].shape}
    assert mismatched and not (changed & mismatched)
    assert all(torch.equal(after[k], six_sd[k]) for k in after if k not in mismatched)


@pytest.mark.parametrize("name, zipfile", [("pretrain.pt", True), ("pretrain.pth.tar", True),
                                           ("weights", True), ("legacy.pth", False)])
def test_pretrain_from_a_torch_file_of_any_name(tmp_path, name, zipfile):
    """A torch file is read as one whatever its name, the format told by
    its first byte (a zip archive, or the legacy format's pickle):
    `saver.pretrain` of a `.pt`, a `.pth.tar` or a name with no suffix
    loads its weights only, and `load_model_variables` its teacher."""
    src = trained_state(0)
    path = str(tmp_path / name)
    ck.save_checkpoint(path, src, epoch=5, best_miou=0.9)
    if not zipfile:
        torch.save(torch.load(path, weights_only=False), path,
                   _use_new_zipfile_serialization=False)
    cfg = parse_config(raw_cfg(pretrain=path))
    dst = state_mod.create_train_state(cfg, device="cpu",
                                       generator=torch.Generator().manual_seed(3))
    assert ck.maybe_resume(cfg.saver, str(tmp_path / "none"), dst) == (True, 0, 0.0)
    for model in ("student", "teacher"):
        want, got = getattr(src, model).state_dict(), getattr(dst, model).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), model
    assert int(dst.step) == 0 and not dst.optimizer.state
    teacher = ck.load_model_variables(path)
    assert all(torch.equal(teacher[k], v) for k, v in src.teacher.state_dict().items())


def test_auto_resume_comes_before_pretrain(tmp_path):
    src = trained_state(0)
    save = tmp_path / "checkpoints"
    save.mkdir()
    ck.save_checkpoint(str(save / ck.CKPT_NAME), src, epoch=2, best_miou=0.25)
    other = trained_state(1)
    ck.save_checkpoint(str(tmp_path / "pretrain.pth"), other, epoch=9, best_miou=0.75)
    cfg = parse_config(raw_cfg(auto_resume=True, pretrain=str(tmp_path / "pretrain.pth")))
    dst = state_mod.create_train_state(cfg, device="cpu")
    assert ck.maybe_resume(cfg.saver, str(save), dst) == (True, 2, 0.25)
    assert int(dst.step) == 7 and torch.equal(dst.bank.keys, src.bank.keys)
    # auto_resume with no checkpoint starts fresh, without the pretrain
    fresh = state_mod.create_train_state(cfg, device="cpu")
    assert ck.maybe_resume(cfg.saver, str(tmp_path / "empty"), fresh) == (False, 0, 0.0)


def test_imagenet_warm_start(tmp_path, monkeypatch):
    cfg = parse_config(raw_cfg())
    enc = dataclasses.replace(cfg.net.encoder, pretrained=True, pretrained_required=True)
    st = trained_state(0)
    monkeypatch.delenv("U2PL_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(FileNotFoundError, match="pretrained_required"):
        ck.load_encoder_pretrained(enc, st)
    with pytest.raises(FileNotFoundError, match="U2PL_ALLOW_RANDOM_INIT"):
        ck.load_encoder_pretrained(dataclasses.replace(enc, pretrained=str(tmp_path / "x.pth")), st)
    monkeypatch.setenv("U2PL_ALLOW_RANDOM_INIT", "1")
    before = {k: v.clone() for k, v in st.student.state_dict().items()}
    assert ck.load_encoder_pretrained(enc, st) is st
    assert all(torch.equal(v, before[k]) for k, v in st.student.state_dict().items())

    # a real file: both encoders take it, strict=False (an extra key is ignored)
    imagenet = trained_state(5).student.encoder.state_dict()
    imagenet["fc.weight"] = torch.zeros(3, 3)
    path = str(tmp_path / "resnet10.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in imagenet.items()}}, path)
    decoder = {k: v.clone() for k, v in st.student.decoder.state_dict().items()}
    ck.load_encoder_pretrained(dataclasses.replace(enc, pretrained=path), st)
    for model in (st.student, st.teacher):
        got = model.encoder.state_dict()
        assert all(torch.equal(got[k], imagenet[k]) for k in got)
    assert all(torch.equal(v, decoder[k]) for k, v in st.student.decoder.state_dict().items())
