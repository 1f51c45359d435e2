"""The port's host data pipeline (u2pl_tpu_torch/data) against the JAX
package's (u2pl_tpu/data), on the CPU.

- split parsing, the seeded labeled subset and the epoch order are equal;
- the numpy transforms are bit-equal under the same `random` /
  `np.random` seeds, for every stage the configs use (random resize, blur,
  rotation, fixed resize, flip, crop with its label-pad-0 quirk, uint8
  output, and the Cityscapes builder's Cutout and Cutmix tails);
- the port's fused C++ path (data/csrc/augment.cc, built with g++ at first
  use) gives the JAX numpy path's labels exactly and its images within
  2e-3 (the bound of tests/test_native.py), and `build_transform` takes it
  wherever the JAX package does;
- the loaders hold the JAX loaders' samples, and give the same batches in
  thread and process (spawn) mode; process-mode batches are a function of
  (seed, epoch, batch) alone.
"""

import os
import random

import numpy as np
import pytest

from u2pl_tpu.config import parse_config as jax_parse_config
from u2pl_tpu.data import loader as jax_loader
from u2pl_tpu.data import splits as jax_splits
from u2pl_tpu.data import transforms as jax_transforms
from u2pl_tpu_torch.config import parse_config
from u2pl_tpu_torch.data import loader, splits, transforms
from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(REPO, "experiments", "pascal", "1464", "ours", "config.yaml")
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
LISTS = ["pascal/1464/labeled.txt", "pascal/val.txt", "cityscapes/744/labeled.txt",
         "cityscapes/val.txt"]


@pytest.mark.parametrize("name", LISTS)
def test_splits_equal_to_jax(name):
    path = os.path.join(REPO, "data", "splits", name)
    pairs = splits.parse_split(path)
    assert pairs == jax_splits.parse_split(path) and len(pairs) > 100
    for n, seed in ((100, 0), (2 * len(pairs) + 3, 2)):  # a sample; the list repeated
        got = splits.subsample(pairs, n, seed, "train")
        assert len(got) == n and got == jax_splits.subsample(pairs, n, seed, "train")
    assert splits.subsample(pairs, 10, 0, "val") == pairs


def test_missing_split_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="vendored"):
        splits.parse_split(str(tmp_path / "data" / "splits" / "pascal" / "x.txt"))


@pytest.mark.parametrize("n,epoch,seed", [(10, 0, 0), (1464, 3, 2), (17, 5, 2**31 + 4)])
def test_epoch_indices_equal_to_jax(n, epoch, seed):
    np.testing.assert_array_equal(loader.epoch_indices(n, epoch, seed),
                                  jax_loader.epoch_indices(n, epoch, seed))
    np.testing.assert_array_equal(loader.epoch_indices(n, epoch, seed, False), np.arange(n))


# dataset type, split config, output_u8
PIPELINES = {
    "voc train": ("pascal_semi", {"flip": True, "rand_resize": [0.5, 2.0],
                                  "crop": {"type": "rand", "size": [65, 65]}}, False),
    "voc val": ("pascal_semi", {"crop": {"type": "center", "size": [65, 65]}}, False),
    "blur, rotation": ("pascal_semi", {"flip": True, "GaussianBlur": True, "rand_rotation": [-10, 10],
                                       "rand_resize": [0.75, 1.25],
                                       "crop": {"type": "rand", "size": [49, 57]}}, False),
    "fixed resize, uint8": ("pascal_semi", {"resize": [70, 61], "flip": True,
                                            "crop": {"type": "rand", "size": [96, 64]}}, True),
    "cityscapes cutout": ("cityscapes_semi", {"flip": True, "rand_resize": [0.5, 2.0],
                                              "crop": {"type": "rand", "size": [65, 65]},
                                              "cutout": {"n_holes": 3, "length": 16}}, False),
    "cityscapes cutmix": ("cityscapes_semi", {"rand_resize": [0.5, 2.0],
                                              "crop": {"type": "rand", "size": [65, 65]},
                                              "cutmix": {"prop_range": [0.25, 0.5],
                                                         "n_holes": 2}}, False),
}


def split_cfgs(kind, split):
    raw = {"dataset": {"type": kind, "mean": MEAN, "std": STD, "ignore_label": 255,
                       "train": split}}
    return parse_config(raw).dataset.train, jax_parse_config(raw).dataset.train


def sample(seed, h=90, w=120):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            rng.randint(0, 21, (h, w)).astype(np.uint8))


def seeded(fn, seed, *args):
    random.seed(seed)
    np.random.seed(seed)
    return fn(*args)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_numpy_pipeline_bit_equal_to_jax(name, monkeypatch):
    monkeypatch.setenv("U2PL_TPU_NO_NATIVE", "1")
    kind, split, u8 = PIPELINES[name]
    ours, theirs = split_cfgs(kind, split)
    t = transforms.build_transform(ours, MEAN, STD, 255, output_u8=u8)
    ref = jax_transforms.build_transform(theirs, MEAN, STD, 255, output_u8=u8)
    assert not isinstance(t, transforms.FusedNativeTransform)
    for seed in range(6):
        img, lab = sample(seed, 40 + 13 * seed, 120 - 9 * seed)
        got = seeded(t, seed, img, lab)
        want = seeded(ref, seed, img, lab)
        assert len(got) == len(want) == {"cityscapes cutout": 5, "cityscapes cutmix": 3}.get(name, 2)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=f"{name} seed {seed}")


@pytest.mark.parametrize("name", ["voc train", "voc val"])
@pytest.mark.parametrize("u8", [False, True])
def test_fused_native_path_against_jax_numpy(name, u8, monkeypatch):
    kind, split, _ = PIPELINES[name]
    ours, theirs = split_cfgs(kind, split)
    fused = transforms.build_transform(ours, MEAN, STD, 255, output_u8=u8)
    assert isinstance(fused, transforms.FusedNativeTransform)  # where JAX takes it
    monkeypatch.setenv("U2PL_TPU_NO_NATIVE", "1")
    ref = jax_transforms.build_transform(theirs, MEAN, STD, 255, output_u8=u8)
    for seed in range(6):
        img, lab = sample(seed, 50 + 11 * seed, 40 + 17 * seed)
        fi, fl = seeded(fused, seed, img, lab)
        pi, pl = seeded(ref, seed, img, lab)
        assert fi.dtype == pi.dtype and fi.shape == pi.shape and fl.dtype == pl.dtype
        np.testing.assert_array_equal(fl, pl)
        # uint8: the resample's float32 rounding may move a value across .5
        np.testing.assert_allclose(fi.astype(np.float32), pi.astype(np.float32),
                                   atol=1.0 if u8 else 2e-3)


def test_fast_path_choice(monkeypatch):
    """The config decides, as in JAX (whose own library, where not built, is
    taken as built here: the port builds its library at first use)."""
    from u2pl_tpu import native as jax_native

    monkeypatch.setattr(jax_native, "available", lambda: True)
    for name, (kind, split, _) in PIPELINES.items():
        ours, theirs = split_cfgs(kind, split)
        assert transforms.native_fast_path_ok(ours) == jax_transforms._native_fast_path_ok(
            theirs), name
    monkeypatch.setenv("U2PL_TPU_NO_NATIVE", "1")
    assert not transforms.native_fast_path_ok(split_cfgs(*PIPELINES["voc train"][:2])[0])


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_data"))
    paths = make_voc_workspace(root, 6, 6, 5, size=(40, 52), num_classes=5, seed=1)
    over = {"dataset.train.crop.size": [33, 33], "dataset.val.crop.size": [33, 33],
            "dataset.batch_size": 2, "dataset.n_sup": 4, "dataset.pool_size": 10}
    return root, paths, over


def port_and_jax_loaders(workspace, name, **extra):
    root, paths, over = workspace
    path = write_config(VOC, paths, os.path.join(root, name), {**over, **extra})
    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu.config import load_config as jax_load_config

    return loader.build_loaders(load_config(path), seed=3), jax_loader.build_loaders(
        jax_load_config(path), seed=3)


def batches_of(ld, epoch):
    return [tuple(np.copy(a) for a in b) for b in ld.epoch(epoch)]


def test_loaders_hold_the_jax_samples(workspace):
    ours, theirs = port_and_jax_loaders(workspace, "thread")
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.dataset.pairs == b.dataset.pairs and len(a) == len(b)
        assert (a.drop_last, a.shuffle, a.batch_size) == (b.drop_last, b.shuffle, b.batch_size)
    # val: all 5 images, the last batch ragged
    assert [x[0].shape[0] for x in ours[2].epoch(0)] == [2, 2, 1]
    # train: 6 pairs, drop_last
    assert len(ours[0]) == 3 and all(x[0].shape == (2, 33, 33, 3) for x in ours[0].epoch(1))
    for ld in ours + theirs:
        ld.close()


def test_thread_and_process_mode_batches(workspace, monkeypatch):
    (sup_t, _, val_t), _ = port_and_jax_loaders(workspace, "t2")
    (sup_p, _, val_p), _ = port_and_jax_loaders(workspace, "p2", **{"dataset.workers_mode": "process"})
    try:
        # the val pipeline draws nothing: equal batches in both modes
        for a, b in zip(batches_of(val_t, 0), batches_of(val_p, 0)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        # process mode: batch i of an epoch is the replay of its task seed
        got = batches_of(sup_p, 2)
        monkeypatch.setattr(loader, "_WORKER_DATASET", sup_p.dataset)
        idx = loader.epoch_indices(len(sup_p.dataset), 2, sup_p.seed)
        for i, batch in enumerate(got):
            want = loader._proc_assemble(idx[2 * i:2 * i + 2], loader.task_seed(3, 2, i))
            for x, y in zip(batch, want):
                np.testing.assert_array_equal(x, y)
        again = batches_of(sup_p, 2)
        for a, b in zip(got, again):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    finally:
        for ld in (sup_t, val_t, sup_p, val_p):
            ld.close()


def test_process_mode_never_forks(workspace, monkeypatch):
    (sup, unsup, val), _ = port_and_jax_loaders(workspace, "fork",
                                                **{"dataset.workers_mode": "process"})
    monkeypatch.setenv("U2PL_LOADER_MP_CONTEXT", "fork")
    with pytest.raises(ValueError, match="no fork"):
        next(iter(sup.epoch(0)))


def test_native_build_from_several_threads(tmp_path, monkeypatch):
    """The loader's threads reach the host library's first build at once:
    every one gets the library, and no temporary file is left behind."""
    import threading

    from u2pl_tpu_torch.data import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    native._load.cache_clear()
    libs, errors = [], []

    def first_use():
        try:
            libs.append(native.load())
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    try:
        threads = [threading.Thread(target=first_use) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors and len(libs) == 4 and all(lib is libs[0] for lib in libs)
        assert os.listdir(tmp_path) == [os.path.basename(native.library_path())]
    finally:
        native._load.cache_clear()
