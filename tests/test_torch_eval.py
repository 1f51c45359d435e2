"""The port's scoring path (u2pl_tpu_torch/evallib/slide.py, the eval and
infer CLIs, `serving.load_image`) against the JAX package's, on the CPU.

One set of weights: the small net of tests/test_torch_model.py (resnet10 +
DeepLabv3+ with the aux head, 5 classes), flax init with every BN
statistic and bias perturbed, written as a `.ckpt` in the layout of
u2pl_tpu/utils/checkpoint.py (flax's `msgpack_serialize`; the student's
weights all zero, so a student read shows) and read by both packages.

Tolerances, per case:
  * the crop grid on a deterministic stand-in network: the canvas divided
    by the counts bit-equal (the same float32 adds in the same order), the
    resized logits within rtol = atol = 1e-5 (kernel A's two taps against
    numpy's dense einsum, about an ulp);
  * masks on the real model: equal wherever JAX's summed logits have a
    top-2 gap of at least GAP (two frameworks' float32 convolutions, and
    the resizes, differ in their last bits, which can flip only a
    near-tie), and on at least MIN_AGREEMENT of all pixels; mIoU equal to
    two decimals;
  * the request image's load on the device against the numpy route:
    within atol 1e-5 (the normalisation is bit-equal, the resize is
    kernel A's plain version).
"""

import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import eval as jax_eval_cli
import infer as jax_infer_cli
from test_torch_model import C, perturbed_flax_variables, small_net_raw
from u2pl_tpu.config import load_config as jax_load_config
from u2pl_tpu.evallib import slide as jslide
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.resize import resize_bilinear_numpy
from u2pl_tpu_torch import eval as eval_cli
from u2pl_tpu_torch import infer as infer_cli
from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.data.synthetic import (
    make_cityscapes_workspace, make_voc_workspace, write_config,
)
from u2pl_tpu_torch.evallib import slide
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.serving import InferEngine, load_image, load_image_plain
from u2pl_tpu_torch.utils.checkpoint import load_eval_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_YAML = os.path.join(REPO, "experiments", "pascal", "1464", "ours", "config.yaml")
CITY_YAML = os.path.join(REPO, "experiments", "cityscapes", "744", "ours", "config.yaml")
CROP = 33
VOC_SIZES = [(40, 52), (52, 40), (37, 45), (40, 52)]  # 4 val images: batch 3 leaves a tail
CITY_SIZE = (40, 72)
CITY_BASE = 72  # base_size scaled down with the image: the long side
GAP = 1e-4
MIN_AGREEMENT = 0.999
MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
STD = np.asarray([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Both workspaces, their configs (the experiments' YAMLs with the small
    net and 33² crops), one `.ckpt`, the JAX model and the port's."""
    root = str(tmp_path_factory.mktemp("eval_ws"))
    over = {"net": small_net_raw(aux=True), "dataset.val.crop.size": [CROP, CROP]}
    voc = make_voc_workspace(os.path.join(root, "voc"), 0, 0, len(VOC_SIZES),
                             num_classes=C, val_sizes=VOC_SIZES)
    city = make_cityscapes_workspace(os.path.join(root, "city"), 0, 0, 2, size=CITY_SIZE,
                                     num_classes=C)
    cfgs = {"voc": write_config(VOC_YAML, voc, os.path.join(root, "voc_exp"), over),
            "city": write_config(CITY_YAML, city, os.path.join(root, "city_exp"), over)}
    jmodel = build_jax_model(jax_load_config(cfgs["voc"]).net)
    init = jax.jit(lambda k, x: jmodel.init(k, x, train=False))
    variables = perturbed_flax_variables(
        types.SimpleNamespace(init=lambda k, x, train: init(k, x)), seed=3)
    ckpt = os.path.join(root, "ckpt_best.ckpt")
    with open(ckpt, "wb") as f:
        f.write(serialization.msgpack_serialize({
            "epoch": 1, "best_miou": 0.0, "step": 4,
            "model_state": serialization.to_state_dict(
                jax.tree_util.tree_map(np.zeros_like, variables)),
            "teacher_state": serialization.to_state_dict(variables),
        }))
    tmodel = load_eval_variables(build_model(load_config(cfgs["voc"]).net, device="cpu"), ckpt)
    jnet = jslide.make_net_process(jmodel, jax.tree_util.tree_map(jnp.asarray, variables))
    return types.SimpleNamespace(root=root, cfgs=cfgs, ckpt=ckpt, jnet=jnet,
                                 net=slide.make_net_process(tmodel))


def normalised_image(seed, h, w):
    """A smooth random image, normalised as both CLIs do: (HWC numpy, CHW torch)."""
    rng = np.random.RandomState(seed)
    field = resize_bilinear_numpy(rng.rand(5, 5, 3).astype(np.float32), (h, w)) * 255
    img = np.clip(field + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8).astype(np.float32)
    img = (img - MEAN) / STD
    return img, torch.from_numpy(img.transpose(2, 0, 1).copy())


def check_masks(got, want, total, what):
    """`got` equals JAX's `want` wherever JAX's total logits (h, w, C) have a
    top-2 gap >= GAP, and on >= MIN_AGREEMENT of all pixels."""
    assert got.shape == want.shape == total.shape[:2], what
    top2 = np.sort(total, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) >= GAP
    assert clear.mean() > 0.9, what  # the criterion bites
    assert np.array_equal(got[clear], want[clear]), (what, int((got != want)[clear].sum()))
    assert (got == want).mean() >= MIN_AGREEMENT, (what, (got == want).mean())


# the stand-in network: per pixel, an affine map of the 3 channels to C
# logits, the same float32 ops in numpy and torch
_A, _B, _D = (np.random.RandomState(7).randn(3, C).astype(np.float32))


def stand_in_jax(calls):
    def net(images):  # (G, h, w, 3) -> (G, h, w, C)
        calls.append(images.shape[0])
        return images[..., 0:1] * _A + images[..., 1:2] * _B + images[..., 2:3] * _D
    return net


def stand_in_port(calls):
    a, b, d = (torch.from_numpy(v)[:, None, None] for v in (_A, _B, _D))

    def net(images):  # (G, 3, h, w) -> (G, C, h, w)
        calls.append(images.shape[0])
        return images[:, 0:1] * a + images[:, 1:2] * b + images[:, 2:3] * d
    return net


@pytest.mark.parametrize("hw, crop, out, chunk", [
    ((50, 70), (33, 33), (61, 47), 32),  # larger than the crop: a 2 x 3 grid
    ((20, 25), (33, 33), (40, 50), 32),  # smaller: zero padding, one crop
    ((47, 61), (21, 17), (47, 60), 4),  # odd sizes, 3 x 5 crops, forwards of 4
])
def test_scale_crop_process_matches_jax(monkeypatch, hw, crop, out, chunk):
    monkeypatch.setattr(slide, "MAX_CROPS_PER_FORWARD", chunk)
    img, timg = normalised_image(1, *hw)
    jcalls, tcalls = [], []
    # at the image's own size JAX's resize is the identity: its result is
    # the canvas divided by the counts, unpadded
    canvas = jslide.scale_crop_process(stand_in_jax(jcalls), img, C, *crop, *hw)
    got = slide.crop_grid_logits(stand_in_port(tcalls), timg, C, *crop)
    assert sum(tcalls) == sum(jcalls) and max(tcalls) <= chunk
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), canvas)
    same = slide.scale_crop_process(stand_in_port([]), timg, C, *crop, *hw)
    assert torch.equal(same, got)
    ref = jslide.scale_crop_process(stand_in_jax([]), img, C, *crop, *out)
    res = slide.scale_crop_process(stand_in_port([]), timg, C, *crop, *out)
    assert tuple(res.shape) == (C,) + out
    np.testing.assert_allclose(res.permute(1, 2, 0).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw, out", [((37, 45), (37, 45)), ((37, 45), (61, 30))])
def test_scale_whole_process_matches_jax(hw, out):
    img, timg = normalised_image(5, *hw)
    ref = jslide.scale_whole_process(stand_in_jax([]), img, *out)
    got = slide.scale_whole_process(stand_in_port([]), timg, *out)
    assert tuple(got.shape) == (C,) + out
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref, rtol=1e-5, atol=1e-5)


def jax_total_whole(jnet, img, scales):
    """JAX's predict_whole before its argmax (u2pl_tpu/evallib/slide.py:207-225)."""
    h, w = img.shape[:2]
    total = np.zeros((h, w, C), np.float32)
    for s in scales:
        scaled = resize_bilinear_numpy(img, (round(h * s), round(w * s)), align_corners=True)
        total += jslide.scale_whole_process(jnet, scaled, h, w)
    return total


def jax_total_city(jnet, img, base, crop_h, crop_w, scales):
    """JAX's predict_city before its argmax (u2pl_tpu/evallib/slide.py:183-204)."""
    h, w = img.shape[:2]
    total = np.zeros((h, w, C), np.float32)
    for s in scales:
        long_size = round(s * base)
        new_h = new_w = long_size
        if h > w:
            new_w = round(long_size / float(h) * w)
        else:
            new_h = round(long_size / float(w) * h)
        scaled = resize_bilinear_numpy(img, (new_h, new_w), align_corners=True)
        total += jslide.scale_crop_process(jnet, scaled, C, crop_h, crop_w, h, w)
    return total


SCALES = [[1.0], [0.75, 1.0, 1.5]]


@pytest.mark.parametrize("scales", SCALES, ids=["1", "3"])
def test_predict_whole_matches_jax(ws, scales):
    img, timg = normalised_image(2, 37, 45)
    total = jax_total_whole(ws.jnet, img, scales)
    want = jslide.predict_whole(ws.jnet, img, C, scales)
    np.testing.assert_array_equal(want, total.argmax(-1))
    got = slide.predict_whole(ws.net, timg, C, scales)
    assert got.dtype == torch.uint8
    check_masks(got.numpy(), want, total, f"predict_whole {scales}")


@pytest.mark.parametrize("scales", SCALES, ids=["1", "3"])
def test_predict_city_matches_jax(ws, scales):
    img, timg = normalised_image(3, *CITY_SIZE)
    total = jax_total_city(ws.jnet, img, CITY_BASE, CROP, CROP, scales)
    want = jslide.predict_city(ws.jnet, img, C, CITY_BASE, CROP, CROP, scales)
    np.testing.assert_array_equal(want, total.argmax(-1))
    got = slide.predict_city(ws.net, timg, C, CITY_BASE, CROP, CROP, scales)
    assert got.dtype == torch.uint8
    check_masks(got.numpy(), want, total, f"predict_city {scales}")


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_logged(fn):
    """fn() with the CLIs' logger recorded: (result, the mIoU line)."""
    rec = Lines()
    logger = logging.getLogger("main-logger")
    logger.addHandler(rec)
    try:
        out = fn()
    finally:
        logger.removeHandler(rec)
    return out, [ln for ln in rec.lines if ln.startswith(" * ")]


def run_jax_main(module, argv):
    old = sys.argv
    sys.argv = [module.__file__] + argv
    try:
        return module.main()
    finally:
        sys.argv = old


def read_grays(folder):
    return {n: np.asarray(Image.open(os.path.join(folder, n)))
            for n in sorted(os.listdir(folder))}


@pytest.mark.parametrize("family", ["voc", "city"])
@pytest.mark.parametrize("scales", SCALES, ids=["1", "3"])
def test_eval_cli_matches_jax_cli(ws, monkeypatch, tmp_path, family, scales):
    """Both CLIs on one `.ckpt`: gray PNGs equal outside near-ties (JAX's
    summed logits recorded through its own forwards), the colour PNGs'
    shapes, and the per-class IoU and mIoU lines equal."""
    totals = []

    def whole(net_process, image, classes, scales_):
        totals.append(jax_total_whole(net_process, image, scales_))
        return totals[-1].argmax(-1).astype(np.uint8)

    def city(net_process, image, classes, base, crop_h, crop_w, scales_):
        totals.append(jax_total_city(net_process, image, base, crop_h, crop_w, scales_))
        return totals[-1].argmax(-1).astype(np.uint8)

    monkeypatch.setattr(jax_eval_cli, "predict_whole", whole)
    monkeypatch.setattr(jax_eval_cli, "predict_city", city)
    common = ["--config", ws.cfgs[family], "--model_path", ws.ckpt, "--base_size",
              str(CITY_BASE), "--scales", *map(str, scales)]
    _, jlines = run_logged(lambda: run_jax_main(
        jax_eval_cli, common + ["--save_folder", str(tmp_path / "jax")]))
    summary, lines = run_logged(lambda: eval_cli.main(
        common + ["--save_folder", str(tmp_path / "port"), "--device", "cpu"]))
    n = len(VOC_SIZES) if family == "voc" else 2
    assert summary["images"] == n == len(totals) and len(summary["seconds"]) == n
    assert lines == jlines and len(lines) == C + 1 and lines[-1].startswith(" * mIoU")
    assert abs(summary["miou"] * 100 - float(lines[-1].split()[-1])) <= 0.005
    want, got = read_grays(tmp_path / "jax" / "gray"), read_grays(tmp_path / "port" / "gray")
    assert list(got) == list(want) and len(got) == n
    for (name, g), total in zip(got.items(), totals):
        check_masks(g, want[name], total, f"{family} {scales} {name}")
        color = np.asarray(Image.open(tmp_path / "port" / "color" / name))
        assert color.shape == g.shape + (3,)


def test_infer_cli_matches_jax_cli(ws, monkeypatch, tmp_path):
    """Both CLIs at batch 1 and 3 (4 images: a partial tail of 1): the port's
    masks equal JAX's outside near-ties, and identical across the two batch
    sizes; the files under the images' own names."""
    jax_logits = []

    def recording_resize(x, size, align_corners=True):
        out = resize_bilinear_numpy(x, size, align_corners)
        if out.shape[-1] == C:  # the logits' resize back to the image (not the image's)
            jax_logits.append(out)
        return out

    monkeypatch.setattr(jax_infer_cli, "resize_bilinear_numpy", recording_resize)
    masks = {}
    to_mask = InferEngine.to_mask

    def recording_to_mask(self, logits, size):
        masks[bs].append(to_mask(self, logits, size))
        return masks[bs][-1]

    monkeypatch.setattr(InferEngine, "to_mask", recording_to_mask)
    for bs in (1, 3):
        masks[bs] = []
        argv = ["--config", ws.cfgs["voc"], "--model_path", ws.ckpt, "--batch_size", str(bs)]
        run_jax_main(jax_infer_cli, argv + ["--save_folder", str(tmp_path / f"jax{bs}")])
        summary = infer_cli.main(argv + ["--save_folder", str(tmp_path / f"port{bs}"),
                                         "--device", "cpu"])
        assert summary["images"] == len(VOC_SIZES) and summary["batches"] == -(-4 // bs)
        assert sorted(os.listdir(tmp_path / f"port{bs}" / "gray")) == sorted(
            os.listdir(tmp_path / f"jax{bs}" / "gray"))
    assert len(jax_logits) == 2 * len(VOC_SIZES)
    for i, (m1, m3) in enumerate(zip(masks[1], masks[3])):
        assert np.array_equal(m1, m3), i  # the batch does not change a mask
        for total in (jax_logits[i], jax_logits[len(VOC_SIZES) + i]):
            check_masks(m1, total.argmax(-1), total, f"infer image {i}")
        assert m1.shape == VOC_SIZES[i]


@pytest.mark.parametrize("size", [(513, 513), (769, 769), None])
def test_load_image_matches_numpy_route(tmp_path, size):
    """`load_image` (upload, normalise, resize on the tensor's device)
    against the numpy route of the JAX engine (`load_image_plain`)."""
    rng = np.random.RandomState(4)
    path = str(tmp_path / "odd.png")
    Image.fromarray((rng.rand(37, 61, 3) * 255).astype(np.uint8)).save(path)
    got, hw = load_image(path, MEAN, STD, size, "cpu")
    want, whw = load_image_plain(path, MEAN, STD, size, "cpu")
    assert hw == whw == (37, 61) and got.shape == want.shape and got.dtype == torch.float32
    assert tuple(got.shape) == (3,) + (tuple(size) if size else (37, 61))
    if size is None:  # the normalisation alone: the same IEEE ops
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("port, jax_cli", [(eval_cli, jax_eval_cli), (infer_cli, jax_infer_cli)])
def test_cli_flags_are_the_jax_flags_and_device(ws, port, jax_cli):
    """Every flag of the root CLI, plus `--device`; `--dtype` takes JAX's
    choices, bfloat16 runs (tests/test_torch_bf16_infer.py holds its masks
    to JAX's) and float16 is refused."""
    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert flags(port.get_parser()) == flags(jax_cli.get_parser()) | {"--device"}
    dtype = next(a for a in port.get_parser()._actions if "--dtype" in a.option_strings)
    assert dtype.choices == ["float32", "bfloat16"] and dtype.default == "float32"
    with pytest.raises(SystemExit):
        port.get_parser().parse_args(["--dtype", "float16"])
    folder = os.path.join(ws.root, f"bf16_{port.__name__}")
    summary = port.main(["--config", ws.cfgs["voc"], "--model_path", ws.ckpt, "--dtype",
                         "bfloat16", "--device", "cpu", "--save_folder", folder])
    assert summary["images"] == len(VOC_SIZES)
    assert sorted(os.listdir(os.path.join(folder, "gray"))) and len(
        os.listdir(os.path.join(folder, "gray"))) == len(VOC_SIZES)
