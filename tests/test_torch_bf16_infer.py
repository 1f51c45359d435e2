"""The port's bfloat16 inference (`--dtype bfloat16` of serve, infer and
eval) against the JAX package's, on the CPU.

One set of weights (tests/test_torch_eval.py's: the small net with the aux
head, 5 classes, every BN statistic and bias perturbed) in a `.ckpt` that
both packages read; JAX's models in bf16 and in f32 on it.

  * The post-forward path, bit for bit: JAX's own bf16 logits (its
    `make_net_process` under bf16) go through the port's `resize_argmax`,
    `_argmax_over_scales` and crop grid on the CPU, and the labels equal
    JAX's `to_mask` / `predict_whole` / `predict_city` at every pixel.  JAX
    rounds nothing after its forward (`resize_bilinear_numpy` widens the
    bf16 logits to f32): a port that resized bf16 logits to bf16 anywhere
    after the forward fails here, and `test_post_forward_tail_bit_equal`
    checks that such a rounding would change labels on these inputs.
  * The bf16 `net_process`: nearer JAX's bf16 than JAX's f32 is
    (tests/test_torch_bf16.py's `test_model_forward` measure), its logits
    in mean abs and its masks in pixels, the shares printed with `-s`.
    JAX's bf16 is taken two ways: its jitted `make_net_process` (what its
    CLIs run) and the same function op by op (`jax.disable_jit`), which
    rounds where the jaxpr rounds; under jit XLA keeps excess precision
    inside its fusions (`xla_allow_excess_precision`) and skips some of
    those roundings.  The deep bf16 forward of this small perturbed net
    is chaotic: JAX's jitted and op-by-op runs of one bf16 program differ
    in about as many pixels as its jitted bf16 and f32 runs do (printed).
    So the masks' count is held against JAX's op-by-op bf16, and the
    logits' mean against both.
  * The CLIs in bf16 against the JAX CLIs in bf16 (serve and infer at the
    fixed 513², eval on VOC at 1 and 3 scales and on Cityscapes at 1): a
    port mask may differ from JAX's only where JAX's bf16 top-two margin is
    below that image's bf16-vs-f32 logit gap (the largest |bf16 - f32| of
    JAX's resized, summed logits), and the mIoU may differ only by what
    those pixels can move it.  The counts (the port's against JAX's jitted
    bf16, and JAX's own bf16 against its f32) are printed, not held: JAX's
    op-by-op run of its own bf16 program would not meet such a count
    either (above).  The JAX CLIs run as they are, with their forwards
    recorded through one cached bf16 `make_net_process` (and its f32 twin
    on the same inputs for the gap), so each input shape compiles once.
"""

import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import eval as jax_eval_cli
import infer as jax_infer_cli
import serve as jax_serve_cli
from test_torch_eval import (
    C, CITY_BASE, CITY_SIZE, CITY_YAML, CROP, VOC_YAML, normalised_image, run_jax_main,
    run_logged,
)
from test_torch_model import perturbed_flax_variables, small_net_raw
import u2pl_tpu.serving as jax_serving
from u2pl_tpu.config import load_config as jax_load_config
from u2pl_tpu.evallib import slide as jslide
from u2pl_tpu.models import build_model as build_jax_model
from u2pl_tpu.ops.resize import resize_bilinear_numpy
from u2pl_tpu.serving import InferEngine as JaxEngine
from u2pl_tpu_torch import eval as eval_cli
from u2pl_tpu_torch import infer as infer_cli
from u2pl_tpu_torch import serve as serve_cli
from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.data.synthetic import (
    make_cityscapes_workspace, make_voc_workspace, write_config,
)
from u2pl_tpu_torch.evallib import slide
from u2pl_tpu_torch.evallib.metrics import intersection_and_union
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.ops.resize import resize_argmax, resize_bilinear_plain
from u2pl_tpu_torch.serving import InferEngine
from u2pl_tpu_torch.utils.checkpoint import load_eval_variables
from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

VOC_SIZES = [(37, 45), (37, 45)]  # odd sizes; one size, so each scale compiles once
SCALES = [[1.0], [0.75, 1.0, 1.5]]
DTYPES = ("bfloat16", "float32")
MEASURED = {}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    for name, m in MEASURED.items():
        print(f"[bf16 infer] {name}: " + ", ".join(f"{k} {v}" for k, v in m.items()))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The workspaces and configs, one `.ckpt` (and the same weights as a
    `.pth`), JAX's cached `make_net_process` per dtype, the port's bf16
    model."""
    root = str(tmp_path_factory.mktemp("bf16_infer_ws"))
    over = {"net": small_net_raw(aux=True), "dataset.val.crop.size": [CROP, CROP]}
    voc = make_voc_workspace(os.path.join(root, "voc"), 0, 0, len(VOC_SIZES),
                             num_classes=C, val_sizes=VOC_SIZES, seed=5)
    city = make_cityscapes_workspace(os.path.join(root, "city"), 0, 0, 2, size=CITY_SIZE,
                                     num_classes=C, seed=6)
    cfgs = {"voc": write_config(VOC_YAML, voc, os.path.join(root, "voc_exp"), over),
            "city": write_config(CITY_YAML, city, os.path.join(root, "city_exp"), over)}
    net = jax_load_config(cfgs["voc"]).net
    jmodels = {dt: build_jax_model(net, dtype=jnp.dtype(dt)) for dt in DTYPES}
    init = jax.jit(lambda k, x: jmodels["float32"].init(k, x, train=False))
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
    pth = os.path.join(root, "ckpt_best.pth")
    torch.save({"epoch": 1, "best_miou": 0.0,
                "model_state": {f"module.{k}": v for k, v in flax_to_torch(variables).items()}},
               pth)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jnets = {dt: jslide.make_net_process(jmodels[dt], jvars) for dt in DTYPES}
    tnet = load_config(cfgs["voc"]).net
    tmodel = load_eval_variables(build_model(tnet, device="cpu", dtype="bfloat16"), ckpt)
    return types.SimpleNamespace(root=root, voc=voc, cfgs=cfgs, ckpt=ckpt, pth=pth, jnets=jnets,
                                 tnet=tnet, tmodel=tmodel, net=slide.make_net_process(tmodel))


def bf16_to_torch(a):
    """A numpy bf16 (..., H, W, C) array -> torch bf16 (..., C, H, W), bit
    for bit."""
    a = np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))
    assert a.dtype == ml_dtypes.bfloat16
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def f64(a):
    if torch.is_tensor(a):
        a = a.float().numpy()
    return np.asarray(a, np.float32).astype(np.float64)


def test_weights_load_into_a_bf16_model_unchanged(ws):
    """`.ckpt` and `.pth` weights load into a bf16-compute model as float32
    parameters and buffers, equal to a float32 model's."""
    f32 = load_eval_variables(build_model(ws.tnet, device="cpu", dtype="float32"), ws.ckpt)
    from_pth = load_eval_variables(build_model(ws.tnet, device="cpu", dtype="bfloat16"), ws.pth)
    want = f32.state_dict()
    for model in (ws.tmodel, from_pth):
        assert model.dtype == torch.bfloat16 and not model.training
        got = model.state_dict()
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
        assert all(p.dtype == torch.float32 for p in model.parameters())


# ---- (a) the post-forward path, bit for bit --------------------------------

def _jax_logits(ws, images):
    """JAX's bf16 `net_process` on (B, H, W, 3) numpy images: bf16 numpy."""
    out = ws.jnets["bfloat16"](images)
    assert out.dtype == ml_dtypes.bfloat16
    return out


def _rounding_tail(logits_bf16, size):
    """The trap: the bf16 logits resized to bf16 (kernel A's narrow mode),
    then the argmax."""
    return resize_bilinear_plain(logits_bf16[None], size)[0].argmax(0).numpy()


@pytest.mark.parametrize("case", ["to_mask", "voc_1", "voc_3", "city_1"])
def test_post_forward_tail_bit_equal(ws, case):
    """JAX's own bf16 logits through the port's tail: JAX's labels at every
    pixel.  `to_mask` is the serving and infer tail (kernel B on bf16
    logits), `voc_*` eval's multi-scale sum (kernel A's bf16 -> f32 mode,
    then B), `city_1` the crop grid's f32 canvas, then B."""
    if case == "to_mask":
        img, _ = normalised_image(8, 65, 65)
        jl = _jax_logits(ws, img[None])[0]
        size = (37, 61)
        want = JaxEngine.to_mask(None, jl, size)
        got = resize_argmax(bf16_to_torch(jl), size).numpy()
        trap = _rounding_tail(bf16_to_torch(jl), size)
    elif case.startswith("voc"):
        scales = SCALES[case == "voc_3"]
        img, _ = normalised_image(2, *VOC_SIZES[0])
        h, w = img.shape[:2]
        logits = {s: bf16_to_torch(_jax_logits(ws, resize_bilinear_numpy(
            img, (round(h * s), round(w * s)), align_corners=True)[None])[0]) for s in scales}
        want = jslide.predict_whole(ws.jnets["bfloat16"], img, C, scales)
        got = slide._argmax_over_scales(scales, logits.__getitem__, h, w).numpy()
        trap = sum(resize_bilinear_plain(logits[s][None], (h, w))[0].float()
                   for s in scales).argmax(0).numpy() if len(scales) > 1 else None
        # (at one scale the logits leave the forward at (h, w): no resize follows)
    else:
        img, timg = normalised_image(3, *CITY_SIZE)

        def jax_forward(crops):  # the port's crops through JAX's bf16 forward
            return bf16_to_torch(_jax_logits(ws, crops.permute(0, 2, 3, 1).numpy()))

        want = jslide.predict_city(ws.jnets["bfloat16"], img, C, CITY_BASE, CROP, CROP, [1.0])
        got = slide.predict_city(jax_forward, timg, C, CITY_BASE, CROP, CROP, [1.0]).numpy()
        trap = None  # the canvas is f32: a rounding here is the narrow resize's, in the forward
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), (case, int((got != want).sum()))
    if trap is not None:
        flips = int((trap != want).sum())
        MEASURED[f"tail {case}"] = {"pixels": want.size, "labels moved by a bf16 rounding": flips}
        assert flips > 0, case  # the check would catch a rounding after the forward


def test_crop_canvas_adds_bf16_as_numpy_does():
    """The canvas's `pred += lg`: f32 += bf16 in torch is numpy's f32 +=
    bf16 (the exact upcast, one f32 rounding per add)."""
    rng = np.random.RandomState(9)
    canvas = rng.randn(4, 9, 11).astype(np.float32) * 30
    lg = (rng.randn(4, 9, 11) * 30).astype(ml_dtypes.bfloat16)
    want = canvas.copy()
    want += lg
    got = torch.from_numpy(canvas.copy())
    got += torch.from_numpy(lg.view(np.int16).copy()).view(torch.bfloat16).float()
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# ---- (b) the bf16 net_process ------------------------------------------------

def test_net_process_bf16(ws):
    """The port's bf16 `net_process` (eval-mode bf16 forward, the logits'
    narrow bf16 upsample) on three images: its logits nearer JAX's bf16
    than JAX's f32 is, in mean abs against JAX's jitted and op-by-op runs
    and in max abs against the op-by-op run (the jitted run's max gap to
    f32 is under one bf16 ulp of the largest logits, where a rounding one
    f32 ulp apart upstream moves an output by one); its masks differ from
    JAX's op-by-op bf16 masks in fewer pixels than JAX's f32 masks do."""
    imgs = [normalised_image(s, *VOC_SIZES[0])[0][None] for s in (2, 4, 6)]
    outs = [ws.net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())) for x in imgs]
    assert all(o.dtype == torch.bfloat16 for o in outs)
    got = np.moveaxis(np.concatenate([f64(o) for o in outs]), 1, -1)
    ref = {dt: np.concatenate([f64(ws.jnets[dt](x)) for x in imgs]) for dt in DTYPES}
    with jax.disable_jit():  # one image at a time: one shape, compiled op by op once
        ref["op_by_op"] = np.concatenate([f64(ws.jnets["bfloat16"](x)) for x in imgs])
    j32 = ref["float32"]
    m = MEASURED["net_process"] = {}
    for name in ("bfloat16", "op_by_op"):
        e, g = np.abs(ref[name] - j32), np.abs(got - ref[name])
        m[f"{name}: port mean"], m[f"{name}: ref mean"] = g.mean(), e.mean()
        m[f"{name}: share"] = g.mean() / e.mean()
        assert g.mean() < e.mean(), (name, m)
        m[f"{name}: port max"], m[f"{name}: ref max"] = g.max(), e.max()
    assert m["op_by_op: port max"] < m["op_by_op: ref max"], m
    masks = {k: v.argmax(-1) for k, v in ref.items()}
    port = got.argmax(-1)
    m.update({"pixels": port.size, "masks port vs op_by_op": int((port != masks["op_by_op"]).sum()),
              "masks op_by_op vs f32": int((masks["op_by_op"] != masks["float32"]).sum()),
              "masks port vs jit": int((port != masks["bfloat16"]).sum()),
              "masks jit vs f32": int((masks["bfloat16"] != masks["float32"]).sum()),
              "masks jit vs op_by_op": int((masks["bfloat16"] != masks["op_by_op"]).sum())})
    assert m["masks port vs op_by_op"] < m["masks op_by_op vs f32"], m


# ---- (c) the CLIs -------------------------------------------------------------

class Recorder:
    """JAX's cached bf16 `net_process`, recording each batch's bf16 logits
    and JAX's f32 logits of the same batch."""

    def __init__(self, ws):
        self.ws, self.calls = ws, []

    def __call__(self, images):
        out = self.ws.jnets["bfloat16"](np.asarray(images))
        self.calls.append((out, self.ws.jnets["float32"](np.asarray(images))))
        return out

    def make(self, *args, **kwargs):  # stands for make_net_process
        return self


def check_against_jax(what, got, totals):
    """`got` [masks] against JAX's `totals` [(bf16 total, f32 total)], each
    (h, w, C) f32: a mask may differ from JAX's bf16 argmax only where its
    top-two margin is below the image's bf16-vs-f32 gap.  Records the count
    of such pixels beside the count where JAX's bf16 and f32 masks differ;
    returns the masks' differences [(h, w) bool]."""
    assert len(got) == len(totals), what
    n_port = n_jax = pixels = 0
    diffs = []
    for i, (mask, (tbf, t32)) in enumerate(zip(got, totals)):
        want, want32 = tbf.argmax(-1), t32.argmax(-1)
        assert mask.shape == want.shape, (what, i)
        gap = float(np.abs(tbf - t32).max())
        top2 = np.sort(tbf, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < gap
        diff = mask != want
        assert not (diff & ~near).any(), (what, i, int((diff & ~near).sum()), gap)
        diffs.append(diff)
        n_port += int(diff.sum())
        n_jax += int((want != want32).sum())
        pixels += mask.size
    MEASURED[what] = {"pixels": pixels, "port vs JAX bf16": n_port,
                      "JAX bf16 vs f32": n_jax}
    return diffs


def _png_requests(ws, folder):
    """The VOC val images as PNG requests (masks are saved under the input's
    name, and a .jpg name would store them lossily)."""
    lines = []
    os.makedirs(folder, exist_ok=True)
    src = os.path.join(ws.voc["data_root"], "JPEGImages")
    for i, name in enumerate(sorted(os.listdir(src))):
        p = os.path.join(folder, f"req{i}.png")
        Image.open(os.path.join(src, name)).convert("RGB").save(p)
        lines.append(json.dumps({"op": "infer", "id": f"r{i}", "image": p}))
    return lines + [json.dumps({"op": "shutdown", "id": "bye"})]


def _resized_totals(calls, sizes):
    """JAX's per-image logits of recorded batches, resized to each image's
    size as its `to_mask` / infer `post` does: [(bf16 total, f32 total)]."""
    flat = [(bf[j], f32[j]) for bf, f32 in calls for j in range(len(bf))]
    return [tuple(resize_bilinear_numpy(a, size, align_corners=True) for a in pair)
            for pair, size in zip(flat, sizes)]


def test_serve_cli_bf16_matches_jax_cli(ws, monkeypatch, tmp_path):
    """Both serve CLIs with `--dtype bfloat16 --batch_size 2` on the same
    requests: the port's InferEngine against JAX's (`to_mask` of bf16
    logits), held to JAX's bf16 masks."""
    lines = _png_requests(ws, str(tmp_path / "req"))
    rec = Recorder(ws)
    monkeypatch.setattr(jax_serving, "make_net_process", rec.make)
    engines = []

    def cpu_engine(*args, **kwargs):  # the serve CLI takes JAX's flags: no --device
        engines.append(InferEngine(*args, device="cpu", **kwargs))
        return engines[-1]

    monkeypatch.setattr(serve_cli, "InferEngine", cpu_engine)
    out = {}
    for name, main in (("jax", lambda argv: run_jax_main(jax_serve_cli, argv)),
                       ("port", serve_cli.main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
        monkeypatch.setattr(sys, "stdout", io.StringIO())
        main(["--config", ws.cfgs["voc"], "--model_path", ws.ckpt, "--batch_size", "2",
              "--dtype", "bfloat16", "--no_warmup", "--save_folder", str(tmp_path / name)])
        out[name] = [json.loads(ln) for ln in sys.stdout.getvalue().splitlines()]
    assert engines[0].dtype == torch.bfloat16 and engines[0].model.dtype == torch.bfloat16
    assert [r["ok"] for r in out["port"]] == [r["ok"] for r in out["jax"]] == [True] * 3
    masks = {k: [np.asarray(Image.open(r["gray"])) for r in v[:-1]] for k, v in out.items()}
    sizes = [m.shape for m in masks["jax"]]
    totals = _resized_totals(rec.calls, sizes)
    for m, (tbf, _) in zip(masks["jax"], totals):
        assert np.array_equal(m, tbf.argmax(-1))  # the recorded logits are the served ones
    check_against_jax("serve CLI", masks["port"], totals)


def test_infer_cli_bf16_matches_jax_cli(ws, monkeypatch, tmp_path):
    """Both infer CLIs with `--dtype bfloat16` at batch 2 (the port's masks
    recorded at `to_mask`, JAX's from its recorded logits)."""
    rec = Recorder(ws)
    monkeypatch.setattr(jax_infer_cli, "make_net_process", rec.make)
    masks = []
    to_mask = InferEngine.to_mask

    def recording(self, logits, size):
        assert logits.dtype == torch.bfloat16
        masks.append(to_mask(self, logits, size))
        return masks[-1]

    monkeypatch.setattr(InferEngine, "to_mask", recording)
    argv = ["--config", ws.cfgs["voc"], "--model_path", ws.ckpt, "--batch_size", "2",
            "--dtype", "bfloat16"]
    run_jax_main(jax_infer_cli, argv + ["--save_folder", str(tmp_path / "jax")])
    summary = infer_cli.main(argv + ["--save_folder", str(tmp_path / "port"), "--device", "cpu"])
    assert summary["images"] == len(VOC_SIZES) == len(masks)
    check_against_jax("infer CLI", masks, _resized_totals(rec.calls, [m.shape for m in masks]))


def _jax_total(ws, family, image, scales, dtype):
    """JAX's predict_whole / predict_city before the argmax, in `dtype`."""
    net = ws.jnets[dtype]
    h, w = image.shape[:2]
    total = np.zeros((h, w, C), np.float32)
    for s in scales:
        if family == "voc":
            scaled = resize_bilinear_numpy(image, (round(h * s), round(w * s)), True)
            total += jslide.scale_whole_process(net, scaled, h, w)
            continue
        long_size = round(s * CITY_BASE)
        new_h = new_w = long_size
        if h > w:
            new_w = round(long_size / float(h) * w)
        else:
            new_h = round(long_size / float(w) * h)
        scaled = resize_bilinear_numpy(image, (new_h, new_w), True)
        total += jslide.scale_crop_process(net, scaled, C, CROP, CROP, h, w)
    return total


@pytest.mark.parametrize("family, scales", [("voc", SCALES[0]), ("voc", SCALES[1]),
                                            ("city", SCALES[0])], ids=["voc-1", "voc-3", "city-1"])
def test_eval_cli_bf16_matches_jax_cli(ws, monkeypatch, tmp_path, family, scales):
    """Both eval CLIs with `--dtype bfloat16`: the port's gray PNGs held to
    JAX's bf16 masks (JAX's predict recorded through the cached forwards),
    and the mIoU lines equal where the masks are, else the mIoU within what
    the differing pixels can move it: n pixels move a class's intersection
    and union by at most n each, so its IoU by at most 2n / (U - n) for a
    JAX union U > n (else by at most 1)."""
    totals = []

    def whole(net_process, image, classes, scales_):
        totals.append(tuple(_jax_total(ws, "voc", image, scales_, dt) for dt in DTYPES))
        return totals[-1][0].argmax(-1).astype(np.uint8)

    def city(net_process, image, classes, base, crop_h, crop_w, scales_):
        assert (base, crop_h, crop_w) == (CITY_BASE, CROP, CROP)
        totals.append(tuple(_jax_total(ws, "city", image, scales_, dt) for dt in DTYPES))
        return totals[-1][0].argmax(-1).astype(np.uint8)

    monkeypatch.setattr(jax_eval_cli, "predict_whole", whole)
    monkeypatch.setattr(jax_eval_cli, "predict_city", city)
    common = ["--config", ws.cfgs[family], "--model_path", ws.ckpt, "--base_size",
              str(CITY_BASE), "--scales", *map(str, scales), "--dtype", "bfloat16"]
    _, jlines = run_logged(lambda: run_jax_main(
        jax_eval_cli, common + ["--no_bucket", "--save_folder", str(tmp_path / "jax")]))
    summary, lines = run_logged(lambda: eval_cli.main(
        common + ["--save_folder", str(tmp_path / "port"), "--device", "cpu"]))
    names = sorted(os.listdir(tmp_path / "port" / "gray"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "gray")) and len(names) == len(totals)
    got = [np.asarray(Image.open(tmp_path / "port" / "gray" / n)) for n in names]
    diffs = check_against_jax(f"eval CLI {family} {scales}", got, totals)
    assert len(lines) == len(jlines) == C + 1 and lines[-1].startswith(" * mIoU")
    n = sum(int(d.sum()) for d in diffs)
    if n == 0:
        assert lines == jlines
        return
    data, _ = eval_cli.build_data_list(load_config(ws.cfgs[family]))
    labels = {os.path.splitext(os.path.basename(i))[0] + ".png": lab for i, lab in data}
    union = sum(intersection_and_union(t[0].argmax(-1), np.asarray(Image.open(labels[name])), C)[1]
                for name, t in zip(names, totals)).astype(np.float64)
    bound = np.where(union > n, 2 * n / np.maximum(union - n, 1), 1.0).mean()
    jmiou = float(jlines[-1].split()[-1]) / 100
    MEASURED[f"eval CLI {family} {scales}"].update(
        {"mIoU port": summary["miou"], "mIoU JAX": jmiou, "bound": bound})
    assert abs(summary["miou"] - jmiou) <= bound + 0.00005  # JAX's line: 2 decimals of a percent
