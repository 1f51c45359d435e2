"""The port's serving slice (u2pl_tpu_torch/serving.py) against the JAX
server, end to end: one reference-format `.pth` written from flax
variables, loaded by both `InferEngine`s, the same JSONL request lines to
both `run_server`s.  Gray masks must agree on >= 99.9% of pixels: the
forwards differ only in f32 summation order, which can flip the argmax at
a near-tie and nowhere else.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_model import C, perturbed_flax_variables, small_net_raw

HW = 65


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    from u2pl_tpu.config import parse_config as jax_parse_config
    from u2pl_tpu.models import build_model as build_jax_model
    from u2pl_tpu.serving import InferEngine as JaxEngine
    from u2pl_tpu_torch.config import parse_config
    from u2pl_tpu_torch.serving import InferEngine
    from u2pl_tpu_torch.utils.convert_jax import flax_to_torch

    root = tmp_path_factory.mktemp("torch_serve_ws")
    rng = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate([(HW, HW), (HW, HW + 8), (HW - 6, HW)]):
        # PNG inputs: masks are saved under the input's name, and a .jpg
        # name would store them lossily (the reference's naming quirk)
        p = root / f"img{i:03d}.png"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        images.append(str(p))

    raw = {
        "dataset": {
            "type": "pascal",
            "mean": [123.675, 116.28, 103.53],
            "std": [58.395, 57.12, 57.375],
        },
        "net": small_net_raw(aux=False),
    }
    cfg, jcfg = parse_config(raw), jax_parse_config(raw)
    variables = perturbed_flax_variables(build_jax_model(jcfg.net), seed=3)
    sd = flax_to_torch(variables)
    pth = root / "ckpt_best.pth"
    # reference layout: DDP prefixes, teacher preferred over the student
    torch.save(
        {
            "epoch": 1,
            "model_state": {k: torch.zeros_like(v) for k, v in sd.items()},
            "teacher_state": {f"module.{k}": v for k, v in sd.items()},
            "best_miou": 0.0,
        },
        pth,
    )
    jax_engine = JaxEngine(jcfg, str(pth), batch_size=2)
    engine = InferEngine(cfg, str(pth), batch_size=2, device="cpu")
    return root, cfg, pth, jax_engine, engine, images


def _serve(engine, request_lines, run_server, **kw):
    reader = io.StringIO("".join(line + "\n" for line in request_lines))
    writer = io.StringIO()
    run_server(reader, writer, engine, **kw)
    return [json.loads(line) for line in writer.getvalue().splitlines()]


def _requests(images, folder):
    return [
        json.dumps({"op": "ping", "id": "p0"}),
        *(
            json.dumps({"op": "infer", "id": f"r{i}", "image": p, "save_folder": folder})
            for i, p in enumerate(images)
        ),
        "this is not json",
        json.dumps({"op": "infer", "id": "gone", "image": "/no/such.jpg"}),
        json.dumps({"op": "warp", "id": "w"}),
        json.dumps({"op": "ping", "id": "p1"}),
        json.dumps({"op": "shutdown", "id": "bye"}),
    ]


def test_port_server_matches_jax_server(ws, tmp_path):
    from u2pl_tpu.serving import run_server as jax_run_server
    from u2pl_tpu_torch.serving import run_server

    _, _, _, jax_engine, engine, images = ws
    batch_sizes = []
    orig = engine.forward
    engine.forward = lambda imgs: (batch_sizes.append(len(imgs)), orig(imgs))[1]
    try:
        got = _serve(
            engine, _requests(images, str(tmp_path / "torch")), run_server,
            batch_window_s=0.05,
        )
    finally:
        engine.forward = orig
    ref = _serve(
        jax_engine, _requests(images, str(tmp_path / "jax")), jax_run_server,
        batch_window_s=0.05,
    )
    assert batch_sizes == [2, 1]  # micro-batching: one full batch + the tail
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    assert [r["ok"] for r in got] == [r["ok"] for r in ref]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r), (g, r)
        if "served" in r:
            assert g["served"] - engine.served == r["served"] - jax_engine.served
        if not r["ok"]:
            assert g["error"].split(":")[0] == r["error"].split(":")[0]
    by_id = {r["id"]: r for r in got}
    for i, path in enumerate(images):
        resp, jresp = by_id[f"r{i}"], {r["id"]: r for r in ref}[f"r{i}"]
        assert resp["batch_ms"] > 0
        assert os.path.basename(resp["gray"]) == os.path.basename(jresp["gray"])
        g = np.asarray(Image.open(resp["gray"]))
        j = np.asarray(Image.open(jresp["gray"]))
        h, w = np.asarray(Image.open(path)).shape[:2]
        assert g.shape == j.shape == (h, w) and g.max() < C
        assert (g == j).mean() >= 0.999, (path, (g == j).mean())
        color = np.asarray(Image.open(resp["color"]))
        assert color.shape == (h, w, 3)


def test_forward_and_mask_match_jax_engine(ws):
    """The engine API without files: same normalized inputs, logits on the
    port's device, masks from the port's resize + argmax."""
    _, _, _, jax_engine, engine, images = ws
    from u2pl_tpu_torch.serving import load_image_plain

    loaded = [engine.load(p) for p in images]
    jloaded = [jax_engine.load(p) for p in images]
    for (img, size), (jimg, jsize), p in zip(loaded, jloaded, images):
        assert size == jsize and tuple(img.shape) == (3, 513, 513)
        # the engine's route: normalised as JAX does (the same IEEE ops), then
        # kernel A's plain version on this CPU tensor, two taps against numpy's
        # dense einsum: about an ulp apart
        np.testing.assert_allclose(img.permute(1, 2, 0).numpy(), jimg, rtol=0, atol=1e-5)
        # the plain route is the JAX engine's own, to the bit
        plain, psize = load_image_plain(p, engine.mean, engine.std, engine.input_scale, "cpu")
        assert psize == jsize
        np.testing.assert_array_equal(plain.permute(1, 2, 0).numpy(), jimg)
    got = engine.forward([img for img, _ in loaded])
    ref = jax_engine.forward([img for img, _ in jloaded])
    assert tuple(got.shape) == (3, C, 513, 513)
    # 1e-3, looser than test_torch_model's 1e-4 at 65²: at 513² these logits
    # reach ~100 and the two frameworks' f32 sum orders differ by ~2e-4
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-3, atol=1e-3
    )
    for logit, jlogit, (_, size) in zip(got, ref, loaded):
        mask = engine.to_mask(logit, size)
        assert mask.dtype == np.uint8 and mask.shape == size
        assert (mask == jax_engine.to_mask(jlogit, size)).mean() >= 0.999


def test_teacher_state_is_preferred(ws):
    from u2pl_tpu_torch.utils.checkpoint import load_model_variables

    _, _, pth, _, engine, _ = ws
    teacher = load_model_variables(str(pth), prefer_teacher=True)
    student = load_model_variables(str(pth), prefer_teacher=False)
    k = "decoder.classifier.8.weight"
    assert not any(key.startswith("module.") for key in teacher)
    assert student[k].abs().max() == 0 and teacher[k].abs().max() > 0


def test_unported_options_raise(ws, tmp_path):
    from u2pl_tpu_torch.config import parse_config
    from u2pl_tpu_torch.serving import InferEngine

    _, cfg, pth, _, _, _ = ws
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferEngine(cfg, str(pth), dtype="bfloat16", device="cpu")
    # the .ckpt reader is ported (tests/test_torch_msgpack_ckpt.py): a
    # missing file is reported as such
    with pytest.raises(FileNotFoundError):
        InferEngine(cfg, str(tmp_path / "ckpt.ckpt"), device="cpu")


def test_serve_cli_has_the_jax_flags():
    import serve as jax_serve

    from u2pl_tpu_torch import serve

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings)

    assert flags(serve.get_parser()) == flags(jax_serve.get_parser())
    args = serve.get_parser().parse_args(
        ["--batch_size", "8", "--compilation_cache_dir", "/tmp/x", "--no_warmup"]
    )
    assert args.batch_size == 8 and args.dtype == "float32" and args.no_warmup


def test_serving_imports_no_jax():
    code = (
        "import sys, u2pl_tpu_torch.serving, u2pl_tpu_torch.serve; "
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]; "
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env, timeout=120)
