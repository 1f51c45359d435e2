"""Long-lived inference serving: engine + request loop (port of
u2pl_tpu/serving.py, same JSON-lines protocol and responses).

    {"op": "infer", "id": "r1", "image": "/abs/img.jpg",
     "save_folder": "/out"}            -> {"id": "r1", "ok": true,
                                           "gray": ..., "color": ...,
                                           "batch_ms": ...}
    {"op": "ping", "id": "p"}          -> {"id": "p", "ok": true,
                                           "served": N}
    {"op": "shutdown", "id": "s"}      -> {"id": "s", "ok": true} + exit

EOF also shuts the server down; consecutive `infer` requests are
micro-batched up to `batch_size`.  Preprocessing and mask encoding match
the JAX engine: align-corners resize to the fixed 513/769 input scale,
argmax at the original resolution, gray + Pascal-colormap PNGs (the
reference's always-pascal quirk).  On the card the request image is
uploaded as decoded (uint8), normalised there and resized to the input
scale by kernel A (`load_image`; `load_image_plain` is the JAX engine's
numpy route), the forward's final upsample is kernel A and `to_mask` is
kernel B (resize + argmax fused); neither the image nor the logits take
a host resize.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import IO, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from u2pl_tpu_torch.evallib.colormap import colorize, create_pascal_label_colormap
from u2pl_tpu_torch.evallib.slide import make_net_process
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.ops.resize import resize_argmax, resize_bilinear, resize_bilinear_numpy
from u2pl_tpu_torch.utils.checkpoint import load_eval_variables


def input_scale_for(cfg) -> Tuple[int, int]:
    """Fixed inference size per dataset family (reference infer.py:62-79)."""
    if "cityscapes" in cfg.dataset.type or "cityscapes" in (
        cfg.dataset.val.data_root or ""
    ):
        return (769, 769)
    return (513, 513)


def load_image(
    path: str,
    mean: np.ndarray,
    std: np.ndarray,
    size: Optional[Sequence[int]],
    device: Union[str, torch.device],
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Decode `path` and return it normalised as (3, H, W) float32 on
    `device`, resized to `size` (align corners; kernel A on the card) unless
    `size` is None, with the decoded (h, w).  The uint8 image is uploaded
    and normalised there in float32 as the JAX engine does on the host,
    `(x - mean) / std` (u2pl_tpu/serving.py:97-99): the same IEEE operations,
    so the same values."""
    image = np.array(Image.open(path).convert("RGB"))  # writable, for from_numpy
    x = torch.from_numpy(image).to(device).permute(2, 0, 1).contiguous().float()
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    std_t = torch.as_tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    x = (x - mean_t) / std_t
    if size is not None:
        x = resize_bilinear(x[None], size, align_corners=True)[0]
    return x, image.shape[:2]


def load_image_plain(
    path: str,
    mean: np.ndarray,
    std: np.ndarray,
    size: Optional[Sequence[int]],
    device: Union[str, torch.device],
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Plain version of `load_image`: the JAX engine's host route (numpy
    normalise, `resize_bilinear_numpy`), then the upload."""
    image = np.asarray(Image.open(path).convert("RGB"), np.float32)
    hw = image.shape[:2]
    image = (image - mean) / std
    if size is not None:
        image = resize_bilinear_numpy(image, size, align_corners=True)
    return torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1))).to(device), hw


class InferEngine:
    """Resident inference: one model on one device, loaded once."""

    def __init__(
        self,
        cfg,
        model_path: str,
        batch_size: int = 1,
        dtype: str = "float32",
        device: Union[str, torch.device] = "cuda",
    ):
        if str(dtype) != "float32":
            raise NotImplementedError(
                f"dtype={dtype!r}: the port serves float32 only; the bfloat16 "
                "forward of serve / eval / infer is ROADMAP.md queue 1 item 2 "
                "(bf16), the slice after bf16 training"
            )
        # float32 means float32: the JAX f32 path is the reference-exact
        # default, and cuDNN would otherwise run f32 convolutions in TF32
        # (about three decimal digits).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = max(1, batch_size)
        self.input_scale = input_scale_for(cfg)
        self.mean = np.asarray(cfg.dataset.mean, np.float32)
        self.std = np.asarray(cfg.dataset.std, np.float32)
        self.colormap = create_pascal_label_colormap()
        self.model = build_model(cfg.net, device=self.device, dtype=torch.float32)
        load_eval_variables(self.model, model_path)
        self._net_process = make_net_process(self.model)
        self.served = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> float:
        """One full-batch forward (cuDNN algorithm choice, kernel build,
        index tables); returns seconds."""
        t0 = time.monotonic()
        self._net_process(torch.zeros((self.batch_size, 3) + self.input_scale,
                                      device=self.device))
        self._sync()
        return time.monotonic() - t0

    def load(self, image_path: str) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Decode + normalize + resize one image to the serving scale:
        (3, H, W) on the engine's device, and the image's (h, w)."""
        return load_image(image_path, self.mean, self.std, self.input_scale, self.device)

    def forward(self, images: List[torch.Tensor]) -> torch.Tensor:
        """Batched forward of `load`'s images -> (n, C, H, W) logits on the
        device.  Waits for the device, so a caller's clock around it
        measures the forward."""
        logits = self._net_process(torch.stack(images))
        self._sync()
        self.served += len(images)
        return logits

    def to_mask(self, logits: torch.Tensor, size: Tuple[int, int]) -> np.ndarray:
        """(C, H, W) logits -> (h, w) uint8 labels at the original size."""
        return resize_argmax(logits, size, align_corners=True).cpu().numpy()

    def save_mask(
        self, mask: np.ndarray, image_path: str, save_folder: str
    ) -> Tuple[str, str]:
        gray_dir = os.path.join(save_folder, "gray")
        color_dir = os.path.join(save_folder, "color")
        os.makedirs(gray_dir, exist_ok=True)
        os.makedirs(color_dir, exist_ok=True)
        name = os.path.basename(image_path)
        gray = os.path.join(gray_dir, name)
        color = os.path.join(color_dir, name)
        Image.fromarray(mask).save(gray)
        colorize(mask, self.colormap).save(color)
        return gray, color


def _reader_thread(stream: IO[str], q: "queue.Queue[Optional[str]]") -> None:
    for line in stream:
        q.put(line)
    q.put(None)  # EOF sentinel


def run_server(
    reader: IO[str],
    writer: IO[str],
    engine: InferEngine,
    default_save_folder: str = "viewer",
    batch_window_s: float = 0.0,
    logger=None,
) -> int:
    """Serve JSONL requests until shutdown/EOF; returns requests served.

    A daemon reader thread feeds an internal queue so a burst of request
    lines is visible at once: consecutive ``infer`` requests drain into a
    single device batch (up to ``engine.batch_size``).  Control ops flush
    the pending batch first, preserving per-client response ordering.
    """
    q: "queue.Queue[Optional[str]]" = queue.Queue()
    threading.Thread(target=_reader_thread, args=(reader, q), daemon=True).start()

    def respond(obj) -> None:
        writer.write(json.dumps(obj) + "\n")
        writer.flush()

    def flush(batch) -> None:
        if not batch:
            return
        t0 = time.monotonic()
        logits = engine.forward([img for _, img, _ in batch])
        ms = (time.monotonic() - t0) * 1e3
        for (req, _, size), logit in zip(batch, logits):
            mask = engine.to_mask(logit, size)
            folder = req.get("save_folder") or default_save_folder
            gray, color = engine.save_mask(mask, req["image"], folder)
            respond(
                {
                    "id": req.get("id"),
                    "ok": True,
                    "gray": gray,
                    "color": color,
                    "batch_ms": round(ms, 3),
                }
            )
        batch.clear()

    served = 0
    batch: list = []
    running = True
    while running:
        try:
            timeout = batch_window_s if batch else None
            line = q.get(timeout=timeout) if timeout else q.get_nowait()
        except queue.Empty:
            if batch:
                flush(batch)
                continue
            line = q.get()  # idle: block for the next request
        if line is None:  # EOF
            flush(batch)
            break
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            op = req.get("op", "infer")
        except Exception as exc:  # malformed line: answer, keep serving
            flush(batch)
            respond({"id": None, "ok": False, "error": f"bad request: {exc}"})
            continue
        if op == "infer":
            try:
                img, size = engine.load(req["image"])
            except Exception as exc:
                flush(batch)
                respond({"id": req.get("id"), "ok": False, "error": str(exc)})
                continue
            batch.append((req, img, size))
            served += 1
            if len(batch) >= engine.batch_size:
                flush(batch)
        elif op == "ping":
            flush(batch)
            respond({"id": req.get("id"), "ok": True, "served": engine.served})
        elif op == "shutdown":
            flush(batch)
            respond({"id": req.get("id"), "ok": True})
            running = False
        else:
            flush(batch)
            respond({"id": req.get("id"), "ok": False, "error": f"unknown op: {op}"})
    if logger is not None:
        logger.info("server exiting after %d inference requests", served)
    return served
