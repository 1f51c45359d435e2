"""Offline sliding-window / multi-scale evaluation on one CUDA card (port of
the root eval.py).

    python -m u2pl_tpu_torch.eval --config config.yaml \\
        --model_path checkpoints/ckpt_best.pth --base_size 2048 --scales 1.0

The root CLI's flags, plus `--device` (default `cuda`; `cpu` only when
asked).  The model is built without SyncBN, in float32 with TF32 off,
teacher preferred, from a reference-format `.pth` or the JAX package's
`.ckpt`.  Cityscapes takes the overlapping crop grid averaged by visit
counts, VOC the whole image; every scale's resize, the canvas and the
final resize + argmax run on the device (`evallib/slide.py`).  Gray and
colour PNG masks are written, intersection and union are counted on the
device, and per-class IoU and mIoU are logged as the root CLI logs them.
`--no_bucket`, `--names_path` and `--compilation_cache_dir` are accepted
and do nothing (the port compiles no XLA programs); `--dtype bfloat16`
raises.  `main(argv)` runs in process and returns a summary.
"""

from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.evallib.colormap import (
    colorize,
    create_cityscapes_label_colormap,
    create_pascal_label_colormap,
)
from u2pl_tpu_torch.evallib.metrics import intersection_and_union_device
from u2pl_tpu_torch.evallib.slide import make_net_process, predict_city, predict_whole
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.serving import load_image
from u2pl_tpu_torch.utils.checkpoint import load_eval_variables
from u2pl_tpu_torch.utils.logging_utils import init_log


def get_parser():
    parser = ArgumentParser(description="CUDA Evaluation")
    parser.add_argument("--base_size", type=int, default=2048)
    parser.add_argument("--scales", type=float, default=[1.0], nargs="+")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--model_path", type=str, default="checkpoints/ckpt_best.ckpt")
    parser.add_argument("--save_folder", type=str, default="checkpoints/results/")
    parser.add_argument("--names_path", type=str, default="",
                        help="accepted for parity with the reference; unused")
    parser.add_argument("--crop", action="store_true", default=False,
                        help="accepted for parity with the reference; unused")
    parser.add_argument("--no_bucket", action="store_true", default=False,
                        help="accepted for parity with the JAX CLI; the port forwards "
                        "each image at its own size")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="forward compute dtype (bfloat16 is not ported yet and raises)")
    parser.add_argument("--compilation_cache_dir", type=str, default="",
                        help="accepted for parity with the JAX CLI; ignored")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the card)")
    return parser


def build_data_list(cfg):
    """[(image path, label path)] of the val list, and the colormap
    (a copy of the root eval.py:92-118)."""
    data_root = cfg.dataset.val.data_root
    f_list = cfg.dataset.val.data_list
    data_list = []
    if "cityscapes" in data_root or "cityscapes" in cfg.dataset.type:
        colormap = create_cityscapes_label_colormap()
        for line in open(f_list):
            s = line.strip()
            data_list.append(
                (
                    os.path.join(data_root, s),
                    os.path.join(data_root, "gtFine/" + s[12:-15] + "gtFine_labelTrainIds.png"),
                )
            )
    else:
        colormap = create_pascal_label_colormap()
        for line in open(f_list):
            s = line.strip()
            data_list.append(
                (
                    os.path.join(data_root, f"JPEGImages/{s}.jpg"),
                    os.path.join(data_root, f"SegmentationClassAug/{s}.png"),
                )
            )
    return data_list, colormap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = get_parser().parse_args(argv)
    if args.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {args.dtype}: the port evaluates float32 only; the bfloat16 "
            "forward of serve / eval / infer is ROADMAP.md queue 1 item 2 (bf16), "
            "the slice after bf16 training")
    cfg = load_config(args.config)
    logger = init_log("main-logger", logging.INFO)
    logger.info(args)
    # float32 means float32: cuDNN would otherwise run f32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)

    num_classes = cfg.net.num_classes
    mean = np.asarray(cfg.dataset.mean, np.float32)
    std = np.asarray(cfg.dataset.std, np.float32)
    crop_size = cfg.dataset.val.crop.size if cfg.dataset.val.crop else (769, 769)

    gray_folder = os.path.join(args.save_folder, "gray")
    color_folder = os.path.join(args.save_folder, "color")
    os.makedirs(gray_folder, exist_ok=True)
    os.makedirs(color_folder, exist_ok=True)

    data_list, colormap = build_data_list(cfg)
    # the port has one BatchNorm for one card: eval builds without SyncBN as
    # the reference does (eval.py:120)
    model = build_model(cfg.net, device=device, dtype=torch.float32)
    load_eval_variables(model, args.model_path)
    net_process = make_net_process(model)
    is_city = "cityscapes" in cfg.dataset.type
    logger.info("Load Model Done!")

    inter = torch.zeros(num_classes, dtype=torch.int64, device=device)
    union = torch.zeros(num_classes, dtype=torch.int64, device=device)
    seconds = []
    with torch.inference_mode():
        for i, (img_path, lab_path) in enumerate(data_list):
            t0 = time.perf_counter()
            image, _ = load_image(img_path, mean, std, None, device)
            label = np.array(Image.open(lab_path).convert("L"), np.uint8)
            if is_city:
                mask = predict_city(net_process, image, num_classes, args.base_size,
                                    crop_size[0], crop_size[1], args.scales)
            else:
                mask = predict_whole(net_process, image, num_classes, args.scales)
            i_, u_, _ = intersection_and_union_device(
                mask, torch.from_numpy(label).to(device), num_classes)
            inter += i_
            union += u_
            gray = mask.cpu().numpy()  # waits for the image's work on the device

            name = os.path.splitext(os.path.basename(img_path))[0]
            Image.fromarray(gray).save(os.path.join(gray_folder, name + ".png"))
            colorize(gray, colormap).save(os.path.join(color_folder, name + ".png"))
            seconds.append(time.perf_counter() - t0)
            if (i + 1) % 10 == 0:
                logger.info(f"Test: [{i + 1}/{len(data_list)}]")

    iou_class = inter.cpu().numpy() / (union.cpu().numpy() + 1e-10)
    for i, iou in enumerate(iou_class):
        logger.info(" * class [{}] IoU {:.2f}".format(i, iou * 100))
    miou = float(np.mean(iou_class))
    logger.info(" * mIoU {:.2f}".format(miou * 100))
    return {"miou": miou, "iou_class": iou_class.tolist(), "images": len(data_list),
            "seconds": seconds}


if __name__ == "__main__":
    main()
