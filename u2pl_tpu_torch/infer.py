"""Single-forward inference on one CUDA card (port of the root infer.py).

    python -m u2pl_tpu_torch.infer --config config.yaml \\
        --model_path checkpoints/ckpt_best.pth --batch_size 4

The root CLI's flags, plus `--device` (default `cuda`; `cpu` only when
asked).  Built on `serving.InferEngine`: each val image is decoded,
uploaded, normalised and resized to 769² (Cityscapes) / 513² (VOC) on the
device, `--batch_size` images go through one forward (the last, partial
batch runs as it is), and each mask is the resize back to the image's size
fused with the argmax (kernel B).  Gray and colour PNGs are written under
the image's own name, with the Pascal colormap whatever the dataset (the
reference's quirk, infer.py:102).  `--dtype bfloat16` runs the forward in
bf16 with float32 parameters, as the root CLI does (the masks from the
exact upcast of the bf16 logits).  `--compilation_cache_dir` is accepted
and ignored.  `main(argv)` runs in process and returns a summary.
"""

from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser
from typing import Dict, List, Optional

from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.serving import InferEngine
from u2pl_tpu_torch.utils.logging_utils import init_log


def get_parser():
    parser = ArgumentParser(description="CUDA Inference")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--model_path", type=str, default="checkpoints/ckpt_best.ckpt")
    parser.add_argument("--save_folder", type=str, default="viewer")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="images per forward; the last, partial batch runs as it is")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="forward compute dtype (bfloat16: float32 parameters, "
                             "bf16 forward)")
    parser.add_argument("--compilation_cache_dir", type=str, default="",
                        help="accepted for parity with the JAX CLI; ignored")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the card)")
    return parser


def build_image_list(cfg) -> List[str]:
    """The val images' paths (the root infer.py:70-79)."""
    data_root = cfg.dataset.val.data_root
    city = "cityscapes" in data_root or "cityscapes" in cfg.dataset.type
    with open(cfg.dataset.val.data_list) as f:
        names = [line.strip() for line in f]
    if city:
        return [os.path.join(data_root, s) for s in names]
    return [os.path.join(data_root, f"JPEGImages/{s}.jpg") for s in names]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = get_parser().parse_args(argv)
    cfg = load_config(args.config)
    logger = init_log("main-logger", logging.INFO)
    logger.info(args)
    engine = InferEngine(cfg, args.model_path, batch_size=args.batch_size,
                         dtype=args.dtype, device=args.device)
    logger.info("Load Model Done!")
    data_list = build_image_list(cfg)
    bs = engine.batch_size
    seconds = []
    for start in range(0, len(data_list), bs):
        t0 = time.perf_counter()
        chunk = data_list[start:start + bs]
        loaded = [engine.load(p) for p in chunk]
        logits = engine.forward([img for img, _ in loaded])
        for path, (_, size), logit in zip(chunk, loaded, logits):
            engine.save_mask(engine.to_mask(logit, size), path, args.save_folder)
        seconds.append(time.perf_counter() - t0)
    return {"images": len(data_list), "batches": len(seconds), "seconds": seconds}


if __name__ == "__main__":
    main()
