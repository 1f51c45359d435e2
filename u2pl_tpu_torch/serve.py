"""Long-lived inference server CLI on one CUDA device (port of serve.py).

    python -m u2pl_tpu_torch.serve --config exp/config.yaml \\
        --model_path exp/checkpoints/ckpt_best.pth --batch_size 8 \\
        < requests.jsonl

Same flags and protocol as the JAX server (u2pl_tpu_torch/serving.py).
Responses go to stdout, one JSON line per request; logs go to stderr.
`--dtype bfloat16` runs the forward in bf16 with float32 parameters, as the
JAX server does; `--compilation_cache_dir` is accepted and ignored (the
port compiles no XLA programs).
"""

from __future__ import annotations

import logging
import sys
from argparse import ArgumentParser

from u2pl_tpu_torch.config import load_config
from u2pl_tpu_torch.serving import InferEngine, run_server
from u2pl_tpu_torch.utils.logging_utils import init_log


def get_parser():
    parser = ArgumentParser(description="CUDA Inference Server")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--model_path", type=str, default="checkpoints/ckpt_best.pth")
    parser.add_argument(
        "--save_folder",
        type=str,
        default="viewer",
        help="default output directory for requests that omit save_folder",
    )
    parser.add_argument(
        "--batch_size",
        type=int,
        default=1,
        help="micro-batch cap: consecutive queued infer requests are "
        "fused into one device batch of at most this size",
    )
    parser.add_argument(
        "--batch_window_ms",
        type=float,
        default=0.0,
        help="after the first queued request, wait up to this long for "
        "more before dispatching (0 = dispatch whatever is already queued)",
    )
    parser.add_argument(
        "--dtype",
        type=str,
        default="float32",
        choices=["float32", "bfloat16"],
        help="forward compute dtype (bfloat16: float32 parameters, bf16 forward)",
    )
    parser.add_argument(
        "--compilation_cache_dir",
        type=str,
        default="",
        help="accepted for CLI parity with the JAX server; ignored",
    )
    parser.add_argument(
        "--no_warmup",
        action="store_true",
        help="skip the startup forward; the first request pays it instead",
    )
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = init_log("main-logger", logging.INFO)
    logger.info(args)
    if args.compilation_cache_dir:
        logger.info(
            "--compilation_cache_dir %s ignored: the port compiles no XLA programs",
            args.compilation_cache_dir,
        )
    cfg = load_config(args.config)
    engine = InferEngine(
        cfg, args.model_path, batch_size=args.batch_size, dtype=args.dtype
    )
    logger.info("Load Model Done!")
    if not args.no_warmup:
        logger.info("warmup: %.1fs", engine.warmup())
    logger.info("ready: serving on stdin (batch_size=%d)", args.batch_size)
    run_server(
        sys.stdin,
        sys.stdout,
        engine,
        default_save_folder=args.save_folder,
        batch_window_s=args.batch_window_ms / 1e3,
        logger=logger,
    )


if __name__ == "__main__":
    main()
