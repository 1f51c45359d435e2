"""Label colormaps + mask colorization for the eval, infer and serving
PNGs (port of u2pl_tpu/evallib/colormap.py; reference utils.py:526-565,
639-696)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def create_cityscapes_label_colormap() -> np.ndarray:
    colormap = np.zeros((256, 3), dtype=np.uint8)
    rows = [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ]
    for i, r in enumerate(rows):
        colormap[i] = r
    return colormap


def create_pascal_label_colormap() -> np.ndarray:
    colormap = 255 * np.ones((256, 3), dtype=np.uint8)
    rows = [
        [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
        [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0],
        [192, 0, 0], [64, 128, 0], [192, 128, 0], [64, 0, 128],
        [192, 0, 128], [64, 128, 128], [192, 128, 128], [0, 64, 0],
        [128, 64, 0], [0, 192, 0], [128, 192, 0], [0, 64, 128],
    ]
    for i, r in enumerate(rows):
        colormap[i] = r
    return colormap


def colorize(mask: np.ndarray, colormap: np.ndarray) -> Image.Image:
    return Image.fromarray(np.uint8(colormap[mask.astype(np.int64)]))
