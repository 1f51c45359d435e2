"""Label colormap + mask colorization for the serving PNGs (port of
u2pl_tpu/evallib/colormap.py; reference utils.py:526-565)."""

from __future__ import annotations

import numpy as np
from PIL import Image


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
