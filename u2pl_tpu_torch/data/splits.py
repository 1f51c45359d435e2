"""Split-file parsing and deterministic sub/over-sampling (port of
u2pl_tpu/data/splits.py).

The reference's path templates (dataset/base.py:12-41) and its seeded
`random.sample` selection (pascal_voc.py:24-33, cityscapes.py:24-32): the
same seed gives the same labeled subset as the reference and the JAX
package.
"""

from __future__ import annotations

import logging
import math
import os
import random
import shutil
from typing import List, Tuple

log = logging.getLogger("global")


def sync_split_dir(source_root: str, dest_root: str) -> int:
    """Copy every ``*.txt`` under ``<source_root>/data/splits`` into
    ``dest_root``, keeping the layout.  Returns the number of files copied."""
    src = os.path.join(source_root, "data", "splits")
    if not os.path.isdir(src):
        raise FileNotFoundError(f"no split directory at {src}")
    n = 0
    for root, _, files in os.walk(src):
        out_dir = os.path.join(dest_root, os.path.relpath(root, src))
        os.makedirs(out_dir, exist_ok=True)
        for f in files:
            if f.endswith(".txt"):
                shutil.copyfile(os.path.join(root, f), os.path.join(out_dir, f))
                n += 1
    return n


def _maybe_sync_missing_split(d_list: str) -> bool:
    """Populate a missing ``data/splits/`` tree outside this repo from the
    reference checkout named by U2PL_SPLITS_SOURCE (the repo's own
    data/splits/** is vendored).  Returns True if the file now exists."""
    parts = os.path.normpath(os.path.abspath(d_list)).split(os.sep)
    try:
        i = len(parts) - 1 - parts[::-1].index("splits")
    except ValueError:
        return False
    if i == 0 or parts[i - 1] != "data":
        return False
    source = os.environ.get("U2PL_SPLITS_SOURCE")
    if not source or not os.path.isdir(os.path.join(source, "data", "splits")):
        return False
    n = sync_split_dir(source, os.sep.join(parts[: i + 1]))
    log.info("split list %s was missing; synced %d split files from %s", d_list, n, source)
    return os.path.isfile(d_list)


def parse_split(d_list: str) -> List[Tuple[str, str]]:
    """(image, label) paths relative to the data root, one per line of the
    split list; the dataset is told by the list's path (cityscapes, or
    pascal / VOC)."""
    if not os.path.isfile(d_list) and not _maybe_sync_missing_split(d_list):
        raise FileNotFoundError(
            f"split list {d_list!r} does not exist. The standard lists are "
            "vendored under this repo's data/splits/**: point the config "
            "there, or set U2PL_SPLITS_SOURCE to a reference checkout to "
            "populate an external data/splits/ tree."
        )
    pairs: List[Tuple[str, str]] = []
    with open(d_list, "r") as f:
        lines = [line.strip() for line in f]
    if "cityscapes" in d_list:
        pairs = [(s, "gtFine/" + s[12:-15] + "gtFine_labelTrainIds.png") for s in lines]
    elif "pascal" in d_list or "VOC" in d_list:
        pairs = [(f"JPEGImages/{s}.jpg", f"SegmentationClassAug/{s}.png") for s in lines]
    else:
        raise ValueError(f"unknown dataset for list {d_list!r}")
    assert pairs, f"empty split list {d_list}"
    return pairs


def subsample(
    pairs: List[Tuple[str, str]], n_sup: int, seed: int, split: str
) -> List[Tuple[str, str]]:
    """The reference's voc_dset / city_dset selection: a seeded
    random.sample of n_sup entries, the list repeated first when n_sup
    exceeds its length; the val split is returned untouched."""
    random.seed(seed)
    if split != "train":
        return list(pairs)
    if len(pairs) >= n_sup:
        return random.sample(pairs, n_sup)
    num_repeat = math.ceil(n_sup / len(pairs))
    return random.sample(pairs * num_repeat, n_sup)
