"""A synthetic PASCAL-VOC-layout workspace, for driving the trainer CLIs
without the dataset (tests, smoke runs on the card).

    root/VOC2012/JPEGImages/<id>.jpg            smooth colour fields + noise
    root/VOC2012/SegmentationClassAug/<id>.png  labels from the colour, some 255
    root/splits/pascal/labeled.txt, unlabeled.txt, val.txt

`write_config` copies an experiment YAML into root/exp/config.yaml with
the data paths pointed at the workspace and the given overrides, so the
config is the experiment's as it stands otherwise.  Everything is made
from a seed with numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def _image_and_label(rng: np.random.RandomState, h: int, w: int, num_classes: int):
    from u2pl_tpu_torch.ops.resize import resize_bilinear_numpy

    field = resize_bilinear_numpy(rng.rand(6, 6, 3).astype(np.float32), (h, w))
    img = np.clip(field * 220 + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
    # the label follows the colour: the hue-ish angle of (r - g, g - b), binned
    ang = np.arctan2(field[..., 1] - field[..., 2], field[..., 0] - field[..., 1])
    lab = ((ang + np.pi) / (2 * np.pi) * num_classes).astype(np.int64) % num_classes
    lab = lab.astype(np.uint8)
    lab[rng.rand(h, w) < 0.03] = 255
    return img, lab


def make_voc_workspace(root: str, n_labeled: int, n_unlabeled: int, n_val: int,
                       size: Tuple[int, int] = (375, 500), num_classes: int = 21,
                       seed: int = 0) -> Dict[str, str]:
    """Write the images, labels and split lists under `root`; returns the
    paths a config needs (data_root, labeled, val)."""
    from PIL import Image

    data_root = os.path.join(root, "VOC2012")
    splits = os.path.join(root, "splits", "pascal")
    for d in ("JPEGImages", "SegmentationClassAug"):
        os.makedirs(os.path.join(data_root, d), exist_ok=True)
    os.makedirs(splits, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f"synthetic_{i:04d}" for i in range(n_labeled + n_unlabeled + n_val)]
    for s in ids:
        img, lab = _image_and_label(rng, size[0], size[1], num_classes)
        Image.fromarray(img).save(os.path.join(data_root, "JPEGImages", f"{s}.jpg"), quality=95)
        Image.fromarray(lab).save(os.path.join(data_root, "SegmentationClassAug", f"{s}.png"))
    lists = {"labeled.txt": ids[:n_labeled],
             "unlabeled.txt": ids[n_labeled:n_labeled + n_unlabeled],
             "val.txt": ids[n_labeled + n_unlabeled:]}
    for name, part in lists.items():
        with open(os.path.join(splits, name), "w") as f:
            f.write("\n".join(part) + "\n")
    return {"data_root": data_root, "labeled": os.path.join(splits, "labeled.txt"),
            "val": os.path.join(splits, "val.txt")}


def write_config(src_yaml: str, paths: Dict[str, str], exp_dir: str, overrides: Dict) -> str:
    """Copy `src_yaml` to `exp_dir`/config.yaml with the dataset paths of
    `paths` and `overrides` ({"dataset.n_sup": 16, ...}, dotted keys) applied;
    returns the new file's path."""
    import yaml

    with open(src_yaml) as f:
        raw = yaml.safe_load(f)
    d = raw["dataset"]
    d["train"]["data_root"] = d["val"]["data_root"] = paths["data_root"]
    d["train"]["data_list"] = paths["labeled"]
    d["val"]["data_list"] = paths["val"]
    for key, value in overrides.items():
        node = raw
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    os.makedirs(exp_dir, exist_ok=True)
    out = os.path.join(exp_dir, "config.yaml")
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out
