"""The port's own config parser against the JAX package's: the same values
(`dataclasses.asdict`) for every experiment config of the repo, and for the
raw dicts the port's tests build."""

import dataclasses
import glob
import os

import pytest

from u2pl_tpu import config as jax_config
from u2pl_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "experiments", "**", "config.yaml"), recursive=True))


def test_every_experiment_config_is_found():
    # 9 VOC and 4 Cityscapes splits, each with an `ours` and a `suponly` config
    assert len(CONFIGS) == 26
    assert sum("/ours/" in p for p in CONFIGS) == 13


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_parse_config_matches_jax(path):
    got, ref = config.load_config(path), jax_config.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert config.head_lr_multiplier(got) == jax_config.head_lr_multiplier(ref)
    if "/ours/" in path:
        assert got.trainer.contrastive is not None


@pytest.mark.parametrize("raw", [
    {},
    {"trainer": {"contrastive": {"anchor_ema": True, "select_keys": "radix",
                                 "max_keys_per_class_per_step": 12288}}},
    {"dataset": {"type": "cityscapes_semi", "train": {"cutmix": {"prop_range": 0.3}},
                 "cutout": {"n_holes": 2, "length": 16}},
     "criterion": {"type": "ohem", "kwargs": {"thresh": 0.7, "min_kept": 100000}},
     "net": {"aux_loss": {"aux_plane": 1024, "loss_weight": 0.4}}},
], ids=["defaults", "contrastive_options", "cityscapes_ohem_aux"])
def test_parse_config_matches_jax_on_raw_dicts(raw):
    assert dataclasses.asdict(config.parse_config(raw)) == dataclasses.asdict(jax_config.parse_config(raw))


def test_parse_config_rejects_what_jax_rejects():
    for raw in ({"trainer": {"contrastive": {"binary": True}}},
                {"trainer": {"contrastive": {"select_keys": "topk"}}}):
        with pytest.raises(ValueError):
            jax_config.parse_config(raw)
        with pytest.raises(ValueError):
            config.parse_config(raw)
