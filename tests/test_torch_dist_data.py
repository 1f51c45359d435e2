"""Data-parallel validation and loaders on the CPU: the inter / union
counts summed over 2 gloo ranks (tests/torch_dist_worker.py) equal one
process's; the loaders' rank slices put together are the JAX loader's
global batch, and each rank's slice is the JAX loader's for that process.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import W, run_ranks


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from test_torch_cli import SMALL, VOC
    from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config

    root = str(tmp_path_factory.mktemp("dist_ws"))
    paths = make_voc_workspace(root, 8, 8, 5, size=(40, 52), num_classes=5, seed=1,
                               val_sizes=[(40, 52), (36, 44)])
    return root, write_config(VOC, paths, os.path.join(root, "exp"),
                              {**SMALL, "dataset.workers": 1})


def test_validation_counts_summed_over_ranks_equal_one_process(workspace, tmp_path):
    """5 val images at batch 2 a rank: a global batch of 4 and a ragged one
    of 1 (rank 1 skips it).  The ranks score 3 + 2 images, and their summed
    inter / union counts equal one process's over all 5."""
    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.data.loader import build_loaders
    from u2pl_tpu_torch.models import build_model
    from u2pl_tpu_torch.train.validate import accumulate_val_sums

    _, cfg_path = workspace
    ranks = run_ranks("validate", {"config": cfg_path}, tmp_path)
    cfg = load_config(cfg_path)
    model = build_model(cfg.net, device="cpu", generator=torch.Generator().manual_seed(5))
    *_, loader = build_loaders(cfg, seed=0)
    inter, union = accumulate_val_sums(model, loader, cfg, 0, torch.device("cpu"))
    loader.close()
    assert [r["images"] for r in ranks] == [3, 2]
    assert union.sum() > 0
    for r in ranks:
        np.testing.assert_array_equal(r["inter"], inter)
        np.testing.assert_array_equal(r["union"], union)


class Indices:
    """A dataset whose sample i is (i, -i): the loaders' batches name their
    indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i]), np.array([-i])


@pytest.mark.parametrize("drop_last", [True, False], ids=["train", "val"])
def test_loader_rank_slices_are_the_jax_global_batch(drop_last):
    """11 samples at batch 2 a rank, 2 ranks: the epoch's length counts
    global batches; each rank's batches are the JAX loader's for that
    process, and put together they are the JAX loader's global batch of one
    process feeding 2 devices (a ragged last one with drop_last False)."""
    from u2pl_tpu.data.loader import EpochLoader as JaxLoader
    from u2pl_tpu_torch.data.loader import EpochLoader

    ds = Indices(11)
    common = dict(seed=3, shuffle=True, drop_last=drop_last, workers=1)
    ranks = [EpochLoader(ds, 2, process_index=r, process_count=W, **common) for r in range(W)]
    jax_ranks = [JaxLoader(ds, 2, process_index=r, process_count=W, **common) for r in range(W)]
    jax_global = JaxLoader(ds, 2, replicas_per_process=W, **common)
    assert [len(ld) for ld in ranks] == [len(jax_global)] * W == [2 if drop_last else 3] * W
    for epoch in (0, 1):
        got = [[b[0][:, 0].tolist() for b in ld.epoch(epoch)] for ld in ranks]
        for r in range(W):
            assert got[r] == [b[0][:, 0].tolist() for b in jax_ranks[r].epoch(epoch)]
        together = [sum((g[i] for g in got if i < len(g)), []) for i in range(len(got[0]))]
        assert together == [b[0][:, 0].tolist() for b in jax_global.epoch(epoch)]
    if not drop_last:  # every sample once
        assert sorted(sum(got[0] + got[1], [])) == list(range(11))
