"""`python -m u2pl_tpu_torch.train_semi --device cpu` launched as 2
processes, as torchrun launches them (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), on the tiny synthetic workspace and config of
tests/test_torch_cli.py (resnet10, 33² crops, 2 + 2 images a rank, a 64 /
96-row bank): one warmup epoch, then a resume that trains the semi epoch
with the contrastive branch.  The two processes train one model: their
states are bit-equal after each run, both log the same mIoU, and rank 0
alone writes the checkpoints.
"""

import os

from test_torch_cli import CONTRA, SMALL, VOC
from test_torch_dist import W, assert_bit_equal, run_ranks
from u2pl_tpu_torch.data.synthetic import make_voc_workspace, write_config
from u2pl_tpu_torch.utils.checkpoint import CKPT_NAME


def torchrun_env(rank, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(W), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "U2PL_ALLOW_RANDOM_INIT": "1"}


def test_train_semi_on_two_processes_then_resume(tmp_path):
    root = str(tmp_path / "ws")
    paths = make_voc_workspace(root, 8, 8, 3, size=(40, 52), num_classes=5, seed=0)
    exp = os.path.join(root, "exp")
    argv = ["--config", os.path.join(exp, "config.yaml"), "--seed", "2", "--device", "cpu"]

    # epoch 0: warmup (sup_only_epoch 1); 8 labeled pairs at 2 x 2 a step: 2 steps
    write_config(VOC, paths, exp, {**SMALL, **CONTRA, "trainer.epochs": 1})
    os.makedirs(tmp_path / "first")
    first = run_ranks("cli", {"module": "semi", "argv": argv}, tmp_path / "first",
                      env_of=torchrun_env)
    for r in first:
        assert (r["start_epoch"], r["steps"], r["steps_per_epoch"]) == (0, 2, 2)
        assert r["state"]["step"] == 2
    assert first[0]["mious"] == first[1]["mious"]
    assert CKPT_NAME in first[0]["saves"] and first[1]["saves"] == []
    assert_bit_equal(first[0]["state"], first[1]["state"], "after epoch 0")
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == sorted(
        {CKPT_NAME, *first[0]["saves"]})

    # the resume: epoch 1, the first semi epoch, the bank fed by both ranks
    write_config(VOC, paths, exp, {**SMALL, **CONTRA, "trainer.epochs": 2,
                                   "saver.auto_resume": True})
    os.makedirs(tmp_path / "resume")
    second = run_ranks("cli", {"module": "semi", "argv": argv}, tmp_path / "resume",
                       env_of=torchrun_env)
    for r in second:
        assert (r["start_epoch"], r["start_iter"], r["steps"]) == (1, 2, 2)
        assert r["state"]["step"] == 4
        assert int(r["state"]["bank"]["occupancy"].sum()) > 0
    assert second[0]["saves"][-1] == CKPT_NAME and second[1]["saves"] == []
    assert second[0]["best_miou"] == second[1]["best_miou"]
    assert_bit_equal(second[0]["state"], second[1]["state"], "after the resumed epoch")
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == sorted(
        {CKPT_NAME, *first[0]["saves"], *second[0]["saves"]})
