"""One rank of the data-parallel tests (tests/test_torch_dist*.py): a gloo
process group on the CPU, the port's code, torch only (no JAX).

    python tests/torch_dist_worker.py TASK RANK WORLD PORT IN OUT

IN is a torch.save'd dict of the task's inputs (written by the test), OUT
this rank's results.  Tasks:
  steps     one train step (sup, warmup or semi) per entry of `steps` (or
            of `posted_steps` entries the test posts one by one as
            step<i>.pt while the ranks run), each from its own state
            snapshot, on this rank's slice of the global batch with this
            rank's injected draws (and under anchor_ema this rank's own
            prototype, returned apart from the shared state);
  one_rank  a group of one process against no group: the same run_steps
            twice from the same state, both states returned;
  bn        the port's BatchNorm2d forward / backward on this rank's slice;
  validate  `validate` of a seeded model on this rank's slice of the val set;
  cli       `train_semi.main` / `train_sup.main` under the launcher's
            environment (the test sets it), with the small bank of
            tests/test_torch_cli.py and every checkpoint write recorded.
"""

import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from u2pl_tpu_torch import dist  # noqa: E402
from u2pl_tpu_torch.config import parse_config  # noqa: E402
from u2pl_tpu_torch.memobank import MemoryBank  # noqa: E402
from u2pl_tpu_torch.models import build_model  # noqa: E402
from u2pl_tpu_torch.models.decoder import Dropout2d  # noqa: E402
from u2pl_tpu_torch.train.state import create_train_state  # noqa: E402


def make_group(rank, world, port):
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                             world_size=world)
    return dist.Group()


def port_state(cfg, snap, group):
    """The port's TrainState at `snap` (state dicts in the port's names,
    the SGD trace, the step and the bank), dropout off."""
    student = build_model(cfg.net, device="cpu")
    student.load_state_dict(snap["student"], strict=True)
    for m in student.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    state = create_train_state(cfg, device="cpu", student=student,
                               with_teacher=snap.get("teacher") is not None, group=group)
    if state.teacher is not None:
        state.teacher.load_state_dict(snap["teacher"], strict=True)
    if snap.get("trace") is not None:
        for name, p in state.student.named_parameters():
            state.optimizer.state[p]["trace"] = snap["trace"][name].clone()
    state.step.fill_(snap["step"])
    if snap.get("bank") is not None:
        b = snap["bank"]
        state.bank = MemoryBank(b["keys"].clone(), b["ptr"].clone(), b["occupancy"].clone(),
                                b["sizes"].clone())
    return state


def snapshot(state):
    out = {"step": int(state.step),
           "student": {k: v.detach().clone() for k, v in state.student.state_dict().items()},
           "trace": {}}
    for name, p in state.student.named_parameters():
        trace = state.optimizer.state.get(p, {}).get("trace")
        if trace is not None:
            out["trace"][name] = trace.clone()
    if state.teacher is not None:
        out["teacher"] = {k: v.detach().clone() for k, v in state.teacher.state_dict().items()}
    if state.bank is not None:
        out["bank"] = {f: getattr(state.bank, f).clone() for f in ("keys", "ptr", "occupancy")}
    return out


def metrics_of(m):
    return {k: (v.item() if v.dim() == 0 else v.clone()) for k, v in m.items()}


def rank_slice(t, rank, world):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n].contiguous()


def posted(name, timeout=300.0):
    """The object the test posts as `name` in the working directory (it may
    post it while this rank runs), waited for up to `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(name):
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing posted as {name}")
        time.sleep(0.05)
    return torch.load(name, weights_only=False)


def task_steps(inp, rank, world, group):
    from u2pl_tpu_torch.train.steps import make_sup_step, run_steps

    cfg = parse_config(inp["raw"])
    out = []
    entries = inp.get("steps") or (posted(f"step{i}.pt") for i in range(inp["posted_steps"]))
    for entry in entries:
        state = port_state(cfg, entry["state"], group)
        if "prototype" in entry:  # anchor_ema: this rank's own
            state.prototype.copy_(entry["prototype"][rank])
        batch = tuple(rank_slice(t, rank, world) for t in entry["batch"])
        if entry["kind"] == "sup":
            m = make_sup_step(cfg, entry["steps_per_epoch"], group)(state, *batch)
            i_iter = entry["state"]["step"]
        else:
            ((i_iter, m),) = run_steps(
                state, [batch], entry["steps_per_epoch"], cfg, start_iter=entry["i"],
                mixes=[entry["mix"][rank]], contras=[entry["contra"][rank]], group=group)
        out.append({"metrics": metrics_of(m), "steps": (i_iter, int(state.step)),
                    "state": snapshot(state)})
        if "prototype" in entry:  # per rank, apart from the state the ranks share
            out[-1].update(prototype_in=entry["prototype"][rank], prototype=state.prototype.clone())
    return out


def task_one_rank(inp, rank, world, group):
    """run_steps from the same state with no group, then with a group of one."""
    from u2pl_tpu_torch.train.steps import run_steps

    cfg = parse_config(inp["raw"])
    out = {}
    for name in ("none", "group"):
        if name == "group":
            group = make_group(0, 1, inp["port"])
        state = port_state(cfg, inp["state"], group if name == "group" else None)
        # dropout on: its masks come from the step generators
        for model in (state.student, state.teacher):
            for m in model.modules():
                if isinstance(m, Dropout2d):
                    m.p = 0.1
        metrics = [metrics_of(m) for _, m in run_steps(
            state, inp["batches"], inp["steps_per_epoch"], cfg, seed=inp["seed"],
            group=group if name == "group" else None)]
        out[name] = {"metrics": metrics, "state": snapshot(state)}
    return out


def task_bn(inp, rank, world, group):
    from u2pl_tpu_torch.models.resnet import BatchNorm2d

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm2d(inp["x"].shape[1], eps=1e-5, momentum=0.1)
        with torch.no_grad():
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, k).copy_(inp[k])
        bn.sync_group = group
        bn.train()
        x = rank_slice(inp["x"], rank, world).to(dtype).requires_grad_(True)
        y = bn(x)
        y.backward(rank_slice(inp["g"], rank, world).to(dtype))
        out[str(dtype)] = {"y": y.detach(), "gx": x.grad, "gw": bn.weight.grad,
                           "gb": bn.bias.grad, "mean": bn.running_mean.clone(),
                           "var": bn.running_var.clone()}
    return out


def task_validate(inp, rank, world, group):
    from u2pl_tpu_torch.config import load_config
    from u2pl_tpu_torch.data.loader import build_loaders
    from u2pl_tpu_torch.train.validate import accumulate_val_sums

    cfg = load_config(inp["config"])
    model = build_model(cfg.net, device="cpu", generator=torch.Generator().manual_seed(5))
    *_, loader_val = build_loaders(cfg, seed=0, process_index=rank, process_count=world)
    inter, union = accumulate_val_sums(model, loader_val, cfg, 0, torch.device("cpu"), group)
    images = sum(b[0].shape[0] for b in loader_val.epoch(0))
    loader_val.close()
    return {"inter": inter, "union": union, "images": images}


def task_cli(inp, rank, world, group):
    from u2pl_tpu_torch import memobank, train_semi, train_sup
    from u2pl_tpu_torch.train import state as state_mod

    state_mod.init_memobank = functools.partial(memobank.init_memobank, queue_size=64,
                                                class0_size=96)
    saves = []
    save = train_semi.save_checkpoint

    def recording_save(path, *args, **kw):
        saves.append(os.path.basename(path))
        return save(path, *args, **kw)

    train_semi.save_checkpoint = recording_save
    module = train_semi if inp["module"] == "semi" else train_sup
    summary = module.main(inp["argv"])
    return {"saves": saves, "state": snapshot(summary["state"]),
            **{k: summary[k] for k in ("start_epoch", "start_iter", "steps", "steps_per_epoch",
                                       "mious", "best_miou")}}


def main():
    task, rank, world, port, inp, outp = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    torch.manual_seed(0)
    inp = torch.load(inp, weights_only=False)
    group = None
    if task not in ("one_rank", "cli"):
        group = make_group(rank, world, int(port))
    fn = {"steps": task_steps, "one_rank": task_one_rank, "bn": task_bn,
          "validate": task_validate, "cli": task_cli}[task]
    out = fn(inp, rank, world, group)
    torch.save(out, outp + ".tmp")
    os.replace(outp + ".tmp", outp)
    if group is not None and tdist.is_initialized():
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
