"""Data-parallel runtime of the port: one process per card, a
`torch.distributed` process group (port of u2pl_tpu/dist.py; reference
dist_helper.py:13-46).

The JAX package runs each train step as one `shard_map` over a ("data",)
mesh of every device, with its collectives compiled in: the SyncBN
`pmean`, the gradient `pmean`, the bank's `all_gather`, the logged losses'
`psum`.  The port runs W processes, rank r on `cuda:LOCAL_RANK`, and makes
those collectives with the group: NCCL on the card, gloo on the CPU (the
tests).  The steps, the model's BatchNorm, the contrastive loss, the
validation and the loaders take a `Group`, or None for no group: one
process, today's path bit for bit.

`init_distributed` reads the launch from the environment, as the reference
does: torchrun / `torch.distributed.launch` (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT; the launcher's `--local_rank` flag), SLURM
(SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID) or Open MPI
(OMPI_COMM_WORLD_RANK / _SIZE / _LOCAL_RANK).  With no launcher, or a
world of one, it makes no group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# (rank, world size, local rank) as each launcher names them
LAUNCHERS = (
    ("torchrun", ("RANK", "WORLD_SIZE", "LOCAL_RANK")),
    ("slurm", ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID")),
    ("openmpi", ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK")),
)
DEFAULT_PORT = 29500


@dataclass(frozen=True)
class Launch:
    rank: int
    world_size: int
    local_rank: int
    launcher: str  # "none", or the name in LAUNCHERS


def launch_from_env(local_rank: Optional[int] = None) -> Launch:
    """The launch as the environment describes it: the first launcher whose
    world size is set; `local_rank` (the `--local_rank` flag of
    `torch.distributed.launch`) stands in for an unset LOCAL_RANK."""
    env = os.environ
    for name, (r, w, lr) in LAUNCHERS:
        if env.get(w, "").strip():
            world = int(env[w])
            rank = int(env.get(r, "0") or 0)
            local = env.get(lr, "").strip()
            local = int(local) if local else (local_rank if local_rank is not None else rank)
            if not 0 <= rank < world:
                raise ValueError(f"{name}: rank {rank} outside a world of {world}")
            return Launch(rank, world, local, name)
    return Launch(0, 1, local_rank or 0, "none")


class Group:
    """A process group with its size and this process's rank in it.  The
    models hold it (their BatchNorm syncs over it), so a deepcopy of a model
    shares it rather than copying the group."""

    def __init__(self, pg=None):
        self.pg = pg if pg is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.pg)
        self.rank = dist.get_rank(self.pg)
        self.backend = dist.get_backend(self.pg)

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return f"Group(rank {self.rank} of {self.size}, {self.backend})"


def init_distributed(device_type: str, local_rank: Optional[int] = None,
                     port: Optional[int] = None):
    """(device, group) of this process.  `device_type` "cuda" trains on
    `cuda:LOCAL_RANK` over NCCL, "cpu" on the CPU over gloo; a local rank
    with no card of its own raises before anything is built.  The group is
    None with no launcher or a world of one; otherwise the default group,
    made at MASTER_ADDR:MASTER_PORT (or localhost and `port`)."""
    launch = launch_from_env(local_rank)
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if launch.local_rank >= n:
            raise RuntimeError(
                f"{launch.launcher}: local rank {launch.local_rank} of a world of "
                f"{launch.world_size} has no card of its own ({n} visible): launch at most one "
                "process per card")
        device = torch.device("cuda", launch.local_rank)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"--device {device_type!r}: cuda or cpu")
    if launch.world_size == 1:
        return device, None
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        master_port = os.environ.get("MASTER_PORT", "") or port or DEFAULT_PORT
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{master_port}",
            rank=launch.rank, world_size=launch.world_size,
        )
    return device, Group()


def world_size(group: Optional[Group]) -> int:
    return 1 if group is None else group.size


def rank(group: Optional[Group]) -> int:
    return 0 if group is None else group.rank


def is_primary(group: Optional[Group]) -> bool:
    return rank(group) == 0


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        if group.backend == "nccl":
            dist.barrier(group.pg, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group.pg)


def all_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """x summed over the ranks (JAX `psum`), a new tensor; x itself with no
    group."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    return out


def all_max(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """x's elementwise max over the ranks (JAX `pmax`)."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group.pg)
    return out


def all_mean(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """x's mean over the ranks (JAX `pmean`: the sum, then / W)."""
    if group is None:
        return x
    return all_sum(x, group) / float(group.size)


class _AllSum(torch.autograd.Function):
    """psum with its gradient: the transpose of a sum over the ranks is a
    sum over the ranks of the cotangents (JAX's psum transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group.pg)
        return g, None


def all_sum_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """`all_sum` through which gradients flow (SyncBN's statistics)."""
    return _AllSum.apply(x, group)


def all_gather(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """(W, *x.shape): every rank's x, in rank order (JAX `all_gather` on a
    new leading axis); x[None] with no group."""
    if group is None:
        return x[None]
    x = x.contiguous()
    out = torch.empty((group.size, *x.shape), dtype=x.dtype, device=x.device)
    if group.backend == "nccl":
        dist.all_gather_into_tensor(out, x, group=group.pg)
    else:
        dist.all_gather(list(out.unbind(0)), x, group=group.pg)
    return out


def mean_gradients(params: Sequence[torch.Tensor], group: Optional[Group]) -> None:
    """The gradient `pmean` of the JAX steps (steps.py:88): the parameters'
    gradients flattened into one buffer, summed over the ranks in one
    all_reduce, divided by W in float32 and written back.  Parameters with
    no gradient have none on any rank (the same graph)."""
    if group is None:
        return
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
    flat.div_(float(group.size))
    for g, m in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(m)


def broadcast_tensors(tensors: Sequence[torch.Tensor], group: Optional[Group],
                      src: int = 0) -> None:
    """Every rank's `tensors` set, in place, to rank `src`'s."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=group.pg)


def destroy(group: Optional[Group]) -> None:
    """Tear the default group down (the end of a run)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
