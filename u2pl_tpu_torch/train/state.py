"""Train state: student, EMA teacher, optimizer and the device step counter
(port of u2pl_tpu/train/state.py).

The JAX state is an immutable pytree threaded through the compiled step;
here it is a small mutable record, and the steps update the models, the
optimizer, `step` and the memory `bank` in place.  With
`trainer.contrastive` the state holds the bank (`memobank.init_memobank`,
in the config's `queue_dtype`) and the (C, Q, 1, 256) `prototype` of the
anchor-EMA path, zeros, as train_semi.py builds them; both None otherwise.

Data-parallel: `create_train_state(..., group=...)` makes every BatchNorm
of both models sync over the group when `net.sync_bn` (JAX builds the
train model with `axis_name="data"`, the teacher's forwards included), and
`broadcast_state` gives every rank rank 0's state after init, pretrain or
resume.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Union

import torch

from u2pl_tpu_torch import dist
from u2pl_tpu_torch.config import Config, head_lr_multiplier
from u2pl_tpu_torch.memobank import MemoryBank, init_memobank
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.models.builder import SegModel, sync_batch_norm
from u2pl_tpu_torch.train.optim import make_optimizer


@dataclass
class TrainState:
    step: torch.Tensor  # 0-d int32 on the models' device: the global iteration
    student: SegModel
    teacher: Optional[SegModel]  # None for the supervised trainer
    optimizer: torch.optim.Optimizer
    bank: Optional[MemoryBank] = None
    prototype: Optional[torch.Tensor] = None


def create_train_state(
    cfg: Config,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
    student: Optional[SegModel] = None,
    with_teacher: bool = True,
    group=None,
) -> TrainState:
    """On `device` (the card unless the caller names the CPU): the student
    from `build_model` (or the one given), the teacher a copy of it
    (parameters and BN buffers) that takes no gradient (None without
    `with_teacher`, as the supervised trainer has it), the optimizer
    with the head group at x `head_lr_multiplier(cfg)`, and the empty bank
    and zero prototype when the config has `trainer.contrastive`; with a
    data-parallel `group` and `net.sync_bn`, both models' BatchNorms sync
    over it."""
    if student is None:
        student = build_model(cfg.net, device=device, generator=generator)
    student = student.to(device)
    teacher = copy.deepcopy(student).requires_grad_(False) if with_teacher else None
    if group is not None and cfg.net.sync_bn:
        for model in (student, teacher):
            if model is not None:
                sync_batch_norm(model, group)
    optimizer = make_optimizer(cfg.trainer.optimizer, student, head_lr_multiplier(cfg))
    step = torch.zeros((), dtype=torch.int32, device=device)
    state = TrainState(step=step, student=student, teacher=teacher, optimizer=optimizer)
    contra = cfg.trainer.contrastive
    if contra is not None:
        c = cfg.net.num_classes
        state.bank = init_memobank(c, 256, dtype=contra.queue_dtype, device=device)
        state.prototype = torch.zeros((c, contra.num_queries, 1, 256), device=device)
    return state


@torch.no_grad()
def copy_student_to_teacher(state: TrainState) -> TrainState:
    """The student -> teacher copy of the first semi epoch (reference
    train_semi.py:309-315): parameters only; the teacher's BN buffers keep
    the running statistics its warmup forwards accumulated."""
    torch._foreach_copy_(list(state.teacher.parameters()), list(state.student.parameters()))
    return state


@torch.no_grad()
def broadcast_state(state: TrainState, group) -> TrainState:
    """Every rank's state set to rank 0's, in place: the step, both models'
    parameters and buffers, the optimizer's state tensors, the bank and the
    prototype (the JAX package replicates one state over the mesh)."""
    if group is None:
        return state
    tensors = [state.step]
    for model in (state.student, state.teacher):
        if model is not None:
            tensors += list(model.parameters()) + list(model.buffers())
    for p in state.student.parameters():
        per = state.optimizer.state.get(p, {})
        tensors += [per[k] for k in sorted(per) if torch.is_tensor(per[k])]
    if state.bank is not None:
        tensors += [state.bank.keys, state.bank.ptr, state.bank.occupancy, state.bank.sizes]
    if state.prototype is not None:
        tensors.append(state.prototype)
    dist.broadcast_tensors(tensors, group)
    return state
