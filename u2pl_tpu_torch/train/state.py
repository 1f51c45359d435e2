"""Train state: student, EMA teacher, optimizer and the device step counter
(port of u2pl_tpu/train/state.py).

The JAX state is an immutable pytree threaded through the compiled step;
here it is a small mutable record, and the steps update the models, the
optimizer, `step` and the memory `bank` in place.  With
`trainer.contrastive` the state holds the bank (`memobank.init_memobank`,
in the config's `queue_dtype`) and the (C, Q, 1, 256) `prototype` of the
anchor-EMA path, zeros, as train_semi.py builds them; both None otherwise.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Union

import torch

from u2pl_tpu_torch.config import Config, head_lr_multiplier
from u2pl_tpu_torch.memobank import MemoryBank, init_memobank
from u2pl_tpu_torch.models import build_model
from u2pl_tpu_torch.models.builder import SegModel
from u2pl_tpu_torch.train.optim import make_optimizer


@dataclass
class TrainState:
    step: torch.Tensor  # 0-d int32 on the models' device: the global iteration
    student: SegModel
    teacher: SegModel
    optimizer: torch.optim.Optimizer
    bank: Optional[MemoryBank] = None
    prototype: Optional[torch.Tensor] = None


def create_train_state(
    cfg: Config,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
    student: Optional[SegModel] = None,
) -> TrainState:
    """On `device` (the card unless the caller names the CPU): the student
    from `build_model` (or the one given), the teacher a copy of it
    (parameters and BN buffers) that takes no gradient, the optimizer
    with the head group at x `head_lr_multiplier(cfg)`, and the empty bank
    and zero prototype when the config has `trainer.contrastive`."""
    if student is None:
        student = build_model(cfg.net, device=device, generator=generator)
    student = student.to(device)
    teacher = copy.deepcopy(student).requires_grad_(False)
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
