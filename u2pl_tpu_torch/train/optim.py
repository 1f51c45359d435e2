"""Optimizers with the JAX package's optax semantics and per-group LR
multipliers (port of u2pl_tpu/train/optim.py).

SGD is optax's chain add_decayed_weights -> trace -> masked scale, applied
as p <- p - lr * u: g' = g + wd * p; t = g' + momentum * t; u = t (or
g' + momentum * t under nesterov); u *= head_lr_multiplier on the
`decoder`/`auxor` group (x10 on pascal).  That is torch SGD's update (the
first trace is the gradient itself, as torch's first buffer), with the LR a
float32 DEVICE scalar from `train.lr.lr_at`: `torch.optim.SGD` takes a
tensor LR only through `alpha=-lr`, which reads it back to the host every
step.  Adam is optax's scale_by_adam (b1 0.9, b2 0.999, eps 1e-8).

As in optax, every parameter is updated every step: a parameter that
received no gradient (the rep head while the contrastive branch is off)
counts a zero gradient, so weight decay and momentum still move it.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from u2pl_tpu_torch.config import OptimizerCfg

HEAD_SCOPES = ("decoder", "auxor")


def head_mask(model: nn.Module) -> Dict[str, bool]:
    """True for decoder/aux-head parameters (the x10 group), by name."""
    return {name: name.split(".", 1)[0] in HEAD_SCOPES for name, _ in model.named_parameters()}


def _grads(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class SGD(torch.optim.Optimizer):
    def __init__(self, groups, momentum: float, weight_decay: float, nesterov: bool):
        super().__init__(
            groups, dict(lr_mult=1.0, momentum=momentum, weight_decay=weight_decay,
                         nesterov=nesterov),
        )

    @torch.no_grad()
    def step(self, lr: torch.Tensor) -> None:  # type: ignore[override]
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
            mu = group["momentum"]
            traces = [self.state[p].get("trace") for p in params]
            if traces[0] is None:
                traces = [torch.zeros_like(p) for p in params]
            traces = torch._foreach_add(grads, torch._foreach_mul(traces, mu))
            for p, t in zip(params, traces):
                self.state[p]["trace"] = t
            upd = torch._foreach_add(grads, torch._foreach_mul(traces, mu)) if group["nesterov"] else traces
            if group["lr_mult"] != 1.0:
                upd = torch._foreach_mul(upd, group["lr_mult"])
            torch._foreach_sub_(params, torch._foreach_mul(upd, lr))


class Adam(torch.optim.Optimizer):
    def __init__(self, groups, weight_decay: float, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(groups, dict(lr_mult=1.0, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, lr: torch.Tensor) -> None:  # type: ignore[override]
        for group in self.param_groups:
            params = group["params"]
            b1, b2 = group["b1"], group["b2"]
            grads = _grads(params)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
            st = self.state[params[0]]
            if "mu" not in st:
                for p in params:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                # "step": the key torch's load_state_dict keeps as saved
                st["step"] = torch.zeros((), dtype=torch.int32, device=params[0].device)
            mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                    torch._foreach_mul([self.state[p]["mu"] for p in params], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
                                    torch._foreach_mul([self.state[p]["nu"] for p in params], b2))
            for p, m, n in zip(params, mu, nu):
                self.state[p].update(mu=m, nu=n)
            st["step"] = st["step"] + 1
            cf = st["step"].to(torch.float32)
            c1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
            c2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
            mu_hat = torch._foreach_div(mu, c1)
            nu_hat = torch._foreach_div(nu, c2)
            den = torch._foreach_add(torch._foreach_sqrt(nu_hat), group["eps"])
            upd = torch._foreach_div(mu_hat, den)
            if group["lr_mult"] != 1.0:
                upd = torch._foreach_mul(upd, group["lr_mult"])
            torch._foreach_sub_(params, torch._foreach_mul(upd, lr))


def make_optimizer(
    cfg: OptimizerCfg, model: nn.Module, head_lr_multiplier: float = 1.0
) -> torch.optim.Optimizer:
    """Two parameter groups, the encoder's and the head's (`decoder`/`auxor`,
    at x `head_lr_multiplier`); `optimizer.step(lr)` with a device LR."""
    mask = head_mask(model)
    named = list(model.named_parameters())
    groups = [
        dict(params=[p for n, p in named if not mask[n]], lr_mult=1.0),
        dict(params=[p for n, p in named if mask[n]], lr_mult=float(head_lr_multiplier)),
    ]
    groups = [g for g in groups if g["params"]]
    kind = cfg.type.lower()
    if kind == "sgd":
        return SGD(groups, cfg.momentum, cfg.weight_decay, cfg.nesterov)
    if kind == "adam":
        return Adam(groups, cfg.weight_decay)
    raise ValueError(f"unsupported optimizer {cfg.type!r}")
