"""Optimizer factories: Adam, AdamW, SparseAdam, RMSprop
(counterpart of ``tha4_tpu/training/optimizers.py``, the reference's
factory set, src/tha4/shion/base/optimizer_factories.py:9-46).

Each factory's ``create(parameters)`` returns a ``torch.optim.Optimizer``
with lr 0: the caller sets the lr before every step (``set_lr``), the
reference's set-learning-rate-then-step contract.

  * Adam: ``torch.optim.Adam``, L2 decay folded into the gradient;
  * AdamW: ``torch.optim.AdamW``, decoupled decay (p *= 1 - lr * wd);
  * SparseAdam: Adam whose moments and parameter move only where the
    gradient is nonzero, with one step count a tensor that advances every
    step, the rule ``torch.optim.SparseAdam`` applies to a sparse gradient.
    The reference uses it on dense SIREN gradients, which
    ``torch.optim.SparseAdam`` refuses, so this is the JAX package's masked
    Adam (``tha4_tpu/training/optimizers.py:112-161``);
  * RMSprop: ``torch.optim.RMSprop`` at alpha 0.99, eps 1e-8, eps outside
    the square root.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

import torch


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass(frozen=True)
class AdamFactory:
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8
    weight_decay: float = 0.0

    def create(self, parameters: Iterable[torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(parameters, lr=0.0, betas=self.betas, eps=self.epsilon, weight_decay=self.weight_decay)


@dataclass(frozen=True)
class AdamWFactory:
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8
    weight_decay: float = 0.01

    def create(self, parameters: Iterable[torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(parameters, lr=0.0, betas=self.betas, eps=self.epsilon, weight_decay=self.weight_decay)


class MaskedSparseAdam(torch.optim.Optimizer):
    """SparseAdam's rule on dense gradients: where g == 0 the moments and the
    parameter keep their values; elsewhere m, v and p take Adam's update with
    SparseAdam's bias correction, lr * sqrt(1 - b2^t) / (1 - b1^t) over
    sqrt(v) + eps.  ``step`` counts every step of a tensor, masked or not."""

    def __init__(self, params, lr: float = 0.0, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = float(state["step"])
                mask = g != 0
                m = torch.where(mask, b1 * state["exp_avg"] + (1.0 - b1) * g, state["exp_avg"])
                v = torch.where(mask, b2 * state["exp_avg_sq"] + (1.0 - b2) * g * g, state["exp_avg_sq"])
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)
                size = group["lr"] * (1.0 - b2**t) ** 0.5 / (1.0 - b1**t)
                p.sub_(size * m / (v.sqrt() + group["eps"]) * mask)
        return loss


@dataclass(frozen=True)
class SparseAdamFactory:
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8

    def create(self, parameters: Iterable[torch.Tensor]) -> MaskedSparseAdam:
        return MaskedSparseAdam(parameters, betas=self.betas, eps=self.epsilon)


@dataclass(frozen=True)
class RMSpropFactory:
    alpha: float = 0.99
    epsilon: float = 1e-8

    def create(self, parameters: Iterable[torch.Tensor]) -> torch.optim.RMSprop:
        return torch.optim.RMSprop(parameters, lr=0.0, alpha=self.alpha, eps=self.epsilon)
