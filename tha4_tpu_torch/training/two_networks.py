"""Two networks stepped together, GAN-style (counterpart of
``tha4_tpu/training/two_networks.py``; the reference's
TwoNetworksTrainingProtocol).

One step updates network A on ``loss_a`` with B held fixed, then B on
``loss_b`` with the updated A held fixed, each with Adam(0.9, 0.999, eps
1e-8) at the lr the caller gives.  The shipped distillation recipes train
one network; this is kept for parity.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from tha4_tpu_torch.training.optimizers import AdamFactory, set_lr


def init_two_network_state(module_a: nn.Module, module_b: nn.Module) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    return AdamFactory().create(module_a.parameters()), AdamFactory().create(module_b.parameters())


def _update(module: nn.Module, optimizer: torch.optim.Optimizer, loss: torch.Tensor, lr: float) -> None:
    """One Adam step on the gradient of ``loss`` in ``module``'s parameters
    alone (the other network's parameters get none)."""
    params = list(module.parameters())
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    set_lr(optimizer, lr)
    optimizer.step()


def make_two_network_step(loss_a: Callable, loss_b: Callable) -> Callable:
    """``loss_a`` and ``loss_b``: (module_a, module_b, batch) -> (scalar,
    {name: scalar}).  Returns step(module_a, opt_a, module_b, opt_b, batch,
    lr_a, lr_b) -> metrics: ``loss_a``, ``loss_b`` and each loss's named
    terms prefixed ``a_`` and ``b_``."""

    def step(module_a, opt_a, module_b, opt_b, batch, lr_a: float, lr_b: float) -> Dict[str, torch.Tensor]:
        la, aux_a = loss_a(module_a, module_b, batch)
        _update(module_a, opt_a, la, lr_a)
        lb, aux_b = loss_b(module_a, module_b, batch)
        _update(module_b, opt_b, lb, lr_b)
        metrics = {"loss_a": la.detach(), "loss_b": lb.detach()}
        metrics.update({f"a_{k}": v.detach() for k, v in aux_a.items()})
        metrics.update({f"b_{k}": v.detach() for k, v in aux_b.items()})
        return metrics

    return step
