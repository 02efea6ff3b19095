"""Exponential moving average of a module's parameters (counterpart of
``tha4_tpu/training/ema.py``; the reference's DecayAccumulator,
src/tha4/shion/base/module_accumulators.py:10-29, beta 0.999).

The reference ships it, but both distillation trainers run without one; it
is here for parity and for recipes that want it.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def init(module: nn.Module) -> nn.Module:
    """A frozen copy of ``module``: the average's starting point."""
    ema = copy.deepcopy(module)
    ema.requires_grad_(False)
    return ema


@torch.no_grad()
def update(ema: nn.Module, module: nn.Module, decay: float = 0.999) -> nn.Module:
    """ema <- decay * ema + (1 - decay) * module, parameter by parameter, in
    place; returns ``ema``."""
    for e, p in zip(ema.parameters(), module.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)
    return ema
