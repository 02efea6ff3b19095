"""Losses (counterpart of ``tha4_tpu/training/losses.py``, the terms the
face distillation uses).  A composition returns ``(total, {name: value})``
so the named terms are logged as the reference's SumLoss logs them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def l1(expected: torch.Tensor, actual: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """weight * mean|e - a|."""
    return weight * (expected - actual).abs().mean()


def masked_l1(expected: torch.Tensor, actual: torch.Tensor, mask: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """weight * mean|(e - a) * mask|: the mean over ALL elements, as the
    reference takes it (not over the masked ones)."""
    return weight * ((expected - actual) * mask).abs().mean()


def sum_named(terms: List[Tuple[str, torch.Tensor]]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total and every term by name, the total under ``loss``."""
    named = dict(terms)
    total = sum(value for _, value in terms)
    named["loss"] = total
    return total, named
