"""Ops of the port: the kernels' wrappers and their plain versions, the
warp, the resizes and the teachers' building blocks."""

import torch


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the plain paths' working precision: f32, or f64 where ``x``
    already is f64, so that a reference run in f64 stays f64 throughout."""
    return x if x.dtype == torch.float64 else x.float()
