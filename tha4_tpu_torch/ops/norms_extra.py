"""The rest of the reference's normalization zoo
(counterpart of ``tha4_tpu/ops/norms_extra.py``), over NCHW.

Reference: src/tha4/nn/normalization.py:21-126.  The shipped teacher modes
use instance norm only (``ops.nn.instance_norm``); these exist for capability
parity with the reference's factory registry:

  * batch norm with running statistics (``batch_norm``, ``BatchNorm2d``);
  * layer norm over (C, H, W) per sample (``layer_norm_2d``, ``LayerNorm2d``);
  * pixel norm, the per-pixel channel RMS (``pixel_norm``, ``PixelNorm``);
  * a per-channel bias (``bias_2d``, ``Bias2d``), NoNorm's affine half.

Statistics are f32 (f64 for an f64 input) and the output is cast back to
the input's dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tha4_tpu_torch.ops import wide


def batch_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    training: bool = False,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm2d over NCHW.  Returns (out, running_mean, running_var), the
    statistics advanced in training (the unbiased batch variance enters the
    running one, as in torch) and returned unchanged otherwise."""
    xf = wide(x)
    if training:
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * n / max(n - 1, 1)
        running_mean = (1 - momentum) * running_mean + momentum * mean.detach()
        running_var = (1 - momentum) * running_var + momentum * unbiased.detach()
    else:
        mean, var = running_mean, running_var
    out = (xf - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None] * weight[:, None, None] + bias[:, None, None]
    return out.to(x.dtype), running_mean, running_var


class BatchNorm2d(nn.Module):
    """Batch norm with ``weight``/``bias`` parameters and f32
    ``running_mean``/``running_var`` buffers; a training-mode forward
    stores the statistics ``batch_norm`` returns."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, mean, var = batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var, self.training,
                                    self.momentum, self.eps)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return out


def layer_norm_2d(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over (C, H, W) per sample with a per-channel affine
    (reference normalization.py:106-119)."""
    xf = wide(x)
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight[:, None, None] + bias[:, None, None]
    return out.to(x.dtype)


class LayerNorm2d(nn.Module):
    """``layer_norm_2d`` with ``weight``/``bias`` (C,), f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean_c(x^2) + eps) (reference normalization.py:13-19)."""
    xf = wide(x)
    return (xf * torch.rsqrt((xf ** 2).mean(dim=1, keepdim=True) + eps)).to(x.dtype)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


def bias_2d(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x + per-channel bias (reference Bias2d, normalization.py:37-45)."""
    return x + bias.to(x.dtype)[:, None, None]


class Bias2d(nn.Module):
    """``bias_2d`` with a zero-initialised ``bias`` (C,), f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bias_2d(x, self.bias)
