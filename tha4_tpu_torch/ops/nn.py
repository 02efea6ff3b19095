"""The teachers' building blocks (counterpart of ``tha4_tpu/ops/nn.py``,
what the mode_12 and mode_07 teachers use).

Modules hold f32 parameters under the reference ``state_dict`` keys: a conv,
downsample or upsample block is ``nn.Sequential(conv, norm, act)`` (keys
``….0.weight``, ``….1.weight``, ``….1.bias``), a resnet block keeps
``resnet_path.{0,1,3,4}``.  The convolutions run on NCHW tensors; the
models permute NHWC images in and out, which gives cuDNN channels-last
memory.  Group norm and the linears work on channels-last tensors, as the
U-Net keeps them.

Precision follows the JAX package: a convolution or linear casts its weight
and bias to the input's dtype (bf16 operands, f32 accumulation in cuDNN and
cuBLAS; a linear adds its bias after the product, as ``x @ w + b`` rounds);
instance and group norm statistics are f32 and their affine is f32, their
output in the input's dtype.  Convolutions are cuDNN's: the JAX package
leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tha4_tpu_torch.ops import quant, wide


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype, casting weight and
    bias as ``tha4_tpu/ops/nn.py:conv2d`` does (free once they already are).

    The port's one conv chokepoint, so the int8 teacher's hook
    (``tha4_tpu/ops/nn.py:156-185``): under ``quant.calibrate()`` an eligible
    conv records its input, under ``quant.apply_scales(...)`` it runs Q1
    (``quant.conv_hook``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qctx = quant.current()
        if qctx is not None and quant.conv_eligible(self):
            out = quant.conv_hook(qctx, self, x)
            if out is not None:
                return out
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype.  The weight stays in
    torch's (I, O, kh, kw) layout; the JAX package stores the equivalent
    forward conv over the 2x-dilated input, flipped and transposed
    (``tha4_tpu/ops/nn.py:190-209``), and the weight bridge converts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


def instance_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float = 1e-5):
    """InstanceNorm2d(affine) over NCHW, the arithmetic of
    ``tha4_tpu/ops/nn.py:instance_norm``.

    bf16: the mean accumulates in f32 without an f32 copy of x; x - mean is
    taken in bf16 (mean rounded to bf16), its square in bf16 summed in f32;
    the normalised value and the affine are f32, the output bf16.  f32: plain."""
    if x.dtype == torch.bfloat16:
        mean = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
        centered = x - mean.to(x.dtype)
        var = (centered * centered).mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
        out = centered.float() * torch.rsqrt(var + eps)
    else:
        xf = wide(x)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight[:, None, None] + bias[:, None, None]
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], num_groups: int, eps: float = 1e-5):
    """GroupNorm over NHWC ``x`` with ``num_groups`` groups (the reference's
    GroupNorm32 takes min(32, C)), the arithmetic of
    ``tha4_tpu/ops/nn.py:group_norm``: the bf16 strategy of ``instance_norm``
    per group."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, num_groups, c // num_groups)
    if x.dtype == torch.bfloat16:
        mean = xg.mean(dim=(1, 2, 4), keepdim=True, dtype=torch.float32)
        centered = xg - mean.to(x.dtype)
        var = (centered * centered).mean(dim=(1, 2, 4), keepdim=True, dtype=torch.float32)
        out = (centered.float() * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    else:
        xf = wide(xg)
        mean = xf.mean(dim=(1, 2, 4), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
        out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    if weight is not None:
        out = out * weight + bias
    return out.to(x.dtype)


class GroupNorm(nn.Module):
    """Affine group norm over NHWC with min(32, C) groups; ``weight`` /
    ``bias`` keys, f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype: ``x @ w + b`` with weight and
    bias cast to it, the product rounded before the bias is added
    (``tha4_tpu/ops/nn.py:linear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight.to(x.dtype).t())
        return out if self.bias is None else out + self.bias.to(x.dtype)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW convolution module to an NHWC tensor (free permutes:
    cuDNN sees channels-last memory)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class InstanceNorm2d(nn.Module):
    """Affine instance norm with the reference's ``weight`` / ``bias`` keys, f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias)


def nonlinearity(name: str) -> nn.Module:
    """The activations the shipped teachers use (``tha4_tpu/ops/nn.py:270``)."""
    if name == "relu":
        return nn.ReLU()
    if name == "leaky_relu_02":
        return nn.LeakyReLU(0.2)
    raise ValueError(f"Unknown nonlinearity {name}")


# ---------------------------------------------------------------------------
# Initialisation: the distributions of tha4_tpu/ops/nn.py:39-146, drawn from a
# torch.Generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_conv_(conv: nn.Module, method: str, gen: torch.Generator) -> None:
    """'he': N(0, 2 / fan_in) with torch's fan_in (in x kh x kw for a conv,
    out x kh x kw for a transposed conv); 'none': torch's default,
    U(+-1/sqrt(fan_in)); 'zero'.  A bias is U(+-1/sqrt(fan_in)), or zero
    under 'zero' (the JAX package zeroes every zero-init conv's bias)."""
    kh, kw = conv.kernel_size
    fan_in = (conv.out_channels if isinstance(conv, nn.ConvTranspose2d) else conv.in_channels) * kh * kw
    bound = 1.0 / math.sqrt(fan_in)
    if method == "he":
        conv.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    elif method == "none":
        conv.weight.uniform_(-bound, bound, generator=gen)
    elif method == "zero":
        conv.weight.zero_()
    else:
        raise ValueError(f"Invalid initialization method {method}")
    if conv.bias is not None:
        if method == "zero":
            conv.bias.zero_()
        else:
            conv.bias.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_linear_(linear: nn.Linear, gen: torch.Generator) -> None:
    """torch's default for a linear, 'none' in the JAX package: weight and
    bias U(+-1/sqrt(in_features))."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=gen)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=gen)


def conv3(cin: int, cout: int, bias: bool) -> Conv2d:
    return Conv2d(cin, cout, kernel_size=3, padding=1, bias=bias)


def conv1(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, kernel_size=1, bias=True)


def conv_block(cin: int, cout: int, nonlin: str) -> nn.Sequential:
    """conv3(bias=False) -> InstanceNorm(affine) -> nonlinearity."""
    return nn.Sequential(conv3(cin, cout, bias=False), InstanceNorm2d(cout), nonlinearity(nonlin))


def downsample_block(cin: int, cout: int, nonlin: str) -> nn.Sequential:
    """Conv2d(4, stride 2, pad 1, bias=False) -> norm -> nonlinearity."""
    return nn.Sequential(Conv2d(cin, cout, kernel_size=4, stride=2, padding=1, bias=False), InstanceNorm2d(cout), nonlinearity(nonlin))


def upsample_block(cin: int, cout: int, nonlin: str) -> nn.Sequential:
    """ConvTranspose2d(4, stride 2, pad 1, bias=False) -> norm -> nonlinearity."""
    return nn.Sequential(ConvTranspose2d(cin, cout, kernel_size=4, stride=2, padding=1, bias=False), InstanceNorm2d(cout), nonlinearity(nonlin))


class ResnetBlock(nn.Module):
    """x + norm(conv3(act(norm(conv3(x))))), keys ``resnet_path.{0,1,3,4}``."""

    def __init__(self, c: int, nonlin: str):
        super().__init__()
        self.resnet_path = nn.Sequential(
            conv3(c, c, bias=False), InstanceNorm2d(c), nonlinearity(nonlin), conv3(c, c, bias=False), InstanceNorm2d(c)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.resnet_path(x)


def reset_convs_(module: nn.Module, method: str, gen: torch.Generator) -> None:
    """Initialise every conv under ``module`` in order (norms keep 1 and 0)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            init_conv_(m, method, gen)
