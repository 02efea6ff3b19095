"""Block factory: the BlockArgs/ConvBlockFactory layer
(counterpart of ``tha4_tpu/ops/blocks.py``), as NCHW ``nn.Module``s.

Reference: src/tha4/nn/util.py:22-40 BlockArgs,
src/tha4/nn/common/conv_block_factory.py ConvBlockFactory,
src/tha4/nn/conv.py:100-189 block builders,
src/tha4/nn/separable_conv.py separable builders,
src/tha4/nn/resnet_block.py:13-67 ResnetBlock incl. the 1x1 and
learned-scale variants.

One ``BlockConfig`` carries the four BlockArgs fields (init method, spectral
norm, norm, nonlinearity) plus the ConvBlockFactory routing flag
(separable).  Every builder honours every flag: ``use_spectral_norm``
reaches each conv, both halves of a separable conv included.  Attribute
names follow the JAX param keys (``conv``, ``norm``, ``conv0``, ...,
``depthwise``, ``pointwise``, ``depthwise_t``, ``scale``; a conv's ``w``,
``b`` and ``sn_u`` are ``weight``, ``bias`` and the buffer ``sn_u``), so
``convert.export_torch.zoo_state_dict`` carries JAX params across.

Spectral norm is functional as in the JAX package: a forward computes the
normalized weight with one fresh power-iteration step from the stored
``sn_u`` and stores nothing; a trainer persists the step by calling
:func:`advance_spectral` once per optimization step.

Divergence: the JAX separable upsample block stores its depthwise
transposed conv as (4, 4, Cin, Cin) and applies it with Cin groups, which
``lax.conv`` refuses for Cin > 1; the port's is the depthwise weight the
grouping needs, (Cin, 1, 4, 4) (the JAX (4, 4, 1, Cin)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.ops import norms_extra
from tha4_tpu_torch.ops.spectral_norm import init_spectral_state, spectral_normalize


@dataclass(frozen=True)
class BlockConfig:
    """BlockArgs + ConvBlockFactory routing (reference nn/util.py:22-40)."""

    init: str = "he"
    use_spectral_norm: bool = False
    norm: str = "instance"  # instance | layer | pixel | none_affine | none
    nonlin: str = "relu"
    separable: bool = False


class WrappedConv(nn.Module):
    """A conv, or a ConvTranspose2d(k, stride 2, padding 1), in its input's
    dtype, whose weight is spectrally normalized when ``sn_u`` is set.

    Weight: OIHW (O, I / groups, k, k) for a conv, torch's (I, O / groups,
    k, k) for a transposed conv; initialised from ``cfg.init`` with torch's
    fans (``ops.nn.init_weight_``), a bias U(+-1/sqrt(fan_in))."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool, cfg: BlockConfig, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1, transpose: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = (k - 1) // 2 if padding is None else padding
        self.groups = groups
        self.transpose = transpose
        shape = (cin, cout // groups, k, k) if transpose else (cout, cin // groups, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        with torch.no_grad():
            tnn.init_weight_(self.weight, cfg.init, generator)
            if self.bias is not None:
                bound = 1.0 / math.sqrt(self.weight[0].numel())
                self.bias.uniform_(-bound, bound, generator=generator)
        u = init_spectral_state(self.weight.detach(), generator, transpose, groups) if cfg.use_spectral_norm else None
        self.register_buffer("sn_u", u)

    def normalized(self) -> tuple:
        """(the weight this forward uses, the advanced ``sn_u`` or None)."""
        if self.sn_u is None:
            return self.weight, None
        return spectral_normalize(self.weight, self.sn_u, transpose=self.transpose, groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized()[0].to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.transpose:
            return F.conv_transpose2d(x, w, b, stride=2, padding=1, groups=self.groups)
        return F.conv2d(x, w, b, self.stride, self.padding, groups=self.groups)


@torch.no_grad()
def advance_spectral(module: nn.Module) -> None:
    """Advance every spectral-norm ``sn_u`` under ``module`` one
    power-iteration step, in place (the state update a torch train-mode
    forward does)."""
    for m in module.modules():
        if isinstance(m, WrappedConv) and m.sn_u is not None:
            m.sn_u.copy_(m.normalized()[1])


class SeparableConv(nn.Module):
    """Depthwise (``depthwise``, or ``depthwise_t`` for the stride-2
    transposed one) then pointwise 1x1, each a ``WrappedConv``."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool, cfg: BlockConfig, stride: int = 1,
                 padding: Optional[int] = None, transpose: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        depthwise = WrappedConv(k, cin, cin, False, cfg, stride, padding, groups=cin, transpose=transpose,
                                generator=generator)
        self.depthwise_key = "depthwise_t" if transpose else "depthwise"
        self.add_module(self.depthwise_key, depthwise)
        self.pointwise = WrappedConv(1, cin, cout, bias, cfg, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(getattr(self, self.depthwise_key)(x))


def _conv(k: int, cin: int, cout: int, bias: bool, cfg: BlockConfig, generator, stride: int = 1,
          padding: Optional[int] = None, transpose: bool = False) -> nn.Module:
    """A kxk conv through the factory's routing: separable or not."""
    if cfg.separable:
        return SeparableConv(k, cin, cout, bias, cfg, stride, padding, transpose, generator)
    return WrappedConv(k, cin, cout, bias, cfg, stride, padding, transpose=transpose, generator=generator)


def make_norm(cfg: BlockConfig, c: int) -> nn.Module:
    """The norm the config names; 'none' is the identity."""
    if cfg.norm == "instance":
        return tnn.InstanceNorm2d(c)
    if cfg.norm == "layer":
        return norms_extra.LayerNorm2d(c)
    if cfg.norm == "pixel":
        return norms_extra.PixelNorm()
    if cfg.norm == "none_affine":
        return norms_extra.Bias2d(c)  # reference NoNorm affine
    if cfg.norm == "none":
        return nn.Identity()
    raise ValueError(f"Unknown norm {cfg.norm}")


def conv3(cin: int, cout: int, bias: bool, cfg: BlockConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Raw conv3 (reference ConvBlockFactory.create_conv3)."""
    return _conv(3, cin, cout, bias, cfg, generator)


class ConvBlock(nn.Module):
    """conv-k (bias=False) -> norm -> nonlinearity (reference
    create_conv{3,7}_block)."""

    def __init__(self, k: int, cin: int, cout: int, cfg: BlockConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(k, cin, cout, False, cfg, generator)
        self.norm = make_norm(cfg, cout)
        self.act = tnn.nonlinearity(cfg.nonlin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class DownsampleBlock(nn.Module):
    """conv4 s2 p1 (bias=False) -> [norm unless the output is 1x1] ->
    nonlinearity (reference create_downsample_block, conv.py:127-148).  As
    in the JAX package, pixel norm, having no parameters, applies even at a
    1x1 output."""

    def __init__(self, cin: int, cout: int, is_output_1x1: bool, cfg: BlockConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(4, cin, cout, False, cfg, generator, stride=2, padding=1)
        self.norm = make_norm(cfg, cout) if not is_output_1x1 or cfg.norm == "pixel" else nn.Identity()
        self.act = tnn.nonlinearity(cfg.nonlin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class UpsampleBlock(nn.Module):
    """ConvTranspose4 s2 p1 (bias=False) -> norm -> nonlinearity."""

    def __init__(self, cin: int, cout: int, cfg: BlockConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(4, cin, cout, False, cfg, generator, transpose=True)
        self.norm = make_norm(cfg, cout)
        self.act = tnn.nonlinearity(cfg.nonlin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class ResnetBlock(nn.Module):
    """ResnetBlock with every reference variant (reference
    resnet_block.py:13-67):

      * 3x3: conv3 (no bias) -> norm -> nonlin -> conv3 (no bias) -> norm;
      * 1x1: conv1 (bias) -> nonlin -> conv1 (bias), no norms, never
        separable (reference resnet_block_seperable.py:45-52);
      * use_scale_parameter: out = x + scale * path(x), scale zero-init."""

    def __init__(self, c: int, cfg: BlockConfig, is_1x1: bool = False, use_scale_parameter: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.is_1x1 = is_1x1
        if is_1x1:
            self.conv0 = WrappedConv(1, c, c, True, cfg, generator=generator)
            self.conv1 = WrappedConv(1, c, c, True, cfg, generator=generator)
        else:
            self.conv0 = conv3(c, c, False, cfg, generator)
            self.norm0 = make_norm(cfg, c)
            self.conv1 = conv3(c, c, False, cfg, generator)
            self.norm1 = make_norm(cfg, c)
        self.act = tnn.nonlinearity(cfg.nonlin)
        self.scale = nn.Parameter(torch.zeros(1)) if use_scale_parameter else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_1x1:
            h = self.conv1(self.act(self.conv0(x)))
        else:
            h = self.norm1(self.conv1(self.act(self.norm0(self.conv0(x)))))
        if self.scale is not None:
            h = self.scale.to(h.dtype) * h
        return x + h
