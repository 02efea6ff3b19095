"""Depthwise-separable conv blocks (counterpart of ``tha4_tpu/ops/separable.py``).

Reference: src/tha4/nn/separable_conv.py, resnet_block_seperable.py,
common/poser_encoder_decoder_00_separable.py — alternative factories that
split each kxk conv into a depthwise kxk and a pointwise 1x1.  Not used by
the shipped modes; provided for capability parity.

These are the block factory's separable routing (``ops.blocks``) with
instance norm and no spectral norm, which is what the JAX functions
compute: the same modules, with the JAX param keys as attribute names.
"""

from __future__ import annotations

from typing import Optional

import torch

from tha4_tpu_torch.ops import blocks as B


def separable_conv(k: int, cin: int, cout: int, bias: bool, stride: int = 1, method: str = "he",
                   generator: Optional[torch.Generator] = None) -> B.SeparableConv:
    """Depthwise kxk (stride, padding (k - 1) // 2, no bias) then pointwise
    1x1 (``depthwise``, ``pointwise``): ``separable_conv2d``."""
    return B.SeparableConv(k, cin, cout, bias, B.BlockConfig(init=method), stride, generator=generator)


def separable_conv_block(k: int, cin: int, cout: int, nonlin: str = "relu", method: str = "he",
                         generator: Optional[torch.Generator] = None) -> B.ConvBlock:
    """Separable conv (no bias) -> instance norm -> nonlinearity."""
    return B.ConvBlock(k, cin, cout, B.BlockConfig(init=method, nonlin=nonlin, separable=True), generator)


def separable_resnet_block(c: int, nonlin: str = "relu", method: str = "he",
                           generator: Optional[torch.Generator] = None) -> B.ResnetBlock:
    """x + norm1(conv1(act(norm0(conv0(x))))), both convs separable 3x3."""
    return B.ResnetBlock(c, B.BlockConfig(init=method, nonlin=nonlin, separable=True), generator=generator)
