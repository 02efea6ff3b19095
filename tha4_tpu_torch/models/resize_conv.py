"""Resize-conv trunks: encoder-decoder and skip-connected U-Net
(counterpart of ``tha4_tpu/models/resize_conv.py``), NCHW ``nn.Module``s.

Reference: src/tha4/nn/common/resize_conv_encoder_decoder.py and
src/tha4/nn/common/resize_conv_unet.py (not used by the shipped modes; kept
for capability parity).  Decoders upsample with a bilinear or nearest
resize followed by a conv3 block instead of transposed convs — the classic
checkerboard-free decoder.  Both return the bottleneck feature plus each
upsample level's feature, like the reference (:94-104 / :92-107).

Both are built from ``ops.blocks``: the encoder-decoder with the default
block config (instance norm, no spectral norm) and its own init and
nonlinearity, the U-Net with its ``BlockConfig``, so spectral norm,
separable convs, norm and nonlinearity all reach every block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from tha4_tpu_torch.ops import blocks as B
from tha4_tpu_torch.ops.resize import resize_bilinear_nchw, upsample_nearest_2x


def _upsample(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nearest":
        return upsample_nearest_2x(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))


@dataclass(frozen=True)
class ResizeConvEncoderDecoderConfig:
    image_size: int
    input_channels: int
    start_channels: int
    bottleneck_image_size: int
    num_bottleneck_blocks: int
    max_channels: int
    upsample_mode: str = "bilinear"  # or "nearest"
    nonlin: str = "relu"
    init: str = "he"

    def channels_at(self, image_size: int) -> int:
        return min(self.start_channels * (self.image_size // image_size), self.max_channels)


class ResizeConvEncoderDecoder(nn.Module):
    """conv7 block, stride-2 downsample blocks to the bottleneck, resnet
    blocks, then (resize, conv3 block) per level up."""

    def __init__(self, cfg: ResizeConvEncoderDecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        block = B.BlockConfig(init=cfg.init, nonlin=cfg.nonlin)
        down = [B.ConvBlock(7, cfg.input_channels, cfg.start_channels, block, generator)]
        size, ch = cfg.image_size, cfg.start_channels
        while size > cfg.bottleneck_image_size:
            size //= 2
            nch = cfg.channels_at(size)
            down.append(B.DownsampleBlock(ch, nch, False, block, generator))
            ch = nch
        bottleneck = [B.ResnetBlock(ch, block, generator=generator) for _ in range(cfg.num_bottleneck_blocks)]
        up = []
        while size < cfg.image_size:
            size *= 2
            nch = cfg.channels_at(size)
            up.append(B.ConvBlock(3, ch, nch, block, generator))
            ch = nch
        self.downsample_blocks = nn.ModuleList(down)
        self.bottleneck_blocks = nn.ModuleList(bottleneck)
        self.upsample_blocks = nn.ModuleList(up)

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        x = image
        for block in self.downsample_blocks:
            x = block(x)
        for block in self.bottleneck_blocks:
            x = block(x)
        outputs = [x]
        for block in self.upsample_blocks:
            x = block(_upsample(x, self.cfg.upsample_mode))
            outputs.append(x)
        return outputs


@dataclass(frozen=True)
class ResizeConvUNetConfig:
    """reference ResizeConvUNetArgs (resize_conv_unet.py:13-37).

    Differences from the encoder-decoder: the first block is a conv3 (not
    conv7), and the decoder concatenates the mirrored encoder feature before
    each conv3 block (skip connections, reference forward :92-107)."""

    image_size: int
    input_channels: int
    start_channels: int
    bottleneck_image_size: int
    num_bottleneck_blocks: int
    max_channels: int
    upsample_mode: str = "bilinear"  # or "nearest"
    block: B.BlockConfig = field(default_factory=B.BlockConfig)

    def channels_at(self, image_size: int) -> int:
        return min(self.start_channels * (self.image_size // image_size), self.max_channels)


class ResizeConvUNet(nn.Module):
    def __init__(self, cfg: ResizeConvUNetConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        down = [B.ConvBlock(3, cfg.input_channels, cfg.start_channels, cfg.block, generator)]
        size, ch = cfg.image_size, cfg.start_channels
        while size > cfg.bottleneck_image_size:
            size //= 2
            nch = cfg.channels_at(size)
            down.append(B.DownsampleBlock(ch, nch, False, cfg.block, generator))
            ch = nch
        bottleneck = [B.ResnetBlock(ch, cfg.block, generator=generator) for _ in range(cfg.num_bottleneck_blocks)]
        up = []
        while size < cfg.image_size:
            size *= 2
            nch = cfg.channels_at(size)
            # the decoder conv takes [upsampled current || encoder skip at size]
            up.append(B.ConvBlock(3, ch + nch, nch, cfg.block, generator))
            ch = nch
        self.downsample_blocks = nn.ModuleList(down)
        self.bottleneck_blocks = nn.ModuleList(bottleneck)
        self.upsample_blocks = nn.ModuleList(up)

    def forward(self, feature: torch.Tensor) -> List[torch.Tensor]:
        """[bottleneck, level_1, ..., full_res] features (reference forward
        resize_conv_unet.py:92-107)."""
        x = self.downsample_blocks[0](feature)
        downsampled = [x]
        for block in self.downsample_blocks[1:]:
            x = block(x)
            downsampled.append(x)
        for block in self.bottleneck_blocks:
            x = block(x)
        outputs = [x]
        for i, block in enumerate(self.upsample_blocks):
            x = torch.cat([_upsample(x, self.cfg.upsample_mode), downsampled[-i - 2]], dim=1)
            x = block(x)
            outputs.append(x)
        return outputs
