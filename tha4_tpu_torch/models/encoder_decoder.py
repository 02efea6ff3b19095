"""PoserEncoderDecoder00: the teacher's encoder-decoder trunk
(counterpart of ``tha4_tpu/models/encoder_decoder.py``).

A conv3 block, stride-2 downsample blocks to the bottleneck size, the pose
broadcast and concatenated at the bottleneck, a conv3 block and a resnet
stack there, then mirrored transposed-conv upsample blocks.  Channels double
per halving, capped at ``max_channels``.  Only the final full-resolution
feature is returned (the THA4 networks consume nothing else).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from tha4_tpu_torch.ops import nn as tnn


@dataclass(frozen=True)
class EncoderDecoderConfig:
    image_size: int
    input_image_channels: int
    num_pose_params: int
    start_channels: int
    bottleneck_image_size: int
    num_bottleneck_blocks: int
    max_channels: int
    nonlin: str = "relu"

    def channels_at(self, image_size: int) -> int:
        return min(self.start_channels * (self.image_size // image_size), self.max_channels)


class PoserEncoderDecoder00(nn.Module):
    """Keys ``downsample_blocks.*``, ``bottleneck_blocks.*``, ``upsample_blocks.*``."""

    def __init__(self, cfg: EncoderDecoderConfig):
        super().__init__()
        self.cfg = cfg
        down = [tnn.conv_block(cfg.input_image_channels, cfg.start_channels, cfg.nonlin)]
        size, ch = cfg.image_size, cfg.start_channels
        while size > cfg.bottleneck_image_size:
            size //= 2
            nch = cfg.channels_at(size)
            down.append(tnn.downsample_block(ch, nch, cfg.nonlin))
            ch = nch
        bottleneck = [tnn.conv_block(ch + cfg.num_pose_params, ch, cfg.nonlin)]
        bottleneck += [tnn.ResnetBlock(ch, cfg.nonlin) for _ in range(1, cfg.num_bottleneck_blocks)]
        up = []
        while size < cfg.image_size:
            size *= 2
            nch = cfg.channels_at(size)
            up.append(tnn.upsample_block(ch, nch, cfg.nonlin))
            ch = nch
        self.downsample_blocks = nn.ModuleList(down)
        self.bottleneck_blocks = nn.ModuleList(bottleneck)
        self.upsample_blocks = nn.ModuleList(up)

    def encode_decode(self, x: torch.Tensor, pose: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, Cin, S, S) [+ pose (N, P)] -> the final feature (N, start_channels, S, S)."""
        if (pose is not None) != (self.cfg.num_pose_params != 0):
            raise ValueError(f"pose given: {pose is not None}, num_pose_params = {self.cfg.num_pose_params}")
        for block in self.downsample_blocks:
            x = block(x)
        if pose is not None:
            n, _, h, w = x.shape
            x = torch.cat([x, pose.to(x.dtype)[:, :, None, None].expand(n, pose.shape[1], h, w)], dim=1)
        for block in self.bottleneck_blocks:
            x = block(x)
        for block in self.upsample_blocks:
            x = block(x)
        return x
