"""Upscaler02: the 512x512 refiner teacher
(counterpart of ``tha4_tpu/models/upscaler.py``).

Warps the rest image by the upsampled coarse grid change (K2), feeds the
coarse result in through a zero-init conv added to the U-Net's first conv
(``coarse_image_conv``), and outputs direct + grid change + alpha like the
body morpher, whose head it shares.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch
from torch import nn

from tha4_tpu_torch.models import unet
from tha4_tpu_torch.models.body_morpher import direct_grid_alpha_outputs
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.ops import warp

INDEX_MERGED = 0
INDEX_ALPHA = 1
INDEX_WARPED = 2
INDEX_GRID_CHANGE = 3
INDEX_DIRECT = 4
OUTPUT_LENGTH = 5


def shipped_unet_config() -> unet.UnetConfig:
    """The instantiation of data/tha4/upscaler.pt
    (``tha4_tpu/models/upscaler.py:29-45``)."""
    return unet.UnetConfig(
        in_channels=4,
        out_channels=7,
        model_channels=32,
        level_channel_multipliers=(1, 2, 4, 8, 8, 8),
        level_use_attention=(False, False, False, False, False, True),
        num_res_blocks_per_level=1,
        num_middle_res_blocks=4,
        time_embedding_channels=None,
        cond_input_channels=6,
        cond_internal_channels=256,
        attention=unet.AttentionConfig(num_heads=8, use_new_attention_order=True),
        dropout_prob=0.0,
    )


@dataclass(frozen=True)
class UpscalerConfig:
    image_size: int = 512
    image_channels: int = 4
    num_pose_parameters: int = 6
    unet: unet.UnetConfig = field(default_factory=shipped_unet_config)


class Upscaler02(nn.Module):
    """rest image, coarse posed image (N,512,512,4), coarse grid change
    (N,512,512,2) and pose (N,6) -> 5 outputs, NHWC."""

    def __init__(self, cfg: UpscalerConfig):
        super().__init__()
        self.cfg = cfg
        self.body = unet.Unet(cfg.unet)
        self.coarse_image_conv = tnn.conv3(2 * cfg.image_channels + 2, cfg.unet.model_channels, bias=True)

    def reset_parameters(self, gen: torch.Generator) -> None:
        tnn.init_conv_(self.coarse_image_conv, "zero", gen)
        self.body.reset_parameters(gen)

    def forward(self, rest_image: torch.Tensor, coarse_posed_image: torch.Tensor,
                coarse_grid_change: torch.Tensor, pose: torch.Tensor) -> List[torch.Tensor]:
        rest_image = rest_image.contiguous()
        warped_by_coarse = warp.apply_grid_change(coarse_grid_change, rest_image)
        feature = torch.cat([coarse_posed_image, warped_by_coarse, coarse_grid_change], dim=-1)
        first_conv_addition = tnn.conv_nhwc(self.coarse_image_conv, feature)
        t = torch.zeros((rest_image.shape[0], 1), dtype=rest_image.dtype, device=rest_image.device)
        out = self.body(rest_image, t, pose, first_conv_addition)
        return direct_grid_alpha_outputs(out, rest_image, self.cfg.image_channels)
