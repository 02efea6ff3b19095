"""Morpher00: the 256x256 body rotator teacher
(counterpart of ``tha4_tpu/models/body_morpher.py``).

The U-Net (``body.*``) outputs 7 channels: direct RGBA (4), grid change (2)
and an alpha logit (1); the result is the direct image alpha-blended over
the input warped by the grid change (K2).  t is always zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch
from torch import nn

from tha4_tpu_torch.models import unet
from tha4_tpu_torch.ops import warp

INDEX_MERGED = 0
INDEX_ALPHA = 1
INDEX_WARPED = 2
INDEX_GRID_CHANGE = 3
INDEX_DIRECT = 4
OUTPUT_LENGTH = 5


def shipped_unet_config() -> unet.UnetConfig:
    """The instantiation of data/tha4/body_morpher.pt
    (``tha4_tpu/models/body_morpher.py:28-44``)."""
    return unet.UnetConfig(
        in_channels=4,
        out_channels=7,
        model_channels=64,
        level_channel_multipliers=(1, 2, 4, 4, 4),
        level_use_attention=(False, False, False, False, True),
        num_res_blocks_per_level=1,
        num_middle_res_blocks=4,
        time_embedding_channels=None,
        cond_input_channels=6,
        cond_internal_channels=256,
        attention=unet.AttentionConfig(num_heads=8, use_new_attention_order=True),
        dropout_prob=0.0,
    )


@dataclass(frozen=True)
class BodyMorpherConfig:
    image_size: int = 256
    image_channels: int = 4
    num_pose_parameters: int = 6
    unet: unet.UnetConfig = field(default_factory=shipped_unet_config)


def direct_grid_alpha_outputs(out: torch.Tensor, image: torch.Tensor, channels: int) -> List[torch.Tensor]:
    """Split a (direct | grid change | alpha logit) head, warp ``image`` by
    the grid change and blend: [merged, alpha, warped, grid change, direct]."""
    direct = out[..., 0:channels]
    grid_change = out[..., channels : channels + 2]
    alpha = torch.sigmoid(out[..., channels + 2 : channels + 3])
    warped = warp.apply_grid_change(grid_change, image.contiguous())
    merged = warp.apply_color_change(alpha, direct, warped)
    return [merged, alpha, warped, grid_change, direct]


class Morpher00(nn.Module):
    """image (N,256,256,4) + pose (N,6) -> 5 outputs, NHWC."""

    def __init__(self, cfg: BodyMorpherConfig):
        super().__init__()
        self.cfg = cfg
        self.body = unet.Unet(cfg.unet)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.body.reset_parameters(gen)

    def forward(self, image: torch.Tensor, pose: torch.Tensor) -> List[torch.Tensor]:
        t = torch.zeros((image.shape[0], 1), dtype=image.dtype, device=image.device)
        return direct_grid_alpha_outputs(self.body(image, t, pose), image, self.cfg.image_channels)
