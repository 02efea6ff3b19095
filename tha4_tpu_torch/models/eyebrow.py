"""Eyebrow teacher networks: decomposer and morphing combiner
(counterpart of ``tha4_tpu/models/eyebrow.py``).

Both wrap a PoserEncoderDecoder00 trunk (``body.*``) with conv3 heads:
``Sequential(conv3, Sigmoid | Tanh)`` (keys ``<head>.0.*``) and, for the
combiner's grid change, a bare zero-init conv3 without bias (key
``<head>.weight``).  Images are NHWC at the module boundary, as in the JAX
package; the combiner's warp runs on K2 (``ops/warp.apply_grid_change``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch import nn

from tha4_tpu_torch.models.encoder_decoder import EncoderDecoderConfig, PoserEncoderDecoder00
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.ops import warp

# Output indices (tha4_tpu/models/eyebrow.py:23-41)
DECOMPOSER_EYEBROW_LAYER_INDEX = 0
DECOMPOSER_EYEBROW_LAYER_ALPHA_INDEX = 1
DECOMPOSER_EYEBROW_LAYER_COLOR_CHANGE_INDEX = 2
DECOMPOSER_BACKGROUND_LAYER_INDEX = 3
DECOMPOSER_BACKGROUND_LAYER_ALPHA_INDEX = 4
DECOMPOSER_BACKGROUND_LAYER_COLOR_CHANGE_INDEX = 5
DECOMPOSER_OUTPUT_LENGTH = 6

COMBINER_EYEBROW_IMAGE_INDEX = 0
COMBINER_COMBINE_ALPHA_INDEX = 1
COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX = 2
COMBINER_MORPHED_EYEBROW_LAYER_INDEX = 3
COMBINER_MORPHED_EYEBROW_LAYER_ALPHA_INDEX = 4
COMBINER_MORPHED_EYEBROW_LAYER_COLOR_CHANGE_INDEX = 5
COMBINER_WARPED_EYEBROW_LAYER_INDEX = 6
COMBINER_MORPHED_EYEBROW_LAYER_GRID_CHANGE_INDEX = 7
COMBINER_OUTPUT_LENGTH = 8


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def head(start_channels: int, out_channels: int, act: nn.Module) -> nn.Sequential:
    """conv3 with bias, then a sigmoid or tanh; He init."""
    return nn.Sequential(tnn.conv3(start_channels, out_channels, bias=True), act)


@dataclass(frozen=True)
class EyebrowDecomposerConfig:
    image_size: int = 128
    image_channels: int = 4
    start_channels: int = 64
    bottleneck_image_size: int = 16
    num_bottleneck_blocks: int = 6
    max_channels: int = 512

    @property
    def body(self) -> EncoderDecoderConfig:
        return EncoderDecoderConfig(self.image_size, self.image_channels, 0, self.start_channels,
                                    self.bottleneck_image_size, self.num_bottleneck_blocks, self.max_channels)


class EyebrowDecomposer00(nn.Module):
    """(N,128,128,4) eyebrow crop -> 6 outputs."""

    def __init__(self, cfg: EyebrowDecomposerConfig):
        super().__init__()
        self.cfg = cfg
        s, c = cfg.start_channels, cfg.image_channels
        self.body = PoserEncoderDecoder00(cfg.body)
        self.background_layer_alpha = head(s, 1, nn.Sigmoid())
        self.background_layer_color_change = head(s, c, nn.Tanh())
        self.eyebrow_layer_alpha = head(s, 1, nn.Sigmoid())
        self.eyebrow_layer_color_change = head(s, c, nn.Tanh())

    def reset_parameters(self, gen: torch.Generator) -> None:
        tnn.reset_convs_(self, "he", gen)

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        feature = self.body.encode_decode(nchw(image))
        bg_alpha = nhwc(self.background_layer_alpha(feature))
        bg_color = nhwc(self.background_layer_color_change(feature))
        background_layer = warp.apply_color_change(bg_alpha, bg_color, image)
        eb_alpha = nhwc(self.eyebrow_layer_alpha(feature))
        eb_color = nhwc(self.eyebrow_layer_color_change(feature))
        # The eyebrow layer lerps towards the image from the colour change
        # (reversed arguments, tha4_tpu/models/eyebrow.py:103-105).
        eyebrow_layer = warp.apply_color_change(eb_alpha, image, eb_color)
        return [eyebrow_layer, eb_alpha, eb_color, background_layer, bg_alpha, bg_color]


@dataclass(frozen=True)
class EyebrowCombinerConfig:
    image_size: int = 128
    image_channels: int = 4
    num_pose_params: int = 12
    start_channels: int = 64
    bottleneck_image_size: int = 16
    num_bottleneck_blocks: int = 6
    max_channels: int = 512

    @property
    def body(self) -> EncoderDecoderConfig:
        return EncoderDecoderConfig(self.image_size, 2 * self.image_channels, self.num_pose_params, self.start_channels,
                                    self.bottleneck_image_size, self.num_bottleneck_blocks, self.max_channels)


class EyebrowMorphingCombiner00(nn.Module):
    """(N,128,128,4) background and eyebrow layers + (N,12) pose -> 8 outputs."""

    def __init__(self, cfg: EyebrowCombinerConfig):
        super().__init__()
        self.cfg = cfg
        s, c = cfg.start_channels, cfg.image_channels
        self.body = PoserEncoderDecoder00(cfg.body)
        self.morphed_eyebrow_layer_grid_change = tnn.conv3(s, 2, bias=False)
        self.morphed_eyebrow_layer_alpha = head(s, 1, nn.Sigmoid())
        self.morphed_eyebrow_layer_color_change = head(s, c, nn.Tanh())
        self.combine_alpha = head(s, 1, nn.Sigmoid())

    def reset_parameters(self, gen: torch.Generator) -> None:
        tnn.reset_convs_(self, "he", gen)
        tnn.init_conv_(self.morphed_eyebrow_layer_grid_change, "zero", gen)

    def forward(self, background_layer: torch.Tensor, eyebrow_layer: torch.Tensor, pose: torch.Tensor) -> List[torch.Tensor]:
        combined = torch.cat([background_layer, eyebrow_layer], dim=-1)
        feature = self.body.encode_decode(nchw(combined), pose)
        grid_change = nhwc(self.morphed_eyebrow_layer_grid_change(feature))
        alpha = nhwc(self.morphed_eyebrow_layer_alpha(feature))
        color = nhwc(self.morphed_eyebrow_layer_color_change(feature))
        warped_eyebrow = warp.apply_grid_change(grid_change, eyebrow_layer.contiguous())
        morphed_eyebrow = warp.apply_color_change(alpha, color, warped_eyebrow)
        combine_alpha = nhwc(self.combine_alpha(feature))
        eyebrow_image = warp.apply_rgb_change(combine_alpha, morphed_eyebrow, background_layer)
        eyebrow_image_no_combine_alpha = warp.apply_rgb_change(
            (morphed_eyebrow[..., 3:4] + 1.0) / 2.0, morphed_eyebrow, background_layer
        )
        return [
            eyebrow_image,
            combine_alpha,
            eyebrow_image_no_combine_alpha,
            morphed_eyebrow,
            alpha,
            color,
            warped_eyebrow,
            grid_change,
        ]
