"""FaceMorpher08: the 192x192 expression morpher teacher
(counterpart of ``tha4_tpu/models/face_morpher.py``).

The encoder-decoder blocks sit at the top level of the state dict (no
``body.`` prefix), so the module is a PoserEncoderDecoder00 with five heads:
the iris/mouth branch (a zero-init grid change, no bias, then colour change
and alpha over the warped image) and the eye branch (colour change and
alpha over the iris/mouth result, detached from it).  The warp runs on K2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch import nn

from tha4_tpu_torch.models.encoder_decoder import EncoderDecoderConfig, PoserEncoderDecoder00
from tha4_tpu_torch.models.eyebrow import head, nchw, nhwc
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.ops import warp

# Output indices (tha4_tpu/models/face_morpher.py:22-31)
OUTPUT_IMAGE_INDEX = 0
EYE_ALPHA_INDEX = 1
EYE_COLOR_CHANGE_INDEX = 2
IRIS_MOUTH_IMAGE_1_INDEX = 3
IRIS_MOUTH_ALPHA_INDEX = 4
IRIS_MOUTH_COLOR_CHANGE_INDEX = 5
IRIS_MOUTH_IMAGE_0_INDEX = 6
IRIS_MOUTH_GRID_CHANGE_INDEX = 7
OUTPUT_LENGTH = 8


@dataclass(frozen=True)
class FaceMorpherConfig:
    image_size: int = 192
    image_channels: int = 4
    num_expression_params: int = 27
    start_channels: int = 64
    bottleneck_image_size: int = 24
    num_bottleneck_blocks: int = 6
    max_channels: int = 512
    output_iris_mouth_grid_change: bool = True
    # The shipped face morpher uses ReLU blocks (tha4_tpu/models/face_morpher.py:46-48).
    nonlin: str = "relu"

    @property
    def body(self) -> EncoderDecoderConfig:
        return EncoderDecoderConfig(
            image_size=self.image_size, input_image_channels=self.image_channels,
            num_pose_params=self.num_expression_params, start_channels=self.start_channels,
            bottleneck_image_size=self.bottleneck_image_size, num_bottleneck_blocks=self.num_bottleneck_blocks,
            max_channels=self.max_channels, nonlin=self.nonlin,
        )


class FaceMorpher08(PoserEncoderDecoder00):
    """(N,192,192,4) image + (N,27) expression pose -> 7 or 8 outputs."""

    def __init__(self, cfg: FaceMorpherConfig):
        super().__init__(cfg.body)
        self.morpher_cfg = cfg
        s, c = cfg.start_channels, cfg.image_channels
        self.iris_mouth_grid_change = tnn.conv3(s, 2, bias=False)
        self.iris_mouth_color_change = head(s, c, nn.Tanh())
        self.iris_mouth_alpha = head(s, 1, nn.Sigmoid())
        self.eye_color_change = head(s, c, nn.Tanh())
        self.eye_alpha = head(s, 1, nn.Sigmoid())

    def reset_parameters(self, gen: torch.Generator) -> None:
        tnn.reset_convs_(self, "he", gen)
        tnn.init_conv_(self.iris_mouth_grid_change, "zero", gen)

    def forward(self, image: torch.Tensor, pose: torch.Tensor) -> List[torch.Tensor]:
        feature = self.encode_decode(nchw(image), pose)
        im_grid_change = nhwc(self.iris_mouth_grid_change(feature))
        iris_mouth_image_0 = warp.apply_grid_change(im_grid_change, image.contiguous())
        im_color = nhwc(self.iris_mouth_color_change(feature))
        im_alpha = nhwc(self.iris_mouth_alpha(feature))
        iris_mouth_image_1 = warp.apply_color_change(im_alpha, im_color, iris_mouth_image_0)
        eye_color = nhwc(self.eye_color_change(feature))
        eye_alpha = nhwc(self.eye_alpha(feature))
        output_image = warp.apply_color_change(eye_alpha, eye_color, iris_mouth_image_1.detach())
        outputs = [output_image, eye_alpha, eye_color, iris_mouth_image_1, im_alpha, im_color, iris_mouth_image_0]
        if self.morpher_cfg.output_iris_mouth_grid_change:
            outputs.append(im_grid_change)
        return outputs
