"""Resize ops with torch ``interpolate`` semantics, no antialiasing
(counterpart of ``tha4_tpu/ops/resize.py``).

Bilinear resizing is R1 (``ops.cuda_resize``): each output pixel samples
``(i + 0.5) * scale - 0.5`` per axis, clamped at the edges, from two taps
per axis, H first and then W, in f32 (f64 for an f64 input), then a cast
back to the input dtype.  A CUDA tensor launches the kernel, a CPU tensor
runs its plain version; both read NCHW and NHWC in place and return a
contiguous tensor in the same layout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tha4_tpu_torch.ops import cuda_resize


def resize_bilinear_nchw(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Torch-rule bilinear resize of NCHW ``image`` to (H, W) = ``size``."""
    if tuple(image.shape[2:]) == tuple(size):
        return image
    return cuda_resize.resize(image, size, channels_last=False)


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Torch-rule bilinear resize of NHWC ``image`` to (H, W) = ``size``."""
    if tuple(image.shape[1:3]) == tuple(size):
        return image
    return cuda_resize.resize(image, size, channels_last=True)


def upsample_nearest_2x(image: torch.Tensor) -> torch.Tensor:
    """Legacy torch 'nearest' 2x upsample of NHWC: src index = floor(dst / 2)."""
    return image.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def downsample_avg_2x(image: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NHWC."""
    n, h, w, c = image.shape
    return image.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
