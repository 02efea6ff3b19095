"""Appearance-flow warping (counterpart of ``tha4_tpu/ops/warp.py``).

Layouts follow the JAX package: NHWC images and (N, H, W, 2) grid changes
with x first, normalised to [-1, 1] as torch ``affine_grid`` /
``grid_sample(align_corners=False)`` use them.  Grid math is f32 whatever the
image dtype.  The warp itself is K2, or K3 under autograd (``ops.cuda_warp``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tha4_tpu_torch.ops import cuda_warp, wide


@functools.lru_cache(maxsize=32)
def _identity_grid_np(h: int, w: int) -> np.ndarray:
    x = (2.0 * np.arange(w, dtype=np.float32) + 1.0) / w - 1.0
    y = (2.0 * np.arange(h, dtype=np.float32) + 1.0) / h - 1.0
    gx, gy = np.meshgrid(x, y)  # (H, W)
    return np.stack([gx, gy], axis=-1)  # (H, W, 2)


@functools.lru_cache(maxsize=None)
def _identity_grid(h: int, w: int, device: str) -> torch.Tensor:
    # A normal tensor even when first asked for under inference mode: the
    # cache outlives that block, and training saves the grid for backward.
    # Never dropped (one per warped size): a captured CUDA graph (mode_07's
    # teacher) reads it by address.
    with torch.inference_mode(False):
        return torch.from_numpy(_identity_grid_np(h, w)).to(device)


def identity_grid(h: int, w: int, device="cpu") -> torch.Tensor:
    """Normalised identity sampling grid, (H, W, 2) f32, last dim (x, y).

    Equals torch ``affine_grid(eye, [n, c, h, w], align_corners=False)``.  The
    tensor is cached per (h, w, device) and shared: callers must not write
    to it."""
    return _identity_grid(h, w, str(torch.device(device)))


def apply_grid_change(grid_change: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``image`` by ``grid_change`` (N, H, W, 2), x first.

    The grid is identity + change, built in f32.  K2 runs the warp (the
    kernel on CUDA tensors, its plain version on CPU tensors), or K3 where
    the grid needs a gradient (gradient to the grid only, the image a
    constant, as the JAX package's fast warp); both are exact, since the
    port's warp has no TPU window budget.  The plain warp, differentiable
    in image and grid, is ``cuda_warp.grid_sample_bilinear_border``."""
    n, h, w, _ = image.shape
    grid = identity_grid(h, w, image.device)[None] + wide(grid_change)
    grid = grid.expand(n, h, w, 2).contiguous()
    if torch.is_grad_enabled() and (grid.requires_grad or image.requires_grad):
        return cuda_warp.grid_sample_train(image, grid)
    return cuda_warp.grid_sample_fast(image, grid)


def apply_color_change(alpha, color_change, image):
    """``color_change * alpha + image * (1 - alpha)``."""
    return color_change * alpha + image * (1.0 - alpha)


def apply_rgb_change(alpha, color_change, image):
    """Alpha-lerp RGB only, pass through the image's alpha channel (NHWC)."""
    out_rgb = color_change[..., 0:3] * alpha + image[..., 0:3] * (1.0 - alpha)
    return torch.cat([out_rgb, image[..., 3:4]], dim=-1)
