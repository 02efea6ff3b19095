"""Resize ops with torch ``interpolate`` semantics, no antialiasing
(counterpart of ``tha4_tpu/ops/resize.py``).

Bilinear resizing is two 1-D interpolation-matrix products in f32 (f64 for
an f64 input; output pixel i samples ``(i + 0.5) * scale - 0.5``, clamped
at the edges), then a cast back to the input dtype.  The products are plain ``torch.matmul``; in
f32 they are full-f32 products because ``StudentPoser`` turns TF32 off.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tha4_tpu_torch.ops import wide


@functools.lru_cache(maxsize=64)
def _bilinear_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) interpolation matrix, torch half-pixel rule."""
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = np.clip((i + 0.5) * scale - 0.5, 0.0, in_size - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = src - i0
    mat = np.zeros((in_size, out_size), dtype=np.float32)
    mat[i0, np.arange(out_size)] += (1.0 - t).astype(np.float32)
    mat[i1, np.arange(out_size)] += t.astype(np.float32)
    return mat


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int, device: str) -> torch.Tensor:
    # A normal tensor even when first asked for under inference mode (see
    # ops.warp._identity_grid).
    with torch.inference_mode(False):
        return torch.from_numpy(_bilinear_matrix_np(in_size, out_size)).to(device)


def resize_bilinear_nchw(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Torch-rule bilinear resize of NCHW ``image`` to (H, W) = ``size``."""
    n, c, h, w = image.shape
    ho, wo = size
    if (h, w) == (ho, wo):
        return image
    device = str(image.device)
    x = wide(image)
    if h != ho:  # H first, then W, as the JAX package does
        x = torch.matmul(_bilinear_matrix(h, ho, device).to(x.dtype).T, x)  # (n, c, ho, w)
    if w != wo:
        x = torch.matmul(x, _bilinear_matrix(w, wo, device).to(x.dtype))  # (n, c, ho, wo)
    return x.to(image.dtype)


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Torch-rule bilinear resize of NHWC ``image`` to (H, W) = ``size``."""
    return resize_bilinear_nchw(image.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def upsample_nearest_2x(image: torch.Tensor) -> torch.Tensor:
    """Legacy torch 'nearest' 2x upsample of NHWC: src index = floor(dst / 2)."""
    return image.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def downsample_avg_2x(image: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NHWC."""
    n, h, w, c = image.shape
    return image.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
