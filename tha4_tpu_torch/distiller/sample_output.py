"""Sample-output grid PNGs: the de-facto regression artifact during training
(a copy of ``tha4_tpu/distiller/sample_output.py``, writing through the
port's ``core/imagecodec``).

Reference: src/tha4/sampleoutput/sample_image_creator.py.  Each cadence a
grid PNG of cells is written under {prefix}/sample_outputs/: columns are
(source tensor, render type); rows are sample poses.  Render types:

  * COLOR         — model-unit RGBA composited over a (-1,1,-1) green screen
                    (sample_image_creator.py:105-113)
  * ALPHA         — single channel replicated, [0,1] -> [-1,1] (:120-124)
  * GRID_CHANGE   — HSV-wheel visualization: hue = flow angle, value = norm x3
                    (:57-71)
  * SIGMOID_LOGIT — sigmoid(logit) replicated, [0,1] -> [-1,1] (:115-119)

Columns can also be declared by (source, index) against the training batch /
model outputs via ``SampleImageSpec`` + ``save_sample_output_image`` — the
reference ``SampleImageSaver`` column spec (sample_image_creator.py:16-30,
:86-130).
"""

from __future__ import annotations

import colorsys
import math
import os
from dataclasses import dataclass
from enum import Enum
from typing import List, Sequence, Tuple

import numpy as np


class ImageType(Enum):
    COLOR = 1
    ALPHA = 2
    GRID_CHANGE = 3
    SIGMOID_LOGIT = 4


class ImageSource(Enum):
    """Which tensor list a sample-grid column reads from
    (reference sample_image_creator.py:16-18)."""

    BATCH = 0
    OUTPUT = 1


@dataclass(frozen=True)
class SampleImageSpec:
    """One grid column: tensor list, index into it, render type
    (reference sample_image_creator.py:28-32)."""

    image_source: ImageSource
    index: int
    image_type: ImageType


def grid_change_to_rgb(grid_change_hw2: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) in [0,1]: hsv-wheel hue by angle, scaled by
    3x the flow magnitude (reference sample_image_creator.py:57-66; the
    reference's channel order makes the angle atan2(x, y))."""
    x = grid_change_hw2[..., 0]
    y = grid_change_hw2[..., 1]
    size = np.sqrt(x * x + y * y)[..., None]
    angle01 = (np.arctan2(x, y) + math.pi) / (2 * math.pi)
    # matplotlib 'hsv' colormap == full-saturation full-value hue wheel
    rgb = np.stack(
        [np.vectorize(lambda h, ch=ch: colorsys.hsv_to_rgb(h, 1.0, 1.0)[ch])(angle01) for ch in range(3)],
        axis=-1,
    )
    return np.clip(size * rgb * 3.0, 0.0, 1.0)


def _render_cell(image_hwc: np.ndarray, image_type: ImageType) -> np.ndarray:
    """-> (H, W, 4) in model units [-1, 1], ready for save_image_hwc."""
    if image_type == ImageType.COLOR:
        rgb = image_hwc[..., 0:3]
        alpha = (image_hwc[..., 3:4] + 1.0) * 0.5
        green = np.full_like(rgb, -1.0)
        green[..., 1] = 1.0
        out_rgb = rgb * alpha + green * (1 - alpha)
        return np.concatenate([out_rgb, np.ones_like(alpha)], axis=-1)
    if image_type == ImageType.ALPHA:
        a = image_hwc[..., 0:1] if image_hwc.ndim == 3 else image_hwc[..., None]
        return np.repeat(a * 2.0 - 1.0, 4, axis=-1)
    if image_type == ImageType.GRID_CHANGE:
        rgb = grid_change_to_rgb(image_hwc) * 2.0 - 1.0
        return np.concatenate([rgb, np.ones(rgb.shape[:2] + (1,))], axis=-1)
    if image_type == ImageType.SIGMOID_LOGIT:
        # sigmoid(logit) replicated to RGBA, [0,1] -> [-1,1]
        # (reference sample_image_creator.py:115-119).
        a = image_hwc[..., 0:1] if image_hwc.ndim == 3 else image_hwc[..., None]
        s = 1.0 / (1.0 + np.exp(-a))
        return np.repeat(s * 2.0 - 1.0, 4, axis=-1)
    raise ValueError(image_type)


def save_sample_grid(
    cells: Sequence[Sequence[Tuple[np.ndarray, ImageType]]],
    file_name: str,
    cell_size: int,
) -> None:
    """cells[row][col] = (HWC array, type). Writes one PNG grid
    (straight-alpha linear->sRGB, like the reference save path)."""
    from tha4_tpu_torch.core.imagecodec import save_image_hwc

    num_rows = len(cells)
    num_cols = len(cells[0])
    grid = np.zeros((cell_size * num_rows, cell_size * num_cols, 4), np.float32)
    for r, row in enumerate(cells):
        for c, (image, image_type) in enumerate(row):
            cell = _render_cell(np.asarray(image, np.float32), image_type)
            if cell.shape[0] != cell_size:
                # Nearest-neighbor resize to the cell, like the reference's
                # interpolate(size=cell_size) (sample_image_creator.py:141-142).
                reps = cell_size // cell.shape[0]
                if reps > 1:
                    cell = np.repeat(np.repeat(cell, reps, axis=0), reps, axis=1)
                elif cell.shape[0] % cell_size == 0:
                    stride = cell.shape[0] // cell_size
                    cell = cell[::stride, ::stride, :]
            grid[r * cell_size : (r + 1) * cell_size, c * cell_size : (c + 1) * cell_size, :] = cell
    save_image_hwc(grid, file_name)


def save_sample_output_image(
    batch: Sequence[np.ndarray],
    outputs: Sequence[np.ndarray],
    specs: Sequence[SampleImageSpec],
    file_name: str,
    cell_size: int,
) -> None:
    """Column-spec grid writer: one column per spec, one row per batch item
    (reference SampleImageSaver.save_sample_output_image,
    sample_image_creator.py:86-130).  ``batch``/``outputs`` are lists of
    (N, H, W, C) arrays; each spec picks (source list, tensor index, render)."""
    sources = {ImageSource.BATCH: batch, ImageSource.OUTPUT: outputs}
    num_rows = int(np.asarray(batch[0]).shape[0]) if batch else int(np.asarray(outputs[0]).shape[0])
    cells = [
        [(np.asarray(sources[spec.image_source][spec.index])[i], spec.image_type) for spec in specs]
        for i in range(num_rows)
    ]
    save_sample_grid(cells, file_name, cell_size)


def sample_output_file_name(prefix: str, examples_seen: int) -> str:
    """reference sample_image_creator.py:133."""
    return os.path.join(prefix, "sample_outputs", "sample_output_%010d.png" % examples_seen)
