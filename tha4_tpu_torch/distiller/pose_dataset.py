"""Pose batches for distillation (counterpart of
``tha4_tpu/distiller/pose_dataset.py``).

Rows of the reference's ``data/pose_dataset.pt`` when that file exists;
otherwise a procedural sampler with the JAX package's distribution: every
parameter uniform over its schema range, then one eyebrow pair, one eye
pair and one mouth shape kept per pose (the others zeroed).  Every draw
comes from the ``torch.Generator`` the caller passes, on the CPU, so a
batch is the same on any device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters

_pp = get_pose_parameters()
_LOWS = torch.zeros(_pp.get_parameter_count())
_HIGHS = torch.zeros(_pp.get_parameter_count())
for _g in _pp.get_pose_parameter_groups():
    _LOWS[_g.parameter_index : _g.parameter_index + _g.arity] = _g.range[0]
    _HIGHS[_g.parameter_index : _g.parameter_index + _g.arity] = _g.range[1]

# Spans of the mutually sparse morph groups, found by name; (start, stop, group size).
_SPARSE_GROUPS = (
    (_pp.get_group_start_index("eyebrow_troubled"), _pp.get_group_start_index("eye_wink"), 2),
    (_pp.get_group_start_index("eye_wink"), _pp.get_group_start_index("iris_small"), 2),
    # aaa iii uuu eee ooo delta; the mouth corners and smirk after them stay independent.
    (_pp.get_group_start_index("mouth_aaa"), _pp.get_group_start_index("mouth_lowered_corner"), 1),
)


def load_pose_dataset(path: str) -> Optional[torch.Tensor]:
    """(N, 45) f32 poses from the reference ``.pt`` file, if it is there."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, (list, tuple)):
        data = data[0]
    return torch.as_tensor(data, dtype=torch.float32)


def sample_poses(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 45) f32 poses on the CPU, a function of the generator's state."""
    pose = torch.rand((n, _LOWS.shape[0]), generator=gen) * (_HIGHS - _LOWS) + _LOWS
    for start, stop, size in _SPARSE_GROUPS:
        choice = torch.randint(0, (stop - start) // size, (n,), generator=gen)
        keep = (torch.arange(stop - start) // size)[None, :] == choice[:, None]
        pose[:, start:stop] *= keep
    return pose


class PoseSource:
    """Batches: dataset rows when the file exists, else procedural poses."""

    def __init__(self, pose_dataset_path: Optional[str] = None):
        self.dataset = load_pose_dataset(pose_dataset_path) if pose_dataset_path else None

    def batch(self, gen: torch.Generator, n: int) -> torch.Tensor:
        if self.dataset is not None:
            return self.dataset[torch.randint(0, self.dataset.shape[0], (n,), generator=gen)]
        return sample_poses(gen, n)
