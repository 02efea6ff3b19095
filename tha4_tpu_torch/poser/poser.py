"""Pose-vector schema and the Poser interface.

API surface mirrors the reference (reference: src/tha4/poser/poser.py:9-162)
so users of THA4 find the same names: PoseParameterCategory, parameter groups
with arity/range/default, name <-> index resolution, and a Poser with
``pose(image, pose, output_index)`` / ``get_posing_outputs``.

Images here are NHWC torch tensors or numpy arrays in model units ([-1,1]
premultiplied linear RGBA); poses are float32 vectors.  A numpy-only copy of
``tha4_tpu.poser.poser``: the port never imports the JAX package.
"""

from __future__ import annotations

import abc
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np


class PoseParameterCategory(Enum):
    EYEBROW = 1
    EYE = 2
    IRIS_MORPH = 3
    IRIS_ROTATION = 4
    MOUTH = 5
    FACE_ROTATION = 6
    BODY_ROTATION = 7
    BREATHING = 8


class PoseParameterGroup:
    def __init__(
        self,
        group_name: str,
        parameter_index: int,
        category: PoseParameterCategory,
        arity: int = 1,
        discrete: bool = False,
        default_value: float = 0.0,
        range: Optional[Tuple[float, float]] = None,
    ):
        assert arity in (1, 2)
        if range is None:
            range = (0.0, 1.0)
        if arity == 1:
            parameter_names = [group_name]
        else:
            parameter_names = [group_name + "_left", group_name + "_right"]
        self.parameter_names = parameter_names
        self.range = range
        self.default_value = default_value
        self.discrete = discrete
        self.arity = arity
        self.category = category
        self.parameter_index = parameter_index
        self.group_name = group_name

    def get_arity(self) -> int:
        return self.arity

    def get_group_name(self) -> str:
        return self.group_name

    def get_parameter_names(self) -> List[str]:
        return self.parameter_names

    def is_discrete(self) -> bool:
        return self.discrete

    def get_range(self) -> Tuple[float, float]:
        return self.range

    def get_default_value(self) -> float:
        return self.default_value

    def get_parameter_index(self) -> int:
        return self.parameter_index

    def get_category(self) -> PoseParameterCategory:
        return self.category


class PoseParameters:
    def __init__(self, pose_parameter_groups: List[PoseParameterGroup]):
        self.pose_parameter_groups = pose_parameter_groups

    def get_parameter_index(self, name: str) -> int:
        index = 0
        for group in self.pose_parameter_groups:
            for param_name in group.parameter_names:
                if name == param_name:
                    return index
                index += 1
        raise KeyError(f"Cannot find parameter with name {name}")

    def get_group_start_index(self, group_name: str) -> int:
        """First parameter index of the named group (an arity-2 group like
        'eye_wink' spans [start, start+2))."""
        for group in self.pose_parameter_groups:
            if group.group_name == group_name:
                return group.parameter_index
        raise KeyError(f"Cannot find parameter group with name {group_name}")

    def get_parameter_name(self, index: int) -> str:
        assert 0 <= index < self.get_parameter_count()
        for group in self.pose_parameter_groups:
            if index < group.get_arity():
                return group.get_parameter_names()[index]
            index -= group.arity
        raise RuntimeError("unreachable")

    def get_pose_parameter_groups(self) -> List[PoseParameterGroup]:
        return self.pose_parameter_groups

    def get_parameter_count(self) -> int:
        return sum(group.arity for group in self.pose_parameter_groups)

    def get_default_pose(self) -> np.ndarray:
        pose = np.zeros(self.get_parameter_count(), dtype=np.float32)
        for group in self.pose_parameter_groups:
            for k in range(group.arity):
                pose[group.parameter_index + k] = group.default_value
        return pose

    class Builder:
        def __init__(self):
            self.index = 0
            self.pose_parameter_groups: List[PoseParameterGroup] = []

        def add_parameter_group(
            self,
            group_name: str,
            category: PoseParameterCategory,
            arity: int = 1,
            discrete: bool = False,
            default_value: float = 0.0,
            range: Optional[Tuple[float, float]] = None,
        ) -> "PoseParameters.Builder":
            self.pose_parameter_groups.append(
                PoseParameterGroup(group_name, self.index, category, arity, discrete, default_value, range)
            )
            self.index += arity
            return self

        def build(self) -> "PoseParameters":
            return PoseParameters(self.pose_parameter_groups)


class Poser(abc.ABC):
    """Posing interface (reference: src/tha4/poser/poser.py:132-162)."""

    @abc.abstractmethod
    def get_image_size(self) -> int: ...

    @abc.abstractmethod
    def get_output_length(self) -> int: ...

    @abc.abstractmethod
    def get_pose_parameter_groups(self) -> List[PoseParameterGroup]: ...

    @abc.abstractmethod
    def get_num_parameters(self) -> int: ...

    @abc.abstractmethod
    def pose(self, image, pose, output_index: int = 0): ...

    @abc.abstractmethod
    def get_posing_outputs(self, image, pose) -> List: ...
