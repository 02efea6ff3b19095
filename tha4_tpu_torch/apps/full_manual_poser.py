"""Pose-vector helpers shared by the posing apps (the teacher CLI of
``tha4_tpu/apps/full_manual_poser.py`` is ported with the teacher)."""

from __future__ import annotations


def build_pose(pose_parameters, assignments):
    """The default pose with ``(name, value)`` assignments applied."""
    pose = pose_parameters.get_default_pose()
    for name, value in assignments:
        pose[pose_parameters.get_parameter_index(name)] = value
    return pose
