"""MediaPipe face pose -> 45-dim THA4 pose (counterpart of
``tha4_tpu/mocap/mediapipe_face_pose_converter.py``).

Reference: src/tha4/mocap/mediapipe_face_pose_converter_00.py.  The
blendshape math mirrors the iFacialMocap converter; head rotation comes from
the facial transform matrix via extrinsic-xyz Euler angles with
user-calibrated offsets (:375-391, :567-581), and the closed-mouth frown
branch uses the corrected ``mouth_frown_max <= 0`` condition (:597-601).

The reference extracts angles with scipy.spatial.transform.Rotation
(:377-378); here the equivalent closed form (R = Rz Ry Rx factorization) is
implemented directly and tested against scipy.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from tha4_tpu_torch.mocap.ifacialmocap_constants import (
    MOUTH_FROWN_LEFT, MOUTH_FROWN_RIGHT,
)
from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import (
    EyebrowDownMode,
    IFacialMocapPoseConverter,
    IFacialMocapPoseConverterArgs,
    WinkMode,
    clamp,
)
from tha4_tpu_torch.mocap.mediapipe_face_pose import MediaPipeFacePose


def matrix_to_euler_xyz(m3: np.ndarray) -> np.ndarray:
    """Extrinsic x-y-z Euler angles of a rotation matrix: R = Rz(c)Ry(b)Rx(a).

    Matches scipy Rotation.as_euler('xyz', degrees=False) for proper
    rotations away from the gimbal singularity (|b| = pi/2).
    """
    b = math.asin(max(-1.0, min(1.0, -m3[2, 0])))
    if abs(m3[2, 0]) < 0.9999999:
        a = math.atan2(m3[2, 1], m3[2, 2])
        c = math.atan2(m3[1, 0], m3[0, 0])
    else:
        a = math.atan2(-m3[1, 2], m3[1, 1])
        c = 0.0
    return np.array([a, b, c])


class MediaPipeFacePoseConverterArgs(IFacialMocapPoseConverterArgs):
    def __init__(self, head_x_offset=0.0, head_y_offset=0.0, head_z_offset=0.0, **kwargs):
        super().__init__(**kwargs)
        self.head_x_offset = head_x_offset
        self.head_y_offset = head_y_offset
        self.head_z_offset = head_z_offset


class MediaPipeFacePoseConverter(IFacialMocapPoseConverter):
    """Shares all blendshape math with the iFacialMocap converter; overrides
    the head-rotation source and the frown-branch fix."""

    def __init__(self, args: Optional[MediaPipeFacePoseConverterArgs] = None, native: bool = True):
        super().__init__(args or MediaPipeFacePoseConverterArgs(), native)

    def extract_euler_angles(self, face_pose: MediaPipeFacePose) -> np.ndarray:
        return matrix_to_euler_xyz(np.asarray(face_pose.xform_matrix)[0:3, 0:3])

    def calibrate(self, face_pose: MediaPipeFacePose) -> None:
        """Set the neutral-head offsets from the current pose
        (reference :385-391)."""
        angles = self.extract_euler_angles(face_pose)
        self.args.head_x_offset = float(angles[0])
        self.args.head_y_offset = float(angles[1])
        self.args.head_z_offset = float(angles[2])

    def convert(self, face_pose: MediaPipeFacePose, now: Optional[float] = None) -> List[float]:
        # A real FaceLandmarker result carries ONLY the 52 ARKit blendshape
        # scores — no bone entries.  The shared iFacialMocap blendshape math
        # reads bone keys before this converter overrides head rotation from
        # the transform matrix, so complete the dict with neutral defaults
        # (the overridden values are discarded below).
        from tha4_tpu_torch.mocap.ifacialmocap import create_default_ifacialmocap_pose

        m = create_default_ifacialmocap_pose()
        m.update(face_pose.blendshape_params)
        pose = super().convert(m, now)
        idx = self._idx
        args = self.args

        # Head rotation from the transform matrix (reference :567-581).
        angles = self.extract_euler_angles(face_pose)
        angles[0] -= args.head_x_offset
        angles[1] -= args.head_y_offset
        angles[2] -= args.head_z_offset
        x_param = clamp(-angles[0] * 180.0 / math.pi, -15.0, 15.0) / 15.0
        pose[idx["head_x"]] = x_param
        y_param = clamp(-angles[1] * 180.0 / math.pi, -10.0, 10.0) / 10.0
        pose[idx["head_y"]] = y_param
        pose[idx["body_y"]] = y_param
        z_param = clamp(angles[2] * 180.0 / math.pi, -15.0, 15.0) / 15.0
        pose[idx["neck_z"]] = z_param
        pose[idx["body_z"]] = z_param

        # Corrected closed-mouth frown branch (reference :595-603).
        if pose[idx["mouth_aaa"]] <= 0.0:
            if args.mouth_frown_max <= 0:
                mouth_frown_value = 0.0
            else:
                mouth_frown_value = clamp(
                    (m[MOUTH_FROWN_LEFT] + m[MOUTH_FROWN_RIGHT]) / args.mouth_frown_max, 0.0, 1.0
                )
            pose[idx["mouth_lowered_corner_left"]] = mouth_frown_value
            pose[idx["mouth_lowered_corner_right"]] = mouth_frown_value
        return pose


def create_mediapipe_pose_converter(
    args: Optional[MediaPipeFacePoseConverterArgs] = None,
) -> MediaPipeFacePoseConverter:
    return MediaPipeFacePoseConverter(args)
