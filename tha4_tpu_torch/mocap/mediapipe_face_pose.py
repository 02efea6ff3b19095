"""MediaPipe face pose: 52 blendshapes + a 4x4 facial transform matrix
(counterpart of ``tha4_tpu/mocap/mediapipe_face_pose.py``).

Reference: src/tha4/mocap/mediapipe_face_pose.py (json round-trip preserved
for recorded-stream compatibility).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class MediaPipeFacePose:
    KEY_BLENDSHAPE_PARAMS = "blendshape_params"
    KEY_XFORM_MATRIX = "xform_matrix"

    def __init__(self, blendshape_params: Optional[Dict[str, float]], xform_matrix: Optional[np.ndarray]):
        if blendshape_params is None:
            blendshape_params = {}
        if xform_matrix is None:
            xform_matrix = np.eye(4)
        self.blendshape_params = blendshape_params
        self.xform_matrix = np.asarray(xform_matrix)

    def get_json(self):
        return {
            MediaPipeFacePose.KEY_BLENDSHAPE_PARAMS: self.blendshape_params.copy(),
            MediaPipeFacePose.KEY_XFORM_MATRIX: self.xform_matrix.tolist(),
        }

    def save(self, file_name: str) -> None:
        os.makedirs(os.path.dirname(file_name), exist_ok=True)
        with open(file_name, "wt") as fout:
            fout.write(json.dumps(self.get_json()))

    @staticmethod
    def load(file_name: str) -> "MediaPipeFacePose":
        with open(file_name, "rt") as fin:
            data = json.loads(fin.read())
        return MediaPipeFacePose(
            data[MediaPipeFacePose.KEY_BLENDSHAPE_PARAMS],
            np.array(data[MediaPipeFacePose.KEY_XFORM_MATRIX]),
        )
