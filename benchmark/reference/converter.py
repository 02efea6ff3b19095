"""The iFacialMocap blendshapes -> 45-value pose rule, with the default
calibration and breathing off, as the reference puppeteer
(``ifacialmocap_pose_converter_25.py:397-607``) states it: a frozen
restatement in plain Python and NumPy, the viseme decomposition solved by
the same fixed 300-step projected gradient of
``||d @ M - p||_2 + 0.01 ||d||_1`` over d in [0, 1]^4."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

POSE_NAMES = (
    "eyebrow_troubled_left", "eyebrow_troubled_right", "eyebrow_angry_left", "eyebrow_angry_right",
    "eyebrow_lowered_left", "eyebrow_lowered_right", "eyebrow_raised_left", "eyebrow_raised_right",
    "eyebrow_happy_left", "eyebrow_happy_right", "eyebrow_serious_left", "eyebrow_serious_right",
    "eye_wink_left", "eye_wink_right", "eye_happy_wink_left", "eye_happy_wink_right",
    "eye_surprised_left", "eye_surprised_right", "eye_relaxed_left", "eye_relaxed_right",
    "eye_unimpressed_left", "eye_unimpressed_right", "eye_raised_lower_eyelid_left", "eye_raised_lower_eyelid_right",
    "iris_small_left", "iris_small_right", "mouth_aaa", "mouth_iii", "mouth_uuu", "mouth_eee", "mouth_ooo",
    "mouth_delta", "mouth_lowered_corner_left", "mouth_lowered_corner_right", "mouth_raised_corner_left",
    "mouth_raised_corner_right", "mouth_smirk", "iris_rotation_x", "iris_rotation_y", "head_x", "head_y",
    "neck_z", "body_y", "body_z", "breathing",
)
INDEX = {name: i for i, name in enumerate(POSE_NAMES)}

# The default calibration (reference :46-91).
SMILE_MIN, SMILE_MAX = 0.4, 0.6
EYE_SURPRISED_MAX, EYE_BLINK_MAX, EYEBROW_DOWN_MAX = 0.5, 0.8, 0.4
CHEEK_SQUINT_MIN, CHEEK_SQUINT_MAX = 0.1, 0.7
EYE_ROTATION_FACTOR = 1.0 / 0.75
JAW_OPEN_MIN, JAW_OPEN_MAX = 0.1, 0.4
MOUTH_FROWN_MAX = 0.6
MOUTH_FUNNEL_MIN, MOUTH_FUNNEL_MAX = 0.25, 0.5

VISEMES = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.5, 0.3, 0.25, 0.75], [1.0, 0.5, 0.5, 0.4]])


def _clamp(x, lo, hi):
    return max(lo, min(hi, x))


def visemes(point) -> np.ndarray:
    p = np.asarray(point, np.float64)
    d = np.zeros(4)
    for _ in range(300):
        r = d @ VISEMES - p
        norm = np.linalg.norm(r)
        grad = ((r @ VISEMES.T) / norm if norm > 1e-12 else np.zeros(4)) + 0.01 * np.sign(d)
        d = np.clip(d - 0.02 * grad, 0.0, 1.0)
    return d


def convert(m: Dict[str, float]) -> List[float]:
    pose = [0.0] * len(POSE_NAMES)

    def put(name, value):
        pose[INDEX[name]] = value

    smile = (m["mouthSmileLeft"] + m["mouthSmileRight"]) / 2.0 + m["mouthShrugUpper"]
    if smile < SMILE_MIN:
        degree = 0.0
    elif smile > SMILE_MAX:
        degree = 1.0
    else:
        degree = (smile - SMILE_MIN) / (SMILE_MAX - SMILE_MIN)

    put("eyebrow_raised_left", _clamp(m["browInnerUp"] + m["browOuterUpLeft"], 0.0, 1.0))
    put("eyebrow_raised_right", _clamp(m["browInnerUp"] + m["browOuterUpRight"], 0.0, 1.0))
    put("eyebrow_angry_left", (1.0 - degree) * _clamp(m["browDownLeft"] / EYEBROW_DOWN_MAX, 0.0, 1.0))
    put("eyebrow_angry_right", (1.0 - degree) * _clamp(m["browDownRight"] / EYEBROW_DOWN_MAX, 0.0, 1.0))
    happy = _clamp(smile, 0.0, 1.0) * degree
    put("eyebrow_happy_left", happy)
    put("eyebrow_happy_right", happy)

    put("eye_surprised_left", _clamp(m["eyeWideLeft"] / EYE_SURPRISED_MAX, 0.0, 1.0))
    put("eye_surprised_right", _clamp(m["eyeWideRight"] / EYE_SURPRISED_MAX, 0.0, 1.0))
    blink_l = _clamp(m["eyeBlinkLeft"] / EYE_BLINK_MAX, 0.0, 1.0)
    blink_r = _clamp(m["eyeBlinkRight"] / EYE_BLINK_MAX, 0.0, 1.0)
    put("eye_wink_left", (1.0 - degree) * blink_l)
    put("eye_wink_right", (1.0 - degree) * blink_r)
    put("eye_happy_wink_left", degree * blink_l)
    put("eye_happy_wink_right", degree * blink_r)
    squint = CHEEK_SQUINT_MAX - CHEEK_SQUINT_MIN
    put("eye_raised_lower_eyelid_left", _clamp((m["cheekSquintLeft"] - CHEEK_SQUINT_MIN) / squint, 0.0, 1.0))
    put("eye_raised_lower_eyelid_right", _clamp((m["cheekSquintRight"] - CHEEK_SQUINT_MIN) / squint, 0.0, 1.0))

    rot_y = (m["eyeLookInLeft"] - m["eyeLookOutLeft"] - m["eyeLookInRight"] + m["eyeLookOutRight"]) / 2.0
    put("iris_rotation_y", _clamp(rot_y * EYE_ROTATION_FACTOR, -1.0, 1.0))
    rot_x = (m["eyeLookUpLeft"] + m["eyeLookUpRight"] - m["eyeLookDownLeft"] - m["eyeLookDownRight"]) / 2.0
    put("iris_rotation_x", _clamp(rot_x * EYE_ROTATION_FACTOR, -1.0, 1.0))

    x = _clamp(-m["headBoneX"] * 180.0 / math.pi, -15.0, 15.0) / 15.0
    y = _clamp(-m["headBoneY"] * 180.0 / math.pi, -10.0, 10.0) / 10.0
    z = _clamp(m["headBoneZ"] * 180.0 / math.pi, -15.0, 15.0) / 15.0
    put("head_x", x)
    put("head_y", y)
    put("body_y", y)
    put("neck_z", z)
    put("body_z", z)

    mouth_open = _clamp((m["jawOpen"] - JAW_OPEN_MIN) / (JAW_OPEN_MAX - JAW_OPEN_MIN), 0.0, 1.0)
    put("mouth_aaa", mouth_open)
    put("mouth_raised_corner_left", _clamp(smile, 0.0, 1.0))
    put("mouth_raised_corner_right", _clamp(smile, 0.0, 1.0))
    if mouth_open <= 0.0:
        # The reference zeroes the frown whenever its maximum is positive.
        put("mouth_lowered_corner_left", 0.0)
        put("mouth_lowered_corner_right", 0.0)
    else:
        lower = _clamp(m["mouthLowerDownLeft"] + m["mouthLowerDownRight"], 0.0, 1.0)
        d = visemes([mouth_open, lower, m["mouthFunnel"], m["mouthPucker"]])
        put("mouth_aaa", float(d[0]))
        put("mouth_iii", float(d[1]))
        ooo = _clamp((m["mouthFunnel"] - MOUTH_FUNNEL_MIN) / (MOUTH_FUNNEL_MAX - MOUTH_FUNNEL_MIN), 0.0, 1.0)
        uo = _clamp(float(d[2]) + float(d[3]), 0.0, 1.0)
        put("mouth_uuu", uo * (1.0 - ooo))
        put("mouth_ooo", uo * ooo)
    return pose
