"""iFacialMocap blendshapes -> 45-dim THA4 pose (counterpart of
``tha4_tpu/mocap/ifacialmocap_pose_converter.py``): numpy and stdlib, the
viseme solve in native code, and one ``utils.profiling`` span around it.

Faithful port of the reference converter math
(reference: src/tha4/mocap/ifacialmocap_pose_converter_25.py:397-607):
smile-degree gating, eyebrow up/down modes, wink modes, iris rotation from
eyeLook*, head x/y/z clamps (+-15/10/15 degrees) with body coupling, and the
mouth-viseme decomposition.  The wx calibration panel is replaced by plain
setters on the args object; breathing is a pure function of a supplied clock.

The reference solves the viseme decomposition with scipy.optimize.minimize
per frame (:574-580).  Here it is a fixed-iteration projected-gradient solve
of the same objective (||d @ M - p||_2 + 0.01 ||d||_1, d in [0,1]^4),
deterministic; parity with scipy is covered by tests.  As a Python loop of
numpy calls (``solve_viseme_decomposition``, the definition) it takes ~5 ms
a call, most of a live frame.  So the converter runs the same 300 steps in
one native call (``native/viseme.cpp``) on numpy's own BLAS routines, bit
for bit; the first converter built checks that on a probe set and raises if
a bit differs.  ``native=False`` keeps the numpy loop.
"""

from __future__ import annotations

import functools
import math
import time
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from tha4_tpu_torch.mocap.ifacialmocap_constants import (
    BROW_DOWN_LEFT, BROW_DOWN_RIGHT, BROW_INNER_UP, BROW_OUTER_UP_LEFT, BROW_OUTER_UP_RIGHT,
    CHEEK_SQUINT_LEFT, CHEEK_SQUINT_RIGHT,
    EYE_BLINK_LEFT, EYE_BLINK_RIGHT,
    EYE_LOOK_DOWN_LEFT, EYE_LOOK_DOWN_RIGHT, EYE_LOOK_IN_LEFT, EYE_LOOK_IN_RIGHT,
    EYE_LOOK_OUT_LEFT, EYE_LOOK_OUT_RIGHT, EYE_LOOK_UP_LEFT, EYE_LOOK_UP_RIGHT,
    EYE_WIDE_LEFT, EYE_WIDE_RIGHT,
    HEAD_BONE_X, HEAD_BONE_Y, HEAD_BONE_Z,
    JAW_OPEN,
    MOUTH_FROWN_LEFT, MOUTH_FROWN_RIGHT, MOUTH_FUNNEL,
    MOUTH_LOWER_DOWN_LEFT, MOUTH_LOWER_DOWN_RIGHT, MOUTH_PUCKER,
    MOUTH_SHRUG_UPPER, MOUTH_SMILE_LEFT, MOUTH_SMILE_RIGHT,
)
from tha4_tpu_torch.native import loader
from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters
from tha4_tpu_torch.utils import profiling


class EyebrowDownMode(Enum):
    TROUBLED = 1
    ANGRY = 2
    LOWERED = 3
    SERIOUS = 4


class WinkMode(Enum):
    NORMAL = 1
    RELAXED = 2


def clamp(x, lo, hi):
    return max(lo, min(hi, x))


# Viseme prototype points (reference :563-571): rows aaa/iii/uuu/ooo over the
# measurement space (mouth_open, mouth_lower_down, mouth_funnel, mouth_pucker).
VISEME_MATRIX = np.array(
    [
        [1.0, 1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.5, 0.3, 0.25, 0.75],
        [1.0, 0.5, 0.5, 0.4],
    ],
    dtype=np.float64,
)


def solve_viseme_decomposition(mouth_point, iterations: int = 300, lr: float = 0.02) -> np.ndarray:
    """argmin_{d in [0,1]^4} ||d @ M - p||_2 + 0.01 ||d||_1 via projected
    gradient with fixed iteration count (deterministic scipy replacement).
    The definition that the native solve is held to, bit for bit."""
    p = np.asarray(mouth_point, np.float64)
    m = VISEME_MATRIX
    d = np.zeros(4)
    for _ in range(iterations):
        r = d @ m - p
        norm = np.linalg.norm(r)
        grad_l2 = (r @ m.T) / norm if norm > 1e-12 else np.zeros(4)
        grad = grad_l2 + 0.01 * np.sign(d)
        d = np.clip(d - lr * grad, 0.0, 1.0)
    return d


def solve_viseme_decomposition_native(mouth_point, iterations: int = 300, lr: float = 0.02) -> np.ndarray:
    """``solve_viseme_decomposition``'s steps in one native call, on the
    ``cblas_dgemv`` and ``cblas_ddot`` that numpy's matmul and dot call."""
    return loader.viseme_solve(VISEME_MATRIX, mouth_point, iterations, lr)


def _viseme_probes() -> np.ndarray:
    """The self-check's 16 points: zero and a point inside the norm guard
    (its branch), the four viseme rows, the unit corners, two points outside
    [0,1]^4 and three seeded ones."""
    edges = [np.zeros(4), [1e-13, 0.0, 0.0, 0.0], *VISEME_MATRIX, *np.eye(4), np.ones(4),
             [-0.1, 1.2, -0.05, 1.1], [2.0, -1.0, 0.3, 0.0]]
    seeded = np.random.default_rng(20240601).uniform(-0.1, 1.2, size=(3, 4))
    return np.concatenate([np.asarray(edges, np.float64), seeded])


@functools.lru_cache(maxsize=1)
def native_viseme_solver():
    """``solve_viseme_decomposition_native``, once built and checked: raise
    unless it gives the numpy loop's bytes on every probe."""
    for point in _viseme_probes():
        native, reference = solve_viseme_decomposition_native(point), solve_viseme_decomposition(point)
        if native.tobytes() != reference.tobytes():
            raise RuntimeError(
                f"the native viseme solve differs from the numpy loop at {point.tolist()}: {native.tolist()} "
                f"against {reference.tolist()} (numpy's BLAS: {loader.numpy_cblas().dgemv_name}); "
                "build the converter with native=False")
    return solve_viseme_decomposition_native


# Viseme solves by path since the module was imported (converters of every
# instance; the self-check's probes are not counted).
VISEME_SOLVES = {"native": 0, "numpy": 0}


class IFacialMocapPoseConverterArgs:
    """Calibration parameters (reference :46-91 defaults)."""

    def __init__(
        self,
        smile_threshold_min: float = 0.4,
        smile_threshold_max: float = 0.6,
        eyebrow_down_mode: EyebrowDownMode = EyebrowDownMode.ANGRY,
        wink_mode: WinkMode = WinkMode.NORMAL,
        eye_surprised_max: float = 0.5,
        eye_blink_max: float = 0.8,
        eyebrow_down_max: float = 0.4,
        cheek_squint_min: float = 0.1,
        cheek_squint_max: float = 0.7,
        eye_rotation_factor: float = 1.0 / 0.75,
        jaw_open_min: float = 0.1,
        jaw_open_max: float = 0.4,
        mouth_frown_max: float = 0.6,
        mouth_funnel_min: float = 0.25,
        mouth_funnel_max: float = 0.5,
        iris_small_left: float = 0.0,
        iris_small_right: float = 0.0,
        breathing_frequency: float = 0.0,  # breaths per minute; 0 = off
    ):
        self.smile_threshold_min = smile_threshold_min
        self.smile_threshold_max = smile_threshold_max
        self.eyebrow_down_mode = eyebrow_down_mode
        self.wink_mode = wink_mode
        self.eye_surprised_max = eye_surprised_max
        self.eye_blink_max = eye_blink_max
        self.eyebrow_down_max = eyebrow_down_max
        self.cheek_squint_min = cheek_squint_min
        self.cheek_squint_max = cheek_squint_max
        self.eye_rotation_factor = eye_rotation_factor
        self.jaw_open_min = jaw_open_min
        self.jaw_open_max = jaw_open_max
        self.mouth_frown_max = mouth_frown_max
        self.mouth_funnel_min = mouth_funnel_min
        self.mouth_funnel_max = mouth_funnel_max
        self.iris_small_left = iris_small_left
        self.iris_small_right = iris_small_right
        self.breathing_frequency = breathing_frequency


class IFacialMocapPoseConverter:
    def __init__(self, args: Optional[IFacialMocapPoseConverterArgs] = None, native: bool = True):
        """``native``: the viseme solve in native code (built and checked
        here, raising on failure), else the numpy loop."""
        self.args = args or IFacialMocapPoseConverterArgs()
        self.native = native
        self._solve = native_viseme_solver() if native else solve_viseme_decomposition
        pp = get_pose_parameters()
        self.pose_size = pp.get_parameter_count()
        self._idx = {}
        for group in pp.get_pose_parameter_groups():
            for name in group.get_parameter_names():
                self._idx[name] = pp.get_parameter_index(name)
        self.breathing_start_time = time.time()

    def restart_breathing_cycle(self) -> None:
        self.breathing_start_time = time.time()

    def convert(self, m: Dict[str, float], now: Optional[float] = None) -> List[float]:
        """Blendshape dict -> 45-float pose list (reference :397-607)."""
        args = self.args
        idx = self._idx
        pose = [0.0] * self.pose_size

        smile_value = (m[MOUTH_SMILE_LEFT] + m[MOUTH_SMILE_RIGHT]) / 2.0 + m[MOUTH_SHRUG_UPPER]
        if args.smile_threshold_min >= args.smile_threshold_max:
            smile_degree = 0.0
        elif smile_value < args.smile_threshold_min:
            smile_degree = 0.0
        elif smile_value > args.smile_threshold_max:
            smile_degree = 1.0
        else:
            smile_degree = (smile_value - args.smile_threshold_min) / (
                args.smile_threshold_max - args.smile_threshold_min
            )

        # Eyebrow (reference :414-449)
        brow_up_left = clamp(m[BROW_INNER_UP] + m[BROW_OUTER_UP_LEFT], 0.0, 1.0)
        brow_up_right = clamp(m[BROW_INNER_UP] + m[BROW_OUTER_UP_RIGHT], 0.0, 1.0)
        pose[idx["eyebrow_raised_left"]] = brow_up_left
        pose[idx["eyebrow_raised_right"]] = brow_up_right

        if args.eyebrow_down_max <= 0.0:
            brow_down_left = brow_down_right = 0.0
        else:
            brow_down_left = (1.0 - smile_degree) * clamp(m[BROW_DOWN_LEFT] / args.eyebrow_down_max, 0.0, 1.0)
            brow_down_right = (1.0 - smile_degree) * clamp(m[BROW_DOWN_RIGHT] / args.eyebrow_down_max, 0.0, 1.0)
        down_group = {
            EyebrowDownMode.TROUBLED: "eyebrow_troubled",
            EyebrowDownMode.ANGRY: "eyebrow_angry",
            EyebrowDownMode.LOWERED: "eyebrow_lowered",
            EyebrowDownMode.SERIOUS: "eyebrow_serious",
        }[args.eyebrow_down_mode]
        pose[idx[down_group + "_left"]] = brow_down_left
        pose[idx[down_group + "_right"]] = brow_down_right

        brow_happy_value = clamp(smile_value, 0.0, 1.0) * smile_degree
        pose[idx["eyebrow_happy_left"]] = brow_happy_value
        pose[idx["eyebrow_happy_right"]] = brow_happy_value

        # Eye (reference :451-497)
        if args.eye_surprised_max > 0.0:
            pose[idx["eye_surprised_left"]] = clamp(m[EYE_WIDE_LEFT] / args.eye_surprised_max, 0.0, 1.0)
            pose[idx["eye_surprised_right"]] = clamp(m[EYE_WIDE_RIGHT] / args.eye_surprised_max, 0.0, 1.0)

        wink_group = "eye_wink" if args.wink_mode == WinkMode.NORMAL else "eye_relaxed"
        if args.eye_blink_max > 0:
            blink_l = clamp(m[EYE_BLINK_LEFT] / args.eye_blink_max, 0.0, 1.0)
            blink_r = clamp(m[EYE_BLINK_RIGHT] / args.eye_blink_max, 0.0, 1.0)
            pose[idx[wink_group + "_left"]] = (1.0 - smile_degree) * blink_l
            pose[idx[wink_group + "_right"]] = (1.0 - smile_degree) * blink_r
            pose[idx["eye_happy_wink_left"]] = smile_degree * blink_l
            pose[idx["eye_happy_wink_right"]] = smile_degree * blink_r

        cheek_squint_denom = args.cheek_squint_max - args.cheek_squint_min
        if cheek_squint_denom > 0.0:
            pose[idx["eye_raised_lower_eyelid_left"]] = clamp(
                (m[CHEEK_SQUINT_LEFT] - args.cheek_squint_min) / cheek_squint_denom, 0.0, 1.0
            )
            pose[idx["eye_raised_lower_eyelid_right"]] = clamp(
                (m[CHEEK_SQUINT_RIGHT] - args.cheek_squint_min) / cheek_squint_denom, 0.0, 1.0
            )

        # Iris rotation (reference :499-512)
        eye_rotation_y = (
            (m[EYE_LOOK_IN_LEFT] - m[EYE_LOOK_OUT_LEFT] - m[EYE_LOOK_IN_RIGHT] + m[EYE_LOOK_OUT_RIGHT])
            / 2.0
            * args.eye_rotation_factor
        )
        pose[idx["iris_rotation_y"]] = clamp(eye_rotation_y, -1.0, 1.0)
        eye_rotation_x = (
            (m[EYE_LOOK_UP_LEFT] + m[EYE_LOOK_UP_RIGHT] - m[EYE_LOOK_DOWN_LEFT] - m[EYE_LOOK_DOWN_RIGHT])
            / 2.0
            * args.eye_rotation_factor
        )
        pose[idx["iris_rotation_x"]] = clamp(eye_rotation_x, -1.0, 1.0)

        # Iris size
        pose[idx["iris_small_left"]] = args.iris_small_left
        pose[idx["iris_small_right"]] = args.iris_small_right

        # Head rotation with body coupling (reference :519-530)
        x_param = clamp(-m[HEAD_BONE_X] * 180.0 / math.pi, -15.0, 15.0) / 15.0
        pose[idx["head_x"]] = x_param
        y_param = clamp(-m[HEAD_BONE_Y] * 180.0 / math.pi, -10.0, 10.0) / 10.0
        pose[idx["head_y"]] = y_param
        pose[idx["body_y"]] = y_param
        z_param = clamp(m[HEAD_BONE_Z] * 180.0 / math.pi, -15.0, 15.0) / 15.0
        pose[idx["neck_z"]] = z_param
        pose[idx["body_z"]] = z_param

        # Mouth (reference :533-592)
        jaw_open_denom = args.jaw_open_max - args.jaw_open_min
        mouth_open = (
            clamp((m[JAW_OPEN] - args.jaw_open_min) / jaw_open_denom, 0.0, 1.0) if jaw_open_denom > 0 else 0.0
        )
        pose[idx["mouth_aaa"]] = mouth_open
        pose[idx["mouth_raised_corner_left"]] = clamp(smile_value, 0.0, 1.0)
        pose[idx["mouth_raised_corner_right"]] = clamp(smile_value, 0.0, 1.0)

        if mouth_open <= 0.0:
            # (reference :545-552; note the reference zeroes the frown when
            # mouth_frown_max > 0 — preserved verbatim, bug and all)
            if args.mouth_frown_max > 0:
                mouth_frown_value = 0.0
            else:
                mouth_frown_value = clamp(
                    (m[MOUTH_FROWN_LEFT] + m[MOUTH_FROWN_RIGHT]) / args.mouth_frown_max, 0.0, 1.0
                )
            pose[idx["mouth_lowered_corner_left"]] = mouth_frown_value
            pose[idx["mouth_lowered_corner_right"]] = mouth_frown_value
        else:
            mouth_lower_down = clamp(m[MOUTH_LOWER_DOWN_LEFT] + m[MOUTH_LOWER_DOWN_RIGHT], 0.0, 1.0)
            mouth_funnel = m[MOUTH_FUNNEL]
            mouth_pucker = m[MOUTH_PUCKER]
            mouth_point = [mouth_open, mouth_lower_down, mouth_funnel, mouth_pucker]
            with profiling.span("ifm.viseme_solve"):
                decomp = self._solve(mouth_point)
            VISEME_SOLVES["native" if self.native else "numpy"] += 1
            pose[idx["mouth_aaa"]] = float(decomp[0])
            pose[idx["mouth_iii"]] = float(decomp[1])
            mouth_funnel_denom = args.mouth_funnel_max - args.mouth_funnel_min
            if mouth_funnel_denom <= 0:
                ooo_alpha = 0.0
                uo_value = 0.0
            else:
                ooo_alpha = clamp((mouth_funnel - args.mouth_funnel_min) / mouth_funnel_denom, 0.0, 1.0)
                uo_value = clamp(float(decomp[2]) + float(decomp[3]), 0.0, 1.0)
            pose[idx["mouth_uuu"]] = uo_value * (1.0 - ooo_alpha)
            pose[idx["mouth_ooo"]] = uo_value * ooo_alpha

        # Breathing (reference :594-607): cosine of wall clock at a chosen
        # breaths-per-minute frequency.
        frequency = args.breathing_frequency
        if frequency > 0:
            period = 60.0 / frequency
            diff = (now if now is not None else time.time()) - self.breathing_start_time
            frac = (diff % period) / period
            pose[idx["breathing"]] = (-math.cos(2 * math.pi * frac) + 1.0) / 2.0

        return pose


def create_ifacialmocap_pose_converter(
    args: Optional[IFacialMocapPoseConverterArgs] = None,
) -> IFacialMocapPoseConverter:
    return IFacialMocapPoseConverter(args)
