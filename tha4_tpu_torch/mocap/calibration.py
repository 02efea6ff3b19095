"""Calibration files: the headless equivalent of the reference's wx panels
(counterpart of ``tha4_tpu/mocap/calibration.py``; the same JSON format, so
a file saved by either package loads in the other).

The reference embeds an interactive calibration panel in each pose converter
(reference: src/tha4/mocap/ifacialmocap_pose_converter_25.py:188-345 — smile
thresholds, eyebrow-down mode, wink mode, iris sizes, breathing frequency;
mediapipe_face_pose_converter_00.py adds a head-neutral 'Calibrate' button
:385-391).  Without a GUI the same workflow is:

  * ``save_calibration(args, path)`` / ``load_calibration(path)`` — all
    calibration parameters as a JSON file (enums by name), reusable across
    sessions;
  * ``apply_overrides(args, ["smile_threshold_min=0.3", ...])`` — one-shot
    CLI tweaks (``tha4-torch-puppeteer --set ...``);
  * the mediapipe converter's ``calibrate(face_pose)`` sets the neutral-head
    offsets from the current frame, then the file persists them.
"""

from __future__ import annotations

import json
from typing import Dict, List, Union

from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import (
    EyebrowDownMode,
    IFacialMocapPoseConverterArgs,
    WinkMode,
)
from tha4_tpu_torch.mocap.mediapipe_face_pose_converter import MediaPipeFacePoseConverterArgs

_ENUM_FIELDS = {"eyebrow_down_mode": EyebrowDownMode, "wink_mode": WinkMode}

AnyArgs = Union[IFacialMocapPoseConverterArgs, MediaPipeFacePoseConverterArgs]


def calibration_to_dict(args: AnyArgs) -> Dict:
    out = {"kind": type(args).__name__}
    for key, value in vars(args).items():
        if key in _ENUM_FIELDS:
            out[key] = value.name
        else:
            out[key] = value
    return out


def save_calibration(args: AnyArgs, path: str) -> None:
    with open(path, "w") as f:
        json.dump(calibration_to_dict(args), f, indent=2, sort_keys=True)
        f.write("\n")


def load_calibration(path: str) -> AnyArgs:
    with open(path) as f:
        data = json.load(f)
    kind = data.pop("kind", "IFacialMocapPoseConverterArgs")
    cls = {
        "IFacialMocapPoseConverterArgs": IFacialMocapPoseConverterArgs,
        "MediaPipeFacePoseConverterArgs": MediaPipeFacePoseConverterArgs,
    }[kind]
    args = cls()
    _assign(args, data)
    return args


def _assign(args: AnyArgs, data: Dict) -> None:
    valid = vars(args)
    for key, value in data.items():
        if key not in valid:
            raise KeyError(f"unknown calibration parameter {key!r}; valid: {sorted(valid)}")
        if key in _ENUM_FIELDS:
            value = _ENUM_FIELDS[key][value] if isinstance(value, str) else _ENUM_FIELDS[key](value)
        setattr(args, key, value)


def apply_overrides(args: AnyArgs, overrides: List[str]) -> AnyArgs:
    """Apply ``key=value`` strings (CLI --set) onto a converter args object."""
    data: Dict = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"--set expects key=value, got {item!r}")
        key, _, raw = item.partition("=")
        key = key.strip()
        raw = raw.strip()
        if key in _ENUM_FIELDS:
            data[key] = raw.upper()
        else:
            data[key] = float(raw)
    _assign(args, data)
    return args
