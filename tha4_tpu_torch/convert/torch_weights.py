"""Reading the reference ``.pt`` student state dicts
(counterpart of ``tha4_tpu/convert/torch_weights.py``).

The port's student modules use the reference key layout directly, so a state
dict needs no conversion: only its widths and depths are read off the
tensor shapes, so that a character model of any trained width loads.  The
image sizes of the levels are the shipped ones (128^2, 256^2, 512^2).
"""

from __future__ import annotations

from typing import Dict

import torch

from tha4_tpu_torch.models import siren


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Deserialize a ``.pt`` state dict onto the CPU, tensors only."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _count(sd, fmt: str) -> int:
    i = 0
    while fmt.format(i) in sd:
        i += 1
    return i


def face_config_from_state_dict(sd: Dict[str, torch.Tensor]) -> siren.SirenFaceMorpherConfig:
    num_sine = _count(sd, "siren.sine_layers.{}.linear.weight")
    if num_sine == 0:
        raise KeyError("not a SirenFaceMorpher state dict: no siren.sine_layers.0.linear.weight")
    first = sd["siren.sine_layers.0.linear.weight"]
    last = sd["siren.last_linear.weight"]
    default = siren.SirenFaceMorpherConfig()
    return siren.SirenFaceMorpherConfig(
        image_size=default.image_size,
        image_channels=last.shape[0],
        pose_size=first.shape[1] - 2,
        siren=siren.SirenConfig(
            in_channels=first.shape[1], out_channels=last.shape[0],
            intermediate_channels=first.shape[0], num_sine_layers=num_sine,
        ),
    )


def body_config_from_state_dict(sd: Dict[str, torch.Tensor]) -> siren.SirenMorpherConfig:
    default = siren.SirenMorpherConfig()
    num_levels = _count(sd, "siren_layers.{}.0.linear.weight")
    if num_levels != len(default.levels):
        raise KeyError(f"expected a SirenMorpher state dict with {len(default.levels)} levels, found {num_levels}")
    levels = tuple(
        siren.SirenMorpherLevelConfig(
            lv.image_size,
            sd[f"siren_layers.{i}.0.linear.weight"].shape[0],
            _count(sd, f"siren_layers.{i}.{{}}.linear.weight"),
        )
        for i, lv in enumerate(default.levels)
    )
    return siren.SirenMorpherConfig(
        image_size=default.image_size,
        image_channels=sd["last_linear.weight"].shape[0] - 3,
        pose_size=sd["siren_layers.0.0.linear.weight"].shape[1] - 2,
        levels=levels,
    )


def face_morpher_from_state_dict(sd: Dict[str, torch.Tensor]) -> siren.SirenFaceMorpher:
    module = siren.SirenFaceMorpher(face_config_from_state_dict(sd))
    module.load_state_dict(sd)
    return module


def body_morpher_from_state_dict(sd: Dict[str, torch.Tensor]) -> siren.SirenMorpher:
    module = siren.SirenMorpher(body_config_from_state_dict(sd))
    module.load_state_dict(sd)
    return module


def load_face_morpher(path: str) -> siren.SirenFaceMorpher:
    return face_morpher_from_state_dict(load_torch_state_dict(path))


def load_body_morpher(path: str) -> siren.SirenMorpher:
    return body_morpher_from_state_dict(load_torch_state_dict(path))
