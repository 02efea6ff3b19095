"""A seeded random-init character model, for runs without trained weights.

``write_random_character_model`` writes the three parts of a character model
(the two student ``.pt`` state dicts, from the port's own init, and a
synthetic 512^2 RGBA character) plus the yaml that ties them together, so
that ``CharacterModel.load(yaml).get_poser(...)`` runs the whole student
frame.  Everything is made from one seed.

One departure from the bare init: the body head's two grid-change rows
(weights and biases) are scaled by ``FLOW_SCALE``.  The He-init head
predicts flows of |grid_change| up to about 1, a quarter of the image, where
a trained student's stay within about 36 px at 512^2
(``tha4_tpu/ops/pallas_warp.py:67``).  At the init's size the bf16 storage
of the flow alone (one bf16 step, about 1 px) dominates a bf16 frame's
error; scaled, the flows are a trained student's size.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tha4_tpu_torch.convert.export_torch import save_module_pt
from tha4_tpu_torch.models import siren

FLOW_SCALE = 0.125


def synthetic_character_image(size: int = 512, seed: int = 0) -> np.ndarray:
    """(size, size, 4) uint8 straight-alpha RGBA: a soft-edged figure of
    smooth colour gradients and blobs on a transparent background."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    # Head-and-body silhouette: two ellipses, soft edges a few pixels wide.
    head = ((x - 0.5) / 0.22) ** 2 + ((y - 0.3) / 0.2) ** 2
    body = ((x - 0.5) / 0.33) ** 2 + ((y - 0.85) / 0.35) ** 2
    inside = np.minimum(head, body)
    alpha = np.clip((1.0 - inside) * 12.0, 0.0, 1.0)
    rgb = np.empty((size, size, 3), np.float32)
    for c in range(3):
        phase = rng.uniform(0.0, 2.0 * np.pi, 2)
        freq = rng.uniform(1.0, 3.0, 2)
        rgb[..., c] = 0.5 + 0.25 * np.sin(2 * np.pi * freq[0] * x + phase[0]) * np.cos(2 * np.pi * freq[1] * y + phase[1])
    for _ in range(6):
        cx, cy = rng.uniform(0.3, 0.7), rng.uniform(0.15, 0.9)
        radius = rng.uniform(0.02, 0.06)
        blob = np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / (2.0 * radius**2)))
        rgb += blob[..., None] * (rng.uniform(0.0, 1.0, 3) - rgb) * 0.8
    out = np.concatenate([np.clip(rgb, 0.0, 1.0), alpha[..., None]], axis=-1)
    return np.uint8(np.rint(out * 255.0))


def write_random_character_model(
    directory: str,
    seed: int = 0,
    face_cfg: Optional[siren.SirenFaceMorpherConfig] = None,
    body_cfg: Optional[siren.SirenMorpherConfig] = None,
) -> str:
    """Write a random-init character model into ``directory``; returns the
    path of its ``character_model.yaml``.  The configurations default to the
    shipped ones (full width)."""
    import PIL.Image

    from tha4_tpu_torch.charmodel.character_model import CharacterModel

    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    face = siren.SirenFaceMorpher(face_cfg, generator=gen)
    body = siren.SirenMorpher(body_cfg, generator=gen)
    with torch.no_grad():
        body.last_linear.weight[0:2] *= FLOW_SCALE
        body.last_linear.bias[0:2] *= FLOW_SCALE
    paths = {name: os.path.join(directory, name) for name in ("character.png", "face_morpher.pt", "body_morpher.pt")}
    size = body.cfg.image_size
    PIL.Image.fromarray(synthetic_character_image(size, seed), mode="RGBA").save(paths["character.png"])
    save_module_pt(face, paths["face_morpher.pt"])
    save_module_pt(body, paths["body_morpher.pt"])
    yaml_path = os.path.join(directory, "character_model.yaml")
    CharacterModel(paths["character.png"], paths["face_morpher.pt"], paths["body_morpher.pt"]).save(yaml_path)
    return yaml_path
