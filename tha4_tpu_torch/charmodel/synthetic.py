"""Seeded synthetic inputs, for runs without trained weights or shipped art.

``write_distiller_inputs`` writes a synthetic character, an eye-mouth mask
and a ``DistillerConfig`` yaml, from which the students train;
``random_teacher_07`` draws a random mode_07 teacher whose zero-init layers
are brought to life (below).
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

A random mode_07 teacher has the same trouble the other way round: every
U-Net's ResBlock ``conv1``, attention projection and last conv, the
upscaler's ``coarse_image_conv`` and the two grid-change heads start at zero
(``tha4_tpu/models/unet.py:98-101, 640-641``), so its residual branches are
dead and its flows exactly zero.  ``random_teacher_07`` gives those layers
small seeded weights (the precedent of ``tests/test_teacher_nets.py:276-279``):
the residual branches a tenth of the default init, and the grid-change
outputs flows of a few pixels, as a trained teacher's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tha4_tpu_torch.convert.export_torch import save_module_pt
from tha4_tpu_torch.models import siren

FLOW_SCALE = 0.125
# random_teacher_07: the zero-init residual convs at this fraction of
# torch's default U(+-1/sqrt(fan_in)) init; the U-Nets' last convs and the
# grid-change heads N(0, std), the grid-change rows at TEACHER_FLOW_STD.
TEACHER_RESIDUAL_SCALE = 0.1
TEACHER_HEAD_STD = 0.02
TEACHER_FLOW_STD = 5e-4


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


def synthetic_face_mask(size: int = 512, seed: int = 0) -> np.ndarray:
    """(size, size, 3) uint8 RGB eye-mouth mask, 0 or 255 in every channel:
    two eyes and a mouth, seeded ellipses in the red channel, inside the
    face square rows 80:208, cols 192:320 (at 512^2) that the distiller
    crops (``distiller/recipes.load_face_mask_crop``)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) * (512.0 / size)
    red = np.zeros((size, size), dtype=bool)
    for cy, cx, ry, rx in [(132.0, 228.0, 10.0, 16.0), (132.0, 284.0, 10.0, 16.0), (182.0, 256.0, 8.0, 22.0)]:
        cy, cx = cy + rng.uniform(-4.0, 4.0), cx + rng.uniform(-4.0, 4.0)
        red |= ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0
    mask = np.zeros((size, size, 3), dtype=np.uint8)
    mask[..., 0] = np.where(red, 255, 0)
    return mask


@torch.no_grad()
def random_teacher_07(gen: torch.Generator, cfg=None):
    """Seeded random mode_07 teacher params (at ``cfg``'s widths, the
    shipped ones by default) with its zero-init layers made small and
    nonzero; see the module docstring."""
    from tha4_tpu_torch.models import unet
    from tha4_tpu_torch.poser.modes import mode_07

    teacher = mode_07.Teacher.from_params(mode_07.init(gen, cfg), cfg)

    def residual(conv):
        bound = TEACHER_RESIDUAL_SCALE / float(np.sqrt(conv.weight[0].numel()))
        conv.weight.uniform_(-bound, bound, generator=gen)
        conv.bias.uniform_(-bound, bound, generator=gen)

    for net in (teacher.body_morpher.body, teacher.upscaler.body):
        for m in net.modules():
            if isinstance(m, unet.ResBlock):
                residual(m.conv1)
            elif isinstance(m, unet.AttentionBlock):
                residual(m.conv)
        last = net.last[2]
        last.weight.normal_(0.0, TEACHER_HEAD_STD, generator=gen)
        last.bias.normal_(0.0, TEACHER_HEAD_STD, generator=gen)
        c = teacher.cfg.body_morpher.image_channels
        last.weight[c : c + 2].normal_(0.0, TEACHER_FLOW_STD, generator=gen)
        last.bias[c : c + 2].zero_()
    residual(teacher.upscaler.coarse_image_conv)
    for conv in (teacher.eyebrow_morphing_combiner.morphed_eyebrow_layer_grid_change, teacher.face_morpher.iris_mouth_grid_change):
        conv.weight.normal_(0.0, TEACHER_FLOW_STD, generator=gen)
    return teacher.params()


def write_distiller_inputs(directory: str, seed: int = 0, batch_size: int = 8, sample_cadence: Optional[int] = None) -> str:
    """Write ``character.png``, ``face_mask.png`` and ``config.yaml`` (a
    ``DistillerConfig`` with its prefix under ``directory/job`` and both
    students' sample outputs every ``sample_cadence`` examples, off by
    default) into ``directory``; returns the yaml's path."""
    import PIL.Image

    from tha4_tpu_torch.distiller.config import DistillerConfig

    os.makedirs(os.path.join(directory, "job"), exist_ok=True)
    character, mask = os.path.join(directory, "character.png"), os.path.join(directory, "face_mask.png")
    PIL.Image.fromarray(synthetic_character_image(512, seed), mode="RGBA").save(character)
    PIL.Image.fromarray(synthetic_face_mask(512, seed), mode="RGB").save(mask)
    config = DistillerConfig(
        prefix=os.path.join(directory, "job"),
        character_image_file_name=character,
        face_mask_image_file_name=mask,
        face_morpher_num_training_examples_per_sample_output=sample_cadence,
        body_morpher_num_training_examples_per_sample_output=sample_cadence,
        face_morpher_batch_size=batch_size,
        body_morpher_batch_size=batch_size,
    )
    path = os.path.join(directory, "config.yaml")
    config.save(path)
    return path


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
