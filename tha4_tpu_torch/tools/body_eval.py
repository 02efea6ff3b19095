"""The body student held against the f32 teacher on a pose set: the
evaluation that ``dtype_ab``, ``quant_ab`` and ``eval_body_checkpoint``
report (counterpart of the ``eval_losses`` / ``evaluate`` pair in each of
``tools/dtype_ab.py:83-117``, ``tools/quant_ab.py:67-93`` and
``tools/eval_body_checkpoint.py:85-107``).

Per batch of ``batch`` poses: the f32 teacher's outputs 0 (posed), 2
(warped), 3 (grid change) and 5 (face_morphed_full); the student on output
5 cast to ``student_dtype``; the L1 of the blended, warped and grid-change
outputs against their labels and the blended output's MSE, each a mean in
f32.  The four are summed in f64 over ``len(poses) // batch`` batches and
divided by that count; PSNR = 10 log10(4 / max(mse, 1e-12)), images being
[-1, 1].

Also what the four tools share: the device from ``--device`` (a CUDA
device by default; a machine without one raises unless ``--device cpu``
asks for the plain versions), the character image, the card's name, and
the ``--json`` file whose arms a run merges into.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from tha4_tpu_torch.distiller import recipes
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_07

METRICS = ("blended_l1", "warped_l1", "grid_l1", "psnr_vs_f32")
EVAL_SEED = 0xE7A1  # the held-out poses, in every tool


def resolve_device(name: str) -> torch.device:
    """``--device``: a CUDA device raises where none is visible; nothing
    falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is visible; --device cpu runs the kernels' plain versions")
    return device


def card(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them; None
    on the CPU."""
    from tha4_tpu_torch.tools import bench

    return bench.card(device) if device.type == "cuda" else None


def character_image(model: Optional[str], device) -> torch.Tensor:
    """(1, 512, 512, 4) f32 in model units on ``device``: the image of the
    character model ``model`` (a ``character_model.yaml``), or, without
    one, ``charmodel.synthetic.synthetic_character_image(512, 0)``."""
    from tha4_tpu_torch.core import imagecodec

    if model:
        from tha4_tpu_torch.charmodel.character_model import CharacterModel

        image = CharacterModel.load(model).get_character_image()
    else:
        import PIL.Image

        from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image

        image = imagecodec.load_image_hwc(PIL.Image.fromarray(synthetic_character_image(512, 0), mode="RGBA"))
    return torch.from_numpy(np.ascontiguousarray(image))[None].to(device)


def load_results(json_path: Optional[str]) -> dict:
    """The arms already in ``json_path``'s ``results``, if the file is there."""
    if json_path and os.path.isfile(json_path):
        with open(json_path) as f:
            return json.load(f).get("results", {})
    return {}


def write_json(json_path: str, record: dict) -> None:
    """Write ``record`` through a temporary file and a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path + ".tmp", "w") as f:
        json.dump(record, f, indent=2)
    os.replace(json_path + ".tmp", json_path)


@torch.no_grad()
def evaluate_body_student(teacher_f32: mode_07.Teacher, student: siren.SirenMorpher, image: torch.Tensor, poses, batch: int,
                          student_dtype: torch.dtype = torch.float32, mixed: bool = False) -> Dict[str, float]:
    """``teacher_f32``: mode_07 frozen in f32; ``image`` (1, 512, 512, 4)
    f32 on the teacher's device; ``poses`` (n, 45), numpy or a tensor.
    The student runs its training forward (``siren_morpher_train_apply``)
    in ``student_dtype``, selective f32 where ``mixed``.  No gradient is
    taken and nothing runs under ``inference_mode``, so the constants it
    caches serve a later training step."""
    if recipes.frozen_dtype(teacher_f32) != torch.float32:
        raise ValueError(f"the evaluation's teacher must be frozen in f32, not {recipes.frozen_dtype(teacher_f32)}")
    poses = torch.as_tensor(np.asarray(poses, np.float32))
    batches = len(poses) // batch
    if batches == 0:
        raise ValueError(f"{len(poses)} poses make no batch of {batch}")
    acc = np.zeros(4, np.float64)
    for i in range(batches):
        p = poses[i * batch : (i + 1) * batch].to(image.device)
        t = mode_07.compute_outputs(teacher_f32, image.expand(batch, *image.shape[1:]), p)
        gt_posed, gt_warped, gt_grid = (t[j].float() for j in (0, 2, 3))
        outs = siren.siren_morpher_train_apply(student, t[mode_07.INDEX_FACE_MORPHED_FULL].to(student_dtype), p,
                                               student_dtype, mixed)
        pred_blended, pred_warped, pred_grid = (outs[j].float() for j in (siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE,
                                                                          siren.SIREN_MORPHER_INDEX_WARPED_IMAGE,
                                                                          siren.SIREN_MORPHER_INDEX_GRID_CHANGE))
        terms = torch.stack([(gt_posed - pred_blended).abs().mean(), (gt_warped - pred_warped).abs().mean(),
                             (gt_grid - pred_grid).abs().mean(), ((gt_posed - pred_blended) ** 2).mean()])
        acc += terms.cpu().numpy().astype(np.float64)
    acc /= batches
    psnr = 10.0 * np.log10(4.0 / max(acc[3], 1e-12))
    return {"blended_l1": float(acc[0]), "warped_l1": float(acc[1]), "grid_l1": float(acc[2]), "psnr_vs_f32": float(psnr)}
