"""The two distillation recipes, face student and body student
(counterpart of ``tha4_tpu/distiller/recipes.py``).

  * Face: teacher = mode_12's face morph (192x192), cropped to the 128x128
    square the student paints; student input = pose[0:39]; loss = L1 + 20 x
    masked L1 over the eye-mouth mask; lr 1e-4, /3, /10, /30 at 200k, 500k,
    800k examples; 1M examples.
  * Body: teacher = mode_07's outputs 0 (posed), 2 (warped), 3 (grid
    change) and 5 (face_morphed_full, the student's input image); four L1
    terms (blended and colour change against the posed label, warped, grid
    change) weighted, with the lr, by six phases; 1.5M examples.

Both use Adam(0.9, 0.999, eps 1e-8) with the lr set before every step
(``torch.optim.Adam`` makes the update of optax ``scale_by_adam`` followed
by p -= lr * u).  One step: the frozen teacher labels the batch (no
gradient, the teacher's dtype; int8 convolutions under ``teacher_quant``,
the scales ``ops.quant`` calibrated), then one exact student update.  The JAX
package can label K batches ahead in one teacher call (lookahead) to fill a
chip at a small per-chip batch; on one card at batch 8 it uses K = 1, which
is what runs here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.poser.modes import mode_07, mode_12
from tha4_tpu_torch.training import losses
from tha4_tpu_torch.training.schedules import TrainingPhase, TrainingPhases, step_lr_schedule

# The student's 128x128 square within the teacher's 192x192 face morph:
# centre (96, 112) there, (256, 144) in the 512x512 frame.
FACE_CROP_Y0, FACE_CROP_X0 = 48, 32
FACE_CROP_SIZE = 128

BODY_LOSS_TERMS = ("full_blended", "full_warped", "full_grid_change", "full_color_change")

FACE_MORPHER_TOTAL_EXAMPLES = 1_000_000
BODY_MORPHER_TOTAL_EXAMPLES = 1_500_000
EXAMPLES_PER_CHECKPOINT = 100_000


def default_body_phases() -> TrainingPhases:
    """The reference's six body phases (``tha4_tpu/distiller/recipes.py:56-70``)."""
    w_a = {"full_blended": 0.25, "full_warped": 0.25, "full_grid_change": 0.5, "full_color_change": 2.0}
    w_b = {"full_blended": 1.0, "full_warped": 2.5, "full_grid_change": 5.0, "full_color_change": 1.0}
    w_c = {"full_blended": 10.0, "full_warped": 1.0, "full_grid_change": 1.0, "full_color_change": 1.0}
    return TrainingPhases(
        [
            TrainingPhase(200_000, 1e-4, w_a),
            TrainingPhase(400_000, 3e-5, w_a),
            TrainingPhase(600_000, 3e-5, w_b),
            TrainingPhase(800_000, 1e-5, w_b),
            TrainingPhase(1_300_000, 1e-5, w_c),
            TrainingPhase(1_500_000, 3e-6, w_c),
        ]
    )


def default_face_lr_fn(base_lr: float = 1e-4) -> Callable[[int], float]:
    return step_lr_schedule(base_lr, [200_000, 500_000, 800_000], [3.0, 10.0, 30.0])


def make_adam(module: torch.nn.Module) -> torch.optim.Adam:
    """The recipe's optimizer; the lr is set before every step."""
    return torch.optim.Adam(module.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def load_face_mask_crop(face_mask_file_name: str) -> np.ndarray:
    """The eye-mouth mask: the red channel of the 512x512 mask PNG over the
    face square, repeated to 4 channels; (128, 128, 4) f32 in [0, 1]."""
    from tha4_tpu_torch.core import imagecodec

    loaded = imagecodec.load_image_hwc(face_mask_file_name, scale=1.0, offset=0.0, premultiply_alpha=True)
    crop = loaded[80:208, 192:320, 0:1]
    return np.repeat(crop, 4, axis=2).astype(np.float32)


@torch.no_grad()
def face_teacher_targets(teacher: mode_12.FaceTeacher, image: torch.Tensor, poses: torch.Tensor, dtype: torch.dtype,
                         teacher_quant: Optional[List[dict]] = None) -> torch.Tensor:
    """The teacher's face morph over the student's square, in ``dtype``:
    image (1, 512, 512, 4), poses (N, 45) -> (N, 128, 128, 4).
    ``teacher_quant``: the int8 teacher's calibrated scales (``ops.quant``),
    or None for the teacher in ``dtype``."""
    n = poses.shape[0]
    image_b = image.to(dtype).expand(n, *image.shape[1:])
    with quant.apply_scales(teacher_quant):
        face = mode_12.compute_outputs(teacher, image_b, poses.to(dtype))[mode_12.INDEX_FACE_MORPHED_IMAGE]
    return face[:, FACE_CROP_Y0 : FACE_CROP_Y0 + FACE_CROP_SIZE, FACE_CROP_X0 : FACE_CROP_X0 + FACE_CROP_SIZE, :]


def face_loss(student: siren.SirenFaceMorpher, target: torch.Tensor, mask: torch.Tensor, poses: torch.Tensor, dtype: torch.dtype):
    """(total, named) for one batch.  The student's pose is rounded to the
    compute dtype first (as the JAX recipe casts it) and widened to f32 for
    the kernel; target and prediction are widened to f32 for the loss."""
    pose = poses[:, : student.cfg.pose_size].to(dtype).float()
    return face_loss_terms(siren.siren_face_morpher_train_apply(student, pose, dtype), target, mask)


def face_loss_terms(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """L1 + 20 x masked L1 of the student's prediction, both widened to f32."""
    gt, pred = target.float(), pred.float()
    return losses.sum_named(
        [("full", losses.l1(gt, pred, weight=1.0)), ("eye_mouth", losses.masked_l1(gt, pred, mask[None], weight=20.0))]
    )


def adam_step(optimizer: torch.optim.Optimizer, total: torch.Tensor, named, lr: float) -> Dict[str, torch.Tensor]:
    """Backward from ``total``, then one Adam step at ``lr`` (the gradients
    were zeroed before the forward); returns the named losses."""
    total.backward()
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return {k: v.detach() for k, v in named.items()}


def student_update(student, optimizer: torch.optim.Optimizer, target, mask, poses, lr: float, dtype) -> Dict[str, torch.Tensor]:
    """One exact Adam step on the face loss; returns the named losses."""
    optimizer.zero_grad(set_to_none=True)
    return adam_step(optimizer, *face_loss(student, target, mask, poses, dtype), lr)


def make_face_distill_step(teacher: mode_12.FaceTeacher, image: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype,
                           teacher_quant: Optional[List[dict]] = None):
    """step(student, optimizer, poses, lr) -> named losses: the teacher's
    labels for ``poses`` (int8 under ``teacher_quant``), then one student
    update."""

    def step(student, optimizer, poses, lr):
        target = face_teacher_targets(teacher, image, poses, dtype, teacher_quant)
        return student_update(student, optimizer, target, mask, poses, lr, dtype)

    return step


# ---------------------------------------------------------------------------
# Body student
# ---------------------------------------------------------------------------


@torch.no_grad()
def body_teacher_targets(teacher: mode_07.Teacher, image: torch.Tensor, poses: torch.Tensor, dtype: torch.dtype,
                         teacher_quant: Optional[List[dict]] = None) -> Tuple[torch.Tensor, ...]:
    """(posed, warped, grid change, face_morphed_full), each (N, 512, 512, *)
    in ``dtype``, the teacher's (int8 under ``teacher_quant``): image (1,
    512, 512, 4), poses (N, 45)."""
    n = poses.shape[0]
    image_b = image.to(dtype).expand(n, *image.shape[1:])
    with quant.apply_scales(teacher_quant):
        t = mode_07.compute_outputs(teacher, image_b, poses.to(dtype))
    return tuple(t[i] for i in (0, 2, 3, mode_07.INDEX_FACE_MORPHED_FULL))


def body_loss_terms(outs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor], weights: Mapping[str, float]):
    """The four weighted L1 terms, prediction and label widened to f32; the
    colour change is held against the posed (blended) label, as the
    reference's trainer does."""
    gt_posed, gt_warped, gt_grid = (t.float() for t in targets[:3])
    pred = {
        name: outs[index].float()
        for name, index in [
            ("blended", siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE),
            ("warped", siren.SIREN_MORPHER_INDEX_WARPED_IMAGE),
            ("grid", siren.SIREN_MORPHER_INDEX_GRID_CHANGE),
            ("color", siren.SIREN_MORPHER_INDEX_COLOR_CHANGE),
        ]
    }
    return losses.sum_named(
        [
            ("full_blended", losses.l1(gt_posed, pred["blended"], weights["full_blended"])),
            ("full_warped", losses.l1(gt_warped, pred["warped"], weights["full_warped"])),
            ("full_grid_change", losses.l1(gt_grid, pred["grid"], weights["full_grid_change"])),
            ("full_color_change", losses.l1(gt_posed, pred["color"], weights["full_color_change"])),
        ]
    )


def body_loss(student: siren.SirenMorpher, targets, poses: torch.Tensor, weights: Mapping[str, float], dtype: torch.dtype, mixed: bool):
    """(total, named) for one batch: the student's five outputs on the
    teacher's face_morphed_full (in ``dtype``) and the poses."""
    outs = siren.siren_morpher_train_apply(student, targets[3].to(dtype), poses, dtype, mixed)
    return body_loss_terms(outs, targets, weights)


def make_body_distill_step(teacher: mode_07.Teacher, image: torch.Tensor, dtype: torch.dtype, mixed: bool = False,
                           teacher_quant: Optional[List[dict]] = None):
    """step(student, optimizer, poses, lr, weights) -> named losses: the
    teacher's labels for ``poses`` (int8 under ``teacher_quant``), then one
    student update with the loss weights ``{term: weight}`` of
    ``BODY_LOSS_TERMS``."""

    def step(student, optimizer, poses, lr, weights):
        targets = body_teacher_targets(teacher, image, poses, dtype, teacher_quant)
        optimizer.zero_grad(set_to_none=True)
        return adam_step(optimizer, *body_loss(student, targets, poses, weights, dtype, mixed), lr)

    return step
