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
the scales ``ops.quant`` calibrated), then one exact student update.

The body recipe's ``teacher_dtype`` (None: the student's ``dtype``) sets
the frozen teacher's activation dtype apart from the student's, as the JAX
recipe's does: the teacher runs on the image and poses in its dtype, its
labels stay in it (the loss widens them to f32), and the student's input,
face_morphed_full, is cast to the student's dtype.  The caller freezes
the teacher in that dtype (``Teacher.freeze``); a teacher frozen in
another raises.

Teacher lookahead (the JAX package's ``lookahead``): the teacher is frozen,
so a group of K consecutive steps can be labelled in one teacher call at
K times the batch, then K exact student updates follow in order; the
update stream is K = 1's, only the teacher's batch grows.
``default_lookahead`` sizes K so that each rank's teacher batch reaches
``TEACHER_SATURATION_BATCH``: at batch 8 on one card K is 1; at 4 a rank
(batch 8 over 2 ranks) K is 2.  The student's forward goes through
``parallel.mesh.apply``, so under a ``data_parallel`` replica its backward
averages the gradients over the ranks.

Each phase of a step is a ``utils.profiling`` span: ``distill.labels`` (the
teacher's call, with mode_07's per-network spans inside),
``distill.forward`` (the student's forward and the loss terms),
``distill.backward`` and ``distill.adam`` (the gradients' zeroing before
the forward, and the update after the backward).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.parallel import mesh
from tha4_tpu_torch.poser.modes import mode_07, mode_12
from tha4_tpu_torch.training import losses
from tha4_tpu_torch.training.schedules import TrainingPhase, TrainingPhases, step_lr_schedule
from tha4_tpu_torch.utils import profiling

# The student's 128x128 square within the teacher's 192x192 face morph:
# centre (96, 112) there, (256, 144) in the 512x512 frame.
FACE_CROP_Y0, FACE_CROP_X0 = 48, 32
FACE_CROP_SIZE = 128

BODY_LOSS_TERMS = ("full_blended", "full_warped", "full_grid_change", "full_color_change")

FACE_MORPHER_TOTAL_EXAMPLES = 1_000_000
BODY_MORPHER_TOTAL_EXAMPLES = 1_500_000
EXAMPLES_PER_CHECKPOINT = 100_000


# The per-rank teacher batch that lookahead fills up to: the recipes' batch,
# at which one card runs the shipped recipe with K = 1
# (``tha4_tpu/distiller/recipes.py:77-89``, where the value was chosen for
# the TPU).  On an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase
# 16) a bf16 teacher call of 8 poses labels a pose in 0.48-0.52 (body) and
# 0.61-0.63 (face) of the time a call of 4 takes; whether more than 8 would
# pay again there is not measured.
TEACHER_SATURATION_BATCH = 8


def default_lookahead(batch_size: int, world_size: int = 1) -> int:
    """The lookahead K that brings each rank's teacher batch, ``batch_size
    / world_size``, up to ``TEACHER_SATURATION_BATCH`` (1: plain steps)."""
    per_rank = max(1, batch_size // max(1, world_size))
    return max(1, TEACHER_SATURATION_BATCH // per_rank)


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
    with profiling.span("distill.labels"):
        n = poses.shape[0]
        image_b = image.to(dtype).expand(n, *image.shape[1:])
        with quant.apply_scales(teacher_quant):
            face = mode_12.compute_outputs(teacher, image_b, poses.to(dtype))[mode_12.INDEX_FACE_MORPHED_IMAGE]
        return face[:, FACE_CROP_Y0 : FACE_CROP_Y0 + FACE_CROP_SIZE, FACE_CROP_X0 : FACE_CROP_X0 + FACE_CROP_SIZE, :]


def face_loss(student: siren.SirenFaceMorpher, target: torch.Tensor, mask: torch.Tensor, poses: torch.Tensor, dtype: torch.dtype):
    """(total, named) for one batch.  The student's pose is rounded to the
    compute dtype first (as the JAX recipe casts it) and widened to f32 for
    the kernel; target and prediction are widened to f32 for the loss."""
    with profiling.span("distill.forward"):
        pose = poses[:, : mesh.unwrap(student).cfg.pose_size].to(dtype).float()
        return face_loss_terms(mesh.apply(student, siren.siren_face_morpher_train_apply, pose, dtype), target, mask)


def face_loss_terms(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """L1 + 20 x masked L1 of the student's prediction, both widened to f32."""
    gt, pred = target.float(), pred.float()
    return losses.sum_named(
        [("full", losses.l1(gt, pred, weight=1.0)), ("eye_mouth", losses.masked_l1(gt, pred, mask[None], weight=20.0))]
    )


def adam_step(optimizer: torch.optim.Optimizer, total: torch.Tensor, named, lr: float) -> Dict[str, torch.Tensor]:
    """Backward from ``total``, then one Adam step at ``lr`` (the gradients
    were zeroed before the forward); returns the named losses."""
    with profiling.span("distill.backward"):
        total.backward()
    with profiling.span("distill.adam"):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    return {k: v.detach() for k, v in named.items()}


def student_update(student, optimizer: torch.optim.Optimizer, target, mask, poses, lr: float, dtype) -> Dict[str, torch.Tensor]:
    """One exact Adam step on the face loss; returns the named losses."""
    with profiling.span("distill.adam"):
        optimizer.zero_grad(set_to_none=True)
    return adam_step(optimizer, *face_loss(student, target, mask, poses, dtype), lr)


def make_face_distill_group(teacher: mode_12.FaceTeacher, image: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype,
                            teacher_quant: Optional[List[dict]] = None):
    """group(student, optimizer, poses_list, lrs) -> the last step's named
    losses: the teacher labels the K batches of ``poses_list`` in one call
    (int8 under ``teacher_quant``), then K student updates, batch j at
    ``lrs[j]``."""

    def group(student, optimizer, poses_list, lrs):
        poses = torch.cat(poses_list) if len(poses_list) > 1 else poses_list[0]
        targets = face_teacher_targets(teacher, image, poses, dtype, teacher_quant).split([len(p) for p in poses_list])
        for target, batch, lr in zip(targets, poses_list, lrs):
            named = student_update(student, optimizer, target, mask, batch, lr, dtype)
        return named

    return group


def make_face_distill_step(teacher: mode_12.FaceTeacher, image: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype,
                           teacher_quant: Optional[List[dict]] = None):
    """step(student, optimizer, poses, lr) -> named losses: the teacher's
    labels for ``poses`` (int8 under ``teacher_quant``), then one student
    update."""
    group = make_face_distill_group(teacher, image, mask, dtype, teacher_quant)

    def step(student, optimizer, poses, lr):
        return group(student, optimizer, [poses], [lr])

    return step


# ---------------------------------------------------------------------------
# Body student
# ---------------------------------------------------------------------------


def frozen_dtype(teacher: torch.nn.Module) -> torch.dtype:
    """The dtype ``Teacher.freeze`` stored the teacher's convolutions in
    (its first conv's weight; norms and linears stay f32)."""
    return next(m.weight.dtype for m in teacher.modules() if isinstance(m, torch.nn.Conv2d))


@torch.no_grad()
def body_teacher_targets(teacher: mode_07.Teacher, image: torch.Tensor, poses: torch.Tensor, dtype: torch.dtype,
                         teacher_quant: Optional[List[dict]] = None,
                         teacher_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """(posed, warped, grid change, face_morphed_full), each (N, 512, 512, *)
    in the teacher's dtype, ``teacher_dtype`` or else ``dtype`` (int8
    convolutions under ``teacher_quant``): image (1, 512, 512, 4), poses
    (N, 45).  Raises where the teacher was frozen in another dtype."""
    with profiling.span("distill.labels"):
        t_dtype = teacher_dtype or dtype
        if frozen_dtype(teacher) != t_dtype:
            raise ValueError(f"the teacher was frozen in {frozen_dtype(teacher)}, but its labels are asked for in {t_dtype}")
        n = poses.shape[0]
        image_b = image.to(t_dtype).expand(n, *image.shape[1:])
        with quant.apply_scales(teacher_quant):
            t = mode_07.compute_outputs(teacher, image_b, poses.to(t_dtype))
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
    with profiling.span("distill.forward"):
        outs = mesh.apply(student, siren.siren_morpher_train_apply, targets[3].to(dtype), poses, dtype, mixed)
        return body_loss_terms(outs, targets, weights)


def make_body_distill_group(teacher: mode_07.Teacher, image: torch.Tensor, dtype: torch.dtype, mixed: bool = False,
                            teacher_quant: Optional[List[dict]] = None, teacher_dtype: Optional[torch.dtype] = None):
    """group(student, optimizer, poses_list, lrs, weights_list) -> the last
    step's named losses: the teacher labels the K batches in one call (int8
    under ``teacher_quant``; in ``teacher_dtype``, None for ``dtype``), then
    K student updates in ``dtype``, batch j at ``lrs[j]`` with the loss
    weights ``weights_list[j]`` (``{term: weight}`` of ``BODY_LOSS_TERMS``)."""

    def group(student, optimizer, poses_list, lrs, weights_list):
        poses = torch.cat(poses_list) if len(poses_list) > 1 else poses_list[0]
        sizes = [len(p) for p in poses_list]
        labels = [t.split(sizes) for t in body_teacher_targets(teacher, image, poses, dtype, teacher_quant, teacher_dtype)]
        for j, (batch, lr, weights) in enumerate(zip(poses_list, lrs, weights_list)):
            with profiling.span("distill.adam"):
                optimizer.zero_grad(set_to_none=True)
            targets = tuple(t[j] for t in labels)
            named = adam_step(optimizer, *body_loss(student, targets, batch, weights, dtype, mixed), lr)
        return named

    return group


def make_body_distill_step(teacher: mode_07.Teacher, image: torch.Tensor, dtype: torch.dtype, mixed: bool = False,
                           teacher_quant: Optional[List[dict]] = None, teacher_dtype: Optional[torch.dtype] = None):
    """step(student, optimizer, poses, lr, weights) -> named losses: the
    teacher's labels for ``poses`` (int8 under ``teacher_quant``; in
    ``teacher_dtype``, None for ``dtype``), then one student update in
    ``dtype`` with the loss weights ``{term: weight}`` of
    ``BODY_LOSS_TERMS``."""
    group = make_body_distill_group(teacher, image, dtype, mixed, teacher_quant, teacher_dtype)

    def step(student, optimizer, poses, lr, weights):
        return group(student, optimizer, [poses], [lr], [weights])

    return step
