"""Distillation jobs: config -> trainers (counterpart of
``tha4_tpu/distiller/pipeline.py``).

    DistillationJobs(config, teacher_params_12=..., face_total_examples=...,
                     examples_per_checkpoint=...).make_face_trainer().train()
    DistillationJobs(config, teacher_params_07=..., body_total_examples=...,
                     ...).make_body_trainer(phases=None).train()

The teachers are injected as reference state dicts (``mode_07.init`` /
``mode_12.init`` make seeded random ones; mode_12's are mode_07's first
three where only mode_07's are given) or, failing that, loaded from the
``data/tha4/*.pt`` files.  Not here yet: the file-task DAG and the
``tha4-distill`` command, sample grids (``distiller/sample_output.py``) and
student export; more than one GPU waits for the data-parallel slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tha4_tpu_torch.distiller import recipes
from tha4_tpu_torch.distiller.config import POSE_DATASET_FILE_NAME, DistillerConfig
from tha4_tpu_torch.distiller.pose_dataset import PoseSource
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_07, mode_12
from tha4_tpu_torch.training.schedules import TrainingPhases
from tha4_tpu_torch.training.trainer import Trainer, TrainerConfig


class DistillationJobs:
    """Builds the two students' trainings for one config.

    ``student_mixed`` (the JAX package's default): the body student trains
    in selective f32, bf16 matmul operands with f32 sums, sines and head."""

    def __init__(
        self,
        config: DistillerConfig,
        teacher_params_07: Optional[mode_07.Params] = None,
        teacher_params_12: Optional[mode_12.Params] = None,
        teacher_cfg_07: Optional[mode_07.TeacherConfig] = None,
        teacher_cfg_12: Optional[mode_12.FaceTeacherConfig] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        face_total_examples: int = recipes.FACE_MORPHER_TOTAL_EXAMPLES,
        body_total_examples: int = recipes.BODY_MORPHER_TOTAL_EXAMPLES,
        examples_per_checkpoint: int = recipes.EXAMPLES_PER_CHECKPOINT,
        examples_per_snapshot: int = 10_000,
        student_mixed: bool = True,
    ):
        if config.num_gpus > 1:
            raise NotImplementedError(f"num_gpus = {config.num_gpus}: training on more than one GPU waits for the port's data-parallel slice")
        self.config = config
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.teacher_cfg_07 = teacher_cfg_07 or mode_07.TeacherConfig()
        self.teacher_cfg_12 = teacher_cfg_12 or mode_12.FaceTeacherConfig()
        self._teacher_params_07 = teacher_params_07
        self._teacher_params_12 = teacher_params_12
        self.face_total_examples = face_total_examples
        self.body_total_examples = body_total_examples
        self.examples_per_checkpoint = examples_per_checkpoint
        self.examples_per_snapshot = examples_per_snapshot
        self.student_mixed = student_mixed
        self.face_student_cfg = siren.SirenFaceMorpherConfig()
        self.body_student_cfg = siren.SirenMorpherConfig()
        self.pose_source = PoseSource(POSE_DATASET_FILE_NAME)

    def character_image(self) -> torch.Tensor:
        """(1, 512, 512, 4) f32 in model units, on the device."""
        from tha4_tpu_torch.core import imagecodec

        return torch.from_numpy(imagecodec.load_image_hwc(self.config.character_image_file_name))[None].to(self.device)

    def teacher_params_07(self) -> mode_07.Params:
        if self._teacher_params_07 is None:
            self._teacher_params_07 = mode_07.load_params_from_torch()
        return self._teacher_params_07

    def teacher_params_12(self) -> mode_12.Params:
        if self._teacher_params_12 is None:
            if self._teacher_params_07 is not None:
                self._teacher_params_12 = {k: self._teacher_params_07[k] for k in mode_12.NETWORK_KEYS}
            else:
                self._teacher_params_12 = mode_12.load_params_from_torch()
        return self._teacher_params_12

    def checkpoint_boundaries(self, total: int):
        return [self.examples_per_checkpoint * (i + 1) for i in range(total // self.examples_per_checkpoint)]

    @staticmethod
    def _refuse_sample_outputs(name: str, cadence) -> None:
        if cadence is not None:
            raise NotImplementedError(
                f"{name} is set, but sample outputs (distiller/sample_output.py) are not ported yet: set it to null"
            )

    def make_face_trainer(self) -> Trainer:
        config = self.config
        self._refuse_sample_outputs("face_morpher_num_training_examples_per_sample_output",
                                    config.face_morpher_num_training_examples_per_sample_output)
        dtype, device = self.compute_dtype, self.device
        teacher = mode_12.FaceTeacher.from_params(self.teacher_params_12(), self.teacher_cfg_12).freeze(dtype, device)
        mask = torch.from_numpy(recipes.load_face_mask_crop(config.face_mask_image_file_name)).to(device)
        step = recipes.make_face_distill_step(teacher, self.character_image(), mask, dtype)
        batch = config.face_morpher_batch_size

        def init_module(gen):
            return siren.SirenFaceMorpher(self.face_student_cfg, generator=gen).to(device)

        def train_step(student, optimizer, gen, lr, weights):
            return step(student, optimizer, self.pose_source.batch(gen, batch).to(device), lr)

        return Trainer(
            TrainerConfig(
                prefix=config.face_morpher_prefix(),
                checkpoint_examples=self.checkpoint_boundaries(self.face_total_examples),
                total_batch_size=batch,
                examples_per_snapshot=self.examples_per_snapshot,
                random_seed=config.face_morpher_random_seed_0,
            ),
            init_module=init_module,
            make_optimizer=recipes.make_adam,
            train_step=train_step,
            lr_fn=recipes.default_face_lr_fn(),
        )

    def make_body_trainer(self, phases: Optional[TrainingPhases] = None) -> Trainer:
        """The body student's trainer; ``phases`` (default: the reference's
        six) set the lr and the four loss weights by examples seen."""
        config = self.config
        self._refuse_sample_outputs("body_morpher_num_training_examples_per_sample_output",
                                    config.body_morpher_num_training_examples_per_sample_output)
        phases = phases or recipes.default_body_phases()
        dtype, device = self.compute_dtype, self.device
        teacher = mode_07.Teacher.from_params(self.teacher_params_07(), self.teacher_cfg_07).freeze(dtype, device)
        step = recipes.make_body_distill_step(teacher, self.character_image(), dtype, self.student_mixed)
        batch = config.body_morpher_batch_size

        def init_module(gen):
            return siren.SirenMorpher(self.body_student_cfg, generator=gen).to(device)

        def train_step(student, optimizer, gen, lr, weights):
            return step(student, optimizer, self.pose_source.batch(gen, batch).to(device), lr, weights)

        return Trainer(
            TrainerConfig(
                prefix=config.body_morpher_prefix(),
                checkpoint_examples=self.checkpoint_boundaries(self.body_total_examples),
                total_batch_size=batch,
                examples_per_snapshot=self.examples_per_snapshot,
                random_seed=config.body_morpher_random_seed_0,
            ),
            init_module=init_module,
            make_optimizer=recipes.make_adam,
            train_step=train_step,
            lr_fn=phases.learning_rate,
            loss_weights_fn=lambda examples_seen: phases.loss_weights(recipes.BODY_LOSS_TERMS, examples_seen),
        )
