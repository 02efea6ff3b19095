"""Distillation jobs: config -> trainer (counterpart of the face half of
``tha4_tpu/distiller/pipeline.py``).

    DistillationJobs(config, teacher_params_12=..., face_total_examples=...,
                     examples_per_checkpoint=...).make_face_trainer().train()

The teacher is injected as the three reference state dicts
(``mode_12.init`` makes a seeded random one) or, failing that, loaded from
the ``data/tha4/*.pt`` files.  Not here yet: the body student, the file-task
DAG and the ``tha4-distill`` command, sample grids (``distiller/sample_output.py``)
and student export; more than one GPU waits for the data-parallel slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tha4_tpu_torch.distiller import recipes
from tha4_tpu_torch.distiller.config import POSE_DATASET_FILE_NAME, DistillerConfig
from tha4_tpu_torch.distiller.pose_dataset import PoseSource
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_12
from tha4_tpu_torch.training.trainer import Trainer, TrainerConfig


class DistillationJobs:
    """Builds the face student's training for one config."""

    def __init__(
        self,
        config: DistillerConfig,
        teacher_params_12: Optional[mode_12.Params] = None,
        teacher_cfg_12: Optional[mode_12.FaceTeacherConfig] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        face_total_examples: int = recipes.FACE_MORPHER_TOTAL_EXAMPLES,
        examples_per_checkpoint: int = recipes.EXAMPLES_PER_CHECKPOINT,
        examples_per_snapshot: int = 10_000,
    ):
        if config.num_gpus > 1:
            raise NotImplementedError(f"num_gpus = {config.num_gpus}: training on more than one GPU waits for the port's data-parallel slice")
        self.config = config
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.teacher_cfg_12 = teacher_cfg_12 or mode_12.FaceTeacherConfig()
        self._teacher_params_12 = teacher_params_12
        self.face_total_examples = face_total_examples
        self.examples_per_checkpoint = examples_per_checkpoint
        self.examples_per_snapshot = examples_per_snapshot
        self.face_student_cfg = siren.SirenFaceMorpherConfig()
        self.pose_source = PoseSource(POSE_DATASET_FILE_NAME)

    def character_image(self) -> torch.Tensor:
        """(1, 512, 512, 4) f32 in model units, on the device."""
        from tha4_tpu_torch.core import imagecodec

        return torch.from_numpy(imagecodec.load_image_hwc(self.config.character_image_file_name))[None].to(self.device)

    def teacher_params_12(self) -> mode_12.Params:
        if self._teacher_params_12 is None:
            self._teacher_params_12 = mode_12.load_params_from_torch()
        return self._teacher_params_12

    def checkpoint_boundaries(self, total: int):
        return [self.examples_per_checkpoint * (i + 1) for i in range(total // self.examples_per_checkpoint)]

    def make_face_trainer(self) -> Trainer:
        config = self.config
        if config.face_morpher_num_training_examples_per_sample_output is not None:
            raise NotImplementedError(
                "face_morpher_num_training_examples_per_sample_output is set, but sample outputs "
                "(distiller/sample_output.py) are not ported yet: set it to null"
            )
        dtype, device = self.compute_dtype, self.device
        teacher = mode_12.FaceTeacher.from_params(self.teacher_params_12(), self.teacher_cfg_12).freeze(dtype, device)
        mask = torch.from_numpy(recipes.load_face_mask_crop(config.face_mask_image_file_name)).to(device)
        step = recipes.make_face_distill_step(teacher, self.character_image(), mask, dtype)
        batch = config.face_morpher_batch_size

        def init_module(gen):
            return siren.SirenFaceMorpher(self.face_student_cfg, generator=gen).to(device)

        def train_step(student, optimizer, gen, lr):
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
