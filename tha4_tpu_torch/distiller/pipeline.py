"""Distillation: config -> trainers -> task DAG -> character model
(counterpart of ``tha4_tpu/distiller/pipeline.py``).

    run_config(config, target="all")        # what tha4-torch-distill runs
    DistillationJobs(config, ...).make_face_trainer().train()
    DistillationJobs(config, ...).make_body_trainer(phases=None).train()

``run_config`` defines the file-task DAG (``tasks/workspace.py``) and runs
one of its nodes: per-checkpoint training tasks for both students, the
character PNG copy, both students' export to ``.pt`` and the
``character_model.yaml`` that ties them together, under
``{prefix}/character_model/``.  A file task reruns only when its file is
missing or older than a dependency, and training resumes from the newest
snapshot or checkpoint, so a run may be stopped at any time and the same
command rerun (the reference's documented contract, docs/distill.md).

The teachers are injected as reference state dicts (``mode_07.init`` /
``mode_12.init`` make seeded random ones; mode_12's are mode_07's first
three where only mode_07's are given) or, failing that, loaded from the
``data/tha4/*.pt`` files.  Each student's trainer writes a sample grid
(``distiller/sample_output.py``) at its config's cadence, rendered by the
trainer's frozen teacher, in f32 as the JAX render runs it, and the live
student.  More than one GPU waits for the data-parallel slice.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tha4_tpu_torch.charmodel.character_model import CharacterModel
from tha4_tpu_torch.convert.export_torch import save_module_pt
from tha4_tpu_torch.distiller import recipes, sample_output
from tha4_tpu_torch.distiller.config import POSE_DATASET_FILE_NAME, DistillerConfig, copy_file
from tha4_tpu_torch.distiller.pose_dataset import PoseSource
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.poser.modes import mode_07, mode_12
from tha4_tpu_torch.tasks.workspace import Workspace, file_task
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training.schedules import TrainingPhases
from tha4_tpu_torch.training.trainer import KEY_MODULE, Trainer, TrainerConfig

logger = logging.getLogger(__name__)

FACE_SAMPLES, FACE_SAMPLE_CELL = 8, 128  # 8 poses x (teacher crop | student)
BODY_SAMPLES, BODY_SAMPLE_CELL = 4, 512  # 4 poses x (teacher | student | alpha | grid change)


class DistillationJobs:
    """Builds the two students' trainings, and the task DAG, for one config.

    ``student_mixed`` (the JAX package's default): the body student trains
    in selective f32, bf16 matmul operands with f32 sums, sines and head.
    ``teacher_int8``: both teachers label with int8 convolutions (``ops.quant``,
    Q1), calibrated once a run; the sample grids keep the f32 teacher."""

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
        teacher_int8: bool = False,
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
        self.teacher_int8 = teacher_int8
        self._teacher_quant_07 = None
        self._teacher_quant_12 = None
        self.face_student_cfg = siren.SirenFaceMorpherConfig()
        self.body_student_cfg = siren.SirenMorpherConfig()
        self.pose_source = PoseSource(POSE_DATASET_FILE_NAME)
        self._character_image = None
        self._face_teachers = {}  # dtype -> frozen mode_12
        self._body_teachers = {}  # dtype -> frozen mode_07
        self._face_trainer = None
        self._body_trainer = None

    # -- lazy heavy assets -------------------------------------------------

    def character_image(self) -> torch.Tensor:
        """(1, 512, 512, 4) f32 in model units, on the device."""
        from tha4_tpu_torch.core import imagecodec

        if self._character_image is None:
            image = imagecodec.load_image_hwc(self.config.character_image_file_name)
            self._character_image = torch.from_numpy(image)[None].to(self.device)
        return self._character_image

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

    def face_teacher(self, dtype: Optional[torch.dtype] = None) -> mode_12.FaceTeacher:
        """The frozen mode_12 teacher in ``dtype`` (default: the compute
        dtype), made once per dtype: in the compute dtype it labels the face
        student's batches, in f32 it renders the sample grids' teacher
        column, as the JAX render runs its f32 params."""
        dtype = dtype or self.compute_dtype
        if dtype not in self._face_teachers:
            self._face_teachers[dtype] = mode_12.FaceTeacher.from_params(self.teacher_params_12(), self.teacher_cfg_12).freeze(
                dtype, self.device)
        return self._face_teachers[dtype]

    def body_teacher(self, dtype: Optional[torch.dtype] = None) -> mode_07.Teacher:
        """The frozen mode_07 teacher (as ``face_teacher``), for the body student."""
        dtype = dtype or self.compute_dtype
        if dtype not in self._body_teachers:
            self._body_teachers[dtype] = mode_07.Teacher.from_params(self.teacher_params_07(), self.teacher_cfg_07).freeze(
                dtype, self.device)
        return self._body_teachers[dtype]

    def teacher_quant_07(self) -> Optional[List[dict]]:
        """The int8 mode_07 teacher's activation scales (``ops.quant``), or
        None when int8 is off: calibrated once a run on the character image
        and a pose-source batch, and written beside the training outputs."""
        if not self.teacher_int8:
            return None
        if self._teacher_quant_07 is None:
            self._teacher_quant_07 = self._calibrate("07", mode_07.compute_outputs, self.body_teacher())
        return self._teacher_quant_07

    def teacher_quant_12(self) -> Optional[List[dict]]:
        if not self.teacher_int8:
            return None
        if self._teacher_quant_12 is None:
            self._teacher_quant_12 = self._calibrate("12", mode_12.compute_outputs, self.face_teacher())
        return self._teacher_quant_12

    def _calibrate(self, tag: str, compute_outputs, teacher) -> List[dict]:
        """8 pose-source poses from a generator seeded 0xCA11B, at batch 8,
        in the compute dtype (``tha4_tpu/distiller/pipeline.py:152-166``);
        the scales go to ``{prefix}/teacher_int8_scales_{tag}.json``."""
        poses = self.pose_source.batch(torch.Generator().manual_seed(0xCA11B), 8).to(self.device, self.compute_dtype)
        image = self.character_image().to(self.compute_dtype).expand(8, -1, -1, -1)
        scales = quant.run_calibration(compute_outputs, teacher, image, poses)
        logger.info("int8 teacher (mode_%s): calibrated %d convs", tag, len(scales))
        os.makedirs(self.config.prefix, exist_ok=True)
        quant.save_scales(os.path.join(self.config.prefix, f"teacher_int8_scales_{tag}.json"), scales)
        return scales

    def checkpoint_boundaries(self, total: int):
        return [self.examples_per_checkpoint * (i + 1) for i in range(total // self.examples_per_checkpoint)]

    # -- face student ------------------------------------------------------

    def make_face_trainer(self) -> Trainer:
        config = self.config
        device = self.device
        mask = torch.from_numpy(recipes.load_face_mask_crop(config.face_mask_image_file_name)).to(device)
        step = recipes.make_face_distill_step(self.face_teacher(), self.character_image(), mask, self.compute_dtype,
                                              self.teacher_quant_12())
        batch = config.face_morpher_batch_size
        cadence = config.face_morpher_num_training_examples_per_sample_output

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
                examples_per_sample_output=cadence,
                random_seed=config.face_morpher_random_seed_0,
            ),
            init_module=init_module,
            make_optimizer=recipes.make_adam,
            train_step=train_step,
            lr_fn=recipes.default_face_lr_fn(),
            sample_output_fn=self.write_face_samples if cadence is not None else None,
        )

    def sample_poses(self, seed: int, n: int) -> torch.Tensor:
        """The sample grid's n poses: the same at every render, from their
        own generator, so that no step's batch moves."""
        return self.pose_source.batch(torch.Generator().manual_seed(seed), n)

    @torch.no_grad()
    def render_face_samples(self, student: siren.SirenFaceMorpher, poses: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """(teacher crops, student crops), each (N, 128, 128, 4) f32 numpy:
        the frozen teacher and the live student, packed afresh, both in f32
        whatever the compute dtype (the JAX render's dtype).  ``no_grad``,
        not ``inference_mode``: constants first made here serve training."""
        poses = poses.to(self.device)
        gt = recipes.face_teacher_targets(self.face_teacher(torch.float32), self.character_image(), poses, torch.float32)
        chain = student.pack(torch.float32, self.device)
        pred = siren.siren_face_morpher_apply(student.cfg, chain, poses[:, : student.cfg.pose_size])
        return gt.float().cpu().numpy(), pred.float().cpu().numpy()

    def write_face_samples(self, student: siren.SirenFaceMorpher, examples_seen: int) -> None:
        """8 poses x (teacher crop | student), 128^2 cells (reference
        siren_face_morpher_protocols_00.py sample grids)."""
        poses = self.sample_poses(self.config.face_morpher_random_seed_1, FACE_SAMPLES)
        gt, pred = self.render_face_samples(student, poses)
        color = sample_output.ImageType.COLOR
        cells = [[(gt[i], color), (pred[i], color)] for i in range(len(gt))]
        path = sample_output.sample_output_file_name(self.config.face_morpher_prefix(), examples_seen)
        sample_output.save_sample_grid(cells, path, cell_size=FACE_SAMPLE_CELL)

    # -- body student ------------------------------------------------------

    def make_body_trainer(self, phases: Optional[TrainingPhases] = None) -> Trainer:
        """The body student's trainer; ``phases`` (default: the reference's
        six) set the lr and the four loss weights by examples seen."""
        config = self.config
        phases = phases or recipes.default_body_phases()
        device = self.device
        step = recipes.make_body_distill_step(self.body_teacher(), self.character_image(), self.compute_dtype,
                                              self.student_mixed, self.teacher_quant_07())
        batch = config.body_morpher_batch_size
        cadence = config.body_morpher_num_training_examples_per_sample_output

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
                examples_per_sample_output=cadence,
                random_seed=config.body_morpher_random_seed_0,
            ),
            init_module=init_module,
            make_optimizer=recipes.make_adam,
            train_step=train_step,
            lr_fn=phases.learning_rate,
            loss_weights_fn=lambda examples_seen: phases.loss_weights(recipes.BODY_LOSS_TERMS, examples_seen),
            sample_output_fn=self.write_body_samples if cadence is not None else None,
        )

    @torch.no_grad()
    def render_body_samples(self, student: siren.SirenMorpher, poses: torch.Tensor) -> Tuple[np.ndarray, ...]:
        """(teacher posed, student blended, alpha, grid change), each (N,
        512, 512, *) f32 numpy: the frozen mode_07 and the live student,
        packed afresh and run on the teacher's face_morphed_full, both in
        f32 (as ``render_face_samples``)."""
        n = poses.shape[0]
        poses = poses.to(self.device)
        image = self.character_image().expand(n, -1, -1, -1)
        t = mode_07.compute_outputs(self.body_teacher(torch.float32), image, poses)
        chains = student.pack(torch.float32, self.device)
        outs = siren.siren_morpher_apply(student.cfg, chains, t[mode_07.INDEX_FACE_MORPHED_FULL], poses)
        picked = (t[0], outs[siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE], outs[siren.SIREN_MORPHER_INDEX_ALPHA],
                  outs[siren.SIREN_MORPHER_INDEX_GRID_CHANGE])
        return tuple(x.float().cpu().numpy() for x in picked)

    def write_body_samples(self, student: siren.SirenMorpher, examples_seen: int) -> None:
        """4 poses x (teacher | student | alpha | grid change), 512^2 cells
        (reference siren_morpher_protocols_03.py:217-352)."""
        poses = self.sample_poses(self.config.body_morpher_random_seed_1, BODY_SAMPLES)
        posed, pred, alpha, grid = self.render_body_samples(student, poses)
        kinds = (sample_output.ImageType.COLOR, sample_output.ImageType.COLOR, sample_output.ImageType.ALPHA,
                 sample_output.ImageType.GRID_CHANGE)
        cells = [list(zip((posed[i], pred[i], alpha[i], grid[i]), kinds)) for i in range(len(posed))]
        path = sample_output.sample_output_file_name(self.config.body_morpher_prefix(), examples_seen)
        sample_output.save_sample_grid(cells, path, cell_size=BODY_SAMPLE_CELL)

    # -- task DAG (reference distiller_config.py:250-310) ------------------

    def define_tasks(self, workspace: Workspace) -> None:
        """The JAX package's DAG, its task names and dependencies.  One
        trainer per student serves all of its checkpoint tasks, made when
        the first of them runs, so that listing the DAG or running an up to
        date one freezes no teacher."""
        config = self.config

        @file_task(workspace, config.config_yaml_file_name(), [])
        def create_config_yaml():
            config.save(config.config_yaml_file_name())

        def student_tasks(prefix: str, total: int, make_trainer: Callable[[], Trainer]) -> str:
            prev = [config.config_yaml_file_name()]
            for i, boundary in enumerate(self.checkpoint_boundaries(total)):
                target_file = os.path.join(ckpt.checkpoint_dir(prefix, i + 1), f"module_{KEY_MODULE}.npz")

                def run(boundary=boundary):
                    make_trainer().train(boundary)

                workspace.create_file_task(target_file, list(prev), run)
                prev = [target_file]
            workspace.create_command_task(f"{prefix}/train", list(prev))
            return prev[0]

        def face_trainer() -> Trainer:
            if self._face_trainer is None:
                self._face_trainer = self.make_face_trainer()
            return self._face_trainer

        def body_trainer() -> Trainer:
            if self._body_trainer is None:
                self._body_trainer = self.make_body_trainer()
            return self._body_trainer

        face_final = student_tasks(config.face_morpher_prefix(), self.face_total_examples, face_trainer)
        body_final = student_tasks(config.body_morpher_prefix(), self.body_total_examples, body_trainer)

        @file_task(workspace, config.character_model_character_png_file_name(), [config.character_image_file_name])
        def copy_character_image():
            copy_file(config.character_image_file_name, config.character_model_character_png_file_name())

        @file_task(workspace, config.character_model_face_morpher_file_name(), [face_final])
        def export_face_morpher():
            self._export_student(face_final, siren.SirenFaceMorpher(self.face_student_cfg),
                                 config.character_model_face_morpher_file_name())

        @file_task(workspace, config.character_model_body_morpher_file_name(), [body_final])
        def export_body_morpher():
            self._export_student(body_final, siren.SirenMorpher(self.body_student_cfg),
                                 config.character_model_body_morpher_file_name())

        @file_task(workspace, config.character_model_yaml_file_name(), [])
        def create_character_model_yaml():
            CharacterModel(
                config.character_model_character_png_file_name(),
                config.character_model_face_morpher_file_name(),
                config.character_model_body_morpher_file_name(),
            ).save(config.character_model_yaml_file_name())

        workspace.create_command_task(
            f"{config.prefix}/all",
            [
                f"{config.face_morpher_prefix()}/train",
                f"{config.body_morpher_prefix()}/train",
                config.character_model_character_png_file_name(),
                config.character_model_face_morpher_file_name(),
                config.character_model_body_morpher_file_name(),
                config.character_model_yaml_file_name(),
            ],
        )

    @staticmethod
    def _export_student(checkpoint_file: str, module: torch.nn.Module, dest: str) -> None:
        """The last checkpoint's ``module_module.npz`` loaded into a fresh
        student on the CPU in f32, written in the reference ``.pt`` format.
        The file is written under a temporary directory, with its own name
        (``torch.save`` records it), and renamed into place, so that a run
        stopped mid-write leaves no file that looks up to date."""
        module.load_state_dict({k: torch.from_numpy(v) for k, v in ckpt._load_npz(checkpoint_file).items()})
        partial = os.path.join(os.path.dirname(dest), f".{os.path.basename(dest)}.partial")
        os.makedirs(partial, exist_ok=True)
        staged = os.path.join(partial, os.path.basename(dest))
        save_module_pt(module, staged)
        os.replace(staged, dest)
        os.rmdir(partial)


def run_config(config: DistillerConfig, target: str = "all", **kwargs) -> None:
    """The distill entry (reference app/distill.py:8-25): define the DAG and
    run ``target``, ``all`` (the whole pipeline, the default), ``face`` or
    ``body`` (that student's training task alone).  ``kwargs`` go to
    ``DistillationJobs``."""
    jobs = DistillationJobs(config, **kwargs)
    workspace = Workspace()
    jobs.define_tasks(workspace)
    if target == "face":
        workspace.run(f"{config.face_morpher_prefix()}/train")
    elif target == "body":
        workspace.run(f"{config.body_morpher_prefix()}/train")
    else:
        workspace.run(f"{config.prefix}/all")
