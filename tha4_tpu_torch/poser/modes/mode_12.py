"""mode_12 — the face-only three-network teacher, the face student's oracle
(counterpart of ``tha4_tpu/poser/modes/mode_12.py``).

Eyebrow decomposer -> eyebrow morphing combiner -> face morpher, stopping at
the 192x192 face morph.  Outputs: face (8) + combiner (8) + decomposer (6) =
22 tensors, NHWC, in the compute dtype.  A call runs K2 twice (the
combiner's and the face morpher's warps).

Parameters travel as the three reference ``.pt`` state dicts, keyed by the
network names (``init`` draws a seeded random set, ``load_params_from_torch``
reads the files, ``convert.export_torch.face_teacher_state_dicts`` bridges
the JAX package's); ``FaceTeacher.from_params`` builds the modules.  The
networks, their keys and files, and the DAG are mode_07's first three
(``poser.modes.mode_07``).  ``create_poser`` wraps them in a
``GeneralPoser`` with no prologue, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from tha4_tpu_torch.models import eyebrow, face_morpher
from tha4_tpu_torch.poser.general_poser import GeneralPoser
from tha4_tpu_torch.poser.modes import mode_07

KEY_EYEBROW_DECOMPOSER = mode_07.KEY_EYEBROW_DECOMPOSER
KEY_EYEBROW_MORPHING_COMBINER = mode_07.KEY_EYEBROW_MORPHING_COMBINER
KEY_FACE_MORPHER = mode_07.KEY_FACE_MORPHER
NETWORK_KEYS = (KEY_EYEBROW_DECOMPOSER, KEY_EYEBROW_MORPHING_COMBINER, KEY_FACE_MORPHER)

OUTPUT_LENGTH = 8 + 8 + 6
INDEX_FACE_MORPHED_IMAGE = 0

Params = mode_07.Params


@dataclass(frozen=True)
class FaceTeacherConfig:
    eyebrow_decomposer: eyebrow.EyebrowDecomposerConfig = field(default_factory=eyebrow.EyebrowDecomposerConfig)
    eyebrow_combiner: eyebrow.EyebrowCombinerConfig = field(default_factory=eyebrow.EyebrowCombinerConfig)
    face_morpher: face_morpher.FaceMorpherConfig = field(default_factory=face_morpher.FaceMorpherConfig)
    eyebrow_morphed_image_index: int = eyebrow.COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX


class FaceTeacher(mode_07.Teacher):
    """The three networks, as attributes named by the network keys."""

    network_keys = NETWORK_KEYS
    default_config = FaceTeacherConfig


def init(gen: torch.Generator, cfg: Optional[FaceTeacherConfig] = None) -> Params:
    """A seeded random teacher at ``cfg``'s widths (the full, shipped ones by
    default): He convs, zero grid-change heads, unit norms."""
    return mode_07.init(gen, cfg, FaceTeacher)


def load_params_from_torch(module_file_names: Optional[Dict[str, str]] = None) -> Params:
    return mode_07.load_params_from_torch(module_file_names, NETWORK_KEYS)


def compute_outputs(teacher: FaceTeacher, image: torch.Tensor, pose: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """image (N,512,512,4) + pose (N,>=39), in the compute dtype -> 22 outputs."""
    return mode_07.compute_face_outputs(teacher, image, pose)


def create_poser(
    module_file_names: Optional[Dict[str, str]] = None,
    eyebrow_morphed_image_index: int = eyebrow.COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX,
    default_output_index: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    params: Optional[Params] = None,
    cfg: Optional[FaceTeacherConfig] = None,
    subrect=None,
    device="cuda",
) -> GeneralPoser:
    """The face teacher poser (22 outputs): the three networks from
    ``module_file_names`` or ``params``, loaded at the first pose and frozen
    in ``compute_dtype`` on ``device``."""
    cfg = cfg or FaceTeacherConfig()
    if eyebrow_morphed_image_index != cfg.eyebrow_morphed_image_index:
        cfg = dataclasses.replace(cfg, eyebrow_morphed_image_index=eyebrow_morphed_image_index)

    def load() -> FaceTeacher:
        p = params if params is not None else load_params_from_torch(module_file_names)
        return FaceTeacher.from_params(p, cfg).freeze(compute_dtype, device)

    return GeneralPoser(
        image_size=512,
        output_length=OUTPUT_LENGTH,
        params_loader=load,
        run_fn=compute_outputs,
        default_output_index=default_output_index,
        compute_dtype=compute_dtype,
        subrect=subrect,
        device=device,
    )
