"""mode_12 — the face-only three-network teacher, the face student's oracle
(counterpart of ``tha4_tpu/poser/modes/mode_12.py``).

Eyebrow decomposer -> eyebrow morphing combiner -> face morpher, stopping at
the 192x192 face morph.  Outputs: face (8) + combiner (8) + decomposer (6) =
22 tensors, NHWC, in the compute dtype.  A call runs K2 twice (the
combiner's and the face morpher's warps).

Parameters travel as the three reference ``.pt`` state dicts, keyed by the
network names (``init`` draws a seeded random set, ``load_params_from_torch``
reads the files, ``convert.export_torch.face_teacher_state_dicts`` bridges
the JAX package's); ``FaceTeacher.from_params`` builds the modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tha4_tpu_torch.models import eyebrow, face_morpher
from tha4_tpu_torch.poser.modes.pose_parameters import NUM_EYEBROW_PARAMS, NUM_FACE_PARAMS

# The network keys and teacher files of tha4_tpu/poser/modes/mode_07.py:41-53,
# kept here until mode_07 is ported.
KEY_EYEBROW_DECOMPOSER = "eyebrow_decomposer"
KEY_EYEBROW_MORPHING_COMBINER = "eyebrow_morphing_combiner"
KEY_FACE_MORPHER = "face_morpher"
NETWORK_KEYS = (KEY_EYEBROW_DECOMPOSER, KEY_EYEBROW_MORPHING_COMBINER, KEY_FACE_MORPHER)
DEFAULT_TEACHER_FILES = {
    KEY_EYEBROW_DECOMPOSER: "data/tha4/eyebrow_decomposer.pt",
    KEY_EYEBROW_MORPHING_COMBINER: "data/tha4/eyebrow_morphing_combiner.pt",
    KEY_FACE_MORPHER: "data/tha4/face_morpher.pt",
}

OUTPUT_LENGTH = 8 + 8 + 6
INDEX_FACE_MORPHED_IMAGE = 0

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class FaceTeacherConfig:
    eyebrow_decomposer: eyebrow.EyebrowDecomposerConfig = field(default_factory=eyebrow.EyebrowDecomposerConfig)
    eyebrow_combiner: eyebrow.EyebrowCombinerConfig = field(default_factory=eyebrow.EyebrowCombinerConfig)
    face_morpher: face_morpher.FaceMorpherConfig = field(default_factory=face_morpher.FaceMorpherConfig)
    eyebrow_morphed_image_index: int = eyebrow.COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX


class FaceTeacher(nn.Module):
    """The three networks, as attributes named by the network keys."""

    def __init__(self, cfg: Optional[FaceTeacherConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or FaceTeacherConfig()
        self.eyebrow_decomposer = eyebrow.EyebrowDecomposer00(cfg.eyebrow_decomposer)
        self.eyebrow_morphing_combiner = eyebrow.EyebrowMorphingCombiner00(cfg.eyebrow_combiner)
        self.face_morpher = face_morpher.FaceMorpher08(cfg.face_morpher)

    @staticmethod
    def from_params(params: Params, cfg: Optional[FaceTeacherConfig] = None) -> "FaceTeacher":
        teacher = FaceTeacher(cfg)
        for key in NETWORK_KEYS:
            getattr(teacher, key).load_state_dict(params[key])
        return teacher

    def params(self) -> Params:
        return {key: getattr(self, key).state_dict() for key in NETWORK_KEYS}

    def freeze(self, dtype: torch.dtype, device) -> "FaceTeacher":
        """A frozen label generator: no gradients, on ``device``, with the
        convolution weights stored in ``dtype`` once instead of cast per
        call.  The norms' affine stays f32, as in the JAX package."""
        self.requires_grad_(False).eval().to(device)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        return self


def init(gen: torch.Generator, cfg: Optional[FaceTeacherConfig] = None) -> Params:
    """A seeded random teacher at ``cfg``'s widths (the full, shipped ones by
    default): He convs, zero grid-change heads, unit norms."""
    teacher = FaceTeacher(cfg)
    for key in NETWORK_KEYS:
        getattr(teacher, key).reset_parameters(gen)
    return teacher.params()


def load_params_from_torch(module_file_names: Optional[Dict[str, str]] = None) -> Params:
    from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict

    files = dict(DEFAULT_TEACHER_FILES)
    files.update(module_file_names or {})
    return {key: load_torch_state_dict(path) for key, path in files.items()}


def compute_outputs(teacher: FaceTeacher, image: torch.Tensor, pose: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """image (N,512,512,4) + pose (N,>=39), in the compute dtype -> 22 outputs."""
    crop = image[:, 64:192, 192:320, :]
    decomposer_outputs = teacher.eyebrow_decomposer(crop)
    combiner_outputs = teacher.eyebrow_morphing_combiner(
        decomposer_outputs[eyebrow.DECOMPOSER_BACKGROUND_LAYER_INDEX],
        decomposer_outputs[eyebrow.DECOMPOSER_EYEBROW_LAYER_INDEX],
        pose[:, :NUM_EYEBROW_PARAMS],
    )
    eyebrow_morphed = combiner_outputs[teacher.cfg.eyebrow_morphed_image_index]
    face_input = image[:, 32:224, 160:352, :].clone()
    face_input[:, 32:160, 32:160, :] = eyebrow_morphed.to(face_input.dtype)
    face_outputs = teacher.face_morpher(face_input, pose[:, NUM_EYEBROW_PARAMS : NUM_EYEBROW_PARAMS + NUM_FACE_PARAMS])
    return tuple(face_outputs) + tuple(combiner_outputs) + tuple(decomposer_outputs)
