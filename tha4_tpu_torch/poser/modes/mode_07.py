"""mode_07 — the full five-network teacher, the body student's oracle
(counterpart of ``tha4_tpu/poser/modes/mode_07.py``).

  eyebrow_decomposer(image[64:192, 192:320])                         128x128
  eyebrow_morphing_combiner(background, eyebrow, pose[0:12])         128x128
  face_morpher(image[32:224, 160:352] with the eyebrows pasted, pose[12:39])
  face_morphed_full = the face morph pasted back into the 512x512 image
  body_morpher(bilinear 256x256 of it, pose[39:45])                  256x256
  upscaler(face_morphed_full, 512x512 of the body's merged image and
           grid change, pose[39:45])                                  512x512

Outputs, 33 tensors, NHWC, in the compute dtype: upscaler (5) +
[face_morphed_full] + body (5) + face (8) + combiner (8) + decomposer (6).
A call runs K2 five times: the combiner's, the face morpher's, the body
morpher's and the upscaler's two warps.

Parameters travel as the five reference ``.pt`` state dicts keyed by the
network names (``init`` draws a seeded random set, ``load_params_from_torch``
reads the files, ``convert.export_torch.teacher_07_state_dicts`` bridges the
JAX package's); ``Teacher.from_params`` builds the modules.  The mode_12
face teacher is the first three networks (``poser.modes.mode_12``).

``create_poser`` is the teacher poser of the ``tha4-torch-pose`` CLI: a
``GeneralPoser`` whose prologue is the eyebrow decomposer, cached per image
object (the reference's cross-frame cache, mode_07.py:54-70), so that pose
changes on one rest image skip network 1.  Direct ``compute_outputs``
callers (the body distillation) run the decomposer inline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, unet, upscaler
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.ops.resize import resize_bilinear
from tha4_tpu_torch.poser.general_poser import GeneralPoser
from tha4_tpu_torch.poser.modes.pose_parameters import NUM_EYEBROW_PARAMS, NUM_FACE_PARAMS

KEY_EYEBROW_DECOMPOSER = "eyebrow_decomposer"
KEY_EYEBROW_MORPHING_COMBINER = "eyebrow_morphing_combiner"
KEY_FACE_MORPHER = "face_morpher"
KEY_BODY_MORPHER = "body_morpher"
KEY_UPSCALER = "upscaler"
NETWORK_KEYS = (KEY_EYEBROW_DECOMPOSER, KEY_EYEBROW_MORPHING_COMBINER, KEY_FACE_MORPHER, KEY_BODY_MORPHER, KEY_UPSCALER)

DEFAULT_TEACHER_FILES = {
    KEY_EYEBROW_DECOMPOSER: "data/tha4/eyebrow_decomposer.pt",
    KEY_EYEBROW_MORPHING_COMBINER: "data/tha4/eyebrow_morphing_combiner.pt",
    KEY_FACE_MORPHER: "data/tha4/face_morpher.pt",
    KEY_BODY_MORPHER: "data/tha4/body_morpher.pt",
    KEY_UPSCALER: "data/tha4/upscaler.pt",
}

OUTPUT_LENGTH = 5 + 1 + 5 + 8 + 8 + 6
INDEX_FACE_MORPHED_FULL = 5

Params = Dict[str, Dict[str, torch.Tensor]]

_NETWORKS = {
    KEY_EYEBROW_DECOMPOSER: lambda cfg: eyebrow.EyebrowDecomposer00(cfg.eyebrow_decomposer),
    KEY_EYEBROW_MORPHING_COMBINER: lambda cfg: eyebrow.EyebrowMorphingCombiner00(cfg.eyebrow_combiner),
    KEY_FACE_MORPHER: lambda cfg: face_morpher.FaceMorpher08(cfg.face_morpher),
    KEY_BODY_MORPHER: lambda cfg: body_morpher.Morpher00(cfg.body_morpher),
    KEY_UPSCALER: lambda cfg: upscaler.Upscaler02(cfg.upscaler),
}


@dataclass(frozen=True)
class TeacherConfig:
    """The shipped teacher (``tha4_tpu/poser/modes/mode_07.py:59-68``)."""

    eyebrow_decomposer: eyebrow.EyebrowDecomposerConfig = field(default_factory=eyebrow.EyebrowDecomposerConfig)
    eyebrow_combiner: eyebrow.EyebrowCombinerConfig = field(default_factory=eyebrow.EyebrowCombinerConfig)
    face_morpher: face_morpher.FaceMorpherConfig = field(default_factory=face_morpher.FaceMorpherConfig)
    body_morpher: body_morpher.BodyMorpherConfig = field(default_factory=body_morpher.BodyMorpherConfig)
    upscaler: upscaler.UpscalerConfig = field(default_factory=upscaler.UpscalerConfig)
    eyebrow_morphed_image_index: int = eyebrow.COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX


class Teacher(nn.Module):
    """The networks named by ``network_keys``, as attributes of those names."""

    network_keys: Tuple[str, ...] = NETWORK_KEYS
    default_config = TeacherConfig

    def __init__(self, cfg=None):
        super().__init__()
        self.cfg = cfg = cfg or self.default_config()
        for key in self.network_keys:
            setattr(self, key, _NETWORKS[key](cfg))

    @classmethod
    def from_params(cls, params: Params, cfg=None):
        teacher = cls(cfg)
        for key in cls.network_keys:
            getattr(teacher, key).load_state_dict(params[key])
        return teacher

    def params(self) -> Params:
        return {key: getattr(self, key).state_dict() for key in self.network_keys}

    def freeze(self, dtype: torch.dtype, device):
        """A frozen label generator: no gradients, on ``device``, with the
        convolution weights stored in ``dtype`` once instead of cast per
        call.  Norm affines and linears stay f32, as in the JAX package (a
        linear casts itself to its input's dtype).  The U-Nets keep their K6
        weights in its layout (``Unet.store_w9``), and every conv that the
        int8 teacher quantizes keeps its int8 weight, quantized from f32
        before the cast, as the JAX teacher quantizes its f32 params
        (``ops.quant.store_int8``)."""
        self.requires_grad_(False).eval().to(device)
        quant.store_int8(self)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                for p in m.parameters(recurse=False):  # not the buffers: the int8 scales stay f32
                    p.data = p.data.to(dtype)
        for m in self.modules():
            if isinstance(m, unet.Unet):
                m.store_w9()
        return self


def init(gen: torch.Generator, cfg: Optional[TeacherConfig] = None, teacher_class=Teacher) -> Params:
    """A seeded random teacher at ``cfg``'s widths (the full, shipped ones by
    default), each network's own init: zero grid-change heads, and zero
    U-Net conv1s, attention projections and last convs."""
    teacher = teacher_class(cfg)
    for key in teacher.network_keys:
        getattr(teacher, key).reset_parameters(gen)
    return teacher.params()


def load_params_from_torch(module_file_names: Optional[Dict[str, str]] = None, keys=NETWORK_KEYS) -> Params:
    from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict

    files = {key: DEFAULT_TEACHER_FILES[key] for key in keys}
    files.update(module_file_names or {})
    return {key: load_torch_state_dict(path) for key, path in files.items()}


def compute_decomposer_outputs(teacher: nn.Module, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The rest-image-only stage, cacheable across frames: the eyebrow
    decomposer's 6 outputs."""
    return tuple(teacher.eyebrow_decomposer(image[:, 64:192, 192:320, :]))


def compute_face_outputs(teacher: nn.Module, image: torch.Tensor, pose: torch.Tensor,
                         decomposer_outputs: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """The first three networks: face (8) + combiner (8) + decomposer (6)
    outputs, mode_12's 22.  ``decomposer_outputs``, where given, stand in
    for the decomposer."""
    if decomposer_outputs is None:
        decomposer_outputs = compute_decomposer_outputs(teacher, image)
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


def compute_outputs(teacher: Teacher, image: torch.Tensor, pose: torch.Tensor,
                    decomposer_outputs: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """image (N,512,512,4) + pose (N,45), in the compute dtype -> 33 outputs."""
    face_outputs = compute_face_outputs(teacher, image, pose, decomposer_outputs)
    face_morphed_full = image.clone()
    face_morphed_full[:, 32:224, 160:352, :] = face_outputs[face_morpher.OUTPUT_IMAGE_INDEX].to(image.dtype)
    face_morphed_half = resize_bilinear(face_morphed_full, (256, 256))

    rotation_pose = pose[:, NUM_EYEBROW_PARAMS + NUM_FACE_PARAMS :]
    body_outputs = teacher.body_morpher(face_morphed_half, rotation_pose)
    coarse_posed = resize_bilinear(body_outputs[body_morpher.INDEX_MERGED], (512, 512))
    coarse_grid = resize_bilinear(body_outputs[body_morpher.INDEX_GRID_CHANGE], (512, 512))
    upscaler_outputs = teacher.upscaler(face_morphed_full, coarse_posed, coarse_grid, rotation_pose)
    return tuple(upscaler_outputs) + (face_morphed_full,) + tuple(body_outputs) + face_outputs


def create_poser(
    module_file_names: Optional[Dict[str, str]] = None,
    eyebrow_morphed_image_index: int = eyebrow.COMBINER_EYEBROW_IMAGE_NO_COMBINE_ALPHA_INDEX,
    default_output_index: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    params: Optional[Params] = None,
    cfg: Optional[TeacherConfig] = None,
    subrect=None,
    device="cuda",
) -> GeneralPoser:
    """The teacher poser (reference create_poser, mode_07.py:272-315): the
    five networks from ``module_file_names`` (the shipped files by default),
    or from ``params`` (e.g. a random init), loaded at the first pose and
    frozen in ``compute_dtype`` on ``device``; the eyebrow decomposer is its
    prologue, cached per image object."""
    cfg = cfg or TeacherConfig()
    if eyebrow_morphed_image_index != cfg.eyebrow_morphed_image_index:
        cfg = dataclasses.replace(cfg, eyebrow_morphed_image_index=eyebrow_morphed_image_index)

    def load() -> Teacher:
        p = params if params is not None else load_params_from_torch(module_file_names)
        return Teacher.from_params(p, cfg).freeze(compute_dtype, device)

    return GeneralPoser(
        image_size=512,
        output_length=OUTPUT_LENGTH,
        params_loader=load,
        run_fn=lambda teacher, image, pose, *dec: compute_outputs(teacher, image, pose, dec or None),
        default_output_index=default_output_index,
        compute_dtype=compute_dtype,
        subrect=subrect,
        prologue_fn=compute_decomposer_outputs,
        device=device,
    )
