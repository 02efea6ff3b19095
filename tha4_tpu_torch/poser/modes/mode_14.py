"""mode_14 — the student poser, the real-time path
(counterpart of ``tha4_tpu/poser/modes/mode_14.py``).

Two networks: the face SIREN paints a 128x128 RGBA crop from pose[0:39],
which is pasted into the 512^2 character at rows 80:208, cols 192:320; the
body SirenMorpher then warps and recolours the composited image from the
full 45-dim pose.  Outputs: the body's five, then the face crop.

One frame launches K1 four times (face, three body levels) and K2 once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tha4_tpu_torch.convert import torch_weights
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops.cuda_siren import PackedChain
from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters
from tha4_tpu_torch.poser.poser import PoseParameterGroup, Poser
from tha4_tpu_torch.utils import precision, profiling

KEY_FACE_MORPHER = "face_morpher"
KEY_BODY_MORPHER = "body_morpher"

FACE_CENTER_X = 256
FACE_CENTER_Y = 128 + 16
FACE_HALF = 64

OUTPUT_LENGTH = siren.SIREN_MORPHER_OUTPUT_LENGTH + 1
INDEX_FACE_MORPHER_OUTPUT = 5


def compute_outputs(
    face_cfg: siren.SirenFaceMorpherConfig,
    body_cfg: siren.SirenMorpherConfig,
    face_chain: PackedChain,
    body_chains: Sequence[PackedChain],
    image: torch.Tensor,
    pose: torch.Tensor,
):
    """(N,512,512,4) image + (N,45) pose, both in the compute dtype -> tuple of
    6 NHWC outputs.  The face is pasted into a clone; ``image`` is not
    written."""
    face_out = siren.siren_face_morpher_apply(face_cfg, face_chain, pose[:, 0 : face_cfg.pose_size])
    y0 = FACE_CENTER_Y - FACE_HALF
    x0 = FACE_CENTER_X - FACE_HALF
    size = face_cfg.image_size
    body_input = image.clone()
    body_input[:, y0 : y0 + size, x0 : x0 + size, :] = face_out.to(image.dtype)
    body_out = siren.siren_morpher_apply(body_cfg, body_chains, body_input, pose)
    return tuple(body_out) + (face_out,)


class StudentPoser(Poser):
    """The mode_14 pipeline on one device and compute dtype.

    Weights are packed once here for that dtype and device.  Image and pose
    are cast to the compute dtype; all six outputs come back as f32.

    ``matmul_precision`` (JAX's words, ``utils.precision.MATMUL_PRECISION``)
    holds for the f32 matmuls of each call, as the JAX poser's
    (``tha4_tpu/poser/modes/mode_14.py:69,83``); without it an f32 poser
    turns TF32 off (full-f32 products, JAX's ``highest``) and a bf16 one
    leaves the setting as it is."""

    def __init__(
        self,
        face: siren.SirenFaceMorpher,
        body: siren.SirenMorpher,
        default_output_index: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        matmul_precision: Optional[str] = None,
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if matmul_precision is not None and matmul_precision not in precision.MATMUL_PRECISION:
            raise ValueError(f"matmul_precision must be one of {sorted(precision.MATMUL_PRECISION)}, got {matmul_precision}")
        if matmul_precision is None and compute_dtype == torch.float32:
            precision.set_full_f32()
        self.matmul_precision = matmul_precision
        self.device = torch.device(device)
        self.face_cfg = face.cfg
        self.body_cfg = body.cfg
        self.default_output_index = default_output_index
        self.compute_dtype = compute_dtype
        self.pose_parameters = get_pose_parameters()
        self.face_chain = face.pack(compute_dtype, self.device)
        self.body_chains = body.pack(compute_dtype, self.device)

    # -- Poser interface ---------------------------------------------------
    def get_image_size(self) -> int:
        return self.body_cfg.image_size

    def get_output_length(self) -> int:
        return OUTPUT_LENGTH

    def get_pose_parameter_groups(self) -> List[PoseParameterGroup]:
        return self.pose_parameters.get_pose_parameter_groups()

    def get_num_parameters(self) -> int:
        return self.pose_parameters.get_parameter_count()

    def get_posing_outputs(self, image, pose) -> List[torch.Tensor]:
        """image (N,H,W,4) or (H,W,4), pose (N,45) or (45,), numpy or tensors."""
        with torch.inference_mode(), precision.matmul_precision(self.matmul_precision):
            with profiling.span("mode14.upload"):
                image = torch.as_tensor(image, device=self.device)
                pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
                if image.dim() == 3:
                    image = image[None]
                if pose.dim() == 1:
                    pose = pose[None]
                image, pose = image.to(self.compute_dtype), pose.to(self.compute_dtype)
            with profiling.span("mode14.compute"):
                outs = compute_outputs(self.face_cfg, self.body_cfg, self.face_chain, self.body_chains, image, pose)
            return [o.float() for o in outs]

    def pose(self, image, pose, output_index: Optional[int] = None) -> torch.Tensor:
        if output_index is None:
            output_index = self.default_output_index
        return self.get_posing_outputs(image, pose)[output_index]


def create_poser(
    module_file_names: Optional[Dict[str, str]] = None,
    default_output_index: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
    matmul_precision: Optional[str] = None,
) -> StudentPoser:
    """Build the student poser from reference-format ``.pt`` files or the
    port's own ``.npz`` training checkpoints."""
    module_file_names = dict(module_file_names or {})
    module_file_names.setdefault(KEY_FACE_MORPHER, "data/character_models/lambda_00/face_morpher.pt")
    module_file_names.setdefault(KEY_BODY_MORPHER, "data/character_models/lambda_00/body_morpher.pt")
    return StudentPoser(
        _load_student(module_file_names[KEY_FACE_MORPHER], "face"),
        _load_student(module_file_names[KEY_BODY_MORPHER], "body"),
        default_output_index=default_output_index,
        compute_dtype=compute_dtype,
        device=device,
        matmul_precision=matmul_precision,
    )


# The JAX package's checkpoints join a pytree path's keys with this
# separator (tha4_tpu/training/checkpoint.py SEP); the port's state-dict
# keys are dotted.
_JAX_TREE_SEP = "\x1f"


def _load_student(path: str, kind: str):
    """A student from a reference-format ``.pt`` state dict, or from the
    port's own training checkpoint, ``module_<name>.npz``: the same state
    dict, one array per key (``training/checkpoint.py``)."""
    if not path.endswith(".npz"):
        return torch_weights.load_face_morpher(path) if kind == "face" else torch_weights.load_body_morpher(path)
    with np.load(path) as data:
        sd = {k: torch.from_numpy(data[k]) for k in data.files}
    if any(_JAX_TREE_SEP in k for k in sd):
        raise ValueError(
            f"{path}: a JAX package checkpoint (a params pytree flattened by path), not the port's; the two "
            "packages do not load each other's .npz checkpoints: export the JAX student to a .pt state dict "
            "(tha4_tpu.convert.export_torch) and load that"
        )
    try:
        if kind == "face":
            return torch_weights.face_morpher_from_state_dict(sd)
        return torch_weights.body_morpher_from_state_dict(sd)
    except (KeyError, RuntimeError) as e:
        raise ValueError(f"{path}: not a port {kind} student checkpoint ({e})") from e
