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

import torch

from tha4_tpu_torch.convert import torch_weights
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops.cuda_siren import PackedChain
from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters
from tha4_tpu_torch.poser.poser import PoseParameterGroup, Poser

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


def _set_f32_precision() -> None:
    """f32 means full-f32 products, as JAX's 'highest' on the f32 path: no
    TF32 in cuBLAS matmuls (the resize) or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class StudentPoser(Poser):
    """The mode_14 pipeline on one device and compute dtype.

    Weights are packed once here for that dtype and device.  Image and pose
    are cast to the compute dtype; all six outputs come back as f32."""

    def __init__(
        self,
        face: siren.SirenFaceMorpher,
        body: siren.SirenMorpher,
        default_output_index: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        _set_f32_precision()
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
        image = torch.as_tensor(image, device=self.device)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        if image.dim() == 3:
            image = image[None]
        if pose.dim() == 1:
            pose = pose[None]
        with torch.inference_mode():
            outs = compute_outputs(
                self.face_cfg, self.body_cfg, self.face_chain, self.body_chains,
                image.to(self.compute_dtype), pose.to(self.compute_dtype),
            )
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
) -> StudentPoser:
    """Build the student poser from reference-format ``.pt`` checkpoints."""
    module_file_names = dict(module_file_names or {})
    module_file_names.setdefault(KEY_FACE_MORPHER, "data/character_models/lambda_00/face_morpher.pt")
    module_file_names.setdefault(KEY_BODY_MORPHER, "data/character_models/lambda_00/body_morpher.pt")
    return StudentPoser(
        _load_student(module_file_names[KEY_FACE_MORPHER], "face"),
        _load_student(module_file_names[KEY_BODY_MORPHER], "body"),
        default_output_index=default_output_index,
        compute_dtype=compute_dtype,
        device=device,
    )


def _load_student(path: str, kind: str):
    if path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: .npz training checkpoints load once the training checkpoint format is ported; "
            "export the student to a .pt state dict (tha4_tpu.convert.export_torch) meanwhile"
        )
    return torch_weights.load_face_morpher(path) if kind == "face" else torch_weights.load_body_morpher(path)
