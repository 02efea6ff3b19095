"""GeneralPoser: a Poser over a lazily loaded teacher
(counterpart of ``tha4_tpu/poser/general_poser.py``).

``params_loader`` is called at the first pose (or after ``free``) and
returns what ``run_fn`` takes as its first argument: for the teacher posers,
the frozen networks on the device in the compute dtype
(``mode_07.Teacher.freeze``).  Two behaviours of the reference's
GeneralPoser02 live at this layer:

* ``subrect`` ((y0, y1), (x0, x1)) poses a sub-rectangle of the input image;
  the crop comes before everything else, so every network sees the cropped
  frame.
* ``prologue_fn`` is an image-only stage (mode_07's eyebrow decomposer)
  cached across frames, keyed on the identity of the caller's image object,
  of which a strong reference is held so that the id cannot be reused while
  cached.  A content-equal but distinct object misses the cache (recomputed,
  still correct): identity costs no device work, where the reference's
  per-frame tensor comparison costs a pass and a host sync.
  ``prologue_cache_misses`` counts the misses.

Precision: f32 means full-f32 products, JAX's 'highest' (TF32 off for cuBLAS
and cuDNN); bf16 means bf16 tensors with f32 accumulation.  Image and pose
are cast to the compute dtype, the calls run under ``torch.inference_mode``
and every output comes back as f32, as the JAX ``_run`` returns them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters
from tha4_tpu_torch.poser.poser import PoseParameterGroup, Poser
from tha4_tpu_torch.utils import precision

Subrect = Tuple[Tuple[int, int], Tuple[int, int]]  # ((y0, y1), (x0, x1))


class GeneralPoser(Poser):
    def __init__(
        self,
        image_size: int,
        output_length: int,
        params_loader: Callable[[], Any],
        run_fn: Callable,  # (params, image, pose[, *prologue_outs]) -> outputs
        default_output_index: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        subrect: Optional[Subrect] = None,
        prologue_fn: Optional[Callable] = None,  # (params, image) -> outputs
        device="cuda",
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if compute_dtype == torch.float32:
            precision.set_full_f32()
        self.image_size = image_size
        self.output_length = output_length
        self.default_output_index = default_output_index
        self.compute_dtype = compute_dtype
        self.subrect = subrect
        self.device = torch.device(device)
        self.pose_parameters = get_pose_parameters()
        self._params_loader = params_loader
        self._params = None
        self._run_fn = run_fn
        self._prologue_fn = prologue_fn
        # A strong reference to the image the cache was computed for: `is`
        # identity is exact while it pins the object.
        self._cached_image = None
        self._cached_prologue_outs: Tuple = ()
        self.prologue_cache_misses = 0

    @property
    def params(self):
        if self._params is None:
            self._params = self._params_loader()
        return self._params

    def free(self) -> None:
        self._params = None
        self._cached_image = None
        self._cached_prologue_outs = ()

    # -- Poser interface ---------------------------------------------------
    def get_image_size(self) -> int:
        return self.image_size

    def get_output_length(self) -> int:
        return self.output_length

    def get_pose_parameter_groups(self) -> List[PoseParameterGroup]:
        return self.pose_parameters.get_pose_parameter_groups()

    def get_num_parameters(self) -> int:
        return self.pose_parameters.get_parameter_count()

    def get_posing_outputs(self, image, pose) -> List[torch.Tensor]:
        """image (N,H,W,4) or (H,W,4), pose (N,45) or (45,), numpy or tensors
        -> the outputs, f32 on the device."""
        image_key = image  # the caller's object identity keys the prologue cache
        image = torch.as_tensor(image, device=self.device)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        if image.dim() == 3:
            image = image[None]
        if pose.dim() == 1:
            pose = pose[None]
        if self.subrect is not None:
            (y0, y1), (x0, x1) = self.subrect
            image = image[:, y0:y1, x0:x1, :]
        params = self.params  # loaded outside inference mode, so its tensors stay normal ones
        with torch.inference_mode():
            image = image.to(self.compute_dtype)
            prologue_outs: Tuple = ()
            if self._prologue_fn is not None:
                if self._cached_image is not image_key:
                    self._cached_prologue_outs = tuple(self._prologue_fn(params, image))
                    self._cached_image = image_key
                    self.prologue_cache_misses += 1
                prologue_outs = self._cached_prologue_outs
            outs = self._run_fn(params, image, pose.to(self.compute_dtype), *prologue_outs)
            return [o.float() for o in outs]

    def pose(self, image, pose, output_index: Optional[int] = None) -> torch.Tensor:
        if output_index is None:
            output_index = self.default_output_index
        return self.get_posing_outputs(image, pose)[output_index]
