"""CharacterModel: the distilled-student package (yaml + png + two ``.pt``
files), in the reference format (counterpart of
``tha4_tpu/charmodel/character_model.py``)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import yaml


class CharacterModel:
    def __init__(
        self,
        character_image_file_name: str,
        face_morpher_file_name: str,
        body_morpher_file_name: str,
    ):
        self.character_image_file_name = character_image_file_name
        self.face_morpher_file_name = face_morpher_file_name
        self.body_morpher_file_name = body_morpher_file_name
        self._posers = {}
        self._character_image: Optional[np.ndarray] = None

    def get_poser(self, compute_dtype: torch.dtype = torch.float32, device="cuda"):
        """The student poser for this dtype and device, built once and cached.

        There is no fallback: ``device='cuda'`` without a card fails."""
        from tha4_tpu_torch.poser.modes import mode_14

        key = (compute_dtype, str(torch.device(device)))
        if key not in self._posers:
            self._posers[key] = mode_14.create_poser(
                module_file_names={
                    mode_14.KEY_FACE_MORPHER: self.face_morpher_file_name,
                    mode_14.KEY_BODY_MORPHER: self.body_morpher_file_name,
                },
                compute_dtype=compute_dtype,
                device=device,
            )
        return self._posers[key]

    def get_character_image(self) -> np.ndarray:
        """HWC float32 in model units ([-1,1] premultiplied linear RGBA)."""
        from tha4_tpu_torch.core import imagecodec

        if self._character_image is None:
            import PIL.Image

            pil = PIL.Image.open(self.character_image_file_name)
            if pil.mode != "RGBA":
                raise RuntimeError("Character image is not an RGBA image!")
            self._character_image = imagecodec.load_image_hwc(pil)
        return self._character_image

    def save(self, file_name: str) -> None:
        dir_name = os.path.dirname(file_name)
        data = {
            "character_image_file_name": os.path.relpath(self.character_image_file_name, dir_name),
            "face_morpher_file_name": os.path.relpath(self.face_morpher_file_name, dir_name),
            "body_morpher_file_name": os.path.relpath(self.body_morpher_file_name, dir_name),
        }
        os.makedirs(dir_name, exist_ok=True)
        with open(file_name, "wt") as fout:
            yaml.safe_dump(data, fout)

    @staticmethod
    def load(file_name: str) -> "CharacterModel":
        with open(file_name) as fin:
            conf = yaml.safe_load(fin)
        dir_name = os.path.dirname(file_name)
        return CharacterModel(
            os.path.join(dir_name, conf["character_image_file_name"]),
            os.path.join(dir_name, conf["face_morpher_file_name"]),
            os.path.join(dir_name, conf["body_morpher_file_name"]),
        )
