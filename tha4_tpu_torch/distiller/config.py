"""DistillerConfig: one character's distillation job
(counterpart of ``tha4_tpu/distiller/config.py``).

The same yaml fields, defaults and checks as the JAX package and the
reference, so one config file drives either.  ``num_gpus`` is the number of
CUDA devices that train data-parallel (``distiller/pipeline.py``); both
batch sizes must divide by it.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import yaml

POSE_DATASET_FILE_NAME = "data/pose_dataset.pt"


def _require(condition, message: str) -> None:
    if not condition:
        raise ValueError(message)


@dataclass
class DistillerConfig:
    prefix: str
    character_image_file_name: str
    face_mask_image_file_name: str

    face_morpher_random_seed_0: int = 12771885812175595441
    face_morpher_random_seed_1: int = 14367217090963479175
    face_morpher_num_training_examples_per_sample_output: Optional[int] = 10_000
    face_morpher_batch_size: int = 8

    body_morpher_random_seed_0: int = 2892221210020292507
    body_morpher_random_seed_1: int = 9998918537095922080
    body_morpher_num_training_examples_per_sample_output: Optional[int] = 10_000
    body_morpher_batch_size: int = 8

    num_cpu_workers: int = 1
    num_gpus: int = 1

    def check(self) -> None:
        """The reference's validation: files, image modes and sizes, seed and
        batch ranges, sample cadences.  Raises ValueError."""
        import PIL.Image

        _require(os.path.isdir(self.prefix), "The 'prefix' must be a directory.")
        _require(os.path.isfile(self.character_image_file_name),
                 f"The specified character image file name, {self.character_image_file_name}, does not point to a file.")
        _require(self.character_image_file_name.lower().endswith(".png"), "The character image file name must have extension '.png'.")
        with PIL.Image.open(self.character_image_file_name) as image:
            _require(image.mode == "RGBA", "The character image must have an alpha channel.")
            _require(image.width == 512 and image.height == 512, "The character image must be 512x512.")

        _require(os.path.isfile(self.face_mask_image_file_name), f"No face mask image at {self.face_mask_image_file_name}.")
        _require(self.face_mask_image_file_name.lower().endswith(".png"), "The face mask image file name must have extension '.png'.")
        with PIL.Image.open(self.face_mask_image_file_name) as mask:
            _require(mask.width == 512 and mask.height == 512, "The face mask image must be 512x512.")
            _require(mask.mode == "RGB", "The face mask image must be an RGB image.")
            _require(np.isin(np.asarray(mask), (0, 255)).all(), "Mask channels must be 0 or 255")

        for name in ("face_morpher_random_seed_0", "face_morpher_random_seed_1",
                     "body_morpher_random_seed_0", "body_morpher_random_seed_1"):
            value = getattr(self, name)
            _require(isinstance(value, int) and 0 <= value <= 0xFFFF_FFFF_FFFF_FFFF, f"The {name} must be between 0 and 2**64-1.")
        for name in ("face_morpher_batch_size", "body_morpher_batch_size"):
            value = getattr(self, name)
            _require(isinstance(value, int) and 1 <= value <= 8, f"The {name} must be in [1, 8].")
        for name in ("face_morpher_num_training_examples_per_sample_output",
                     "body_morpher_num_training_examples_per_sample_output"):
            _require(getattr(self, name) in (10_000, 100_000, 1_000_000, None), f"The {name} must be 10000, 100000, 1000000 or null.")
        _require(self.num_cpu_workers >= 1, "num_cpu_workers must be at least 1.")
        _require(self.num_gpus >= 1, "num_gpus must be at least 1.")

    def save(self, file_name: str) -> None:
        os.makedirs(self.prefix, exist_ok=True)
        with open(file_name, "wt") as fout:
            yaml.safe_dump(asdict(self), fout, sort_keys=False)

    @staticmethod
    def load(file_name: str) -> "DistillerConfig":
        with open(file_name) as fin:
            config = DistillerConfig(**yaml.safe_load(fin))
        config.check()
        return config

    # The derived paths of the task DAG, the JAX package's.

    def config_yaml_file_name(self) -> str:
        return f"{self.prefix}/config.yaml"

    def face_morpher_prefix(self) -> str:
        return f"{self.prefix}/face_morpher"

    def body_morpher_prefix(self) -> str:
        return f"{self.prefix}/body_morpher"

    def character_model_prefix(self) -> str:
        return f"{self.prefix}/character_model"

    def character_model_face_morpher_file_name(self) -> str:
        return f"{self.character_model_prefix()}/face_morpher.pt"

    def character_model_body_morpher_file_name(self) -> str:
        return f"{self.character_model_prefix()}/body_morpher.pt"

    def character_model_character_png_file_name(self) -> str:
        return f"{self.character_model_prefix()}/character.png"

    def character_model_yaml_file_name(self) -> str:
        return f"{self.character_model_prefix()}/character_model.yaml"


def copy_file(source_file_name: str, dest_file_name: str) -> None:
    os.makedirs(os.path.dirname(dest_file_name), exist_ok=True)
    shutil.copyfile(source_file_name, dest_file_name)
