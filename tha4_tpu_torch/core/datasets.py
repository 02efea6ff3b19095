"""Host-side datasets (counterpart of ``tha4_tpu/core/datasets.py``).

Reference: src/tha4/shion/base/dataset/ — LazyTensorDataset (lazy torch.load
-> TensorDataset), XformedDataset, PngInDirDataset, get_indexed_batch — and
src/tha4/dataset/image_poses_and_aother_images_dataset.py (pose row +
memoized constant images).

Datasets are indexable objects yielding CPU tensors (or whatever their
callables return); ``gather_batch`` is get_indexed_batch, a stacked gather.
Pose sampling for training lives in ``distiller.pose_dataset``; these
classes cover the file-backed cases.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


class LazyTensorDataset:
    """Rows of a tensor file, loaded on first access
    (reference lazy_tensor_dataset.py:7-31): a ``.npy`` array, or a ``.pt``
    tensor (the first of a saved list or tuple)."""

    def __init__(self, file_name: str):
        self.file_name = file_name
        self._data: Optional[torch.Tensor] = None

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            if self.file_name.endswith(".npy"):
                self._data = torch.from_numpy(np.load(self.file_name))
            else:
                loaded = torch.load(self.file_name, map_location="cpu", weights_only=True)
                if isinstance(loaded, (list, tuple)):
                    loaded = loaded[0]
                self._data = torch.as_tensor(loaded)
        return self._data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


class XformedDataset:
    """Apply a transform per item (reference XformedDataset)."""

    def __init__(self, base, xform: Callable):
        self.base = base
        self.xform = xform

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index):
        return self.xform(self.base[index])


class PngInDirDataset:
    """All PNGs under a directory, sorted by name, as model-unit HWC f32
    tensors through ``core.imagecodec.load_image_hwc`` (reference
    PngInDirDataset)."""

    def __init__(self, dir_name: str, scale: float = 2.0, offset: float = -1.0):
        self.dir_name = dir_name
        self.files = sorted(
            os.path.join(dir_name, f) for f in os.listdir(dir_name) if f.lower().endswith(".png")
        )
        self.scale = scale
        self.offset = offset

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index) -> torch.Tensor:
        from tha4_tpu_torch.core.imagecodec import load_image_hwc

        return torch.from_numpy(load_image_hwc(self.files[index], scale=self.scale, offset=self.offset))


class ImagePosesAndOtherImagesDataset:
    """Item = [constant character image, pose row, *constant extra images]
    (reference image_poses_and_aother_images_dataset.py:31-35).  The constant
    images are memoized."""

    def __init__(self, main_image_func: Callable, pose_dataset, other_image_funcs: Sequence[Callable] = ()):
        self.main_image_func = main_image_func
        self.pose_dataset = pose_dataset
        self.other_image_funcs = list(other_image_funcs)
        self._main = None
        self._others = None

    def __len__(self):
        return len(self.pose_dataset)

    def __getitem__(self, index) -> List:
        if self._main is None:
            self._main = self.main_image_func()
            self._others = [f() for f in self.other_image_funcs]
        return [self._main, self.pose_dataset[index], *self._others]


def gather_batch(dataset, indices) -> List[torch.Tensor]:
    """Stack items dataset[i] for i in indices, per field, into CPU tensors
    (reference shion/base/dataset/util.py get_indexed_batch)."""
    items = [dataset[int(i)] for i in indices]
    first = items[0]
    if isinstance(first, (list, tuple)):
        return [torch.stack([torch.as_tensor(it[k]) for it in items]) for k in range(len(first))]
    return [torch.stack([torch.as_tensor(it) for it in items])]
