"""The port's indexed task families and host-side datasets against the JAX
copies (``tha4_tpu/tasks/indexed.py``, ``tha4_tpu/core/datasets.py``), on
the behaviour tests/test_aux.py:15-126 pins: the same files, calls and
arrays from both packages."""

import os

import numpy as np
import PIL.Image
import pytest
import torch

from tha4_tpu.core import datasets as jdatasets
from tha4_tpu.tasks import indexed as jindexed
from tha4_tpu.tasks.workspace import Workspace as JWorkspace
from tha4_tpu_torch.core import datasets
from tha4_tpu_torch.tasks import indexed
from tha4_tpu_torch.tasks.workspace import Workspace


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("suffix", [".npy", ".pt"])
def test_lazy_tensor_dataset_loads_rows_on_first_access(tmp_path, suffix):
    data = np.random.default_rng(0).uniform(0, 1, (10, 45)).astype(np.float32)
    path = str(tmp_path / f"poses{suffix}")
    if suffix == ".npy":
        np.save(path, data)
    else:
        torch.save([torch.from_numpy(data)], path)
    ds = datasets.LazyTensorDataset(path)
    assert ds._data is None
    assert len(ds) == 10
    np.testing.assert_array_equal(_np(ds[3]), data[3])
    np.testing.assert_array_equal(_np(ds[3]), jdatasets.LazyTensorDataset(path)[3])


def test_xformed_dataset_and_gather_batch_match_jax(tmp_path):
    path = str(tmp_path / "poses.npy")
    np.save(path, np.arange(20, dtype=np.float32).reshape(10, 2))
    ours = datasets.gather_batch(datasets.XformedDataset(datasets.LazyTensorDataset(path), lambda r: r * 2), [0, 2, 4])
    theirs = jdatasets.gather_batch(jdatasets.XformedDataset(jdatasets.LazyTensorDataset(path), lambda r: r * 2),
                                    [0, 2, 4])
    assert len(ours) == len(theirs) == 1
    np.testing.assert_array_equal(_np(ours[0]), theirs[0])
    np.testing.assert_array_equal(_np(ours[0]), np.asarray([[0, 2], [8, 10], [16, 18]], np.float32))


def test_image_poses_dataset_memoizes_and_gathers_fields():
    for module in (datasets, jdatasets):
        calls = []

        def image(calls=calls):
            calls.append(1)
            return np.zeros((4, 4, 4), np.float32)

        ds = module.ImagePosesAndOtherImagesDataset(image, np.arange(5, dtype=np.float32), [lambda: np.ones((2, 2))])
        _ = ds[0]
        _ = ds[1]
        assert len(calls) == 1
        assert ds[2][1] == 2 and len(ds) == 5
        batch = module.gather_batch(ds, [1, 3])
        assert [tuple(np.shape(b)) for b in batch] == [(2, 4, 4, 4), (2,), (2, 2, 2)]
        np.testing.assert_array_equal(_np(batch[1]), [1.0, 3.0])


def test_png_in_dir_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for name in ("b.png", "a.png", "skip.txt"):
        rgba = rng.integers(0, 256, size=(8, 8, 4), dtype=np.uint8)
        rgba[..., 3] = np.maximum(rgba[..., 3], 1)
        if name.endswith(".png"):
            PIL.Image.fromarray(rgba, "RGBA").save(tmp_path / name)
        else:
            (tmp_path / name).write_text("x")
    ours, theirs = datasets.PngInDirDataset(str(tmp_path)), jdatasets.PngInDirDataset(str(tmp_path))
    assert [os.path.basename(f) for f in ours.files] == ["a.png", "b.png"] == [os.path.basename(f) for f in theirs.files]
    for i in range(2):
        assert ours[i].dtype == torch.float32
        np.testing.assert_allclose(ours[i].numpy(), theirs[i], atol=2e-6, rtol=0)


@pytest.mark.parametrize("doubly", [False, True])
def test_indexed_file_tasks_match_jax(tmp_path, doubly):
    """Both packages' families over their own workspaces: the same names,
    the same runs in the same order, the umbrella runs each member once,
    and a second session runs nothing."""
    runs = {}
    for tag, ws, module in (("port", Workspace(), indexed), ("jax", JWorkspace(), jindexed)):
        root = tmp_path / tag
        root.mkdir()
        done = runs.setdefault(tag, [])

        def write(*index, root=root, done=done):
            done.append(index)
            (root / ("f" + "_".join(map(str, index)) + ".txt")).write_text(str(index))

        if doubly:
            names = module.define_doubly_indexed_file_tasks(
                ws, lambda i, j, root=root: str(root / f"f{i}_{j}.txt"), lambda i, j: [], write, 2, 3, "all")
        else:
            names = module.define_indexed_file_tasks(
                ws, lambda i, root=root: str(root / f"f{i}.txt"), lambda i: [], write, 3, "all")
        ws.run("all")
        ws.start_session()
        ws.run("all")
        assert [os.path.relpath(n, root) for n in names] == sorted(os.listdir(root))
    assert runs["port"] == runs["jax"]
    assert len(runs["port"]) == (6 if doubly else 3)
