"""The port's frame bench (``tha4_tpu_torch.tools.bench``) on the CPU: its
pose sweep against the JAX bench's formulas, its frame loop on a narrow
student, and its last line's keys against the JAX bench's.  The bench's
``main`` needs a card and is run by ``tests/test_torch_card_frame.py``."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tha4_tpu.poser.modes import pose_parameters as jpose_parameters
from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_14, pose_parameters
from tha4_tpu_torch.tools import bench
from test_torch_mode14 import _port_cfgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# XLA's f32 sin on the CPU is up to 2.4e-6 from the correctly rounded value
# on these arguments (read beside numpy's f64 sin), and the JAX sweep
# rounds i / d to f32 first (|i / d| < 34, so up to 2e-6 of argument); the
# blink multiplies its sine by 8.  The port's sweep is the formulas in f64,
# rounded once.  Reads 3.8e-6.
SWEEP_ATOL = 8 * 5e-6


def _jax_sweep(n):
    """bench.py:56-72, the same formulas in jnp."""
    pp = jpose_parameters.get_pose_parameters()
    idx = {name: pp.get_parameter_index(name) for name in (
        "head_x", "head_y", "neck_z", "body_z", "breathing", "mouth_aaa", "eye_wink_left", "eye_wink_right")}
    p0 = jnp.asarray(pp.get_default_pose())[None]

    def pose_at(p0, i):
        pose = p0
        pose = pose.at[0, idx["head_x"]].set(0.6 * jnp.sin(i / 4.0))
        pose = pose.at[0, idx["head_y"]].set(jnp.sin(i / 10.0))
        pose = pose.at[0, idx["neck_z"]].set(0.5 * jnp.sin(i / 6.0))
        pose = pose.at[0, idx["body_z"]].set(0.4 * jnp.sin(i / 9.0))
        pose = pose.at[0, idx["breathing"]].set(0.5 + 0.5 * jnp.sin(i / 5.0))
        pose = pose.at[0, idx["mouth_aaa"]].set(0.5 + 0.5 * jnp.sin(i / 3.0))
        blink = jnp.clip(jnp.sin(i / 7.0) * 8.0 - 7.0, 0.0, 1.0)
        pose = pose.at[0, idx["eye_wink_left"]].set(blink)
        pose = pose.at[0, idx["eye_wink_right"]].set(blink)
        return pose

    sweep = jax.jit(jax.vmap(lambda i: pose_at(p0, i)[0]))
    return np.asarray(sweep(jnp.arange(n, dtype=jnp.float32)))


def test_pose_sweep_matches_the_jax_bench():
    ours = bench.pose_sweep(pose_parameters.get_pose_parameters(), 100)
    theirs = _jax_sweep(100)
    assert ours.shape == theirs.shape == (100, 45) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0.0, atol=SWEEP_ATOL)
    moved = np.nonzero((ours != ours[0]).any(axis=0))[0]
    assert len(moved) == 8  # the eight swept parameters, the rest the default pose
    assert ours[:, moved].min() < -0.99 and ours[:, moved].max() > 0.99  # the full ranges are swept


def test_frame_loop_equals_frames_one_by_one():
    face_cfg, body_cfg = _port_cfgs()
    gen = torch.Generator().manual_seed(8)
    poser = mode_14.StudentPoser(siren.SirenFaceMorpher(face_cfg, generator=gen),
                                 siren.SirenMorpher(body_cfg, generator=gen), compute_dtype=torch.bfloat16, device="cpu")
    image = imagecodec.load_image_hwc(PIL.Image.fromarray(synthetic_character_image(512, seed=2), mode="RGBA"))
    sweep = bench.pose_sweep(poser.pose_parameters, 3)
    acc = torch.zeros(())
    with torch.no_grad():
        total = bench.frame_sum(poser, torch.from_numpy(image)[None].bfloat16(), torch.from_numpy(sweep).bfloat16(), acc)
    assert total is acc and bool(torch.isfinite(acc))
    expected = torch.zeros(())
    for pose in sweep:
        expected += poser.get_posing_outputs(image, pose)[0].mean()
    assert float(acc) == float(expected)


def _jax_bench_keys():
    """The keys of the dict that the root bench.py prints."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    dicts = [node for node in ast.walk(tree) if isinstance(node, ast.Dict) and node.keys]
    keys = [{k.value for k in d.keys} for d in dicts]
    return next(k for k in keys if "metric" in k)


def test_last_line_has_the_jax_bench_keys_and_the_card():
    line = bench.headline(123.456, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(line) == _jax_bench_keys() | {"device"} == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["metric"] == "student_512x512_frames_per_sec_per_chip" and line["unit"] == "fps"
    assert line["value"] == 123.46 and line["vs_baseline"] == round(123.456 / 60.0, 3)


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code == 2
