"""The teacher posers of the PyTorch port (``poser/general_poser.py``, both
``create_poser``s and the ``tha4-torch-pose`` CLI) against the JAX package.

The GeneralPoser mechanics run with dummy networks, as
tests/test_general_poser.py pins them.  The posers run on the CPU in f32 at
the small widths of tests/test_torch_body_teacher.py:66-82 (mode_07) and
tests/test_torch_teacher.py:123-141 (mode_12), on the same images and poses
as those files' cascade tests, so those tests' bars hold here.
"""

import PIL.Image
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_body_teacher import MORPHER_ATOL, _teacher_cfgs, _to_jax_07
from tests.test_torch_teacher import COMBINER_ATOL, DECOMPOSER_ATOL, FACE_ATOL, _image_and_pose, _images, _jax_teacher
from tha4_tpu.apps import full_manual_poser as jfull_manual_poser
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu.poser.modes import mode_12 as jmode_12
from tha4_tpu_torch.apps import full_manual_poser
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, synthetic_character_image
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.ops import cuda_conv, cuda_warp
from tha4_tpu_torch.poser.general_poser import GeneralPoser
from tha4_tpu_torch.poser.modes import mode_07, mode_12

torch.set_num_threads(2)


class _Counter:
    def __init__(self):
        self.calls = 0
        self.loads = 0


def _make_poser(counter, subrect=None, with_prologue=True):
    def prologue_fn(params, image):
        counter.calls += 1
        return (image.mean(dim=(1, 2, 3)),)  # (N,) image-only summary

    def run_fn(params, image, pose, *prologue_outs):
        summary = prologue_outs[0] if prologue_outs else image.mean(dim=(1, 2, 3))
        first = image[:, 0, 0, :].sum(dim=-1)
        return (summary + pose.sum(dim=-1), first)

    def loader():
        counter.loads += 1
        return {}

    return GeneralPoser(image_size=16, output_length=2, params_loader=loader, run_fn=run_fn,
                        prologue_fn=prologue_fn if with_prologue else None, subrect=subrect, device="cpu")


def test_prologue_cached_per_image_object():
    c = _Counter()
    poser = _make_poser(c)
    image = np.random.default_rng(0).normal(size=(16, 16, 4)).astype(np.float32)
    out_a = poser.get_posing_outputs(image, np.zeros(45, np.float32))
    out_a2 = poser.get_posing_outputs(image, np.zeros(45, np.float32))
    out_b = poser.get_posing_outputs(image, np.ones(45, np.float32))
    assert poser.prologue_cache_misses == c.calls == 1 and c.loads == 1
    assert torch.equal(out_a[0], out_a2[0]) and out_a[0].dtype == torch.float32
    assert float(out_b[0][0]) != float(out_a[0][0])  # the pose still flows
    # A new object, even content-equal, misses; new content is never stale.
    image2 = image.copy()
    poser.get_posing_outputs(image2, np.zeros(45, np.float32))
    assert poser.prologue_cache_misses == 2
    out_c = poser.get_posing_outputs(image2 * 2.0, np.zeros(45, np.float32))
    assert poser.prologue_cache_misses == 3 and float(out_c[0][0]) != float(out_a[0][0])
    # A tensor on the device is keyed the same way.
    tensor = torch.from_numpy(image)
    for _ in range(3):
        poser.get_posing_outputs(tensor, np.zeros(45, np.float32))
    assert poser.prologue_cache_misses == 4


def test_prologue_cache_cleared_by_free():
    c = _Counter()
    poser = _make_poser(c)
    image = np.ones((16, 16, 4), np.float32)
    poser.get_posing_outputs(image, np.zeros(45, np.float32))
    poser.free()
    poser.get_posing_outputs(image, np.zeros(45, np.float32))
    assert poser.prologue_cache_misses == 2 and c.loads == 2  # the networks load again too


def test_prologue_matches_inline_computation():
    c = _Counter()
    split, inline = _make_poser(c, with_prologue=True), _make_poser(c, with_prologue=False)
    image = np.random.default_rng(1).normal(size=(16, 16, 4)).astype(np.float32)
    pose = np.linspace(0, 1, 45).astype(np.float32)
    for x, y in zip(split.get_posing_outputs(image, pose), inline.get_posing_outputs(image, pose)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def test_subrect_crops_before_everything():
    """subrect ((y0, y1), (x0, x1)) poses image[:, y0:y1, x0:x1, :]."""
    c = _Counter()
    sub, plain = _make_poser(c, subrect=((4, 20), (8, 24))), _make_poser(c)
    big = np.random.default_rng(2).normal(size=(32, 32, 4)).astype(np.float32)
    pose = np.zeros(45, np.float32)
    a = sub.get_posing_outputs(big, pose)
    b = plain.get_posing_outputs(np.ascontiguousarray(big[4:20, 8:24]), pose)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def posers_07():
    """The teacher and inputs of tests/test_torch_body_teacher.py's
    ``teacher_run``, through both packages' ``create_poser``."""
    jcfg, cfg = _teacher_cfgs()
    params = random_teacher_07(torch.Generator().manual_seed(31), cfg)
    with torch.no_grad():
        for net in ("body_morpher", "upscaler"):
            params[net]["body.last.2.weight"][4:6] *= 8.0
    jparams = jax.tree.map(jnp.asarray, _to_jax_07(params, jcfg))
    rng = np.random.default_rng(32)
    image = _images(int(rng.integers(1000)), 2)
    pose = rng.uniform(0.0, 1.0, (2, 45)).astype(np.float32)
    pose[:, 35:45] = rng.uniform(-1.0, 1.0, (2, 10))
    ref = jmode_07.create_poser(params=jparams, cfg=jcfg).get_posing_outputs(image, pose)
    return cfg, params, image, pose, [np.asarray(r) for r in ref]


def test_mode_07_create_poser_matches_jax_f32(posers_07, monkeypatch):
    """33 outputs at the bars of test_mode_07_all_33_outputs_match_jax_f32;
    over two poses of one image the decomposer runs once, and every call
    launches K6 once per ResBlock, once more per "same" ResBlock and once
    per U-Net's last conv (102 at the shipped widths), and warps five times;
    the poser's outputs equal ``compute_outputs`` of the same frozen teacher
    bit for bit."""
    cfg, params, image, pose, ref = posers_07
    poser = mode_07.create_poser(params=params, cfg=cfg, device="cpu")
    assert poser.get_output_length() == mode_07.OUTPUT_LENGTH == 33
    counts = {"k6": 0, "k2": 0}
    real_k6, real_k2 = cuda_conv.fused_affine_conv3_nchw, cuda_warp.grid_sample_fast
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a: counts.__setitem__("k6", counts["k6"] + 1) or real_k6(*a))
    monkeypatch.setattr(cuda_warp, "grid_sample_fast", lambda *a: counts.__setitem__("k2", counts["k2"] + 1) or real_k2(*a))
    ours = poser.get_posing_outputs(image, pose)
    again = poser.get_posing_outputs(image, pose)
    assert poser.prologue_cache_misses == 1
    unet_blocks = sum(2 if m.sampling == "same" else 1 for m in poser.params.modules() if isinstance(m, mode_07.body_morpher.unet.ResBlock))
    assert counts == {"k6": 2 * (unet_blocks + 2), "k2": 10}
    bars = [3e-3, 2e-4, 3e-3] + [2 * MORPHER_ATOL] * 8 + [4e-4] * 8 + [1e-4] * 8 + [2e-5] * 6
    for i, (o, a, r) in enumerate(zip(ours, again, ref)):
        assert o.dtype == torch.float32 and torch.equal(o, a), i
        np.testing.assert_allclose(o.numpy(), r, atol=bars[i], err_msg=f"output {i}")
        mse = float(np.mean((o.numpy().astype(np.float64) - r) ** 2))
        assert mse == 0.0 or 10.0 * np.log10(4.0 / mse) > 70.0, (i, mse)
    with torch.no_grad():
        inline = mode_07.compute_outputs(poser.params, torch.from_numpy(image), torch.from_numpy(pose))
    assert all(torch.equal(o, i) for o, i in zip(ours, inline))


def test_mode_12_create_poser_matches_jax_f32():
    """22 outputs at the bars of test_mode_12_all_22_outputs_match_jax_f32;
    no prologue, as in the JAX package."""
    jcfg, jparams, cfg = _jax_teacher()
    image, pose = _image_and_pose(np.random.default_rng(12))
    ref = jmode_12.create_poser(params=jax.tree.map(jnp.asarray, jparams), cfg=jcfg).get_posing_outputs(image, pose)
    poser = mode_12.create_poser(params=export_torch.face_teacher_state_dicts(jparams), cfg=cfg, device="cpu")
    ours = poser.get_posing_outputs(image, pose)
    assert len(ours) == len(ref) == poser.get_output_length() == 22 and poser.prologue_cache_misses == 0
    for i, (o, r) in enumerate(zip(ours, ref)):
        atol, floor = (2 * FACE_ATOL, 50.0) if i < 8 else (2 * COMBINER_ATOL, 70.0) if i < 16 else (DECOMPOSER_ATOL, 90.0)
        r = np.asarray(r)
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape, i
        np.testing.assert_allclose(o.numpy(), r, atol=atol, err_msg=f"output {i}")
        mse = float(np.mean((o.numpy().astype(np.float64) - r) ** 2))
        assert mse == 0.0 or 10.0 * np.log10(4.0 / mse) > floor, (i, mse)


@pytest.mark.parametrize("flag", ["--list-params", "--list-outputs"])
def test_cli_lists_match_jax(capsys, flag):
    assert jfull_manual_poser.main([flag]) == 0
    theirs = capsys.readouterr().out
    assert full_manual_poser.main([flag]) == 0
    ours = capsys.readouterr().out
    assert ours == theirs and len(ours.splitlines()) == (45 if flag == "--list-params" else 33)


def test_cli_poses_from_module_files_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Five ``--module-file`` state dicts of a small random teacher (its
    configuration patched in for the shipped one), a synthetic character, one
    pose and a sweep of two: every PNG written, the decomposer run once."""
    _, cfg = _teacher_cfgs()
    monkeypatch.setattr(mode_07, "TeacherConfig", lambda: cfg)
    params = random_teacher_07(torch.Generator().manual_seed(5), cfg)
    files = []
    for key in mode_07.NETWORK_KEYS:
        path = tmp_path / f"{key}.pt"
        torch.save(params[key], path)
        files += ["--module-file", f"{key}={path}"]
    png = tmp_path / "character.png"
    PIL.Image.fromarray(synthetic_character_image(512, 3), "RGBA").save(png)
    posers = []
    real_create = mode_07.create_poser
    monkeypatch.setattr(mode_07, "create_poser", lambda **kw: posers.append(real_create(**kw)) or posers[-1])

    out = tmp_path / "out.png"
    assert full_manual_poser.main(["--input", str(png), *files, "--set", "head_y=0.5", "--output", str(out), "--device", "cpu"]) == 0
    sweep = tmp_path / "sweep"
    assert full_manual_poser.main(["--input", str(png), *files, "--sweep", "head_y", "--frames", "2", "--output-dir", str(sweep),
                                   "--output-index", "3", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert PIL.Image.open(out).size == (512, 512) and PIL.Image.open(out).mode == "RGBA"
    frames = sorted(p.name for p in sweep.iterdir())
    assert frames == ["head_y_000.png", "head_y_001.png"] and PIL.Image.open(sweep / frames[0]).mode == "RGB"
    assert printed.count(" ms") == 3 and "device" not in printed
    assert [p.prologue_cache_misses for p in posers] == [1, 1]
