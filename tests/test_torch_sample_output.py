"""Sample grids in the PyTorch port against the JAX package.

The grid writer (``tha4_tpu_torch/distiller/sample_output.py``) against
``tha4_tpu/distiller/sample_output.py`` on seeded arrays: the same PNG
pixels for every render type, cells resized both ways.  The two students'
sample renders (``DistillationJobs.render_face_samples`` /
``render_body_samples``) against the JAX package's jitted renders
(``jobs._face_sample_render`` / ``_body_sample_render``) on the same teacher
and student weights (JAX's, bridged) and the same poses, in f32, at the
bars of tests/test_torch_teacher.py, tests/test_torch_body_teacher.py and
tests/test_torch_mode14.py.  Sizes are the small teachers and students of
tests/test_torch_{face,body}_distill.py at the real geometry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tests.test_torch_body_distill import _student_cfgs, _student_params
from tests.test_torch_body_teacher import _teacher_cfgs, _to_jax_07
from tests.test_torch_face_distill import _students
from tests.test_torch_mode14 import F32_ATOL
from tests.test_torch_teacher import FACE_ATOL, _jax_teacher
from tha4_tpu.distiller import sample_output as jsample_output
from tha4_tpu.distiller.config import DistillerConfig as JDistillerConfig
from tha4_tpu.distiller.pipeline import DistillationJobs as JDistillationJobs
from tha4_tpu.models import siren as jsiren
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.distiller import sample_output
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs
from tha4_tpu_torch.models import siren

torch.set_num_threads(2)

# The teachers' f32 bars: the face morph (tests/test_torch_teacher.py:177)
# and mode_07's posed output (tests/test_torch_body_teacher.py:250).
FACE_TEACHER_ATOL = 2 * FACE_ATOL
POSED_ATOL = 3e-3


def _pngs_equal(a: str, b: str) -> np.ndarray:
    pa, pb = np.asarray(PIL.Image.open(a)), np.asarray(PIL.Image.open(b))
    np.testing.assert_array_equal(pa, pb)
    return pa


def test_grid_change_to_rgb_matches_jax():
    rng = np.random.default_rng(3)
    flow = (rng.standard_normal((33, 17, 2)) * 0.2).astype(np.float32)
    flow[0, 0] = 0.0  # the angle at zero flow
    ours, ref = sample_output.grid_change_to_rgb(flow), jsample_output.grid_change_to_rgb(flow)
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (33, 17, 3) and 0.0 <= ours.min() and ours.max() <= 1.0


@pytest.mark.parametrize("size", [16, 32, 64])
def test_save_sample_grid_pixels_match_jax(tmp_path, size):
    """Every render type, at a cell of 32: the 16^2 inputs repeated, the
    64^2 ones strided; the PNGs' pixels equal."""
    rng = np.random.default_rng(size)
    kinds = [(sample_output.ImageType.COLOR, jsample_output.ImageType.COLOR, 4),
             (sample_output.ImageType.ALPHA, jsample_output.ImageType.ALPHA, 1),
             (sample_output.ImageType.GRID_CHANGE, jsample_output.ImageType.GRID_CHANGE, 2),
             (sample_output.ImageType.SIGMOID_LOGIT, jsample_output.ImageType.SIGMOID_LOGIT, 1)]
    rows = [[rng.uniform(-1.0, 1.0, (size, size, c)).astype(np.float32) for _, _, c in kinds] for _ in range(3)]
    ours = [[(a, k) for a, (k, _, _) in zip(row, kinds)] for row in rows]
    ref = [[(a, k) for a, (_, k, _) in zip(row, kinds)] for row in rows]
    sample_output.save_sample_grid(ours, str(tmp_path / "port.png"), cell_size=32)
    jsample_output.save_sample_grid(ref, str(tmp_path / "jax.png"), cell_size=32)
    pixels = _pngs_equal(str(tmp_path / "port.png"), str(tmp_path / "jax.png"))
    assert pixels.shape == (3 * 32, 4 * 32, 4)


def test_column_spec_grid_and_file_name_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    batch = [rng.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)]
    outputs = [rng.uniform(-1, 1, (2, 16, 16, 2)).astype(np.float32), rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)]
    for module, name in ((sample_output, "port.png"), (jsample_output, "jax.png")):
        specs = [module.SampleImageSpec(module.ImageSource.BATCH, 0, module.ImageType.COLOR),
                 module.SampleImageSpec(module.ImageSource.OUTPUT, 0, module.ImageType.GRID_CHANGE),
                 module.SampleImageSpec(module.ImageSource.OUTPUT, 1, module.ImageType.ALPHA)]
        module.save_sample_output_image(batch, outputs, specs, str(tmp_path / name), cell_size=16)
    _pngs_equal(str(tmp_path / "port.png"), str(tmp_path / "jax.png"))
    for seen in (0, 10_000, 1_500_000):
        assert sample_output.sample_output_file_name("p/face_morpher", seen) == jsample_output.sample_output_file_name("p/face_morpher", seen)
    assert sample_output.sample_output_file_name("p", 10_000).endswith("sample_outputs/sample_output_0000010000.png")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return DistillerConfig.load(write_distiller_inputs(str(tmp_path_factory.mktemp("samples")), seed=31, batch_size=2, sample_cadence=10_000))


def _jax_jobs(inputs, prefix, **kwargs):
    config = dataclasses.replace(JDistillerConfig.load(inputs.prefix + "/../config.yaml"), prefix=prefix)
    return JDistillationJobs(config, compute_dtype=jnp.float32, **kwargs)


def test_face_render_matches_jax_f32(inputs, tmp_path):
    jtcfg, tparams, tcfg = _jax_teacher(seed=17)
    jscfg, scfg = _students()
    sparams = jax.tree.map(np.asarray, jsiren.siren_face_morpher_init(jax.random.PRNGKey(6), jscfg))
    jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path / "port")),
                            teacher_params_12=export_torch.face_teacher_state_dicts(tparams), teacher_cfg_12=tcfg,
                            compute_dtype=torch.float32, device="cpu")
    jobs.face_student_cfg = scfg
    student = siren.SirenFaceMorpher(scfg)
    student.load_state_dict(export_torch.siren_face_morpher_state_dict(sparams))
    poses = jobs.sample_poses(inputs.face_morpher_random_seed_1, 8)
    np.testing.assert_array_equal(poses.numpy(), jobs.sample_poses(inputs.face_morpher_random_seed_1, 8).numpy())
    gt, pred = jobs.render_face_samples(student, poses)

    jjobs = _jax_jobs(inputs, str(tmp_path / "jax"), teacher_params_12=tparams, teacher_cfg_12=jtcfg)
    jjobs.face_student_cfg = jscfg
    jjobs._write_face_samples(sparams, tparams, jjobs.character_image, 0)  # builds the jitted render
    image_b = jnp.broadcast_to(jjobs.character_image, (8, 512, 512, 4))
    jgt, jpred = (np.asarray(x) for x in jjobs._face_sample_render(tparams, sparams, image_b, jnp.asarray(poses.numpy())))
    assert gt.shape == jgt.shape == pred.shape == (8, 128, 128, 4)
    np.testing.assert_allclose(gt, jgt, atol=FACE_TEACHER_ATOL)
    np.testing.assert_allclose(pred, jpred, atol=F32_ATOL["face"])

    jobs.write_face_samples(student, 10_000)
    png = np.asarray(PIL.Image.open(sample_output.sample_output_file_name(jobs.config.face_morpher_prefix(), 10_000)))
    assert png.shape == (8 * 128, 2 * 128, 4)


def test_body_render_matches_jax_f32(inputs, tmp_path):
    jtcfg, tcfg = _teacher_cfgs()
    tparams = random_teacher_07(torch.Generator().manual_seed(43), tcfg)
    jt = _to_jax_07(tparams, jtcfg)
    jscfg, scfg = _student_cfgs()
    sparams = _student_params(jscfg, 7)
    jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path / "port")), teacher_params_07=tparams,
                            teacher_cfg_07=tcfg, compute_dtype=torch.float32, device="cpu")
    jobs.body_student_cfg = scfg
    student = siren.SirenMorpher(scfg)
    student.load_state_dict(export_torch.siren_morpher_state_dict(sparams))
    poses = jobs.sample_poses(inputs.body_morpher_random_seed_1, 4)
    ours = jobs.render_body_samples(student, poses)

    jjobs = _jax_jobs(inputs, str(tmp_path / "jax"), teacher_params_07=jt, teacher_cfg_07=jtcfg)
    jjobs.body_student_cfg = jscfg
    jjobs._write_body_samples(sparams, jt, jjobs.character_image, 0)
    image_b = jnp.broadcast_to(jjobs.character_image, (4, 512, 512, 4))
    ref = [np.asarray(x) for x in jjobs._body_sample_render(jt, sparams, image_b, jnp.asarray(poses.numpy()))]
    for name, a, r, bar in zip(("posed", "blended", "alpha", "grid_change"), ours, ref,
                               (POSED_ATOL, F32_ATOL["blended"], F32_ATOL["alpha"], F32_ATOL["grid_change"])):
        assert a.shape == r.shape and a.shape[:3] == (4, 512, 512), name
        np.testing.assert_allclose(a, r, atol=bar, err_msg=name)
    assert float(np.abs(ref[3]).max()) > 1e-3  # the student's flows are not zero

    jobs.write_body_samples(student, 0)
    png = np.asarray(PIL.Image.open(sample_output.sample_output_file_name(jobs.config.body_morpher_prefix(), 0)))
    assert png.shape == (4 * 512, 4 * 512, 4)


@pytest.mark.parametrize("kind", ["face", "body"])
def test_each_render_packs_the_live_student(inputs, tmp_path, kind):
    """Two renders with an optimizer step between them differ, and each
    equals the render of a fresh copy of the student as it stood (a fresh
    pack): no packed weights outlive a render.  The render leaves the
    module's mode, dtype and gradients as they were."""
    import copy

    if kind == "face":
        _, tparams, tcfg = _jax_teacher(seed=19)
        jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path)), compute_dtype=torch.float32, device="cpu",
                                teacher_params_12=export_torch.face_teacher_state_dicts(tparams), teacher_cfg_12=tcfg)
        student, n, seed = siren.SirenFaceMorpher(_students()[1]), 8, inputs.face_morpher_random_seed_1
    else:
        tcfg = _teacher_cfgs()[1]
        jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path)), compute_dtype=torch.float32, device="cpu",
                                teacher_params_07=random_teacher_07(torch.Generator().manual_seed(47), tcfg), teacher_cfg_07=tcfg)
        student, n, seed = siren.SirenMorpher(_student_cfgs()[1]), 4, inputs.body_morpher_random_seed_1
    render = getattr(jobs, f"render_{kind}_samples")
    poses = jobs.sample_poses(seed, n)
    before = copy.deepcopy(student)
    first = render(student, poses)
    assert student.training and all(p.dtype == torch.float32 and p.grad is None for p in student.parameters())
    optimizer = torch.optim.Adam(student.parameters(), lr=1e-3)
    sum(p.sum() for p in student.parameters()).backward()
    optimizer.step()
    second = render(student, poses)
    assert any(not np.array_equal(a, b) for a, b in zip(first[1:], second[1:]))  # the student's columns moved
    for ours, ref in ((first, render(before, poses)), (second, render(copy.deepcopy(student), poses))):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["face", "body"])
def test_renders_run_in_f32_whatever_the_compute_dtype(inputs, tmp_path, kind):
    """The grid's teacher and student columns are rendered in f32, as the
    JAX render runs its f32 params: a job whose compute dtype is bf16 (the
    CLI's default) renders exactly what an f32 job renders, so the f32 bars
    against JAX above hold for the shipped precision too.  Its labels'
    teacher stays in bf16."""
    renders = {}
    for dtype in (torch.bfloat16, torch.float32):
        if kind == "face":
            _, tparams, tcfg = _jax_teacher(seed=19)
            jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path)), compute_dtype=dtype, device="cpu",
                                    teacher_params_12=export_torch.face_teacher_state_dicts(tparams), teacher_cfg_12=tcfg)
            student = siren.SirenFaceMorpher(_students()[1], generator=torch.Generator().manual_seed(3))
            n, seed = 8, inputs.face_morpher_random_seed_1
            conv = jobs.face_teacher().face_morpher.eye_alpha[0]
        else:
            tcfg = _teacher_cfgs()[1]
            jobs = DistillationJobs(dataclasses.replace(inputs, prefix=str(tmp_path)), compute_dtype=dtype, device="cpu",
                                    teacher_params_07=random_teacher_07(torch.Generator().manual_seed(47), tcfg), teacher_cfg_07=tcfg)
            student = siren.SirenMorpher(_student_cfgs()[1], generator=torch.Generator().manual_seed(3))
            n, seed = 4, inputs.body_morpher_random_seed_1
            conv = jobs.body_teacher().upscaler.body.first_conv
        assert conv.weight.dtype == dtype  # the labels' teacher
        renders[dtype] = getattr(jobs, f"render_{kind}_samples")(student, jobs.sample_poses(seed, n))
    for ours, ref in zip(renders[torch.bfloat16], renders[torch.float32]):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
