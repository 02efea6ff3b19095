"""The port's A/B and run-report tools (``tha4_tpu_torch/tools/{body_eval,
dtype_ab,quant_ab,run_report,eval_body_checkpoint}.py``) and the body
recipe's ``teacher_dtype``, against the JAX package, on the CPU.

Sizes are small: the tiny mode_07 teacher of tests/test_torch_body_teacher.py
at the real 512^2 geometry and the 3-level student, 16/8/8 channels wide, of
tests/test_torch_body_distill.py, batch 2.  The JAX tools' ``main``s read
files under a path the repository does not hold, so their evaluation is
rebuilt here from ``mode_07.compute_outputs`` and
``siren_morpher_apply_nhwc``; the JAX ``tools/run_report.py`` reads only its
argument and is loaded by path.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tests.test_torch_body_distill import BF16_OUT_STEPS, _student_cfgs, _student_params
from tests.test_torch_body_teacher import _jax, _teacher_cfgs, _to_jax_07
from tha4_tpu.distiller import recipes as jrecipes
from tha4_tpu.models import siren as jsiren
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, synthetic_character_image, write_distiller_inputs
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.tools import body_eval, dtype_ab, eval_body_checkpoint, quant_ab, run_report
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.utils import fidelity

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
WEIGHTS = [1.0, 2.5, 5.0, 1.0]  # dtype_ab's, in BODY_LOSS_TERMS order
# f32 student, port against JAX on the same input: the rtol of
# tests/test_torch_body_distill.py::test_body_step_losses_match_jax_f32.
F32_RTOL = 1e-5
# bf16 labels, port against JAX, each as far from JAX's f32 labels as JAX's
# own bf16 labels are: the bars of tests/test_torch_body_teacher.py::
# test_bf16_unet_is_as_close_to_f32_as_jax_bf16 (RMS at most JAX's, largest
# error within 1.5x), the RMS one at 1.05x for the five-network cascade
# (read 0.995x-1.003x, largest 1.10x-1.14x).
LABEL_RMS_RATIO, LABEL_MAX_RATIO = 1.05, 1.5


@pytest.fixture(scope="module")
def setup():
    """The tiny teacher (both packages' params), the student's params, a
    synthetic character and two seeded poses."""
    jtcfg, tcfg = _teacher_cfgs()
    tparams = random_teacher_07(torch.Generator().manual_seed(41), tcfg)
    jscfg, scfg = _student_cfgs()
    sparams = _student_params(jscfg, 5)
    image = imagecodec.load_image_hwc(PIL.Image.fromarray(synthetic_character_image(512, 3), mode="RGBA"))[None]
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(8), 2).numpy()
    return dict(jtcfg=jtcfg, tcfg=tcfg, tparams=tparams, jt=_jax(_to_jax_07(tparams, jtcfg)), jscfg=jscfg, scfg=scfg,
                sparams=sparams, image=image, poses=poses, jax_teacher=jax.jit(functools.partial(jmode_07.compute_outputs, jtcfg)))


def _student(setup, dtype=torch.float32):
    student = siren.SirenMorpher(setup["scfg"])
    student.load_state_dict(export_torch.siren_morpher_state_dict(setup["sparams"]))
    return student.to(dtype)


def _teacher(setup, dtype):
    return mode_07.Teacher.from_params(setup["tparams"], setup["tcfg"]).freeze(dtype, "cpu")


# ---------------------------------------------------------------------------
# (a) teacher_dtype
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split_step(setup):
    """JAX's bf16-teacher / f32-student chunk (one step, lookahead 1) and
    its bf16 labels; the port's step and labels on the same inputs."""
    poses = setup["poses"]
    chunk = jrecipes.make_body_distill_chunk(setup["jtcfg"], setup["jscfg"], lambda key, n: jnp.asarray(poses), batch_size=2,
                                             compute_dtype=jnp.float32, lookahead=1, teacher_dtype=jnp.bfloat16)
    js = _jax(setup["sparams"])
    _, _, jnamed = chunk(js, jrecipes.adam_init(js), setup["jt"], jnp.asarray(setup["image"]), jax.random.PRNGKey(0),
                         jnp.float32(LR), jnp.asarray(WEIGHTS, jnp.float32), n_steps=1)
    run = setup["jax_teacher"]
    image_b = jnp.broadcast_to(jnp.asarray(setup["image"]), (2, 512, 512, 4))
    picked = (0, 2, 3, jmode_07.INDEX_FACE_MORPHED_FULL)
    j16 = run(setup["jt"], image_b.astype(jnp.bfloat16), jnp.asarray(poses).astype(jnp.bfloat16))
    j32 = run(setup["jt"], image_b, jnp.asarray(poses))
    teacher16 = _teacher(setup, torch.bfloat16)
    image, tposes = torch.from_numpy(setup["image"]), torch.from_numpy(poses)
    labels = recipes.body_teacher_targets(teacher16, image, tposes, torch.float32, None, torch.bfloat16)
    student = _student(setup)
    step = recipes.make_body_distill_step(teacher16, image, torch.float32, teacher_dtype=torch.bfloat16)
    named = step(student, recipes.make_adam(student), tposes, LR, dict(zip(recipes.BODY_LOSS_TERMS, WEIGHTS)))
    return dict(jnamed={k: float(v) for k, v in jnamed.items()}, named={k: float(v) for k, v in named.items()},
                j16=[np.asarray(j16[i].astype(jnp.float32)) for i in picked], j32=[np.asarray(j32[i]) for i in picked],
                labels=labels)


def test_split_arm_labels_are_bf16_and_as_close_to_f32_as_jax_bf16(split_step):
    labels, j16, j32 = split_step["labels"], split_step["j16"], split_step["j32"]
    assert [t.dtype for t in labels] == [torch.bfloat16] * 4
    rms = lambda d: float(np.sqrt(np.mean(d * d)))
    for i, (ours, theirs, exact) in enumerate(zip(labels, j16, j32)):
        ours = ours.float().numpy()
        assert rms(ours - exact) <= LABEL_RMS_RATIO * rms(theirs - exact), i
        assert np.abs(ours - exact).max() <= LABEL_MAX_RATIO * np.abs(theirs - exact).max(), i


def test_split_arm_step_matches_jax_chunk(setup, split_step):
    """The four weighted terms and the loss of the bf16-teacher / f32-student
    step against JAX's chunk.  Each term is w x mean|label - prediction|,
    so by the triangle inequality two runs differ by at most w x (mean
    |label difference| + mean |prediction difference|): the bar, with the
    label difference between the two packages' bf16 labels and the
    prediction difference the port's f32 student's on the two packages'
    inputs (face_morphed_full), plus the f32 students' own rtol.  The grid
    change and colour are the SIREN head's, which the image does not reach.
    Measured well inside (colour 3.0e-4 against 2.0e-3)."""
    labels = [t.float().numpy() for t in split_step["labels"]]
    j16 = split_step["j16"]
    student = _student(setup)
    poses = torch.from_numpy(setup["poses"])
    with torch.no_grad():
        ours, theirs = (siren.siren_morpher_train_apply(student, torch.from_numpy(x), poses, torch.float32)
                        for x in (labels[3], np.array(j16[3])))
    d_pred = [float((a - b).abs().mean()) for a, b in zip(ours, theirs)]
    d_label = [float(np.abs(a - b).mean()) for a, b in zip(labels, j16)]
    bars = {
        "full_blended": WEIGHTS[0] * (d_label[0] + d_pred[siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE]),
        "full_warped": WEIGHTS[1] * (d_label[1] + d_pred[siren.SIREN_MORPHER_INDEX_WARPED_IMAGE]),
        "full_grid_change": WEIGHTS[2] * d_label[2],
        "full_color_change": WEIGHTS[3] * d_label[0],
    }
    assert d_pred[siren.SIREN_MORPHER_INDEX_GRID_CHANGE] == d_pred[siren.SIREN_MORPHER_INDEX_COLOR_CHANGE] == 0.0
    bars["loss"] = sum(bars.values())
    named, jnamed = split_step["named"], split_step["jnamed"]
    assert named.keys() == jnamed.keys() == set(recipes.BODY_LOSS_TERMS) | {"loss"}
    for name, bar in bars.items():
        assert abs(named[name] - jnamed[name]) <= bar + F32_RTOL * abs(jnamed[name]), (name, named[name], jnamed[name], bar)


def _parent_step(teacher, image, poses, dtype, mixed, student, optimizer, weights):
    """The body step as the recipe made it before ``teacher_dtype``: one
    dtype for the teacher's inputs, its labels and the student."""
    with torch.no_grad():
        t = mode_07.compute_outputs(teacher, image.to(dtype).expand(len(poses), *image.shape[1:]), poses.to(dtype))
    targets = tuple(t[i] for i in (0, 2, 3, mode_07.INDEX_FACE_MORPHED_FULL))
    optimizer.zero_grad(set_to_none=True)
    return recipes.adam_step(optimizer, *recipes.body_loss(student, targets, poses, weights, dtype, mixed), LR)


@pytest.mark.parametrize("dtype,mixed", [(torch.float32, False), (torch.bfloat16, True)])
def test_teacher_dtype_none_is_the_plain_step_bit_for_bit(setup, dtype, mixed):
    """``teacher_dtype`` None (omitted) or equal to ``dtype``, and the step
    as the recipe made it before: the same losses and parameters, bit for
    bit."""
    teacher = _teacher(setup, dtype)
    image, poses = torch.from_numpy(setup["image"]), torch.from_numpy(setup["poses"])
    weights = dict(zip(recipes.BODY_LOSS_TERMS, WEIGHTS))
    runs = []
    for how in ("omitted", dtype, "parent"):
        student = _student(setup)
        optimizer = recipes.make_adam(student)
        if how == "parent":
            named = _parent_step(teacher, image, poses, dtype, mixed, student, optimizer, weights)
        else:
            kw = {} if how == "omitted" else {"teacher_dtype": how}  # omitted: None
            named = recipes.make_body_distill_step(teacher, image, dtype, mixed, **kw)(student, optimizer, poses, LR, weights)
        runs.append((named, student.state_dict()))
    (named0, state0), *rest = runs
    for named, state in rest:
        assert all(torch.equal(named0[k], named[k]) for k in named0)
        assert all(torch.equal(state0[k], state[k]) for k in state0)


@pytest.mark.parametrize("frozen,dtype,teacher_dtype", [(torch.bfloat16, torch.float32, None),
                                                        (torch.float32, torch.float32, torch.bfloat16)])
def test_teacher_frozen_in_another_dtype_raises(setup, frozen, dtype, teacher_dtype):
    teacher = _teacher(setup, frozen)
    student = _student(setup)
    step = recipes.make_body_distill_step(teacher, torch.from_numpy(setup["image"]), dtype, teacher_dtype=teacher_dtype)
    with pytest.raises(ValueError, match="frozen"):
        step(student, recipes.make_adam(student), torch.from_numpy(setup["poses"]), LR, dict(zip(recipes.BODY_LOSS_TERMS, WEIGHTS)))


# ---------------------------------------------------------------------------
# (b) body_eval
# ---------------------------------------------------------------------------


def _jax_eval(setup, poses, batch, jdtype):
    """The JAX tools' ``eval_losses`` / ``evaluate`` pair on the same
    weights (``tools/dtype_ab.py:83-117``), the teacher through the
    module's one jitted ``compute_outputs``."""
    jscfg = setup["jscfg"]

    @jax.jit
    def student_losses(sparams, poses, t0, t2, t3, t5):
        outs = jsiren.siren_morpher_apply_nhwc(jscfg, sparams, t5.astype(jdtype), poses.astype(jdtype))
        pred_blended, pred_warped, pred_grid = (outs[i].astype(jnp.float32) for i in (0, 3, 4))
        l1 = lambda a, b: jnp.mean(jnp.abs(a - b))
        return l1(t0, pred_blended), l1(t2, pred_warped), l1(t3, pred_grid), jnp.mean((t0 - pred_blended) ** 2)

    acc = np.zeros(4, np.float64)
    nb = len(poses) // batch
    image_b = jnp.broadcast_to(jnp.asarray(setup["image"]), (batch, 512, 512, 4))
    for i in range(nb):
        p = jnp.asarray(poses[i * batch:(i + 1) * batch])
        t = setup["jax_teacher"](setup["jt"], image_b, p)
        acc += np.asarray([float(x) for x in student_losses(_jax(setup["sparams"]), p, t[0], t[2], t[3],
                                                             t[jmode_07.INDEX_FACE_MORPHED_FULL])])
    acc /= nb
    return {"blended_l1": acc[0], "warped_l1": acc[1], "grid_l1": acc[2], "psnr_vs_f32": 10 * np.log10(4.0 / max(acc[3], 1e-12))}


# f32: the teachers' outputs differ by ~1e-5 where the image is smooth and
# up to 3e-3 on the pasted face square's hard edge (tests/test_torch_body_
# teacher.py), the students by ~1e-6: the means to 1e-4 relative, PSNR to
# 1e-3 dB.  bf16 student: the outputs' bar of tests/test_torch_body_distill.py
# (BF16_OUT_STEPS bf16 steps, 2^-8 relative each) on each mean, and the PSNR
# that an MSE that many steps apart moves.
EVAL_RTOL_BF16 = BF16_OUT_STEPS * 2.0**-8
EVAL_BARS = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (EVAL_RTOL_BF16, 10 * np.log10(1 + 2 * EVAL_RTOL_BF16))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_body_eval_matches_the_jax_tools_evaluation(setup, dtype):
    poses = fidelity.random_pose_suite(5, seed=body_eval.EVAL_SEED)  # 2 batches of 2; the fifth pose is dropped, as in JAX
    ref = _jax_eval(setup, poses, 2, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ours = body_eval.evaluate_body_student(_teacher(setup, torch.float32), _student(setup), torch.from_numpy(setup["image"]),
                                           poses, 2, dtype)
    assert list(ours) == list(body_eval.METRICS)
    rtol, psnr_atol = EVAL_BARS[dtype]
    for key in ("blended_l1", "warped_l1", "grid_l1"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=rtol, err_msg=key)
    assert abs(ours["psnr_vs_f32"] - ref["psnr_vs_f32"]) <= psnr_atol


def test_body_eval_refuses_a_teacher_not_in_f32(setup):
    with pytest.raises(ValueError, match="f32"):
        body_eval.evaluate_body_student(_teacher(setup, torch.bfloat16), _student(setup), torch.from_numpy(setup["image"]),
                                        setup["poses"], 2)


# ---------------------------------------------------------------------------
# (c) run_report, against the JAX tool on the JAX package's own logs
# ---------------------------------------------------------------------------


def _jax_run_report():
    spec = importlib.util.spec_from_file_location("jax_run_report", os.path.join(ROOT, "tools", "run_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LOGS = {  # (run, student) -> a scalars.jsonl the JAX trainer wrote
    "body_full_r5": {"body": "docs/runs/body_full_r5/scalars.jsonl"},  # 11 resumes: elapsed resets
    "sustained_r4": {"face": "docs/runs/sustained_r4/face_scalars.jsonl", "body": "docs/runs/sustained_r4/body_scalars.jsonl"},
}


def _prefix(tmp_path, run):
    for student, path in LOGS[run].items():
        log = tmp_path / f"{student}_morpher" / "log"
        log.mkdir(parents=True)
        shutil.copy(os.path.join(ROOT, path), log / "scalars.jsonl")
    return str(tmp_path)


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


@pytest.mark.parametrize("run", sorted(LOGS))
def test_run_report_matches_the_jax_tool(tmp_path, run):
    """Segments, the per-student report and the per-phase rollup, called
    with the same boundaries, equal the JAX tool's; so do both ``main``
    outputs, text and ``--json``, with the port's six phases."""
    prefix = _prefix(tmp_path, run)
    jax_tool = _jax_run_report()
    for student in LOGS[run]:
        path = os.path.join(prefix, f"{student}_morpher", "log", "scalars.jsonl")
        assert run_report.read_segments(path) == jax_tool.read_segments(path)
        assert run_report.report_student(student, prefix, 8) == jax_tool.report_student(student, prefix, 8)
    boundaries = [p.num_examples_upper_bound for p in recipes.default_body_phases().phases]
    assert boundaries == [p.num_examples_upper_bound for p in jrecipes.default_body_phases().phases]
    phases = run_report.report_phases("body", prefix, 8, boundaries)
    assert phases == jax_tool.report_phases("body", prefix, 8, boundaries) and phases
    if run == "body_full_r5":
        assert len(run_report.read_segments(os.path.join(prefix, "body_morpher", "log", "scalars.jsonl"))) > 1
    for flags in ([], ["--json"], ["--phases"], ["--phases", "--json"]):
        argv = [prefix, "--batch", "8", *flags]
        ours = _printed(run_report.main, argv)
        old, sys.argv = sys.argv, ["run_report.py", *argv]
        try:
            theirs = _printed(jax_tool.main)
        finally:
            sys.argv = old
        assert ours == theirs, flags
    assert json.loads(_printed(run_report.main, [prefix, "--json"])) == run_report.main([prefix, "--json"])


# ---------------------------------------------------------------------------
# (d) eval_body_checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run_prefix(setup, tmp_path_factory):
    """A run's prefix (config.yaml, the character) with two body
    checkpoints of known weights, written by ``checkpoint.save_state``."""
    config = DistillerConfig.load(write_distiller_inputs(str(tmp_path_factory.mktemp("run")), seed=3, batch_size=2))
    config.save(config.config_yaml_file_name())
    students = []
    for index in (1, 2):
        student = _student(setup)
        with torch.no_grad():
            for p in student.parameters():
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(index)) * 1e-3 * index)
        ckpt.save_state(ckpt.checkpoint_dir(config.body_morpher_prefix(), index), {"module": student},
                        {"module": recipes.make_adam(student)}, 4 * index, 0)
        students.append(student)
    return config, students


@pytest.mark.parametrize("index", [None, 1])
def test_eval_body_checkpoint_equals_body_eval_and_exports(setup, run_prefix, tmp_path, index):
    config, students = run_prefix
    export = str(tmp_path / "export")
    result = eval_body_checkpoint.evaluate(config.prefix, index, eval_poses=2, batch=2, export=export, device="cpu",
                                           teacher_cfg=setup["tcfg"], student_cfg=setup["scfg"], log=lambda line: None)
    chosen = index or 2
    assert (result["checkpoint"], result["examples"]) == (chosen, 4 * chosen)
    tcfg = setup["tcfg"]
    teacher = mode_07.Teacher.from_params(mode_07.init(torch.Generator().manual_seed(0), tcfg), tcfg).freeze(torch.float32, "cpu")
    image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None]
    expected = body_eval.evaluate_body_student(teacher, students[chosen - 1], image,
                                               fidelity.random_pose_suite(2, seed=body_eval.EVAL_SEED), 2)
    assert {k: result[k] for k in body_eval.METRICS} == expected
    reloaded = siren.SirenMorpher(setup["scfg"])
    reloaded.load_state_dict(load_torch_state_dict(os.path.join(export, "body_morpher.pt")))
    for name, tensor in students[chosen - 1].state_dict().items():
        assert torch.equal(reloaded.state_dict()[name], tensor), name


# ---------------------------------------------------------------------------
# (e) dtype_ab and quant_ab end to end
# ---------------------------------------------------------------------------


def _tool_inputs(setup, make=mode_07.init):
    """Each tool's teacher at the tiny widths, and the character."""
    return make(torch.Generator().manual_seed(0), setup["tcfg"]), torch.from_numpy(setup["image"])


def test_dtype_ab_arms_merge_into_one_json(setup, tmp_path):
    """Two steps an arm at batch 1, the arms in two runs merged into one
    file with the JAX tool's keys; the second run at lookahead 2 rounds 1
    example up to one group of 2 steps.  Every arm saw the same poses."""
    tparams, image = _tool_inputs(setup)
    path = str(tmp_path / "ab.json")
    kw = dict(batch=1, eval_poses=1, device=torch.device("cpu"), json_path=path, teacher_cfg=setup["tcfg"],
              student_cfg=setup["scfg"], log=lambda line: None)
    first = dtype_ab.run(tparams, image, ["bf16", "f32"], examples=2, lookahead=1, **kw)
    assert set(first["results"]) == {"bf16", "f32"} and set(first["delta"]) == set(body_eval.METRICS)
    assert (first["examples"], first["lookahead"]) == (2, 1)
    dtype_ab.run(tparams, image, ["bf16t+f32s", "mixed"], examples=1, lookahead=2, **kw)
    with open(path) as f:
        record = json.load(f)
    reference = json.load(open(os.path.join(ROOT, "docs", "runs", "dtype_ab_r5.json")))
    assert set(reference) <= set(record) and record["card"] is None
    assert (record["examples"], record["batch"], record["lookahead"], record["lr"]) == (2, 1, 2, 1e-4)
    assert set(record["results"]) == set(dtype_ab.ARMS)
    assert record["results"]["bf16"] == first["results"]["bf16"]
    assert record["delta"] == {k: record["results"]["bf16"][k] - record["results"]["f32"][k] for k in body_eval.METRICS}
    for arm, values in record["results"].items():
        assert set(reference["results"]["f32"]) <= set(values), arm
        assert all(np.isfinite(v) for k, v in values.items() if k != "poses_sha256"), arm
    assert len({v["poses_sha256"] for v in record["results"].values()}) == 1
    # The arms differ: bf16 activations move the losses, the split arm's bf16 labels too.
    losses = {arm: v["train_loss"] for arm, v in record["results"].items()}
    assert len(set(losses.values())) == 4, losses
    with pytest.raises(ValueError, match="unknown arms"):
        dtype_ab.run(tparams, image, ["fp8"], examples=1, lookahead=1, **kw)


def test_quant_ab_arms_and_delta(setup, tmp_path):
    """bf16 then int8 (the plain int8 conv on the CPU) merged into one
    record: the delta int8 - bf16 of the four metrics, the same poses, the
    student in bf16.  The teacher is ``random_teacher_07``: at these narrow
    widths the tool's ``mode_07.init`` teacher gives int8 labels equal to
    its bf16 ones, bit for bit, where at full width its arms differ
    (chip_smoke.py phase 18)."""
    tparams, image = _tool_inputs(setup, random_teacher_07)
    path = str(tmp_path / "quant.json")
    kw = dict(steps=2, batch=1, eval_batches=1, device=torch.device("cpu"), json_path=path, teacher_cfg=setup["tcfg"],
              student_cfg=setup["scfg"], log=lambda line: None)
    quant_ab.run(tparams, image, ["bf16"], **kw)
    record = quant_ab.run(tparams, image, ["int8"], **kw)
    assert set(record["results"]) == {"bf16", "int8"}
    assert record["delta"] == {k: record["results"]["int8"][k] - record["results"]["bf16"][k] for k in body_eval.METRICS}
    assert record["results"]["bf16"]["poses_sha256"] == record["results"]["int8"]["poses_sha256"]
    assert record["results"]["bf16"]["train_loss"] != record["results"]["int8"]["train_loss"]
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(record))


@pytest.mark.parametrize("tool,argv", [(dtype_ab, []), (quant_ab, []), (eval_body_checkpoint, ["prefix"])])
def test_tools_refuse_a_missing_card(monkeypatch, tool, argv):
    """On the card by default: without one, the tool raises before any
    work; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)
