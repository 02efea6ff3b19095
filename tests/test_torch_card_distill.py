"""Distillation to a character model and the verification slice on the
card, at full width.

``pipeline.run_config`` (the ``tha4-torch-distill`` command's callee) on the
seeded random mode_07 (mode_12 taken from it), the bf16 teacher and the
selective-f32 body student, 16 steps a student at batch 8 and a checkpoint
every 8, cuDNN deterministic: its targets, rerun, resumes, sample grids,
TensorBoard events and export.  Then the int8 teacher (``--teacher-int8``),
``tha4-torch-verify`` on a written full-width bundle and
``tha4-torch-eval --against``.  How to run: ``tests/torch_card.py``.
"""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from torch_card import (
    BATCH, BF16_MIN_PSNR, SEED, TEACHER_CALL, dispatched, graph_calls, kernel_counters, launches, psnr, reset,
    teacher_calls, teacher_params, workdir,
)

pytestmark = pytest.mark.cuda

DAG_STEPS = 16  # steps a student, a checkpoint every half
POSES = 4  # the exported model's poses
INT8_STEPS = 8  # steps a student with and without --teacher-int8
CAL_SEED = 0xCA11B
RUNS = ["face", "all", "rerun", "resume_snapshot", "resume_checkpoint_1"]


def _expect(*terms) -> dict:
    """Launches by counter: each term (launches of one unit, units)."""
    out = dict.fromkeys((c.__name__ for c in kernel_counters()), 0)
    for counts, times in terms:
        for k, v in counts.items():
            out[k] += v * times
    return out


FACE_STEP = {"sine_chain_t": 1, "sine_chain_t_bwd": 1, "grid_sample_fast": 2}
# The body's step and render without the teacher's call, which launches
# TEACHER_CALL where it runs its body (not where it replays its graph).
BODY_STEP = {"grid_sample_train_forward": 1, "grid_sample_grid_backward": 1, "poly_sin_forward": 9, "poly_sin_backward": 9}
FACE_RENDER = {"sine_chain_t": 1, "grid_sample_fast": 2}  # the student's f32 chain and mode_12 at B = 8
BODY_RENDER = {"sine_chain_t": 3, "grid_sample_fast": 1}  # the student's three levels and warp, beside mode_07 at B = 4
EXPECTED = {"face": ((FACE_STEP, DAG_STEPS), (FACE_RENDER, 1)), "all": ((BODY_STEP, DAG_STEPS), (BODY_RENDER, 1)),
            "rerun": (), "resume_snapshot": (), "resume_checkpoint_1": ((BODY_STEP, DAG_STEPS // 2),)}
# mode_07's calls a signature in each run: the render's at B = 4, the steps'.
TEACHER_SIGNATURES = {"face": (), "all": (1, DAG_STEPS), "rerun": (), "resume_snapshot": (),
                      "resume_checkpoint_1": (DAG_STEPS // 2,)}


def _file_state(root: str) -> dict:
    """Every file under ``root`` with its mtime in ns."""
    out = {}
    for directory, _, files in os.walk(root):
        for f in files:
            path = os.path.join(directory, f)
            out[path] = os.stat(path).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def dag(workdir, teacher_params):
    """The DAG driven five times: the face target; ``all``; a rerun; the
    body's last checkpoint and ``body_morpher.pt`` deleted and rerun, with
    the snapshot at the end kept (no step), then without it (resumed from
    checkpoint 1, 8 steps).  Each run's launches, and what the runs left;
    every training task logs a row every step."""
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import pipeline, sample_output
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training.trainer import Trainer

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill_dag"), seed=SEED + 30,
                                                         batch_size=BATCH, sample_cadence=10_000))
    total = DAG_STEPS * BATCH
    kwargs = dict(teacher_params_07=teacher_params, compute_dtype=torch.bfloat16, device="cuda", face_total_examples=total,
                  body_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4)
    counters = kernel_counters()
    train = Trainer.train

    def logged(self, target_examples=None):  # a row and a TensorBoard event every step
        self.cfg.log_every_seconds = 0.0
        return train(self, target_examples)

    def drive(target: str) -> dict:
        reset(counters)
        pipeline.run_config(config, target=target, **kwargs)
        return {**launches(counters), "teacher_calls": teacher_calls()}

    pngs = {kind: sample_output.sample_output_file_name(getattr(config, f"{kind}_morpher_prefix")(), 0)
            for kind in ("face", "body")}
    out = {"config": config, "pngs": pngs, "runs": {}, "resumed_equal": {}}
    body_prefix, body_pt = config.body_morpher_prefix(), config.character_model_body_morpher_file_name()
    torch.backends.cudnn.deterministic = True
    Trainer.train = logged
    try:
        out["runs"]["face"] = drive("face")
        out["face_only"] = not os.path.exists(pngs["body"]) and not os.path.exists(config.character_model_yaml_file_name())
        out["runs"]["all"] = drive("all")
        files = _file_state(config.prefix)
        out["runs"]["rerun"] = drive("all")
        out["rerun_wrote_nothing"] = _file_state(config.prefix) == files
        with open(body_pt, "rb") as f:
            first_pt = f.read()
        for case, drop in (("snapshot", []), ("checkpoint_1", [ckpt.snapshot_dir(body_prefix)])):
            for path in [ckpt.checkpoint_dir(body_prefix, 2), *drop]:
                shutil.rmtree(path)
            os.remove(body_pt)
            out["runs"][f"resume_{case}"] = drive("all")
            with open(body_pt, "rb") as f:
                out["resumed_equal"][case] = f.read() == first_pt
    finally:
        Trainer.train = train
        torch.backends.cudnn.deterministic = False
    return out


@pytest.mark.parametrize("run", RUNS)
def test_dag_run_launches(dag, run):
    calls = graph_calls(*TEACHER_SIGNATURES[run])
    assert dag["runs"][run] == {**_expect(*EXPECTED[run], (TEACHER_CALL, dispatched(calls))), "teacher_calls": calls}


def test_face_target_runs_no_body_or_character_model_task(dag):
    assert dag["face_only"]


def test_rerun_of_an_up_to_date_dag_writes_nothing(dag):
    assert dag["rerun_wrote_nothing"]


@pytest.mark.parametrize("case", ["snapshot", "checkpoint_1"])
def test_resumed_body_export_equals_the_first(dag, case):
    assert dag["resumed_equal"][case]


@pytest.mark.parametrize("kind", ["face", "body"])
def test_sample_grid_and_tensorboard_events(dag, kind):
    """The grid at 0 decodes to its size; the TensorBoard scalar events
    read back are as many as the JSONL's rows, and finite."""
    import PIL.Image

    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.training import tensorboard

    config = dag["config"]
    samples, cell, columns = ((pipeline.FACE_SAMPLES, pipeline.FACE_SAMPLE_CELL, 2) if kind == "face"
                              else (pipeline.BODY_SAMPLES, pipeline.BODY_SAMPLE_CELL, 4))
    assert np.asarray(PIL.Image.open(dag["pngs"][kind])).shape == (samples * cell, columns * cell, 4)
    prefix = getattr(config, f"{kind}_morpher_prefix")()
    log = os.path.join(prefix, "log")
    events = [e for f in sorted(os.listdir(log)) if f.startswith("events.out.tfevents.")
              for e in tensorboard.read_events(os.path.join(log, f)) if e["scalars"]]
    with open(os.path.join(log, "scalars.jsonl")) as f:
        rows = sum(1 for _ in f)
    assert events and len(events) == rows
    assert all(math.isfinite(v) for e in events for v in e["scalars"].values())


def test_exported_model_poses_as_its_checkpoints(dag):
    """The written character model, posed through
    ``CharacterModel.load(...).get_poser(...)``: 4 K1 and 1 K2 a frame, f32
    equal bit for bit to a poser from the last checkpoints' ``.npz`` files,
    bf16 within 28 dB of f32."""
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.poser.modes import mode_14
    from tha4_tpu_torch.tools import bench
    from tha4_tpu_torch.training import checkpoint as ckpt

    config = dag["config"]
    model = CharacterModel.load(config.character_model_yaml_file_name())
    image = model.get_character_image()
    posers = {"f32": model.get_poser(torch.float32, "cuda"), "bf16": model.get_poser(torch.bfloat16, "cuda")}
    poses = list(bench.pose_sweep(posers["f32"].pose_parameters, POSES))
    counters = kernel_counters()
    reset(counters)
    frames = {tag: [poser.get_posing_outputs(image, pose) for pose in poses] for tag, poser in posers.items()}
    assert launches(counters) == _expect(({"sine_chain_t": 4, "grid_sample_fast": 1}, 2 * POSES))
    npz = {key: os.path.join(ckpt.checkpoint_dir(prefix, 2), "module_module.npz") for key, prefix in
           ((mode_14.KEY_FACE_MORPHER, config.face_morpher_prefix()), (mode_14.KEY_BODY_MORPHER, config.body_morpher_prefix()))}
    from_npz = mode_14.create_poser(module_file_names=npz, compute_dtype=torch.float32, device="cuda")
    assert all(torch.equal(a, b) for pose, outs in zip(poses, frames["f32"])
               for a, b in zip(outs, from_npz.get_posing_outputs(image, pose)))
    assert all(bool(torch.isfinite(o).all()) for outs in frames.values() for f in outs for o in f)
    assert min(psnr(b[0], f[0]) for b, f in zip(frames["bf16"], frames["f32"])) >= BF16_MIN_PSNR


# -- the verification slice --------------------------------------------------------


@pytest.fixture(scope="module")
def image(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.distiller.config import DistillerConfig

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=BATCH))
    return torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_q1_equals_plain_at_every_signature_of_the_int8_teachers(teacher_params, image, monkeypatch, dtype):
    """One calibrated int8 call of the full-width mode_07 at B = 8 and one of
    mode_12, with every eligible conv's Q1 output held bit for bit against
    its plain version on the same inputs and scale, and against a second
    call of the hook, at each (signature) the call gives Q1."""
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.ops import cuda_int8_conv, quant
    from tha4_tpu_torch.poser.modes import mode_07, mode_12

    real = quant.conv_hook
    checked_sigs = set()

    def again(ctx):
        """The scope as it stood at this conv: a second call of the hook
        takes the same scale without moving the scope on."""
        scope = quant._Apply(ctx.scales)
        scope.idx = ctx.idx - 1
        return scope

    def checked(ctx, conv, x):
        out = real(ctx, conv, x)
        sig = json.dumps(quant.nchw_signature(x, conv))
        if sig not in checked_sigs:
            checked_sigs.add(sig)
            layout, w_s = quant._int8_weights(conv)
            plain = cuda_int8_conv.int8_conv_plain(x.permute(0, 2, 3, 1), cuda_int8_conv._hwio(layout), w_s,
                                                   ctx.scales[ctx.idx - 1]["scale"], conv.padding[0],
                                                   quant._int8_bias(conv, x.dtype))
            err = float((out.permute(0, 2, 3, 1).float() - plain.float()).abs().max())
            assert torch.equal(out.permute(0, 2, 3, 1), plain), f"Q1 {sig}: differs from its plain version by {err}"
            assert torch.equal(real(again(ctx), conv, x), out), f"Q1 {sig}: differs from itself"
        return out

    cal_poses = sample_poses(torch.Generator().manual_seed(CAL_SEED), BATCH).cuda().to(dtype)
    poses = sample_poses(torch.Generator().manual_seed(SEED + 51), BATCH).cuda().to(dtype)
    images = image.to(dtype).expand(BATCH, -1, -1, -1)
    teachers = [(mode_07.compute_outputs, mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")),
                (mode_12.compute_outputs, mode_12.FaceTeacher.from_params(
                    {k: teacher_params[k] for k in mode_12.NETWORK_KEYS}).freeze(dtype, "cuda"))]
    for fn, teacher in teachers:
        scales = quant.run_calibration(fn, teacher, images, cal_poses)
        monkeypatch.setattr(quant, "conv_hook", checked)
        with torch.no_grad(), quant.apply_scales(scales):
            fn(teacher, images, poses)
        torch.cuda.synchronize()
        monkeypatch.setattr(quant, "conv_hook", real)
    assert checked_sigs


def test_int8_teacher_labels_are_finite_beside_bf16_and_f32(teacher_params, image):
    """The int8 teacher's body labels (bf16 activations, scales calibrated on
    their own poses) against the bf16 and f32 teachers' at B = 8: finite,
    with a finite PSNR and grid-change L1 between each pair."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.ops import quant
    from tha4_tpu_torch.poser.modes import mode_07

    cal_poses = sample_poses(torch.Generator().manual_seed(CAL_SEED), BATCH).cuda()
    poses = sample_poses(torch.Generator().manual_seed(SEED + 51), BATCH).cuda()
    teachers = {tag: mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
                for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    images = image.to(torch.bfloat16).expand(BATCH, -1, -1, -1)
    scales = quant.run_calibration(mode_07.compute_outputs, teachers["bf16"], images, cal_poses.to(torch.bfloat16))
    with torch.no_grad():
        int8 = recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16, scales)
        bf16 = recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16)
        f32 = recipes.body_teacher_targets(teachers["f32"], image, poses, torch.float32)
    for name, (a, b) in {"int8_vs_bf16": (int8, bf16), "int8_vs_f32": (int8, f32), "bf16_vs_f32": (bf16, f32)}.items():
        db = min(psnr(a[i].float(), b[i].float()) for i in (0, 1, 3))
        grid_l1 = float((a[2].float() - b[2].float()).abs().mean())
        print(f"{name}: label PSNR min {db:.2f} dB, grid change L1 {grid_l1:.3e}")
        assert math.isfinite(grid_l1) and db > 0.0, name


@pytest.mark.parametrize("int8_on", [True, False], ids=["int8", "bf16"])
def test_distill_with_and_without_teacher_int8(workdir, teacher_params, int8_on):
    """``tha4-torch-distill --teacher-int8`` through ``run_config``, 8 steps
    a student: Q1 launched once per eligible conv per teacher call, K6 and
    its fold never, every student and warp kernel, both scales files
    written; without it, no Q1 and no scales file; a character model
    either way."""
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import pipeline, recipes
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.ops import quant

    arm = "int8" if int8_on else "bf16"
    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, f"distill_{arm}"), seed=SEED + 52,
                                                         batch_size=BATCH))
    total = INT8_STEPS * BATCH
    steps = {}
    make_face, make_body = recipes.make_face_distill_group, recipes.make_body_distill_group

    def counted(make, kind):
        def made(*args, **kwargs):
            group = make(*args, **kwargs)

            def run(*a, **k):
                steps[kind] = steps.get(kind, 0) + len(a[2])  # one step a generator
                return group(*a, **k)
            return run
        return made

    counters = kernel_counters()
    reset(counters)
    recipes.make_face_distill_group, recipes.make_body_distill_group = counted(make_face, "face"), counted(make_body, "body")
    try:
        pipeline.run_config(config, target="all", teacher_params_07=teacher_params, compute_dtype=torch.bfloat16,
                            device="cuda", face_total_examples=total, body_total_examples=total,
                            examples_per_checkpoint=total, examples_per_snapshot=total, teacher_int8=int8_on)
    finally:
        recipes.make_face_distill_group, recipes.make_body_distill_group = make_face, make_body
    counts = launches(counters)
    files = {tag: os.path.join(config.prefix, f"teacher_int8_scales_{tag}.json") for tag in ("07", "12")}
    print(f"distill {arm}: launches {counts}")
    if int8_on:
        convs = {tag: len(quant.load_scales(path)) for tag, path in files.items()}
        assert counts["int8_conv"] == INT8_STEPS * (convs["07"] + convs["12"]), (counts, convs)
        unfused = ("fused_affine_conv3_nchw", "fold_groupnorm_film")  # the U-Nets' K6 path, not taken under int8
        assert all(bool(counts[k]) != (k in unfused) for k in counts), counts
    else:
        assert not counts["int8_conv"] and not any(os.path.exists(p) for p in files.values())
    assert steps == {"face": INT8_STEPS, "body": INT8_STEPS}
    assert os.path.isfile(config.character_model_yaml_file_name())


def _damped_teacher_files(teacher_params, directory: str) -> None:
    """The five full-width teacher state dicts as ``.pt`` files, the heads
    damped as tests/test_verify.py:83-91 damps its stand-ins."""
    from tha4_tpu_torch.poser.modes import mode_07

    gen = torch.Generator().manual_seed(SEED + 50)
    params = {key: {k: v.clone() for k, v in sd.items()} for key, sd in teacher_params.items()}
    damped = [("eyebrow_morphing_combiner", "morphed_eyebrow_layer_grid_change.weight", 0.02),
              ("face_morpher", "iris_mouth_grid_change.weight", 0.02),
              ("body_morpher", "body.last.2.weight", 0.01), ("body_morpher", "body.last.2.bias", 0.01),
              ("upscaler", "body.last.2.weight", 0.01), ("upscaler", "body.last.2.bias", 0.01),
              ("upscaler", "coarse_image_conv.weight", 0.05), ("upscaler", "coarse_image_conv.bias", 0.05)]
    for net, name, std in damped:
        params[net][name] = torch.randn(params[net][name].shape, generator=gen) * std
    os.makedirs(directory, exist_ok=True)
    for key in mode_07.NETWORK_KEYS:
        torch.save(params[key], os.path.join(directory, f"{key}.pt"))


@pytest.fixture(scope="module")
def bundle(workdir, teacher_params):
    """A full-width verification bundle: five damped random teacher ``.pt``
    files, a pose dataset, a synthetic character and mask, a random
    character model; no reference source.  Returns its directory."""
    import PIL.Image

    from tha4_tpu_torch.charmodel.synthetic import synthetic_face_mask, write_random_character_model
    from tha4_tpu_torch.utils import fidelity

    data = os.path.join(workdir, "verify_data")
    _damped_teacher_files(teacher_params, os.path.join(data, "tha4"))
    torch.save(torch.from_numpy(fidelity.random_pose_suite(64, seed=SEED + 53)), os.path.join(data, "pose_dataset.pt"))
    write_random_character_model(os.path.join(data, "character_models", "lambda_00"), seed=SEED + 54)
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    PIL.Image.fromarray(synthetic_face_mask(512, SEED + 54)).save(os.path.join(data, "images", "lambda_00_face_mask.png"))
    return data


def test_verify_on_a_full_width_bundle(bundle, workdir):
    """``tha4-torch-verify``: exit 0, steps 2 and 5 ``skip``, the rest ``ok``."""
    from tha4_tpu_torch.apps import verify

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify.main(["--data-dir", bundle, "--poses", "2", "--examples", "64",
                          "--reference-src", os.path.join(workdir, "no_reference_source")])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert {k: v["status"] for k, v in summary["checks"].items()} == {
        "teacher files load": "ok", "teacher weight conversion": "ok", "golden render": "skip",
        "int8 teacher fidelity": "ok", "pose dataset": "ok", "distill smoke (loss decrease)": "ok",
        "student fidelity eval": "skip"}, summary["checks"]


@pytest.fixture(scope="module")
def other_model(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    return write_random_character_model(os.path.join(workdir, "eval_b"), seed=SEED + 55)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eval_against_another_character_model(bundle, other_model, dtype):
    """``tha4-torch-eval --against`` between two random character models."""
    from tha4_tpu_torch.apps import evaluate

    yaml_a = os.path.join(bundle, "character_models", "lambda_00", "character_model.yaml")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evaluate.main(["--model", yaml_a, "--against", other_model, "--poses", "4", "--dtype", dtype])
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and stats["frames"] == 4
    assert all(math.isfinite(stats[k]) for k in ("psnr_min", "ssim_mean", "lpips_proxy_mean")), stats
