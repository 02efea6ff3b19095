"""The rest of the JAX package's twins and the tools slice on the card.

The block zoo at the face morpher's published widths, the native codec, the
iFacialMocap receiver between student frames; then, at full width, batch 8
and cuDNN deterministic, the body recipe's ``teacher_dtype``, the A/B tools
(``dtype_ab``, ``quant_ab``) through their entry points, and a body run's
``run_report`` and ``eval_body_checkpoint``.  How to run:
``tests/torch_card.py``.
"""

import contextlib
import copy
import io
import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from torch_card import BATCH, K6_PER_TEACHER_CALL, SEED, kernel_counters, need_card, puppeteer_run, teacher_params, workdir

pytestmark = pytest.mark.cuda

# The face morpher's published widths (tha4_tpu/models/face_morpher.py:38-44),
# the configuration of the resize-conv nets, at batch 8.
ZOO_NET = dict(image_size=192, input_channels=4, start_channels=64, bottleneck_image_size=24, num_bottleneck_blocks=6,
               max_channels=512)
ZOO_BATCH = 8
ZOO_CPU_BATCH = 1  # the card's first sample against the CPU (every norm is per sample)
# The zoo's bars.  f32 card against the same module on the CPU (TF32 off),
# error over each level's largest |CPU| value: two f32 orders of sums
# through 14-16 convs, 100x the ~1e-6 the teacher's f32 U-Nets read.  bf16
# against f32 on the card, over each level's largest and mean |f32| value:
# every conv and norm output rounded to bf16 (2^-8) through 14-16 conv and
# norm layers, a few percent in all; about three times the readings on an
# H100 (0.021-0.036 and 0.021-0.031).  sn_u after three advance_spectral
# steps, card against CPU: unit vectors of length <= 512.
ZOO_F32_REL = 1e-4
ZOO_BF16_MAX_REL = 0.1
ZOO_BF16_MEAN_REL = 0.075
ZOO_SN_U_ATOL = 1e-5
ZOO_SN_STEPS = 3
ZOO_NETS = [f"encoder_decoder/{m}" for m in ("bilinear", "nearest")] + [
    f"unet/{b}/{m}" for m in ("bilinear", "nearest") for b in ("instance+sn", "instance", "separable+sn")]
CODEC_ATOL = 2e-6  # tests/test_native_codec.py:27
MOCAP_RATE = 240.0  # packets a second from the loopback sender
MOCAP_FRAMES = 300
MOCAP_PORT = 49350  # the in-process receivers; the puppeteer listens on 49983
# The tools: steps a dtype_ab and a quant_ab arm, at batch 8.
AB_STEPS = 32
QUANT_STEPS = 16
EVAL_POSES = 64  # the held-out suite: 8 batches
RUN_STEPS = 16  # the body run: two checkpoints of 8 steps
# The checkpoint's evaluation against body_eval on the trainer's own module:
# the same f32 weights, the teacher in cuDNN's deterministic mode.
EVAL_RTOL = 1e-6


# -- the block zoo ---------------------------------------------------------------


def _zoo_net(name: str, gen):
    from tha4_tpu_torch.models import resize_conv as R
    from tha4_tpu_torch.ops import blocks as B

    kind, *rest = name.split("/")
    if kind == "encoder_decoder":
        return R.ResizeConvEncoderDecoder(R.ResizeConvEncoderDecoderConfig(**ZOO_NET, upsample_mode=rest[0]), gen)
    block = {"instance+sn": B.BlockConfig(use_spectral_norm=True), "instance": B.BlockConfig(),
             "separable+sn": B.BlockConfig(use_spectral_norm=True, separable=True)}[rest[0]]
    return R.ResizeConvUNet(R.ResizeConvUNetConfig(**ZOO_NET, upsample_mode=rest[1], block=block), gen)


def _rel(a, b, reduce) -> float:
    return float(reduce((a.float() - b.float()).abs()) / reduce(b.float().abs()))


@pytest.mark.parametrize("name", ZOO_NETS)
def test_zoo_net_on_the_card_matches_the_cpu(name):
    """f32 on the card against the same module on the CPU (TF32 off), bf16
    against f32 on the card, and the ``sn_u`` vectors after three
    ``advance_spectral`` steps against the CPU's."""
    from tha4_tpu_torch.ops import blocks as B

    need_card()
    x_cpu = torch.randn(ZOO_BATCH, ZOO_NET["input_channels"], ZOO_NET["image_size"], ZOO_NET["image_size"],
                        generator=torch.Generator().manual_seed(SEED + 17))
    x = x_cpu.cuda()
    size, shapes = ZOO_NET["bottleneck_image_size"], []
    while size <= ZOO_NET["image_size"]:
        shapes.append((ZOO_BATCH, min(ZOO_NET["start_channels"] * ZOO_NET["image_size"] // size, ZOO_NET["max_channels"]),
                       size, size))
        size *= 2
    cpu = _zoo_net(name, torch.Generator().manual_seed(SEED + 170 + ZOO_NETS.index(name)))
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        ref = cpu(x_cpu[:ZOO_CPU_BATCH])
        f32 = card(x)
        bf16 = card(x.bfloat16())
    assert [tuple(o.shape) for o in f32] == shapes and all(o.dtype == torch.bfloat16 for o in bf16)
    assert all(bool(torch.isfinite(o).all()) for o in f32 + bf16)
    f32_rel = max(_rel(o[:ZOO_CPU_BATCH].cpu(), c, torch.max) for o, c in zip(f32, ref))
    bf16_max = max(_rel(b, f, torch.max) for b, f in zip(bf16, f32))
    bf16_mean = max(_rel(b, f, torch.mean) for b, f in zip(bf16, f32))
    print(f"{name}: f32 card vs CPU {f32_rel:.3e}, bf16 vs f32 max {bf16_max:.3e} mean {bf16_mean:.3e}")
    assert f32_rel <= ZOO_F32_REL
    assert bf16_max <= ZOO_BF16_MAX_REL and bf16_mean <= ZOO_BF16_MEAN_REL
    sn_cpu = {k: v for k, v in cpu.state_dict().items() if k.endswith("sn_u")}
    if sn_cpu:
        start = {k: v.clone() for k, v in sn_cpu.items()}
        for _ in range(ZOO_SN_STEPS):
            B.advance_spectral(cpu)
            B.advance_spectral(card)
        sn_card = {k: v for k, v in card.state_dict().items() if k.endswith("sn_u")}
        assert max(float((sn_card[k].cpu() - v).abs().max()) for k, v in sn_cpu.items()) <= ZOO_SN_U_ATOL
        assert max(float((v - start[k]).abs().max()) for k, v in sn_cpu.items()) > 1e-3


# -- the codec and the receiver ----------------------------------------------------


def test_native_codec_decodes_as_numpy():
    """A 512^2 RGBA ``load_image_hwc``, native against numpy."""
    import PIL.Image

    from tha4_tpu_torch.core import imagecodec

    need_card()
    rgba = np.random.default_rng(SEED).integers(0, 256, size=(512, 512, 4), dtype=np.uint8)
    rgba[..., 3] = np.maximum(rgba[..., 3], 1)
    pil = PIL.Image.fromarray(rgba, "RGBA")
    native = imagecodec.load_image_hwc(pil)
    assert native.shape == (512, 512, 4)
    assert float(np.abs(native - imagecodec.load_image_hwc(pil, native=False)).max()) <= CODEC_ATOL


class _MocapSender:
    """A loopback iFacialMocap sender at MOCAP_RATE packets a second, each
    packet's sequence number in a blendshape the converter ignores
    (tongueOut = seq / 100) and jawOpen stepping through the converter's
    unclamped range (0.1-0.4), so that nearly every packet changes the pose;
    records each packet's send time."""

    def __init__(self, port: int):
        self.port = port
        self.sent = []  # send time by sequence number
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import socket

        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            t0 = time.perf_counter()
            while not self._stop.is_set():
                seq = len(self.sent)
                packet = f"tongueOut&{seq}|jawOpen&{11 + seq % 29}|=head#1.0,2.0,3.0,0,0,0|".encode()
                self.sent.append(time.perf_counter())
                tx.sendto(packet, ("127.0.0.1", self.port))
                self._stop.wait(max(0.0, t0 + (seq + 1) / MOCAP_RATE - time.perf_counter()))
        finally:
            tx.close()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive(), "the mocap sender did not stop"


@pytest.fixture(scope="module")
def model_yaml(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    return write_random_character_model(os.path.join(workdir, "model"), seed=SEED)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "socket"])
def test_receiver_between_student_frames(model_yaml, use_native):
    """The receiver, fed by a loopback sender, read between bf16 student
    frames: it drains on the thread asked for, and at least a quarter of
    the reads get a packet."""
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.mocap import ifacialmocap_constants as C
    from tha4_tpu_torch.mocap.ifacialmocap import IFacialMocapReceiver
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter

    model = CharacterModel.load(model_yaml)
    poser = model.get_poser(torch.bfloat16, "cuda")
    image = torch.from_numpy(model.get_character_image()).cuda()
    converter = IFacialMocapPoseConverter()
    rx = IFacialMocapReceiver(port=MOCAP_PORT, use_native=use_native)
    rx.start()
    native = rx.draining_natively
    ages, newest = [], 0
    try:
        with _MocapSender(MOCAP_PORT) as sender:
            time.sleep(0.05)
            blend = None
            for _ in range(MOCAP_FRAMES):
                got = rx.read_pose()
                t_read = time.perf_counter()
                if got is not None:
                    seq = round(got[C.TONGUE_OUT] * 100)
                    ages.append((t_read - sender.sent[seq]) * 1e3)
                    newest += seq == len(sender.sent) - 1
                    blend = got
                if blend is not None:
                    poser.pose(image, np.asarray(converter.convert(blend), np.float32))
                    torch.cuda.synchronize()
    finally:
        rx.close()
    print(f"{len(ages)} packets in {MOCAP_FRAMES} reads; age p50 {np.percentile(ages, 50):.3f} ms, p99 "
          f"{np.percentile(ages, 99):.3f} ms; the newest packet in {newest / max(len(ages), 1):.3f} of reads")
    assert native == use_native
    assert len(ages) >= MOCAP_FRAMES // 4


def test_puppeteer_drains_udp_on_the_native_thread(model_yaml):
    with _MocapSender(49983):
        puppeteer_run(["--model", model_yaml, "--source", "udp", "--frames", "30", "--dtype", "bf16"],
                      expect="Listening for iFacialMocap packets on UDP 49983 (native drain thread)")


# -- the tools slice ---------------------------------------------------------------


def _counted(fn, *args) -> tuple:
    """fn(*args) in cuDNN's deterministic mode, with every launch counter
    set to 0 just before it: (its result, {counter: launches})."""
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    torch.backends.cudnn.deterministic = True
    try:
        out = fn(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    return out, {c.__name__: c.launches for c in counters}


def _step_launches(steps: int, evals: int, teacher_calls: int = None) -> dict:
    """The launches of ``steps`` body steps (one teacher call each, or
    ``teacher_calls``) and ``evals`` evaluation batches (an f32 teacher call
    and a student forward under no_grad: K2, not K3)."""
    calls = steps if teacher_calls is None else teacher_calls
    return {"grid_sample_fast": 5 * calls + 6 * evals, "grid_sample_train_forward": steps, "grid_sample_grid_backward": steps,
            "poly_sin_forward": 9 * (steps + evals), "poly_sin_backward": 9 * steps,
            "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * (calls + evals),
            "fold_groupnorm_film": K6_PER_TEACHER_CALL * (calls + evals), "sine_chain_t": 0, "sine_chain_t_bwd": 0,
            "int8_conv": 0}


def test_teacher_dtype_omitted_or_bf16_is_the_recipes_step(teacher_params):
    """One bf16 selective-f32 body step at B = 8, full width, three ways:
    ``teacher_dtype`` omitted (None), ``teacher_dtype=bf16``, and the step
    as the recipe made it before ``teacher_dtype``; cuDNN deterministic.
    Losses and parameters equal bit for bit."""
    from tha4_tpu_torch.distiller import pose_dataset, recipes
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import body_eval, dtype_ab

    teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.bfloat16, "cuda")
    image = body_eval.character_image(None, "cuda")
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(SEED + 18), BATCH).cuda()
    student0 = dtype_ab.student_init(siren.SirenMorpherConfig())
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("omitted", "bf16", "recipe before teacher_dtype"):
            student = siren.SirenMorpher()
            student.load_state_dict(student0)
            student.cuda()
            optimizer = recipes.make_adam(student)
            if how == "recipe before teacher_dtype":
                with torch.no_grad():
                    t = mode_07.compute_outputs(teacher, image.to(torch.bfloat16).expand(len(poses), -1, -1, -1),
                                                poses.to(torch.bfloat16))
                targets = tuple(t[i] for i in (0, 2, 3, mode_07.INDEX_FACE_MORPHED_FULL))
                optimizer.zero_grad(set_to_none=True)
                named = recipes.adam_step(optimizer, *recipes.body_loss(student, targets, poses, dtype_ab.LOSS_WEIGHTS,
                                                                        torch.bfloat16, True), 1e-4)
            else:
                kw = {} if how == "omitted" else {"teacher_dtype": torch.bfloat16}
                step = recipes.make_body_distill_step(teacher, image, torch.bfloat16, True, **kw)
                named = step(student, optimizer, poses, 1e-4, dtype_ab.LOSS_WEIGHTS)
            runs.append(({k: v.clone() for k, v in named.items()}, {k: v.clone() for k, v in student.state_dict().items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (named0, state0), *rest = runs
    for named, state in rest:
        assert all(torch.equal(named0[k], named[k]) for k in named0)
        assert all(torch.equal(state0[k], state[k]) for k in state0)


@pytest.fixture(scope="module")
def dtype_ab_arms(workdir):
    """``python -m tha4_tpu_torch.tools.dtype_ab``, one call an arm, merged
    into one JSON: (the last record, each arm's launches)."""
    from tha4_tpu_torch.tools import dtype_ab

    need_card()
    argv = ["--examples", str(AB_STEPS * BATCH), "--batch", str(BATCH), "--eval-poses", str(EVAL_POSES),
            "--json", os.path.join(workdir, "dtype_ab.json")]
    launches = {}
    for arm in dtype_ab.ARMS:
        record, launches[arm] = _counted(dtype_ab.main, argv + ["--arms", arm])
    return record, launches


@pytest.mark.parametrize("arm", ["bf16", "f32", "bf16t+f32s", "mixed"])
def test_dtype_ab_arm_launches(dtype_ab_arms, arm):
    """K2, K3's pair, K5's pair, K6 and its fold; K1, K4 and Q1 never."""
    assert dtype_ab_arms[1][arm] == _step_launches(AB_STEPS, EVAL_POSES // BATCH)


def test_dtype_ab_arms_see_one_pose_stream_and_give_finite_numbers(dtype_ab_arms):
    from tha4_tpu_torch.tools import dtype_ab

    results = dtype_ab_arms[0]["results"]
    assert set(results) == set(dtype_ab.ARMS)
    assert len({results[arm]["poses_sha256"] for arm in dtype_ab.ARMS}) == 1
    keys = ("train_loss", "blended_l1", "warped_l1", "grid_l1", "psnr_vs_f32")
    assert all(math.isfinite(results[arm][k]) for arm in dtype_ab.ARMS for k in keys), results


def test_quant_ab_arms(workdir):
    """``python -m tha4_tpu_torch.tools.quant_ab``, bf16 then int8, merged:
    Q1 a whole number of launches a step in the int8 arm and none in the
    bf16 arm, K6 only in the f32 evaluation there; the same poses."""
    from tha4_tpu_torch.tools import quant_ab

    need_card()
    evals = EVAL_POSES // BATCH
    argv = ["--steps", str(QUANT_STEPS), "--batch", str(BATCH), "--eval-batches", str(evals),
            "--json", os.path.join(workdir, "quant_ab.json")]
    launches = {}
    for arm in quant_ab.ARMS:
        record, launches[arm] = _counted(quant_ab.main, argv + ["--arms", arm])
    q1 = launches["int8"]["int8_conv"]
    per_step = q1 // QUANT_STEPS
    assert launches == {
        "bf16": _step_launches(QUANT_STEPS, evals),
        # the calibration's bf16 call and every int8 call leave K6 for the unfused order
        "int8": {**_step_launches(QUANT_STEPS, evals, teacher_calls=QUANT_STEPS + 1),
                 "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * evals, "fold_groupnorm_film": K6_PER_TEACHER_CALL * evals,
                 "int8_conv": q1},
    }
    assert per_step and q1 == per_step * QUANT_STEPS
    results = record["results"]
    assert set(results) == set(quant_ab.ARMS) and record["delta"]
    assert results["bf16"]["poses_sha256"] == results["int8"]["poses_sha256"]


@pytest.fixture(scope="module")
def body_run(workdir):
    """A body-only ``run_config`` with ``--random-teacher``'s teacher
    (``mode_07.init`` seed 0), 16 steps and two checkpoints, logging every
    step: (its config, its arguments, its launches, each trainer call's
    result)."""
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.training.trainer import Trainer

    need_card()
    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "tools_run"), seed=SEED + 18, batch_size=BATCH))
    total = RUN_STEPS * BATCH
    kwargs = dict(teacher_params_07=mode_07.init(torch.Generator().manual_seed(0), mode_07.TeacherConfig()),
                  compute_dtype=torch.bfloat16, device="cuda", face_total_examples=total, body_total_examples=total,
                  examples_per_checkpoint=total // 2, examples_per_snapshot=total // 2, student_mixed=True)
    trained = []
    train = Trainer.train

    def logged(self, target_examples=None):  # a log row every step, so that the report has rows to read
        self.cfg.log_every_seconds = 0.0
        out = train(self, target_examples)
        trained.append(out)
        return out

    Trainer.train = logged
    try:
        _, launches = _counted(lambda: pipeline.run_config(config, target="body", **kwargs))
    finally:
        Trainer.train = train
    return {"config": config, "kwargs": kwargs, "launches": launches, "trained": trained, "total": total}


def test_body_run_launches(body_run):
    assert body_run["launches"] == _step_launches(RUN_STEPS, 0)


def test_run_report_reads_the_body_run(body_run):
    """A segment a checkpoint task (each ``Trainer.train`` call's elapsed
    starts anew), covering its examples after its first step's row."""
    from tha4_tpu_torch.tools import run_report

    config, total, trained = body_run["config"], body_run["total"], body_run["trained"]
    with open(os.path.join(config.body_morpher_prefix(), "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = run_report.main([config.prefix, "--json", "--batch", str(BATCH)])
        phases = run_report.main([config.prefix, "--json", "--phases", "--batch", str(BATCH)])
    body = [r for r in report if r["student"] == "body"]
    assert len(body) == 1 and len(rows) == RUN_STEPS and len(phases) == 1
    assert body[0]["examples_seen"] == rows[-1]["examples_seen"] == total
    assert body[0]["segments"] == len(trained) == 2
    assert body[0]["examples_covered"] == total - len(trained) * BATCH


def test_eval_body_checkpoint_matches_body_eval_and_exports_the_checkpoint(body_run, workdir):
    """``tools.eval_body_checkpoint --export`` at checkpoint 2: equal to
    ``tools.body_eval`` on the trainer's own module to f32 rounding, the
    exported ``.pt`` loaded into ``SirenMorpher`` equal to the checkpoint,
    and the evaluation's launches."""
    from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import body_eval, eval_body_checkpoint
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.utils import fidelity

    config = body_run["config"]
    export = os.path.join(workdir, "tools_export")
    result, launches = _counted(eval_body_checkpoint.main, [
        config.prefix, "--export", export, "--eval-poses", str(EVAL_POSES), "--batch", str(BATCH)])
    assert (result["checkpoint"], result["examples"]) == (2, body_run["total"])
    assert launches == _step_launches(0, EVAL_POSES // BATCH)
    npz = ckpt._load_npz(os.path.join(ckpt.checkpoint_dir(config.body_morpher_prefix(), 2), "module_module.npz"))
    exported = siren.SirenMorpher()
    exported.load_state_dict(load_torch_state_dict(os.path.join(export, "body_morpher.pt")))
    assert all(np.array_equal(v.numpy(), npz[k]) for k, v in exported.state_dict().items())
    teacher = mode_07.Teacher.from_params(body_run["kwargs"]["teacher_params_07"]).freeze(torch.float32, "cuda")
    image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()
    torch.backends.cudnn.deterministic = True
    try:
        direct = body_eval.evaluate_body_student(teacher, body_run["trained"][-1]["module"], image,
                                                 fidelity.random_pose_suite(EVAL_POSES, seed=body_eval.EVAL_SEED), BATCH)
    finally:
        torch.backends.cudnn.deterministic = False
    assert max(abs(result[k] - direct[k]) / abs(direct[k]) for k in body_eval.METRICS) <= EVAL_RTOL
