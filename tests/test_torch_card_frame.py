"""The student frame and the serving slice on the card, at full width.

A seeded random-init character model, written to a temporary directory and
loaded through ``CharacterModel.load(...).get_poser(...)``, answers 8 pose
requests in bf16 and in f32; the headless CLI, the frame bench, the
puppeteer (as subprocesses), the ``--web`` puppeteer and both web posers
(in this process, on ephemeral ports) serve the same model.  How to run:
``tests/torch_card.py``.  Speed is the benchmark's (``frame.live.f32``) and
``tha4_tpu_torch/tools/profile_step.py --time``'s (the bf16 frame).
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from torch_card import (
    BF16_MIN_PSNR, K6_PER_TEACHER_CALL, ROOT, SEED, launches, psnr, puppeteer_run, reset, run_module, teacher_files,
    teacher_params, workdir,
)

pytestmark = pytest.mark.cuda

FRAMES = 8
FRAME_OUTPUTS = ["blended", "alpha", "color_change", "warped", "grid_change", "face"]
# Card f32 frame against the CPU plain frame: tests/test_mode_14_parity.py:79-92,127-135.
FRAME_F32_ATOL = {"blended": 2e-3, "alpha": 2e-4, "color_change": 2e-4, "warped": 2e-3, "grid_change": 2e-4, "face": 2e-4}
FRAME_F32_MIN_PSNR = 60.0
PARITY_POSES = 4  # the replayed poses held against the CPU
SERVING_METRIC = "student_512x512_frames_per_sec_per_chip"
BENCH_FRAMES = 100
IFM_TRACE = os.path.join(ROOT, "tests", "fixtures", "ifacialmocap_trace.jsonl")
MP_TRACE = os.path.join(ROOT, "tests", "fixtures", "mediapipe_trace.jsonl")


def http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as response:
        return response.read()


def png_rgba(png: bytes) -> np.ndarray:
    """A served PNG's pixels, which must be 512^2 RGBA uint8."""
    import io

    import PIL.Image

    pixels = np.asarray(PIL.Image.open(io.BytesIO(png)))
    assert pixels.shape == (512, 512, 4) and pixels.dtype == np.uint8, (pixels.shape, pixels.dtype)
    return pixels


def serve(server):
    """Serve ``server`` on a daemon thread; returns the thread."""
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def stop(server, *threads) -> None:
    server.shutdown()
    server.server_close()
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive(), "a server thread did not stop"


def wait_for(condition, what: str, seconds: float = 120.0) -> None:
    deadline = time.time() + seconds
    while not condition():
        assert time.time() < deadline, f"{what} within {seconds} s"
        time.sleep(0.05)


def _counters():
    from tha4_tpu_torch.ops import cuda_resize, cuda_siren, cuda_warp

    return [cuda_siren.sine_chain_t, cuda_warp.grid_sample_fast, cuda_resize.bilinear_resize_forward]


@pytest.fixture(scope="module")
def model_yaml(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    return write_random_character_model(os.path.join(workdir, "model"), seed=SEED)


@pytest.fixture(scope="module")
def frames(model_yaml):
    """The model's 8 poses in bf16 and f32 (tag -> outputs a pose), the
    poses, and the K1, K2 and R1 launches of those 16 frames."""
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.tools import bench

    model = CharacterModel.load(model_yaml)
    image = model.get_character_image()
    posers = {"bf16": model.get_poser(torch.bfloat16, "cuda"), "f32": model.get_poser(torch.float32, "cuda")}
    poses = list(bench.pose_sweep(posers["f32"].pose_parameters, FRAMES))
    counters = _counters()
    reset(counters)
    outputs = {tag: [poser.get_posing_outputs(image, pose) for pose in poses] for tag, poser in posers.items()}
    return {"outputs": outputs, "poses": poses, "model": model, "launches": launches(counters)}


def test_a_frame_launches_k1_four_times_k2_once_r1_twice(frames):
    n = FRAMES * 2
    assert frames["launches"] == {"sine_chain_t": 4 * n, "grid_sample_fast": n, "bilinear_resize_forward": 2 * n}


@pytest.mark.parametrize("tag", ["bf16", "f32"])
def test_frames_give_six_finite_f32_outputs_on_the_card(frames, tag):
    expected = [(1, 512, 512, 4), (1, 512, 512, 1), (1, 512, 512, 4), (1, 512, 512, 4), (1, 512, 512, 2), (1, 128, 128, 4)]
    for outs in frames["outputs"][tag]:
        assert [tuple(o.shape) for o in outs] == expected
        assert all(o.device.type == "cuda" and o.dtype == torch.float32 for o in outs)
        assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_f32_frames_match_the_cpu_plain_frames(frames):
    cpu_poser = frames["model"].get_poser(torch.float32, "cpu")
    image = frames["model"].get_character_image()
    worst = dict.fromkeys(FRAME_OUTPUTS, 0.0)
    psnrs = []
    for pose, card_outs in zip(frames["poses"], frames["outputs"]["f32"]):
        plain = cpu_poser.get_posing_outputs(image, pose)
        assert all(bool(torch.isfinite(o).all()) for o in plain)
        for name, a, b in zip(FRAME_OUTPUTS, card_outs, plain):
            worst[name] = max(worst[name], float((a.cpu() - b).abs().max()))
        psnrs.append(psnr(card_outs[0].cpu(), plain[0]))
    print(f"f32 card vs CPU plain: {worst}; blended PSNR min {min(psnrs):.2f} dB")
    assert all(worst[name] <= FRAME_F32_ATOL[name] for name in FRAME_OUTPUTS), worst
    assert min(psnrs) > FRAME_F32_MIN_PSNR


def test_bf16_frames_are_within_28_db_of_f32(frames):
    db = [psnr(b[0], f[0]) for b, f in zip(frames["outputs"]["bf16"], frames["outputs"]["f32"])]
    assert min(db) >= BF16_MIN_PSNR, db


def test_headless_cli_writes_a_png_through_4_k1_and_1_k2(model_yaml, workdir):
    from tha4_tpu_torch.apps import character_model_manual_poser
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp

    png = os.path.join(workdir, "cli.png")
    before = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
    rc = character_model_manual_poser.main(
        ["--model", model_yaml, "--device", "cuda", "--bf16", "--set", "eye_wink_left=1", "--set", "head_x=0.5", "--output", png]
    )
    after = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
    assert rc == 0 and os.path.getsize(png)
    assert (after[0] - before[0], after[1] - before[1]) == (4, 1)


def test_frame_bench_graph_equals_eager(model_yaml):
    """``python -m tha4_tpu_torch.tools.bench``: its CUDA-graph scalar equal
    to its eager scalar bit for bit, 400 K1 and 100 K2 launches at capture."""
    lines = run_module(["tha4_tpu_torch.tools.bench", "--model", model_yaml], "bench")
    detail, headline = json.loads(lines[-2]), json.loads(lines[-1])
    assert set(headline) == {"metric", "value", "unit", "vs_baseline", "device"} and headline["metric"] == SERVING_METRIC
    assert math.isfinite(detail["graph_scalar"]) and detail["graph_scalar"] == detail["eager_scalar"]
    assert detail["launches_at_capture"] == {"sine_chain_t": 4 * BENCH_FRAMES, "grid_sample_fast": BENCH_FRAMES}


@pytest.fixture(scope="module")
def ifacialmocap_f32_run(model_yaml, workdir):
    """The puppeteer replaying the iFacialMocap trace in f32, one PNG a
    rendered frame: (its benchmark line's fields, the PNGs' directory)."""
    png_dir = os.path.join(workdir, "puppeteer_frames")
    run = puppeteer_run(["--model", model_yaml, "--source", f"file:{IFM_TRACE}", "--dtype", "f32", "--output-dir", png_dir])
    return run, png_dir


def test_puppeteer_writes_a_png_a_rendered_frame(ifacialmocap_f32_run):
    run, png_dir = ifacialmocap_f32_run
    assert len(os.listdir(png_dir)) == run["rendered"]


def test_puppeteer_calibrates_from_the_mediapipe_trace(model_yaml, workdir):
    calibration = os.path.join(workdir, "calibration.json")
    puppeteer_run(["--model", model_yaml, "--source", f"file:{MP_TRACE}", "--dtype", "bf16", "--calibrate-head",
                   "--save-calibration", calibration])
    with open(calibration) as f:
        assert json.load(f)["kind"] == "MediaPipeFacePoseConverterArgs"


def test_puppeteer_renders_300_synthetic_frames(model_yaml):
    assert puppeteer_run(["--model", model_yaml, "--source", "synthetic", "--frames", "300", "--dtype", "bf16"])["rendered"]


@pytest.fixture(scope="module")
def replayed(model_yaml):
    """The f32 and bf16 frames of the first replayed poses on the card, and
    their K1 and K2 launches."""
    from tha4_tpu_torch.apps import puppeteer
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter

    model = CharacterModel.load(model_yaml)
    image = torch.from_numpy(model.get_character_image()).cuda()
    converter = IFacialMocapPoseConverter()
    poses = [np.asarray(converter.convert(b), np.float32) for b in puppeteer.file_pose_stream(IFM_TRACE, PARITY_POSES)]
    posers = {"f32": model.get_poser(torch.float32, "cuda"), "bf16": model.get_poser(torch.bfloat16, "cuda")}
    counters = _counters()[:2]
    reset(counters)
    f32 = [posers["f32"].get_posing_outputs(image, pose) for pose in poses]
    bf16 = [posers["bf16"].get_posing_outputs(image, pose)[0] for pose in poses]
    return {"model": model, "poses": poses, "f32": f32, "bf16": bf16, "launches": launches(counters)}


def test_replayed_frames_launch_4_k1_and_1_k2(replayed):
    assert replayed["launches"] == {"sine_chain_t": 8 * PARITY_POSES, "grid_sample_fast": 2 * PARITY_POSES}


def test_replayed_bf16_frames_are_within_28_db_of_f32(replayed):
    from tha4_tpu_torch.utils import fidelity

    pairs = [(b[0].cpu().numpy(), f[0][0].cpu().numpy()) for b, f in zip(replayed["bf16"], replayed["f32"])]
    db = [fidelity.psnr(b, f) for b, f in pairs]
    print(f"replayed bf16 vs f32: PSNR min {min(db):.2f} dB, SSIM min {min(fidelity.ssim(b, f) for b, f in pairs):.4f}")
    assert min(db) >= BF16_MIN_PSNR


def test_replayed_f32_frames_match_the_cpu(replayed):
    cpu_poser = replayed["model"].get_poser(torch.float32, "cpu")
    image = replayed["model"].get_character_image()
    worst = dict.fromkeys(FRAME_OUTPUTS, 0.0)
    for pose, outs in zip(replayed["poses"], replayed["f32"]):
        for name, a, b in zip(FRAME_OUTPUTS, outs, cpu_poser.get_posing_outputs(image, pose)):
            worst[name] = max(worst[name], float((a.cpu() - b).abs().max()))
    assert all(worst[name] <= FRAME_F32_ATOL[name] for name in FRAME_OUTPUTS), worst


def test_puppeteer_png_equals_encode_display_of_the_same_frame(ifacialmocap_f32_run, replayed):
    import PIL.Image

    from tha4_tpu_torch.core import imagecodec

    _, png_dir = ifacialmocap_f32_run
    written = np.asarray(PIL.Image.open(os.path.join(png_dir, "frame_000001.png")))
    encoded = imagecodec.encode_display_u8(replayed["f32"][0][0])[0].cpu().numpy()
    assert np.array_equal(written, encoded), int((written != encoded).sum())


def test_web_puppeteer_serves_frames_and_its_calibration(model_yaml, workdir):
    from tha4_tpu_torch.apps import puppeteer
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter

    model = CharacterModel.load(model_yaml)
    image = torch.from_numpy(model.get_character_image()).cuda()
    stream = puppeteer.file_pose_stream(IFM_TRACE)
    counters = _counters()[:2]
    reset(counters)
    server, state, render = puppeteer._make_web_server(0, model.get_poser(torch.bfloat16, "cuda"), image,
                                                       IFacialMocapPoseConverter(), lambda: next(stream, None), False,
                                                       save_dir=workdir)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    render.start()
    thread = serve(server)
    try:
        wait_for(lambda: state["png"], "--web puppeteer: a frame")
        png_rgba(http_get(base + "/frame.png"))
        calib = json.loads(http_get(base + "/calib"))
    finally:
        state["stop"] = True
        stop(server, thread, render)
    web = launches(counters)
    assert calib["kind"] == "IFacialMocapPoseConverterArgs"
    assert web["grid_sample_fast"] and web["sine_chain_t"] == 4 * web["grid_sample_fast"], web


def _web_poser_requests(poser, image, poses, counters) -> tuple:
    """The web poser's handler on an ephemeral port: its /meta, and each
    pose's /pose.png with the launches of ``counters`` it took."""
    from tha4_tpu_torch.apps import web_poser

    state = web_poser._PoserState(poser, image, poser.pose_parameters)
    server = web_poser.ThreadingHTTPServer(("127.0.0.1", 0), web_poser._make_handler(state))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = serve(server)
    per_request = []
    try:
        meta = json.loads(http_get(base + "/meta"))
        for pose in poses:
            before = [c.launches for c in counters]
            png_rgba(http_get(f"{base}/pose.png?i=0&p=" + ",".join(repr(float(v)) for v in pose)))
            per_request.append(tuple(c.launches - b for c, b in zip(counters, before)))
    finally:
        stop(server, thread)
    return meta, per_request


def test_student_web_poser_serves_poses(replayed):
    """/meta: 45 parameters and 6 outputs; /pose.png: 4 K1 and 1 K2."""
    model = replayed["model"]
    image = torch.from_numpy(model.get_character_image()).cuda()
    meta, per_request = _web_poser_requests(model.get_poser(torch.bfloat16, "cuda"), image, replayed["poses"][:2],
                                            _counters()[:2])
    assert len(meta["params"]) == 45 and meta["output_length"] == 6
    assert per_request == [(4, 1)] * 2


def test_teacher_web_poser_serves_poses(teacher_files):
    """``tha4-torch-web-poser --teacher`` on the five full-width ``.pt``
    files: /meta 45 parameters and 33 outputs; /pose.png 102 K6, 102 fold
    and 5 K2 launches."""
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import bench

    files, png = teacher_files
    poser = mode_07.create_poser(module_file_names=files, compute_dtype=torch.bfloat16, device="cuda")
    image = torch.from_numpy(imagecodec.load_image_hwc(png)).cuda()
    counters = (cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film, cuda_warp.grid_sample_fast)
    meta, per_request = _web_poser_requests(poser, image, bench.pose_sweep(poser.pose_parameters, 2), counters)
    assert len(meta["params"]) == 45 and meta["output_length"] == 33
    assert per_request == [(K6_PER_TEACHER_CALL, K6_PER_TEACHER_CALL, 5)] * 2
