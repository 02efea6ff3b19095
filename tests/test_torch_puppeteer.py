"""The port's puppeteer (``tha4_tpu_torch.apps.puppeteer``) against the JAX
package's, on the CPU.

One narrow character model (the widths of ``test_torch_mode14.py``), written
by the port's ``write_random_character_model``, is loaded by both packages'
``CharacterModel``.  Both ``puppeteer.main``s replay the iFacialMocap trace
for 4 frames at full f32 (the port ``--dtype exact --device cpu``, which
runs the kernels' plain versions; JAX ``--dtype exact``) and write PNGs.

The float frames are held to ``test_torch_mode14.py``'s f32 bars.  The PNGs
cannot carry those bars over: the display encode divides by alpha (an
error grows as 1/alpha where alpha is small) and the linear->sRGB curve has
slope 12.92 near black, so a 1e-3 float gap can move a uint8 RGB value by
several levels.  PNGs are held to alpha within 1 level everywhere and RGB
within 4 levels where both alphas are at least 128.
"""

import io
import json
import statistics
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from tha4_tpu.apps import puppeteer as jpuppeteer
from tha4_tpu.charmodel import CharacterModel as JCharacterModel
from tha4_tpu.mocap import ifacialmocap_constants as JC
from tha4_tpu.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter as JIfmConverter
from tha4_tpu.mocap.mediapipe_face_pose import MediaPipeFacePose as JMediaPipeFacePose
from tha4_tpu_torch.apps import puppeteer
from tha4_tpu_torch.charmodel import CharacterModel
from tha4_tpu_torch.charmodel.synthetic import write_random_character_model
from tha4_tpu_torch.mocap import calibration as cal
from tha4_tpu_torch.mocap import ifacialmocap_constants as C
from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter, WinkMode
from tha4_tpu_torch.mocap.mediapipe_face_pose import MediaPipeFacePose
from test_torch_mode14 import F32_ATOL, OUTPUT_NAMES, _port_cfgs

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
IFM_TRACE = os.path.join(FIXTURES, "ifacialmocap_trace.jsonl")
FRAMES = 4
PNG_ALPHA_LEVELS = 1
PNG_RGB_LEVELS = 4
PNG_OPAQUE = 128


def png_gaps(a: np.ndarray, b: np.ndarray):
    """(largest alpha gap, largest RGB gap where both alphas >= 128) of two
    uint8 RGBA images, in levels."""
    a, b = a.astype(np.int32), b.astype(np.int32)
    alpha = int(np.abs(a[..., 3] - b[..., 3]).max())
    opaque = (a[..., 3] >= PNG_OPAQUE) & (b[..., 3] >= PNG_OPAQUE)
    rgb = int(np.abs(a[..., :3] - b[..., :3])[opaque].max()) if opaque.any() else 0
    return alpha, rgb


def _rot_x(a):
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = np.cos(a), -np.sin(a), np.sin(a), np.cos(a)
    return m


def _stub_landmarker(names, pose_cls):
    """tests/test_calibration.py's FaceLandmarker stand-in for one package:
    only the 52 ARKit scores, the jaw opening with time, the head turned
    about x."""
    def landmarker(timestamp_ms):
        blend = {name: 0.0 for name in names.BLENDSHAPE_NAMES}
        blend[names.JAW_OPEN] = min(1.0, timestamp_ms / 100.0)
        return pose_cls(blend, _rot_x(0.2))
    return landmarker


@pytest.fixture(scope="module")
def model_yaml(tmp_path_factory):
    face_cfg, body_cfg = _port_cfgs()
    return write_random_character_model(str(tmp_path_factory.mktemp("narrow_model")), seed=5,
                                        face_cfg=face_cfg, body_cfg=body_cfg)


@pytest.fixture(scope="module")
def replay(model_yaml, tmp_path_factory):
    """Both packages' puppeteer.main over the trace's first 4 records, f32,
    each writing its PNGs."""
    out = tmp_path_factory.mktemp("replay")
    dirs = {"port": str(out / "port"), "jax": str(out / "jax")}
    args = ["--model", model_yaml, "--source", f"file:{IFM_TRACE}", "--frames", str(FRAMES), "--dtype", "exact"]
    assert puppeteer.main(args + ["--device", "cpu", "--output-dir", dirs["port"]]) == 0
    assert jpuppeteer.main(args + ["--output-dir", dirs["jax"]]) == 0
    return dirs


def test_replay_writes_the_same_pngs(replay):
    names = sorted(os.listdir(replay["port"]))
    assert names == sorted(os.listdir(replay["jax"])) == [f"frame_{i:06d}.png" for i in range(1, FRAMES + 1)]
    for name in names:
        ours, theirs = (np.asarray(PIL.Image.open(os.path.join(replay[k], name))) for k in ("port", "jax"))
        assert ours.shape == theirs.shape == (512, 512, 4) and ours.dtype == np.uint8
        alpha, rgb = png_gaps(ours, theirs)
        assert alpha <= PNG_ALPHA_LEVELS and rgb <= PNG_RGB_LEVELS, (name, alpha, rgb)


def test_replayed_frames_match_jax_f32(model_yaml):
    """The float frames of the replayed poses: both converters give the same
    poses, and both posers' six outputs agree at the f32 bars."""
    ours = [IFacialMocapPoseConverter().convert(b) for b in puppeteer.file_pose_stream(IFM_TRACE, FRAMES)]
    theirs = [JIfmConverter().convert(b) for b in jpuppeteer.file_pose_stream(IFM_TRACE, FRAMES)]
    assert ours == theirs
    model, jmodel = CharacterModel.load(model_yaml), JCharacterModel.load(model_yaml)
    poser, jposer = model.get_poser(torch.float32, "cpu"), jmodel.get_poser(compute_dtype=jnp.float32)
    image = model.get_character_image()
    # JAX decodes the PNG with its native codec's sRGB table, an f32 step
    # from the numpy formula in places; both posers take the port's image.
    np.testing.assert_allclose(image, jmodel.get_character_image(), rtol=0.0, atol=2.0**-22)
    for k, pose in enumerate(np.asarray(ours, np.float32)):
        got, ref = poser.get_posing_outputs(image, pose), jposer.get_posing_outputs(image, pose)
        for name, a, b in zip(OUTPUT_NAMES, got, ref):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=F32_ATOL[name], err_msg=f"frame {k} {name}")


def test_mediapipe_head_calibration_saves_what_jax_saves(model_yaml, tmp_path):
    args = ["--model", model_yaml, "--source", "mediapipe", "--frames", "2", "--dtype", "exact", "--calibrate-head",
            "--set", "wink_mode=relaxed"]
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert puppeteer.main(args + ["--device", "cpu", "--save-calibration", ours],
                          mediapipe_landmarker=_stub_landmarker(C, MediaPipeFacePose)) == 0
    assert jpuppeteer.main(args + ["--save-calibration", theirs],
                           mediapipe_landmarker=_stub_landmarker(JC, JMediaPipeFacePose)) == 0
    saved = json.loads(open(ours).read())
    assert saved == json.loads(open(theirs).read())
    assert saved["kind"] == "MediaPipeFacePoseConverterArgs" and saved["wink_mode"] == "RELAXED"
    assert saved["head_x_offset"] == pytest.approx(0.2, abs=1e-12)


def _hide_mediapipe(monkeypatch):
    monkeypatch.setitem(sys.modules, "mediapipe", None)  # import raises ImportError


def test_missing_mediapipe_messages_equal_jax(model_yaml, monkeypatch, capsys):
    _hide_mediapipe(monkeypatch)
    with pytest.raises(ImportError) as ours:
        puppeteer.make_mediapipe_landmarker()
    with pytest.raises(ImportError) as theirs:
        jpuppeteer.make_mediapipe_landmarker()
    assert str(ours.value) == str(theirs.value) and "file:<trace" in str(ours.value)
    assert puppeteer.main(["--model", model_yaml, "--source", "mediapipe", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.strip() == "ERROR: mediapipe not installed in this environment"


def test_missing_task_bundle_message_equals_jax(monkeypatch, tmp_path):
    """With a package that imports (a stand-in module tree) but no task
    bundle, both packages raise the same FileNotFoundError."""
    vision = types.SimpleNamespace()
    python = types.ModuleType("mediapipe.tasks.python")
    python.BaseOptions, python.vision = object, vision
    for name, module in [("mediapipe", types.ModuleType("mediapipe")), ("mediapipe.tasks", types.ModuleType("mediapipe.tasks")),
                         ("mediapipe.tasks.python", python)]:
        monkeypatch.setitem(sys.modules, name, module)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("THA4_FACE_LANDMARKER_TASK", raising=False)
    with pytest.raises(FileNotFoundError) as ours:
        puppeteer.make_mediapipe_landmarker()
    with pytest.raises(FileNotFoundError) as theirs:
        jpuppeteer.make_mediapipe_landmarker()
    assert str(ours.value) == str(theirs.value) and "THA4_FACE_LANDMARKER_TASK" in str(ours.value)


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(url, data=json.dumps(body).encode(), method="POST"), timeout=30)


def test_web_calibration_panel_on_a_cpu_poser(model_yaml, tmp_path):
    """The --web server on an ephemeral port around the CPU poser: the
    panel's parameters, a live edit, /save confined to a bare .json name,
    and /frame.png a 512^2 RGBA PNG of the stream."""
    model = CharacterModel.load(model_yaml)
    poser = model.get_poser(torch.float32, "cpu")
    image = torch.from_numpy(model.get_character_image())
    conv = IFacialMocapPoseConverter()
    stream = puppeteer.synthetic_blendshape_stream(1_000_000)
    server, state, render_thread = puppeteer._make_web_server(
        0, poser, image, conv, lambda: next(stream), False, save_dir=str(tmp_path))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    render_thread.start()
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        meta = json.loads(urllib.request.urlopen(base + "/calib", timeout=30).read())
        values = cal.calibration_to_dict(conv.args)
        assert meta["kind"] == values.pop("kind") == "IFacialMocapPoseConverterArgs" and meta["values"] == values
        assert meta["enums"]["wink_mode"] == ["NORMAL", "RELAXED"]
        assert b"calibration" in urllib.request.urlopen(base + "/", timeout=30).read()

        assert _post(base + "/calib", {"smile_threshold_min": 0.31, "wink_mode": "RELAXED"}).status == 200
        assert conv.args.smile_threshold_min == 0.31 and conv.args.wink_mode is WinkMode.RELAXED
        assert _post(base + "/save", {"path": "c.json"}).status == 200
        assert cal.load_calibration(str(tmp_path / "c.json")).smile_threshold_min == 0.31
        for bad in ("../evil.json", str(tmp_path / "evil.json"), "c.txt"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/save", {"path": bad})
            assert e.value.code == 400
        assert not (tmp_path / "evil.json").exists() and not (tmp_path.parent / "evil.json").exists()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/calib", {"not_a_param": 1})
        assert e.value.code == 400

        deadline, png = time.time() + 60, b""
        while time.time() < deadline and not png:
            try:
                png = urllib.request.urlopen(base + "/frame.png", timeout=30).read()
            except urllib.error.HTTPError as e:
                assert e.code == 503  # warming up
                time.sleep(0.1)
        frame = np.asarray(PIL.Image.open(io.BytesIO(png)))
        assert frame.shape == (512, 512, 4) and frame.dtype == np.uint8
        assert state["fps"] is None or state["fps"] > 0
    finally:
        state["stop"] = True
        server.shutdown()
        server.server_close()
        render_thread.join(timeout=60)
    assert not render_thread.is_alive()


def test_pairs_tool_alternates_the_two_sides(model_yaml, capsys):
    """``tools.puppeteer_pairs`` runs side a, then b, then b, then a, parses
    each benchmark line and counts the pairs each side won."""
    from tha4_tpu_torch.tools import puppeteer_pairs

    assert puppeteer_pairs.main(["--model", model_yaml, "--pairs", "2", "--a=--dtype exact", "--b=--dtype bf16", "--",
                                 "--source", f"file:{IFM_TRACE}", "--frames", "2", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["pair"], r["side"]) for r in lines[:-1]] == [(0, "a"), (0, "b"), (1, "b"), (1, "a")]
    assert all(r["frames"] == r["rendered"] == 2 and r["fps"] > 0.0 for r in lines[:-1])
    last = lines[-1]
    assert last["pairs"] == 2 and 0 <= last["a_higher_fps"] <= 2 and last["card"] == "cpu"
    assert last["a"]["fps"] == statistics.median(r["fps"] for r in lines[:-1] if r["side"] == "a")
