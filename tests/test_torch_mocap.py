"""The port's mocap stack against the JAX package's: the same recorded traces
through both packages' replay streams and pose converters, the same packets
through both parsers, calibration files across packages, and a UDP
round-trip through the port's receiver.  Within the port: the converters'
native viseme solve against their numpy loop, its counter and its
self-check.

Both packages run the same numpy and stdlib code, and the port's native
solve the same BLAS routines and IEEE operations, so poses are held to be
exactly equal: the same Python floats, in the same order.
"""

import json
import math
import os
import socket
import time

import numpy as np
import pytest

from tha4_tpu.apps import puppeteer as jpuppeteer
from tha4_tpu.mocap import calibration as jcal
from tha4_tpu.mocap import ifacialmocap as jifm
from tha4_tpu.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter as JIfmConverter
from tha4_tpu.mocap.mediapipe_face_pose_converter import MediaPipeFacePoseConverter as JMpConverter
from tha4_tpu_torch.apps import puppeteer
from tha4_tpu_torch.mocap import calibration as cal
from tha4_tpu_torch.mocap import ifacialmocap
from tha4_tpu_torch.mocap import ifacialmocap_constants as C
from tha4_tpu_torch.mocap import ifacialmocap_pose_converter as ifm_converter
from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import EyebrowDownMode, IFacialMocapPoseConverter
from tha4_tpu_torch.mocap.mediapipe_face_pose import MediaPipeFacePose
from tha4_tpu_torch.mocap.mediapipe_face_pose_converter import MediaPipeFacePoseConverter

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRACES = {"ifacialmocap": os.path.join(FIXTURES, "ifacialmocap_trace.jsonl"),
          "mediapipe": os.path.join(FIXTURES, "mediapipe_trace.jsonl")}
# The --set-style overrides of the calibration case: thresholds, both enums
# and (mediapipe) a head offset.
OVERRIDES = ["smile_threshold_min=0.3", "smile_threshold_max=0.55", "wink_mode=relaxed",
             "eyebrow_down_mode=troubled", "jaw_open_max=0.35", "iris_small_left=0.2", "mouth_funnel_min=0.1"]
MP_OVERRIDES = OVERRIDES + ["head_y_offset=0.05"]
# The packets of tests/test_mocap.py.
PACKETS = [
    "mouthSmile_L&55.5|mouthSmile_R&44.5|browInnerUp&10|=head#12.0,-6.0,3.0,0,0,0|rightEye#1,2,3|leftEye#4,5,6|",
    "mouthSmile_L-30|=head#0,0,15,0,0,0",
    "mouthSmile_L&55.5|=head#0,0,15,0,0,0",
    "mouthSmile_L&35|=head#1.0,2.0,3.0,0,0,0|",
    "mouthSmile_L&70|jawOpen&50|=head#4.0,5.0,6.0,0,0,0|",
]


def _converters(kind, case):
    """(port, JAX) converters with equal arguments for one case; breathing's
    clock starts at the same instant in both."""
    if kind == "mediapipe":
        port, jax_ = MediaPipeFacePoseConverter(), JMpConverter()
        overrides = MP_OVERRIDES
    else:
        port, jax_ = IFacialMocapPoseConverter(), JIfmConverter()
        overrides = OVERRIDES
    if case == "breathing":
        port.args.breathing_frequency = jax_.args.breathing_frequency = 17.0
    elif case == "calibrated":
        cal.apply_overrides(port.args, overrides)
        jcal.apply_overrides(jax_.args, overrides)
    port.breathing_start_time = jax_.breathing_start_time = 1000.0
    return port, jax_


@pytest.mark.parametrize("case", ["default", "breathing", "calibrated"])
@pytest.mark.parametrize("kind", ["ifacialmocap", "mediapipe"])
def test_replayed_poses_equal_jax(kind, case):
    ours = list(puppeteer.file_pose_stream(TRACES[kind]))
    theirs = list(jpuppeteer.file_pose_stream(TRACES[kind]))
    assert len(ours) == len(theirs) == 90
    port, jax_ = _converters(kind, case)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if kind == "mediapipe":
            assert isinstance(a, MediaPipeFacePose)
            assert a.blendshape_params == b.blendshape_params
            assert np.array_equal(a.xform_matrix, b.xform_matrix)
        else:
            assert a == b
        now = 1000.0 + k / 30.0
        pa, pb = port.convert(a, now=now), jax_.convert(b, now=now)
        assert len(pa) == 45 and all(isinstance(v, float) for v in pa), k
        assert pa == pb, (k, [(i, x, y) for i, (x, y) in enumerate(zip(pa, pb)) if x != y])
    if case == "breathing":
        assert pa[port._idx["breathing"]] > 0.0


@pytest.mark.parametrize("case", ["default", "breathing", "calibrated"])
@pytest.mark.parametrize("kind", ["ifacialmocap", "mediapipe"])
def test_native_and_numpy_solves_give_equal_poses(kind, case):
    """The same replayed trace through a converter with the native viseme
    solve and one with the numpy loop: the same pose lists."""
    poses = {}
    for native in (True, False):
        if kind == "mediapipe":
            conv = MediaPipeFacePoseConverter(native=native)
        else:
            conv = IFacialMocapPoseConverter(native=native)
        if case == "breathing":
            conv.args.breathing_frequency = 17.0
        elif case == "calibrated":
            cal.apply_overrides(conv.args, MP_OVERRIDES if kind == "mediapipe" else OVERRIDES)
        conv.breathing_start_time = 1000.0
        before = dict(ifm_converter.VISEME_SOLVES)
        poses[native] = [conv.convert(p, now=1000.0 + k / 30.0)
                         for k, p in enumerate(puppeteer.file_pose_stream(TRACES[kind]))]
        path = "native" if native else "numpy"
        assert ifm_converter.VISEME_SOLVES[path] > before[path]  # the trace opens the mouth
    assert len(poses[True]) == 90 and poses[True] == poses[False]


def test_the_solve_counter_counts_each_path():
    packet = ifacialmocap.create_default_ifacialmocap_pose()
    packet.update({C.JAW_OPEN: 0.6, C.MOUTH_FUNNEL: 0.3, C.MOUTH_PUCKER: 0.2})
    native, numpy_ = IFacialMocapPoseConverter(), IFacialMocapPoseConverter(native=False)
    assert native.native and not numpy_.native
    before = dict(ifm_converter.VISEME_SOLVES)
    native.convert(packet)
    native.convert(packet)
    numpy_.convert(packet)
    native.convert(ifacialmocap.create_default_ifacialmocap_pose())  # the mouth closed: no solve
    assert ifm_converter.VISEME_SOLVES["native"] - before["native"] == 2
    assert ifm_converter.VISEME_SOLVES["numpy"] - before["numpy"] == 1


def test_the_self_check_raises_when_a_bit_differs(monkeypatch):
    """A probe's expectation one ulp off: building a native converter
    raises; one with the numpy loop is still built."""
    loop = ifm_converter.solve_viseme_decomposition
    probe = ifm_converter._viseme_probes()[7]

    def off_by_one_ulp(point, *args):
        d = loop(point, *args)
        return np.nextafter(d, 2.0) if np.array_equal(point, probe) else d

    monkeypatch.setattr(ifm_converter, "solve_viseme_decomposition", off_by_one_ulp)
    ifm_converter.native_viseme_solver.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="differs from the numpy loop"):
            IFacialMocapPoseConverter()
        with pytest.raises(RuntimeError, match="differs from the numpy loop"):
            MediaPipeFacePoseConverter()
        assert IFacialMocapPoseConverter(native=False)._solve is off_by_one_ulp
    finally:
        ifm_converter.native_viseme_solver.cache_clear()


def test_mediapipe_head_calibration_equals_jax():
    first = next(puppeteer.file_pose_stream(TRACES["mediapipe"]))
    port, jax_ = _converters("mediapipe", "default")
    port.calibrate(first)
    jax_.calibrate(next(jpuppeteer.file_pose_stream(TRACES["mediapipe"])))
    assert cal.calibration_to_dict(port.args) == jcal.calibration_to_dict(jax_.args)
    assert port.convert(first)[port._idx["head_x"]] == 0.0


@pytest.mark.parametrize("packet", PACKETS)
def test_packet_parsing_equals_jax(packet):
    for name in ("parse_ifacialmocap_v1_pose", "parse_ifacialmocap_v2_pose", "parse_ifacialmocap_pose"):
        ours = getattr(ifacialmocap, name)(packet)
        assert ours == getattr(jifm, name)(packet), name
    assert ifacialmocap.create_default_ifacialmocap_pose() == jifm.create_default_ifacialmocap_pose()
    assert ifacialmocap.IFacialMocapReceiver._complete(ifacialmocap.parse_ifacialmocap_pose(packet)) == \
        jifm.IFacialMocapReceiver._complete(jifm.parse_ifacialmocap_pose(packet))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", ["ifacialmocap", "mediapipe"])
def test_calibration_files_load_across_packages(tmp_path, writer, kind):
    port, jax_ = _converters(kind, "calibrated")
    path = str(tmp_path / "calibration.json")
    if writer == "port":
        cal.save_calibration(port.args, path)
    else:
        jcal.save_calibration(jax_.args, path)
    expected = cal.calibration_to_dict(port.args)
    assert expected == jcal.calibration_to_dict(jax_.args)
    assert cal.calibration_to_dict(cal.load_calibration(path)) == expected
    assert jcal.calibration_to_dict(jcal.load_calibration(path)) == expected
    assert json.loads(open(path).read())["eyebrow_down_mode"] == EyebrowDownMode.TROUBLED.name


def _read_until(rx, predicate, seconds=5.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        pose = rx.read_pose()
        if pose is not None and predicate(pose):
            return pose
        time.sleep(0.01)
    raise AssertionError("no matching packet arrived")


def test_receiver_udp_roundtrip():
    """The port's socket receiver (``use_native=False``; the native one is
    tested in tests/test_torch_native.py) on a port of its own (the kernel
    picks it): the freshest packet wins, None when nothing new arrived, and
    a partial packet comes back completed with the default pose."""
    rx = ifacialmocap.IFacialMocapReceiver(port=0, use_native=False)
    rx.start()
    port = rx.socket.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert rx.read_pose() is None
        tx.sendto(PACKETS[3].encode(), ("127.0.0.1", port))
        tx.sendto(PACKETS[4].encode(), ("127.0.0.1", port))
        pose = _read_until(rx, lambda p: abs(p[C.MOUTH_SMILE_LEFT] - 0.70) < 1e-9)
        assert pose[C.JAW_OPEN] == pytest.approx(0.5)
        assert pose[C.HEAD_BONE_X] == pytest.approx(4.0 * math.pi / 180)
        assert rx.read_pose() is None
        tx.sendto(b"jawOpen&25", ("127.0.0.1", port))
        pose = _read_until(rx, lambda p: True)
        assert pose[C.JAW_OPEN] == pytest.approx(0.25)
        assert pose == jifm.IFacialMocapReceiver._complete(jifm.parse_ifacialmocap_pose("jawOpen&25"))
        assert all(name in pose for name in C.BLENDSHAPE_NAMES) and pose[C.HEAD_BONE_QUAT] == [0.0, 0.0, 0.0, 1.0]
    finally:
        tx.close()
        rx.close()
    assert rx.socket is None and rx.read_pose() is None
