"""The port's native code (``tha4_tpu_torch/native``) against the JAX
package's: the image codec against ``tha4_tpu/native/loader.py``'s output,
``load_image_hwc`` against the JAX function, the iFacialMocap receiver's
UDP round trip on its native drain thread and on the socket, and a failed
build, which raises (the JAX loader returns None there).

Needs ``g++``.  The UDP tests bind ports 49320-49321 (the JAX suite's
tests/test_mocap.py takes 49310-49311, and test files run in parallel).
"""

import math
import socket
import time

import numpy as np
import PIL.Image
import pytest

from tha4_tpu.core import imagecodec as jimagecodec
from tha4_tpu.native import loader as jloader
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.mocap import ifacialmocap
from tha4_tpu_torch.mocap import ifacialmocap_constants as C
from tha4_tpu_torch.native import loader

CODEC_ATOL = 2e-6  # tests/test_native_codec.py:27


def _numpy_decode(rgba):
    ref = rgba.astype(np.float32) / 255.0
    ref[:, :, 0:3] = jimagecodec.srgb_to_linear(ref[:, :, 0:3])
    ref[:, :, 0:3] *= ref[:, :, 3:4]
    return ref * 2.0 - 1.0


def test_library_is_built_into_the_build_dir_by_digest():
    path = loader.build(loader.SOURCES / "codec.cpp")
    assert path.parent == loader.BUILD_DIR and path.name.startswith("codec_") and path.suffix == ".so"
    assert path == loader.library_path(loader.SOURCES / "codec.cpp")
    assert not list(loader.SOURCES.glob("*.so"))


@pytest.mark.parametrize("premultiply", [True, False])
def test_decode_matches_the_jax_codec(rng, premultiply):
    rgba = rng.integers(0, 256, size=(64, 64, 4), dtype=np.uint8)
    ours = loader.decode_rgba(rgba, 2.0, -1.0, premultiply)
    theirs = jloader.decode_rgba(rgba, 2.0, -1.0, premultiply)
    assert ours.dtype == np.float32 and ours.shape == rgba.shape
    np.testing.assert_allclose(ours, theirs, atol=CODEC_ATOL, rtol=0)
    if premultiply:
        np.testing.assert_allclose(ours, _numpy_decode(rgba), atol=CODEC_ATOL, rtol=0)


def test_encode_matches_the_jax_codec(rng):
    img = rng.uniform(-1, 1, size=(32, 32, 4)).astype(np.float32)
    img[..., 3] = rng.uniform(0.2, 1.0, size=(32, 32))
    ours = loader.encode_rgba(img, 2.0, -1.0, True)
    theirs = jloader.encode_rgba(img, 2.0, -1.0, True)
    assert ours.dtype == np.uint8
    # Two builds of one source with other flags: at most one step at an exact .5.
    assert np.abs(ours.astype(np.int32) - theirs.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError):
        loader.encode_rgba(img[..., :3], 2.0, -1.0, True)


def test_load_image_hwc_matches_jax_on_one_png(tmp_path, rng):
    rgba = rng.integers(0, 256, size=(16, 16, 4), dtype=np.uint8)
    rgba[..., 3] = np.maximum(rgba[..., 3], 1)
    path = str(tmp_path / "x.png")
    PIL.Image.fromarray(rgba, "RGBA").save(path)
    ours = imagecodec.load_image_hwc(path)
    np.testing.assert_allclose(ours, jimagecodec.load_image_hwc(path), atol=CODEC_ATOL, rtol=0)
    np.testing.assert_allclose(ours, imagecodec.load_image_hwc(path, native=False), atol=CODEC_ATOL, rtol=0)
    np.testing.assert_allclose(ours, _numpy_decode(rgba), atol=CODEC_ATOL, rtol=0)


def _read_until(rx, pred, seconds=5.0):
    """Poll until a pose satisfying ``pred`` arrives (the drain thread may
    expose an older packet briefly between two datagrams)."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        pose = rx.read_pose()
        if pose is not None and pred(pose):
            return pose
        time.sleep(0.01)
    raise AssertionError("no matching packet arrived")


@pytest.mark.parametrize("use_native", [True, False])
def test_receiver_udp_roundtrip(use_native):
    """Freshest packet wins, None when nothing new arrived, partial packets
    completed with the default pose, both paths (tests/test_mocap.py:201)."""
    port = 49320 + (0 if use_native else 1)
    rx = ifacialmocap.IFacialMocapReceiver(port=port, use_native=use_native)
    rx.start()
    assert rx.draining_natively == use_native and (rx.socket is None) == use_native
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert rx.read_pose() is None
        tx.sendto(b"mouthSmile_L&35|=head#1.0,2.0,3.0,0,0,0|", ("127.0.0.1", port))
        tx.sendto(b"mouthSmile_L&70|jawOpen&50|=head#4.0,5.0,6.0,0,0,0|", ("127.0.0.1", port))
        pose = _read_until(rx, lambda p: abs(p[C.MOUTH_SMILE_LEFT] - 0.70) < 1e-9)
        assert pose[C.JAW_OPEN] == pytest.approx(0.5)
        assert pose[C.EYE_BLINK_LEFT] == 0.0 and pose[C.HEAD_BONE_QUAT] == [0.0, 0.0, 0.0, 1.0]
        assert pose[C.HEAD_BONE_X] == pytest.approx(4.0 * math.pi / 180)
        assert rx.read_pose() is None
    finally:
        tx.close()
        rx.close()
    assert rx.read_pose() is None


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        loader.build(broken)
    assert "error" in str(info.value)
    assert not list(loader.BUILD_DIR.glob("broken*"))


@pytest.mark.parametrize("what", ["receiver", "codec"])
def test_callers_raise_when_the_native_build_fails(tmp_path, monkeypatch, what):
    """No silent fallback: with sources that do not compile, the native
    receiver and the native decode raise; ``native=False`` still works."""
    for name in ("codec.cpp", "mocap_receiver.cpp"):
        (tmp_path / name).write_text("#error broken on purpose\n")
    monkeypatch.setattr(loader, "SOURCES", tmp_path)
    loader.get_codec_library.cache_clear()
    loader.get_mocap_library.cache_clear()
    try:
        if what == "receiver":
            with pytest.raises(RuntimeError, match="broken on purpose"):
                ifacialmocap.IFacialMocapReceiver(port=49322).start()
        else:
            image = PIL.Image.fromarray(np.full((4, 4, 4), 100, np.uint8), "RGBA")
            image.putpixel((0, 0), (1, 2, 3, 4))
            with pytest.raises(RuntimeError, match="broken on purpose"):
                imagecodec.load_image_hwc(image)
            assert imagecodec.load_image_hwc(image, native=False).shape == (4, 4, 4)
    finally:
        loader.get_codec_library.cache_clear()
        loader.get_mocap_library.cache_clear()
