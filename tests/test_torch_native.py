"""The port's native code (``tha4_tpu_torch/native``) against the JAX
package's: the image codec against ``tha4_tpu/native/loader.py``'s output,
``load_image_hwc`` against the JAX function, the iFacialMocap receiver's
UDP round trip on its native drain thread and on the socket, and a failed
build, which raises (the JAX loader returns None there).  The viseme
solve's build flags and its lookup of numpy's BLAS routines (its arithmetic
is held to the numpy loop in tests/test_torch_viseme.py).

Needs ``g++``.  The UDP tests bind ports 49320-49321 (the JAX suite's
tests/test_mocap.py takes 49310-49311, and test files run in parallel).
"""

import hashlib
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
from tha4_tpu_torch.mocap import ifacialmocap_pose_converter as ifm_converter
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


def test_viseme_library_builds_with_its_own_flag_in_its_digest(tmp_path, monkeypatch):
    """viseme.cpp is compiled with -ffp-contract=off, and the flag enters its
    library's digest; the codec's and the receiver's libraries keep the
    names the common flags alone give them."""
    source = loader.SOURCES / "viseme.cpp"
    assert loader.VISEME_FLAGS == ("-ffp-contract=off",)
    assert loader.library_path(source, loader.VISEME_FLAGS) != loader.library_path(source)
    assert loader.get_viseme_library()._name == str(loader.library_path(source, loader.VISEME_FLAGS))
    for name in ("codec.cpp", "mocap_receiver.cpp"):
        digest = hashlib.sha256(" ".join(loader.GXX_FLAGS).encode())
        digest.update(loader._compiler_version().encode())
        digest.update((loader.SOURCES / name).read_bytes())
        assert loader.library_path(loader.SOURCES / name).name == f"{name[:-4]}_{digest.hexdigest()[:16]}.so"

    calls = []
    run_gxx = loader._run_gxx
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "_run_gxx", lambda args: calls.append(list(args)) or run_gxx(args))
    built = loader.build(source, loader.VISEME_FLAGS)
    assert built.is_file() and built.parent == tmp_path
    assert calls[-1][:len(loader.GXX_FLAGS) + 1] == [*loader.GXX_FLAGS, "-ffp-contract=off"]
    assert calls[-1][-1] == str(source)


def test_numpy_blas_routines_are_resolved_in_numpys_blas():
    """Both routines come from one library that the process mapped, under
    one naming, with the integer width that naming says."""
    blas = loader.numpy_cblas()
    assert blas.dgemv_name.endswith("cblas_dgemv" + ("64_" if blas.ilp64 else ""))
    assert blas.ddot_name == blas.dgemv_name.replace("dgemv", "ddot")
    assert blas.dgemv and blas.ddot

    def mapped_file(address):
        with open("/proc/self/maps") as maps:
            for line in maps:
                fields = line.split()
                lo, hi = (int(x, 16) for x in fields[0].split("-"))
                if lo <= address < hi:
                    return fields[-1]
        return None

    library = mapped_file(blas.dgemv)
    assert library is not None and "blas" in library.lower(), library
    assert mapped_file(blas.ddot) == library


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


def _clear_library_caches():
    for cached in (loader.get_codec_library, loader.get_mocap_library, loader.get_viseme_library,
                   ifm_converter.native_viseme_solver):
        cached.cache_clear()


@pytest.mark.parametrize("what", ["receiver", "codec", "viseme"])
def test_callers_raise_when_the_native_build_fails(tmp_path, monkeypatch, what):
    """No silent fallback: with sources that do not compile, the native
    receiver, the native decode and a converter with the native viseme
    solve raise; ``native=False`` still works."""
    for name in ("codec.cpp", "mocap_receiver.cpp", "viseme.cpp"):
        (tmp_path / name).write_text("#error broken on purpose\n")
    monkeypatch.setattr(loader, "SOURCES", tmp_path)
    _clear_library_caches()
    try:
        if what == "receiver":
            with pytest.raises(RuntimeError, match="broken on purpose"):
                ifacialmocap.IFacialMocapReceiver(port=49322).start()
        elif what == "viseme":
            with pytest.raises(RuntimeError, match="broken on purpose"):
                ifm_converter.IFacialMocapPoseConverter()
            assert not ifm_converter.IFacialMocapPoseConverter(native=False).native
        else:
            image = PIL.Image.fromarray(np.full((4, 4, 4), 100, np.uint8), "RGBA")
            image.putpixel((0, 0), (1, 2, 3, 4))
            with pytest.raises(RuntimeError, match="broken on purpose"):
                imagecodec.load_image_hwc(image)
            assert imagecodec.load_image_hwc(image, native=False).shape == (4, 4, 4)
    finally:
        _clear_library_caches()
