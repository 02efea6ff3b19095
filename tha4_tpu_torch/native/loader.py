"""Build-on-first-use loader for the native mocap receiver and image codec
(counterpart of ``tha4_tpu/native/loader.py``).

Each library is a plain shared object, ``g++ -O3 -shared -fPIC -pthread``
of one source in this directory, called through ``ctypes``.  It is built at
first use into ``tha4_tpu_torch/_build/`` (ignored by git), named by a
digest of its source, the flags and the compiler's version, so an edited
source is rebuilt, an unchanged one reused, and nothing is written beside
the sources.

Unlike the JAX loader, nothing here returns ``None``: a missing compiler or
a failed build raises with the compiler's output.  Callers reach the numpy
or socket path only when they ask for it (``load_image_hwc(native=False)``,
``IFacialMocapReceiver(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCES = Path(__file__).resolve().parent
BUILD_DIR = SOURCES.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()


def _run_gxx(args) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: cannot build the native libraries") from e


@functools.lru_cache(maxsize=1)
def _compiler_version() -> str:
    return _run_gxx(["--version"]).stdout


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_compiler_version().encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library for it exists; raise on failure."""
    with _lock:
        so = library_path(source)
        if so.is_file():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # A unique name, then an atomic rename: test workers may build at once.
        fd, partial = tempfile.mkstemp(dir=BUILD_DIR, prefix=so.stem + ".", suffix=".partial")
        os.close(fd)
        try:
            proc = _run_gxx([*GXX_FLAGS, "-o", partial, str(source)])
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on {source.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(partial, so)
        finally:
            if os.path.exists(partial):
                os.remove(partial)
        return so


@functools.lru_cache(maxsize=1)
def get_codec_library() -> ctypes.CDLL:
    """The native image codec (``codec.cpp``), built on first call."""
    lib = ctypes.CDLL(str(build(SOURCES / "codec.cpp")))
    lib.tha4_decode_rgba.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.tha4_decode_rgba.restype = None
    lib.tha4_encode_rgba.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
    ]
    lib.tha4_encode_rgba.restype = None
    return lib


@functools.lru_cache(maxsize=1)
def get_mocap_library() -> ctypes.CDLL:
    """The native UDP drain-thread receiver (``mocap_receiver.cpp``), built
    on first call."""
    lib = ctypes.CDLL(str(build(SOURCES / "mocap_receiver.cpp")))
    lib.tha4_mocap_rx_start.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.tha4_mocap_rx_start.restype = ctypes.c_void_p
    lib.tha4_mocap_rx_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_ulonglong),
    ]
    lib.tha4_mocap_rx_read.restype = ctypes.c_longlong
    lib.tha4_mocap_rx_stop.argtypes = [ctypes.c_void_p]
    lib.tha4_mocap_rx_stop.restype = None
    return lib


def _rgba(image: np.ndarray, dtype) -> np.ndarray:
    if image.ndim != 3 or image.shape[2] != 4:
        raise ValueError(f"expected an (H, W, 4) image, got shape {image.shape}")
    return np.ascontiguousarray(image, dtype=dtype)


def decode_rgba(rgba_u8, scale: float, offset: float, premultiply: bool) -> np.ndarray:
    """(H, W, 4) u8 sRGB -> (H, W, 4) f32 model units: linear light,
    alpha premultiplied if asked, ``x * scale + offset``; one pass."""
    src = _rgba(np.asarray(rgba_u8), np.uint8)
    dst = np.empty(src.shape, np.float32)
    get_codec_library().tha4_decode_rgba(
        src.ctypes.data, dst.ctypes.data, src.shape[0] * src.shape[1], scale, offset, int(premultiply),
    )
    return dst


def encode_rgba(image_f32, scale: float, offset: float, unpremultiply: bool, epsilon: float = 1e-5) -> np.ndarray:
    """(H, W, 4) f32 model units -> (H, W, 4) u8 sRGB, straight alpha if
    ``unpremultiply``; one pass."""
    src = _rgba(np.asarray(image_f32), np.float32)
    dst = np.empty(src.shape, np.uint8)
    get_codec_library().tha4_encode_rgba(
        src.ctypes.data, dst.ctypes.data, src.shape[0] * src.shape[1], scale, offset, int(unpremultiply), epsilon,
    )
    return dst
