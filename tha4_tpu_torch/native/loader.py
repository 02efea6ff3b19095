"""Build-on-first-use loader for the native mocap receiver, image codec and
viseme solve (counterpart of ``tha4_tpu/native/loader.py``, which has no
viseme solve).

Each library is a plain shared object, ``g++ -O3 -shared -fPIC -pthread``
(plus the library's own extra flags, if any) of one source in this
directory, called through ``ctypes``.  It is built at first use into
``tha4_tpu_torch/_build/`` (ignored by git), named by a digest of its
source, the flags and the compiler's version, so an edited source is
rebuilt, an unchanged one reused, and nothing is written beside the
sources.

The viseme solve calls numpy's own ``cblas_dgemv`` and ``cblas_ddot``:
``numpy_cblas`` finds them in the BLAS library that numpy's
``_multiarray_umath`` loaded, so the native loop does the same arithmetic as
numpy on whatever CPU runs it.

Unlike the JAX loader, nothing here returns ``None``: a missing compiler or
a failed build raises with the compiler's output.  Callers reach the numpy
or socket path only when they ask for it (``load_image_hwc(native=False)``,
``IFacialMocapReceiver(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

SOURCES = Path(__file__).resolve().parent
BUILD_DIR = SOURCES.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
# viseme.cpp must round every elementwise step on its own, as numpy does:
# no multiply-add fused into an FMA where that is baseline (aarch64).
VISEME_FLAGS = ("-ffp-contract=off",)

_lock = threading.Lock()


def _run_gxx(args) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: cannot build the native libraries") from e


@functools.lru_cache(maxsize=1)
def _compiler_version() -> str:
    return _run_gxx(["--version"]).stdout


def library_path(source: Path, extra_flags=()) -> Path:
    digest = hashlib.sha256(" ".join((*GXX_FLAGS, *extra_flags)).encode())
    digest.update(_compiler_version().encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, extra_flags=()) -> Path:
    """Compile ``source`` (with ``extra_flags`` after the common flags)
    unless a library for it exists; raise on failure."""
    with _lock:
        so = library_path(source, extra_flags)
        if so.is_file():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # A unique name, then an atomic rename: test workers may build at once.
        fd, partial = tempfile.mkstemp(dir=BUILD_DIR, prefix=so.stem + ".", suffix=".partial")
        os.close(fd)
        try:
            proc = _run_gxx([*GXX_FLAGS, *extra_flags, "-o", partial, str(source)])
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


# The CBLAS names numpy's builds export, most specific first: the scipy-openblas
# wheels' ILP64 names (numpy 2), OpenBLAS's ILP64 suffix (numpy 1 wheels),
# then LP64.  The suffix ``64_`` means 64-bit integer arguments.
_CBLAS_NAMES = (("scipy_", "64_"), ("", "64_"), ("scipy_", ""), ("", ""))


class NumpyCblas(NamedTuple):
    dgemv_name: str
    ddot_name: str
    ilp64: bool
    dgemv: int  # addresses
    ddot: int


def _numpy_umath_path() -> str:
    try:
        module = importlib.import_module("numpy._core._multiarray_umath")  # numpy 2
    except ImportError:
        module = importlib.import_module("numpy.core._multiarray_umath")
    return module.__file__


@functools.lru_cache(maxsize=1)
def numpy_cblas() -> NumpyCblas:
    """``cblas_dgemv`` and ``cblas_ddot`` as numpy calls them: looked up
    through the handle of numpy's ``_multiarray_umath``, which searches that
    module and the libraries it loaded (its BLAS), and no other.  Raises
    unless both are found under one naming."""
    umath_path = _numpy_umath_path()
    umath = ctypes.CDLL(umath_path)
    for prefix, suffix in _CBLAS_NAMES:
        names = (f"{prefix}cblas_dgemv{suffix}", f"{prefix}cblas_ddot{suffix}")
        try:
            dgemv, ddot = (ctypes.cast(getattr(umath, name), ctypes.c_void_p).value for name in names)
        except AttributeError:
            continue
        return NumpyCblas(*names, suffix == "64_", dgemv, ddot)
    tried = ", ".join(f"{p}cblas_dgemv{s}" for p, s in _CBLAS_NAMES)
    raise RuntimeError(f"numpy's BLAS routines not found from {umath_path} (tried {tried}): "
                       "the native viseme solve needs the cblas_dgemv and cblas_ddot that numpy calls")


@functools.lru_cache(maxsize=1)
def get_viseme_library() -> ctypes.CDLL:
    """The native viseme solve (``viseme.cpp``), built on first call with
    ``VISEME_FLAGS``."""
    lib = ctypes.CDLL(str(build(SOURCES / "viseme.cpp", VISEME_FLAGS)))
    lib.tha4_viseme_solve.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_void_p,
    ]
    lib.tha4_viseme_solve.restype = None
    return lib


def viseme_solve(matrix, point, iterations: int, lr: float) -> np.ndarray:
    """``iterations`` projected-gradient steps of ``||d @ matrix - point||_2
    + 0.01 ||d||_1`` over d in [0,1]^4 from d = 0, in one native call on
    numpy's BLAS routines; returns d (float64, shape (4,))."""
    m = np.ascontiguousarray(matrix, np.float64)
    p = np.ascontiguousarray(point, np.float64)
    if m.shape != (4, 4) or p.shape != (4,):
        raise ValueError(f"expected a (4, 4) matrix and a (4,) point, got {m.shape} and {p.shape}")
    d = np.empty(4)
    blas = numpy_cblas()
    get_viseme_library().tha4_viseme_solve(
        blas.dgemv, blas.ddot, int(blas.ilp64), m.ctypes.data, p.ctypes.data, iterations, lr, d.ctypes.data,
    )
    return d


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
