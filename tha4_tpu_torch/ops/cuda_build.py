"""Build and load the port's CUDA kernels (``tha4_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so one
``nvcc`` call compiles them all into a shared library in seconds; ``ctypes``
loads it.  The library is built at first use and keyed on a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused.  It lands in ``tha4_tpu_torch/_build/`` (ignored by git).

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# -O3 and exact IEEE float math: no --use_fast_math, which would swap in
# approximate division/sqrt and flush denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # prev, has_prev, cp, pos, pose, pose_dim, w, b, specs, num_layers,
    # num_sine, omega, out, n, hw, is_bf16, stream
    "tha4_sine_chain_forward": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                ctypes.c_float, _P, _I, _I, _I, _P],
    # prev, has_prev, cp, pos, pose, pose_dim, w, b, specs, num_layers,
    # num_sine, omega, gout, dprev, scratch, blocks, grads, n, hw, is_bf16, stream
    "tha4_sine_chain_backward": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                 ctypes.c_float, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    # image, grid, out, n, h, w, ho, wo, is_bf16, stream
    "tha4_grid_sample_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError("nvcc not found (not on PATH, nor under $CUDA_HOME/bin): cannot build the CUDA kernels")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"tha4_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept next to the library as ``<name>.log``."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
            capture_output=True, text=True,
        )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        name = library().tha4_cuda_error_string
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {status} ({name(status).decode()})")
