"""Build and load the port's CUDA kernels (``tha4_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` compiles each in seconds: one process per ``.cu`` file, all started
together, then one link into a shared library that ``ctypes`` loads.  The
library is built at first use and keyed on a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is reused.  It lands in
``tha4_tpu_torch/_build/`` (ignored by git).

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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -O3 and exact IEEE float math: no --use_fast_math, which would swap in
# approximate division/sqrt and flush denormals.
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # prev, has_prev, cp, pos, pose, pose_dim, w, b, specs, num_layers,
    # num_sine, omega, out, n, hw, stream
    "tha4_sine_chain_forward": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                ctypes.c_float, _P, _I, _I, _P],
    # prev, has_prev, cp, pos, pose, pose_dim, w, b, specs, num_layers,
    # num_sine, omega, gout, dprev, scratch, blocks, grads, n, hw, stream
    "tha4_sine_chain_backward": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                 ctypes.c_float, _P, _P, _P, _I, _P, _I, _I, _P],
    # specs, num_layers, num_sine, cp, pose_dim, n, hw, sms, plan[5] out
    "tha4_sine_chain_tc_plan": [_P, _I, _I, _I, _I, _I, _I, _I, _P],
    # prev, cp, pos, pose, pose_dim, w, b, tiles, specs, num_layers,
    # num_sine, omega, out, fold scratch, n, hw, stream
    "tha4_sine_chain_tc_forward": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P, _P, _I, _I, _P],
    # prev, cp, pos, pose, pose_dim, w, b, tiles, specs, num_layers,
    # num_sine, omega, gout, dprev, workspace, workspace bytes, grads, n,
    # hw, sms, stream
    "tha4_sine_chain_tc_backward": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P, _P, _P, _L, _P,
                                    _I, _I, _I, _P],
    # image, grid, out, n, h, w, ho, wo, is_bf16, stream
    "tha4_grid_sample_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # g, image, grid, dgrid, n, h, w, ho, wo, is_bf16, stream
    "tha4_grid_sample_grid_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, out, n, dtypes, stream
    "tha4_poly_sin_forward": [_P, _P, _L, _I, _P],
    # a, g, da, n, dtypes, stream
    "tha4_poly_sin_backward": [_P, _P, _P, _L, _I, _P],
    # n, h, w, cin, cout, cs, skip_mode, is_bf16, plan[4] out
    "tha4_affine_conv3_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, scale, shift, wpack, bias, skip, out, n, h, w, cin, cout, cs,
    # skip_mode, is_bf16, workspace, stream
    "tha4_affine_conv3_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # n, hw, c, groups, is_bf16
    "tha4_group_norm_fold_blocks": [_I, _I, _I, _I, _I],
    # x, n, hw, c, groups, is_bf16, gamma, beta, (film scale, row stride,
    # film shift, row stride) x 2, film_count, film_bf16, condition_bias,
    # eps, workspace, scale, shift, stream
    "tha4_group_norm_fold": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _L, _P, _L, _P, _L, _P, _L, _I, _I,
                             ctypes.c_float, ctypes.c_float, _P, _P, _P, _P],
    # x, w8, w_scale, bias, out, n, h, w, cin, cout, k, inv, xs, is_bf16,
    # stream
    "tha4_int8_conv_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P],
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(obj)}: nvcc failed ({proc.returncode})")
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + "".join(log))
        linked = os.path.join(tmp, so.name)
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", linked, *(obj for obj, _ in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(linked, so)
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


def current_stream(device) -> int:
    """The current CUDA stream of ``device`` (a ``torch.device`` with an
    index) as a raw handle for a launch.  The call returns just the handle:
    ``torch.cuda.current_stream`` builds a Stream object, a visible share of
    the host's cost around a kernel of a few microseconds."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        name = library().tha4_cuda_error_string
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {status} ({name(status).decode()})")
