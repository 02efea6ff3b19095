"""What the card tests share: the ``card`` fixture, the seeded full-width
inputs and the drivers of the port's entry points.

Not collected (no ``test_`` prefix).  The card tests are
``tests/test_torch_cuda.py`` and ``tests/test_torch_card_*.py``; each skips
itself, inside a fixture, where ``torch.cuda.is_available()`` is False.  On
a machine with a card (``--noconftest``: tests/conftest.py sets jax up for
the CPU tests):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py tests/test_torch_card_*.py tests/test_torch_parallel.py

Module level stays light (torch and pytest); the port is imported inside
the functions.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
BATCH = 8  # the students' training batch
K6_PER_TEACHER_CALL = 55 + 47  # upscaler + body morpher U-Nets of one mode_07 call
# The wrappers' launches of a mode_07 call that runs its body: an eager call
# or a capture.  A replay of the captured graph launches the same kernels
# through none of the wrappers, so their counters do not see it.
TEACHER_CALL = {"grid_sample_fast": 5, "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL,
                "fold_groupnorm_film": K6_PER_TEACHER_CALL}
BF16_MIN_PSNR = 28.0  # tests/test_mode_14_parity.py:166


def need_card() -> torch.device:
    """The card, with full-f32 products on both sides of every comparison;
    skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()
    return torch.device("cuda")


@pytest.fixture
def card():
    return need_card()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    need_card()
    return str(tmp_path_factory.mktemp("card"))


@pytest.fixture(scope="module")
def teacher_params():
    """The seeded full-width random mode_07 (its zero-init layers brought to
    life by ``random_teacher_07``)."""
    need_card()
    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07

    return random_teacher_07(torch.Generator().manual_seed(SEED + 8))


@pytest.fixture(scope="module")
def teacher_files(teacher_params, workdir):
    """The five teacher state dicts as ``.pt`` files and a 512^2 character
    PNG: (files by network key, the PNG's path)."""
    import PIL.Image

    from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image
    from tha4_tpu_torch.poser.modes import mode_07

    files = {key: os.path.join(workdir, f"{key}.pt") for key in mode_07.NETWORK_KEYS}
    for key, path in files.items():
        torch.save(teacher_params[key], path)
    png = os.path.join(workdir, "character.png")
    PIL.Image.fromarray(synthetic_character_image(512, SEED), "RGBA").save(png)
    return files, png


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0.0 else 10.0 * math.log10(4.0 / mse)  # signal range [-1, 1]


def kernel_counters() -> list:
    """The launch counters of the kernels a distillation step, a teacher
    call or a tool may take: K1, K4, K2, K3's pair, K5's pair, K6, its fold
    and Q1."""
    from tha4_tpu_torch.ops import cuda_conv, cuda_int8_conv, cuda_poly_sin, cuda_siren, cuda_warp

    return [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast,
            cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward, cuda_poly_sin.poly_sin_forward,
            cuda_poly_sin.poly_sin_backward, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film,
            cuda_int8_conv.int8_conv]


def reset(counters) -> None:
    """The launch counters, and mode_07's counts of how its calls ran."""
    from tha4_tpu_torch.poser.modes import mode_07

    for c in counters:
        c.launches = 0
    mode_07.counts.reset()


def teacher_calls() -> tuple:
    """(eager calls, captures, replays) of ``mode_07.compute_outputs``
    since the last ``reset``."""
    from tha4_tpu_torch.poser.modes import mode_07

    return mode_07.counts.eager_calls, mode_07.counts.captures, mode_07.counts.replays


def graph_calls(*calls_per_signature: int) -> tuple:
    """What ``teacher_calls`` reads after these many calls of each of a
    teacher's signatures, on the card outside an int8 scope: a signature's
    first call runs eagerly, its second captures, the rest replay."""
    return (len(calls_per_signature), sum(n >= 2 for n in calls_per_signature),
            sum(max(n - 2, 0) for n in calls_per_signature))


def dispatched(calls: tuple) -> int:
    """The calls of ``teacher_calls``'s reading that ran the body, which the
    launch counters see: the eager calls and the captures."""
    return calls[0] + calls[1]


def launches(counters) -> dict:
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters}


def run_module(args, what: str, timeout: int = 300) -> list:
    """``python -m <args>`` from the repository's root, as a user runs it;
    its stdout lines."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{what}: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout.strip().splitlines()


def puppeteer_run(args, expect: str = None) -> dict:
    """``python -m tha4_tpu_torch.apps.puppeteer --benchmark ...`` on the
    card: its benchmark line, with the frames rendered and the process's K1
    and K2 launches, which must be 4 and 1 a frame (the warm-up frame
    included); ``expect``, a line it must print."""
    lines = run_module(["tha4_tpu_torch.apps.puppeteer", *args, "--benchmark", "--device", "cuda"], "puppeteer")
    assert expect is None or any(expect in line for line in lines), lines
    line = next(l for l in lines if l.startswith("frames="))
    fields = re.search(r"frames=(\d+) rendered=(\d+) latency mean=([\d.]+)ms p50=([\d.]+)ms p99=([\d.]+)ms "
                       r"throughput=([\d.]+) fps \(pipeline depth 1\) on .*; launches K1 (\d+) K2 (\d+)$", line)
    assert fields is not None, line
    rendered, k1, k2 = int(fields[2]), int(fields[7]), int(fields[8])
    assert rendered and (k1, k2) == (4 * (rendered + 1), rendered + 1), line
    return {"rendered": rendered, "k1": k1, "k2": k2}
