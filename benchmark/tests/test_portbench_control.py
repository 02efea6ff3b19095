"""On the card, at each cell's own size: the control (the plain reference
in the program's place one precision below the configuration's: TF32 for
the f32 frame, float8 operands for the bf16 step) comes out not correct on
three seeds, and the program correct.
Run on an H100: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
benchmark/tests/test_portbench_control.py`` (a few minutes)."""

import time

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda

SECONDS = {"frame.live.f32": 3.0, "body_distill.bf16": 2.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_the_control_fails_and_the_program_passes(card, workload):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = harness.run_cell(workload, seed, SECONDS[workload], False, t0=time.perf_counter(), program="control")
        assert not r["correct"], (seed, r["checks"])
    r = harness.run_cell(workload, 2**31 + 104, SECONDS[workload], False, t0=time.perf_counter())
    assert r["correct"], r["checks"]
