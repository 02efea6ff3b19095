"""A run with the timed path broken underneath comes out not correct: the
look for a chip skipped, the rest of a run driven on the CPU at narrow
widths, once for each fault that the cell can have (``benchmark/faults``;
one chip: no exchange between chips to leave out)."""

import pytest

from benchmark import faults
from benchmark.tests import narrow


def test_sound_runs_are_correct():
    assert narrow.run("frame.live.f32")["correct"]
    assert narrow.run("body_distill.bf16")["correct"]


@pytest.mark.parametrize("workload, fault, check", [
    ("frame.live.f32", "frame_altered", "body"),
    ("frame.live.f32", "pose_altered", "pose"),
    ("body_distill.bf16", "unchanged", "change"),
    ("body_distill.bf16", "half_batch", None),
    ("body_distill.bf16", "grad_altered", "grad"),
])
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault, check):
    with faults.FAULTS[fault]():
        r = narrow.run(workload)
    assert not r["correct"]
    if check is not None:
        assert r["checks"][check]["value"] > r["checks"][check]["limit"]
