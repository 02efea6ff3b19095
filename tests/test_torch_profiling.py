"""The port's profiling utilities (``tha4_tpu_torch.utils.profiling``) on the
CPU: the frame timer's window and barrier, the trace file, and
``device_timeit`` refusing to time without a card."""

import json
import os

import pytest
import torch

from tha4_tpu_torch.utils import profiling


def test_frame_timer_keeps_a_rolling_window():
    timer = profiling.FrameTimer(window=3)
    assert timer.fps is None
    for k in range(5):
        out = timer.measure(lambda x: [x * 2.0, {"y": x}], torch.full((4,), float(k)))
        assert timer.last_ms is not None and timer.last_ms >= 0.0
    assert torch.equal(out[0], torch.full((4,), 8.0))
    assert len(timer.times) == 3 and timer.fps > 0.0


def test_frame_timer_ticks_as_the_puppeteers_fps_meter():
    timer = profiling.FrameTimer(window=3)
    assert timer.tick() is None
    rates = [timer.tick() for _ in range(4)]
    assert all(r > 0.0 for r in rates) and rates[-1] == timer.fps
    assert len(timer.times) == 3 and timer.last_ms is None


def test_fetch_barrier_takes_any_nesting_of_cpu_results():
    profiling.fetch_barrier([{"a": (torch.ones(2),)}])
    profiling.fetch_barrier({"none": None})
    profiling.fetch_barrier(3.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(os.path.join(tmp_path, "trace", "trace.json")).read())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None


def test_device_timeit_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_timeit(lambda: None)
