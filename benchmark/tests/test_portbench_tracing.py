"""The reduction of the program's spans (``benchmark/program_spans.py``)
against hand counts on a hand-built trace, the trace's existing keys left
as they were, and narrow CPU traced runs of both cells."""

import bisect
from collections import defaultdict

import pytest

from benchmark import counts, program_spans, tracing
from benchmark.tests import narrow

MAIN, AUTOGRAD = 1, 2


class FakeEvent:
    """The methods of a kineto event that the reductions call."""

    def __init__(self, name, start, end, kind, thread=MAIN, corr=0):
        self._name, self._start, self._dur, self._kind, self._thread, self._corr = name, start, end - start, kind, thread, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._kind in ("kernel", "gpu_user_annotation") else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr


class FakeProf:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda _self: list(evs)})()})()


def _span(name, s, e, thread=MAIN):
    return FakeEvent(name, s, e, "user_annotation", thread)


def _launch(corr, t, thread=MAIN):
    return FakeEvent("cudaLaunchKernel", t, t + 2, "cuda_runtime", thread, corr)


def _kernel(name, corr, s, e):
    return FakeEvent(name, s, e, "kernel", corr=corr)


# One step in a window of 0..1000 ns (a step's bench span "group" over
# 100..900).  Program spans on the main thread: labels 100..400 holding
# mode07.decomposer 150..250 and mode07.upscaler 300..380; forward 400..600;
# backward 600..800, whose launches come from the autograd thread; adam
# 800..850.  A program span on the autograd thread (ignored: not the
# window's thread) and a CPU op whose correlation id collides with a launch.
PROGRAM = [
    _span("tha4:distill.labels", 100, 400), _span("tha4:mode07.decomposer", 150, 250),
    _span("tha4:mode07.upscaler", 300, 380), _span("tha4:distill.forward", 400, 600),
    _span("tha4:distill.backward", 600, 800), _span("tha4:distill.adam", 800, 850),
    _span("tha4:distill.labels", 610, 700, thread=AUTOGRAD),
]
OTHER = [
    _span("bench:window", 0, 1000), _span("bench:group", 100, 900),
    FakeEvent("aten::conv2d", 160, 170, "cpu_op", corr=3),
    _launch(1, 160), _kernel("affine_silu_conv3_kernel", 1, 170, 260),  # decomposer
    _launch(2, 200), _kernel("elementwise_kernel", 2, 260, 280),  # decomposer
    _launch(3, 260), _kernel("vectorized_copy", 3, 300, 310),  # labels' own glue, between the networks
    _launch(4, 320), _kernel("implicit_convolve", 4, 320, 420),  # upscaler
    _launch(5, 450), _kernel("poly_sin_fwd", 5, 460, 500),  # forward
    _launch(6, 650, thread=AUTOGRAD), _kernel("gemm_kernel", 6, 650, 700),  # backward, from the autograd thread
    _launch(7, 820), _kernel("multi_tensor_apply_kernel", 7, 820, 830),  # adam
    _launch(8, 950), _kernel("vectorized_copy", 8, 960, 980),  # outside the program's spans
    FakeEvent("gpu annotation", 100, 400, "gpu_user_annotation"),
]
# Merged device intervals: 170-280, 300-310, 320-420, 460-500, 650-700,
# 820-830, 960-980; gaps in the window: 0-170, 280-300, 310-320, 420-460,
# 500-650, 700-820, 830-960, 980-1000.
HAND = {
    "distill.labels": dict(calls=1, host=300, self=300 - 100 - 80, ops=1, idle=(170 - 100) + 20 + 10,
                           device={"elementwise, copies": 10}),
    "mode07.decomposer": dict(calls=1, host=100, self=100, ops=2, idle=20,
                              device={"K6 affine_silu_conv3": 90, "elementwise, copies": 20}),
    "mode07.upscaler": dict(calls=1, host=80, self=80, ops=1, idle=10, device={"convolution (cuDNN)": 100}),
    "distill.forward": dict(calls=1, host=200, self=200, ops=1, idle=40 + 100, device={"K5 poly_sin": 40}),
    "distill.backward": dict(calls=1, host=200, self=200, ops=1, idle=50 + 100, device={"GEMM (cuBLAS)": 50}),
    "distill.adam": dict(calls=1, host=50, self=50, ops=1, idle=20 + 20, device={"other": 10}),
}


def _parent_reduce_trace(prof) -> dict:
    """``tracing.reduce_trace`` as the first benchmark wrote it, frozen: the
    keys that the existing metrics read must not move."""
    device, spans, window = [], [], None
    for name, start, end, on_device, annotation in tracing._events(prof):
        if on_device:
            if not annotation:
                device.append((start, end, name))
        elif annotation and name.startswith("bench:"):
            if name == "bench:window":
                window = (start, end)
            else:
                spans.append((start, end, name[len("bench:"):]))
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    merged = counts.merge_intervals([(s, e) for s, e, _ in inside])
    group_ns = defaultdict(float)
    for s, e, n in inside:
        group_ns[counts.group_of(n)] += e - s
    gaps, cursor = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    spans.sort()
    starts = [sp[0] for sp in spans]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        stop = max(-1, i - 64)
        while i > stop:
            if spans[i][1] > t:
                return spans[i][2]
            i -= 1
        return "outside spans"

    idle = defaultdict(float)
    for g0, g1 in gaps:
        idle[innermost((g0 + g1) / 2)] += g1 - g0
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in merged) / 1e9, "device_ops": len(inside),
            "group_s": {k: v / 1e9 for k, v in group_ns.items()},
            "breakdown": {"device_ops": top(group_ns), "idle_gaps": top(idle)}}


def test_program_spans_by_hand():
    r = program_spans.reduce(program_spans.events(FakeProf(PROGRAM + OTHER)))
    assert sorted(r["spans"]) == sorted(HAND)
    for name, want in HAND.items():
        got = r["spans"][name]
        assert got["calls"] == want["calls"], name
        assert got["host_s"] == pytest.approx(want["host"] / 1e9), name
        assert got["self_s"] == pytest.approx(want["self"] / 1e9), name
        assert got["ops"] == want["ops"], name
        assert got["idle_s"] == pytest.approx(want["idle"] / 1e9), name
        assert got["device_s"] == pytest.approx({g: v / 1e9 for g, v in want["device"].items()}), name
    assert (r["device_ops"], r["ops_outside"], r["ops_unmatched"]) == (8, 1, 0)
    # Gaps named by the innermost span, program or benchmark, at their
    # middle: 0-170 and 980-1000 outside, 830-960 in group, the rest in
    # program spans.
    assert dict(r["idle_gaps"]) == pytest.approx({
        "outside spans": 190e-9, "distill.forward": 190e-9, "group": 130e-9, "distill.backward": 120e-9,
        "distill.labels": 20e-9, "mode07.upscaler": 10e-9,
    })


def test_readings_by_hand():
    r = program_spans.reduce(program_spans.events(FakeProf(PROGRAM + OTHER)))
    got = program_spans.readings(r, units=1)
    assert got["labels_idle_ms.distill"] == pytest.approx(1e-6 * 100)  # the networks' idle lies inside the labels' own
    assert got["student_idle_ms.distill"] == pytest.approx(1e-6 * (140 + 150 + 40))
    assert got["dispatch_us_per_op.distill"] == pytest.approx(1e-3 * (120 + 100 + 80 + 200 + 200 + 50) / 7)
    assert got["viseme_ms.frame"] is None and got["upload_ms.frame"] is None and got["dispatch_us_per_op.frame"] is None


def test_existing_keys_stay_the_parents():
    """The program's spans move none of ``reduce_trace``'s keys: the trace
    with them reads as the trace without them, and as the parent's
    function reads either."""
    with_spans = tracing.reduce_trace(FakeProf(PROGRAM + OTHER))
    without = tracing.reduce_trace(FakeProf(OTHER))
    assert with_spans == without == _parent_reduce_trace(FakeProf(PROGRAM + OTHER))
    assert with_spans["breakdown"]["idle_gaps"] == [["group", pytest.approx(470e-9)], ["outside spans", pytest.approx(190e-9)]]


@pytest.mark.parametrize("workload", ["frame.live.f32", "body_distill.bf16"])
def test_narrow_traced_runs_read_the_spans(workload, monkeypatch):
    """A narrow traced run on the CPU: the program's spans are in its trace;
    the host readings are there, and the readings that need a device op are
    None."""
    captured = {}
    reduce_trace = tracing.reduce_trace

    def both(prof):
        captured["reduced"] = program_spans.reduce(program_spans.events(prof))
        return reduce_trace(prof)

    monkeypatch.setattr(tracing, "reduce_trace", both)
    result = narrow.run(workload, trace=True, seconds=0.5)
    assert result["correct"], result["checks"]
    reduced, units = captured["reduced"], result["attempted"]
    got = program_spans.readings(reduced, units)
    spans = program_spans.table(reduced, units)
    assert reduced["device_ops"] == 0 and units >= 1
    if workload.startswith("frame."):
        assert {"ifm.viseme_solve", "mode14.upload", "mode14.compute"} <= set(spans)
        assert spans["mode14.compute"]["calls"] == 1.0
        assert got["viseme_ms.frame"] > 0.0 and got["upload_ms.frame"] > 0.0
        assert got["dispatch_us_per_op.frame"] is None
    else:
        assert set(spans) == {"distill.labels", "distill.forward", "distill.backward", "distill.adam",
                              "mode07.decomposer", "mode07.combiner", "mode07.face_morpher", "mode07.body_morpher",
                              "mode07.upscaler"}
        assert spans["distill.labels"]["calls"] == 1.0 and spans["distill.adam"]["calls"] == 2.0
        assert all(got[k] is None for k in ("labels_idle_ms.distill", "student_idle_ms.distill", "dispatch_us_per_op.distill"))
