"""Spans around the calls into each layer, and the reduction of a
``torch.profiler`` trace of the measured window.

A span's durations are kept by name on the host clock.  In a traced run
each span is also a ``record_function`` range, so that the profiler puts
it on the device ops' clock: the idle gaps of the device are then named by
the span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark import counts

PREFIX = "bench:"
WINDOW = "window"
TOP = 10


class Recorder:
    def __init__(self, trace: bool):
        self.trace = bool(trace)
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._prof = None
        self._window = None
        self.reduced: Optional[dict] = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.trace:
            import torch

            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def start_window(self) -> None:
        """Start the profiler (traced runs) and open the window's span."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            import torch

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        self._window = self.span(WINDOW)
        self._window.__enter__()

    def end_window(self) -> None:
        """Close the window's span (the caller has synchronised) and reduce
        the trace."""
        self._window.__exit__(None, None, None)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.reduced = reduce_trace(self._prof)
            self._prof = None


def _events(prof):
    """(name, start_ns, end_ns, on_device, is_annotation) of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield e.name(), start, start + e.duration_ns(), e.device_type() == cuda, e.is_user_annotation()


def _innermost(spans, starts, t) -> str:
    """The span that covers t and started last (spans on one thread nest;
    a parent lies within a few entries of its open child)."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - 64)
    while i > stop:
        if spans[i][1] > t:
            return spans[i][2]
        i -= 1
    return "outside spans"


def reduce_trace(prof) -> dict:
    """Busy time, op count and time by kernel group inside the window, and
    the idle gaps by the innermost span the host was in."""
    device, spans = [], []
    window = None
    for name, start, end, on_device, annotation in _events(prof):
        if on_device:
            if not annotation:
                device.append((start, end, name))
        elif annotation and name.startswith(PREFIX):
            if name == PREFIX + WINDOW:
                window = (start, end)
            else:
                spans.append((start, end, name[len(PREFIX):]))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    merged = counts.merge_intervals([(s, e) for s, e, _ in inside])
    busy_ns = sum(e - s for s, e in merged)
    group_ns: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        group_ns[counts.group_of(n)] += e - s
    gaps, cursor = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    spans.sort()
    starts = [sp[0] for sp in spans]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        idle[_innermost(spans, starts, (g0 + g1) / 2)] += g1 - g0
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": len(inside),
        "group_s": {k: v / 1e9 for k, v in group_ns.items()},
        "breakdown": {"device_ops": top(group_ns), "idle_gaps": top(idle)},
    }
