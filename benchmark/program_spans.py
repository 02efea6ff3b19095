"""The program's own spans in a traced run of a cell.

The port marks where it does each piece of work with
``tha4_tpu_torch.utils.profiling.span``: a ``record_function`` range named
``tha4:<name>`` while a profiler records.  ``reduce`` reads them from the
same ``torch.profiler`` trace that ``tracing.reduce_trace`` reduces, on the
thread that opened the window, and gives for each span name:

  * ``calls``, ``host_s`` (the spans' durations) and ``self_s`` (less the
    part their child spans cover);
  * ``ops``: the device operations launched inside it.  A device op belongs
    to the innermost program span of the window's thread that covers the
    start of the runtime launch with its correlation id, whichever thread
    launched it, so that the autograd engine's launches fall in
    ``distill.backward``;
  * ``device_s``: those ops' device time by ``counts.GROUPS`` group;
  * ``idle_s``: the device's idle gaps (the gaps between the merged device
    intervals that ``idle_share`` reads) that overlap the span.

It also names each idle gap by the innermost span, program or benchmark,
that the host was in at its middle (``idle_gaps``), where ``reduce_trace``
names it by the benchmark's spans alone.  The six per-layer readings of the
spans are ``readings``.

The harness does not call this module yet (``PERF.md``, Open questions).
Run a cell traced with the spans reduced:

    python3 benchmark/program_spans.py --workload <name> --seed <n> --seconds <s>

prints ``run.py``'s result line of a ``--trace 1`` run, then one line with
``program_spans`` (per unit of work) and ``readings``.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import counts  # noqa: E402
from benchmark.tracing import PREFIX as BENCH_PREFIX, TOP, WINDOW, _innermost  # noqa: E402

PREFIX = "tha4:"
# Host-side CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync,
# cuLaunchKernel, ...): the launches of device ops.  The
# profiler's CPU ops number their correlation ids apart, so the name tells
# a launch from an op whose id collides with one.
LAUNCH_PREFIX = "cu"
GROUP_SPANS = ("distill.", "mode07.")
STUDENT_SPANS = ("distill.forward", "distill.backward", "distill.adam")


class Event(NamedTuple):
    name: str
    start: int  # ns
    end: int
    kind: str  # "device", "launch", "bench" or "program"
    thread: int
    corr: int


def events(prof) -> List[Event]:
    """The trace's events that the reduction reads."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = e.is_user_annotation()
        if e.device_type() == cuda:
            if annotation:
                continue
            kind = "device"
        elif annotation:
            name = e.name()
            kind = "bench" if name.startswith(BENCH_PREFIX) else "program" if name.startswith(PREFIX) else None
        else:
            kind = "launch" if e.name().startswith(LAUNCH_PREFIX) else None
        if kind is not None:
            start = e.start_ns()
            out.append(Event(e.name(), start, start + e.duration_ns(), kind, e.start_thread_id(), e.correlation_id()))
    return out


def _overlap(intervals, gaps, gap_starts) -> int:
    """ns of ``gaps`` (sorted, disjoint) covered by ``intervals`` (merged)."""
    total = 0
    for s, e in intervals:
        i = max(0, bisect.bisect_right(gap_starts, s) - 1)
        while i < len(gaps) and gaps[i][0] < e:
            total += max(0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return total


def reduce(evs: Iterable[Event]) -> dict:
    """The program's spans in the window, as the module docstring says.
    Times in seconds, totals over the window."""
    evs = list(evs)
    window = next((e for e in evs if e.kind == "bench" and e.name == BENCH_PREFIX + WINDOW), None)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window.start, window.end
    clip = lambda e: (max(e.start, w0), min(e.end, w1))  # noqa: E731
    # By start, the outer of two spans that start together first, so that
    # the later one is the inner.
    outer_first = lambda sp: (sp[0], -sp[1])  # noqa: E731
    program = sorted(((*clip(e), e.name[len(PREFIX):]) for e in evs
                      if e.kind == "program" and e.thread == window.thread and e.end > w0 and e.start < w1), key=outer_first)
    bench = [(*clip(e), e.name[len(BENCH_PREFIX):]) for e in evs
             if e.kind == "bench" and e is not window and e.end > w0 and e.start < w1]
    launched = {e.corr: e.start for e in evs if e.kind == "launch"}
    device = [e for e in evs if e.kind == "device" and e.end > w0 and e.start < w1]

    spans: Dict[str, dict] = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0, "ops": 0,
                                                  "device_s": defaultdict(float), "idle_s": 0.0})
    stack, covered = [], defaultdict(int)  # covered: ns of each span (by index) that its children take
    for k, (s, e, name) in enumerate(program):
        while stack and program[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            covered[stack[-1]] += e - s
        stack.append(k)
    for k, (s, e, name) in enumerate(program):
        row = spans[name]
        row["calls"] += 1
        row["host_s"] += (e - s) / 1e9
        row["self_s"] += (e - s - covered[k]) / 1e9

    starts = [sp[0] for sp in program]
    outside = unmatched = 0
    for e in device:
        t = launched.get(e.corr)
        unmatched += t is None
        owner = "outside spans" if t is None else _innermost(program, starts, t)
        if owner == "outside spans":
            outside += 1
            continue
        row = spans[owner]
        row["ops"] += 1
        s, f = clip(e)
        row["device_s"][counts.group_of(e.name)] += (f - s) / 1e9

    merged = counts.merge_intervals([clip(e) for e in device])
    gaps, cursor = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if merged:
        gap_starts = [g[0] for g in gaps]
        for name in spans:
            own = counts.merge_intervals([(s, e) for s, e, n in program if n == name])
            spans[name]["idle_s"] = _overlap(own, gaps, gap_starts) / 1e9
    else:
        for row in spans.values():
            row["idle_s"] = None  # no device op: no idle time to speak of

    named = sorted(program + bench, key=outer_first)
    named_starts = [sp[0] for sp in named]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        idle[_innermost(named, named_starts, (g0 + g1) / 2)] += g1 - g0
    return {
        "spans": {name: dict(row, device_s=dict(row["device_s"])) for name, row in spans.items()},
        "device_ops": len(device),
        "ops_outside": outside,
        "ops_unmatched": unmatched,
        "idle_gaps": [[k, v / 1e9] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def table(reduced: dict, units: int) -> Dict[str, dict]:
    """Each span's numbers per unit of work (a frame or a step), in ms."""
    out = {}
    for name, row in sorted(reduced["spans"].items()):
        idle = row["idle_s"]
        out[name] = {"calls": row["calls"] / units, "host_ms": 1e3 * row["host_s"] / units,
                     "self_ms": 1e3 * row["self_s"] / units, "ops": row["ops"] / units,
                     "device_ms": {g: 1e3 * v / units for g, v in sorted(row["device_s"].items(), key=lambda kv: -kv[1])},
                     "idle_ms": None if idle is None else 1e3 * idle / units}
    return out


def readings(reduced: dict, units: int) -> Dict[str, Optional[float]]:
    """The six per-layer readings of the spans; None where a reading's
    spans, or the device ops it divides by, are absent."""
    spans = reduced["spans"]

    def per_unit_ms(names, key):
        rows = [spans[n] for n in names if n in spans]
        if not rows or not units or any(r[key] is None for r in rows):
            return None
        return 1e3 * sum(r[key] for r in rows) / units

    def us_per_op(names):
        rows = [spans[n] for n in names if n in spans]
        ops = sum(r["ops"] for r in rows)
        return 1e6 * sum(r["self_s"] for r in rows) / ops if ops else None

    group = [n for n in spans if n.startswith(GROUP_SPANS)]
    return {
        "viseme_ms.frame": per_unit_ms(["ifm.viseme_solve"], "host_s"),
        "upload_ms.frame": per_unit_ms(["mode14.upload"], "host_s"),
        "dispatch_us_per_op.frame": us_per_op(["mode14.compute"]),
        "labels_idle_ms.distill": per_unit_ms(["distill.labels"], "idle_s"),
        "student_idle_ms.distill": per_unit_ms(STUDENT_SPANS, "idle_s"),
        "dispatch_us_per_op.distill": us_per_op(group),
    }


def main(argv=None) -> int:
    """``run.py`` with ``--trace 1``, its trace also reduced by program span."""
    from benchmark import harness, run, tracing

    argv = list(sys.argv[1:] if argv is None else argv)
    captured = {}
    reduce_trace, run_cell = tracing.reduce_trace, harness.run_cell

    def both(prof):
        out = reduce_trace(prof)
        captured["reduced"] = reduce(events(prof))
        return out

    def kept(*args, **kwargs):
        captured["result"] = run_cell(*args, **kwargs)
        return captured["result"]

    tracing.reduce_trace, harness.run_cell = both, kept
    rc = run.main(argv + ["--trace", "1"])
    if rc == 0:
        units = captured["result"]["attempted"]
        reduced = captured["reduced"]
        print(json.dumps({"units": units, "device_ops": reduced["device_ops"], "ops_outside": reduced["ops_outside"],
                          "ops_unmatched": reduced["ops_unmatched"], "idle_gaps": reduced["idle_gaps"],
                          "program_spans": table(reduced, units), "readings": readings(reduced, units)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
