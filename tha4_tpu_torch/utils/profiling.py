"""Profiling and tracing on the card (counterpart of ``tha4_tpu/utils/profiling.py``).

The reference brackets teacher frames with CUDA events and the wall clock
(reference: src/tha4/app/full_manual_poser.py:388-399) and keeps a rolling
FPS meter in the puppeteers (:28-42).  Here:

  * ``fetch_barrier`` waits for the card: ``torch.cuda.synchronize`` on the
    device of the first CUDA tensor it is given (a CPU result is ready when
    the call returns);
  * ``FrameTimer`` times a frame with the host clock up to that barrier and
    keeps a rolling FPS over its window (the puppeteer's FPS meter);
  * ``span(name)`` marks where the program does one piece of work (the
    viseme solve, the pose upload, a teacher network, the student's
    backward): while a ``torch.profiler`` records, it is a
    ``record_function`` range named ``"tha4:" + name``, which the profiler
    puts on the device ops' clock beside the kernels launched inside it;
    otherwise it is one shared null context, which reads no clock;
  * ``trace`` records a ``torch.profiler`` timeline (host and card), the
    spans in it, and writes it as a Chrome trace.

A profiler that runs turns the spans on; there is no other switch.  With
none running, an enter and exit of a span costs about 1 us on one x86 core
(the flag test and the null context), where a ``record_function`` costs
about 14 us even with no profiler running.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Callable, Optional

import torch

SPAN_PREFIX = "tha4:"
_NO_SPAN = contextlib.nullcontext()


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def fetch_barrier(x) -> None:
    """Wait until the card has finished the work that produced ``x``."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class FrameTimer:
    """Per-frame ms + rolling FPS over the last ``window`` frames (the
    reference puppeteers' FPS meter, character_model_ifacialmocap_puppeteer.py:28-42).
    ``measure`` times one frame up to ``fetch_barrier``; ``tick`` marks a
    frame done where the caller has its own barrier (the puppeteer's loop)."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self.last_ms: Optional[float] = None

    def measure(self, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        fetch_barrier(out)
        self.last_ms = (time.perf_counter() - t0) * 1000.0
        self.tick()
        return out

    def tick(self) -> Optional[float]:
        """A frame is done now: the rolling FPS, None before two frames."""
        self.times.append(time.perf_counter())
        return self.fps

    @property
    def fps(self) -> Optional[float]:
        if len(self.times) < 2:
            return None
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])


def span(name: str):
    """``with span("mode14.upload"): ...``: a ``record_function`` range
    named ``"tha4:" + name`` while a ``torch.profiler`` records, else one
    shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('traces/run'): step()`` records host and card activity
    with ``torch.profiler`` and writes ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing), the program's ``tha4:`` spans included.
    Yields the profiler, whose ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
