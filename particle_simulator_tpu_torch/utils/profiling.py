"""Profiling: the program's span recorder, its trace and the card's line.

Counterpart of ``particle_simulator_tpu/utils/profiling.py``:

- ``annotate(name, frame=None)``: a span of the program (nests). It records
  only while recording is on: inside ``trace`` and inside ``recording()``.
  Off, the default, it returns one shared no-op context: it reads no clock,
  allocates nothing and opens no profiler or NVTX range. On, it keeps the
  span in memory as ``(name, start ns, end ns, thread name, frame id,
  parent span name)`` on ``time.time_ns()``'s Unix clock, the clock of
  ``torch.profiler``'s (kineto's) host and device events, and opens an
  NVTX range of the same name on a CUDA build and, while a profiler runs, a
  ``torch.profiler.record_function`` range. The parent is the innermost span open on the same
  thread; a span given no frame id takes its parent's;
- ``count(name, n=1)``: a counter, kept while recording is on;
- ``export()``: ``{"clock": "unix_ns", "spans": [[name, start, end, thread,
  frame, parent], ...], "counters": {...}, "dropped": n}``, where
  ``dropped`` counts the oldest spans the bounded buffer let go;
- ``trace(dir)``: a ``torch.profiler`` trace (CPU activity and, on a CUDA
  build with a card, the card's kernels and copies) of the enclosed region,
  written into ``dir`` as a Chrome trace (viewable in Perfetto or
  ``chrome://tracing``), with recording on;
- ``card_line()``: the card's name and power limit as ``nvidia-smi``
  gives them, the line every script prints beside the numbers it measures.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from collections import deque

# torch is imported where a span opens or a trace starts, never here: the
# wire transport counts through this module, and the editor, which shares
# the transport, runs on numpy alone
SPAN_CAPACITY = 1 << 18  # ~50 MB of spans; a served frame keeps ~10


class Recorder:
    """The spans and counters of one process while recording is on."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.depth = 0  # open recording() / trace() blocks; on while > 0
        self.spans: deque = deque(maxlen=capacity)
        self.counters: dict = {}
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the thread's open spans

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, span: tuple) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def export(self) -> dict:
        with self.lock:
            return {"clock": "unix_ns", "spans": [list(s) for s in self.spans],
                    "counters": dict(self.counters), "dropped": self.dropped}


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "frame", "parent", "t0", "rf", "nvtx")

    def __init__(self, name: str, frame):
        self.name = name
        self.frame = frame

    def __enter__(self):
        stack = RECORDER.stack()
        self.parent = stack[-1] if stack else None
        if self.frame is None and self.parent is not None:
            self.frame = self.parent.frame
        stack.append(self)
        import torch

        # the clock is read outside the ranges, so a span encloses its own
        # profiler event
        self.t0 = time.time_ns()
        # torch.cuda.nvtx needs a CUDA build
        self.nvtx = torch.cuda.nvtx if torch.cuda.is_available() else None
        if self.nvtx is not None:
            self.nvtx.range_push(self.name)
        # a range only a running profiler can see: opening one costs ~15 us
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        finally:
            if self.nvtx is not None:
                self.nvtx.range_pop()
            t1 = time.time_ns()
            RECORDER.stack().pop()
            RECORDER.keep((self.name, self.t0, t1, threading.current_thread().name, self.frame,
                           None if self.parent is None else self.parent.name))
        return False


def annotate(name: str, frame: int | None = None):
    """A span named ``name`` of frame ``frame`` around the enclosed region;
    a shared no-op context while recording is off."""
    if not RECORDER.depth:
        return _OFF
    return _Span(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if RECORDER.depth:
        RECORDER.count(name, n)


def export() -> dict:
    """The spans and counters recorded so far (see the module's docstring)."""
    return RECORDER.export()


@contextlib.contextmanager
def recording():
    """Recording on inside the block (blocks nest)."""
    with RECORDER.lock:
        RECORDER.depth += 1
    try:
        yield
    finally:
        with RECORDER.lock:
            RECORDER.depth -= 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (created if missing) as ``trace_<pid>_<ns>.json``, with
    recording on; yields the profiler, whose ``events()`` are complete once
    the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording():
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the card's work in flight belongs to the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def card_line() -> str:
    """The first card's ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line. A card set below its maximum power runs
    slower under load, so a measured number is kept with this line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
