"""The device trace of a steady sub-window and its reduction.

``DeviceTrace`` runs ``torch.profiler`` (CUDA activity only) between two
host-clock instants and keeps the device operations (kernels, copies,
fills) with their start and end in Unix nanoseconds, the profiler's clock
for device activity. ``reduce`` turns them, with the harness's host spans,
into what the per-layer metrics and the ``breakdown`` read: the busy
seconds inside the window (which runs from the trace's start to its stop on
the host clock, idle edges included), the device time by operation, the
idle gaps by what the host was doing, and each kernel's launches and mean
time.
"""

from __future__ import annotations

import re
import time

import torch

SETTLE_NS = 500_000_000


def short_name(name: str) -> str:
    """A device operation's name without ``void``, arguments and template
    parameters' types."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80] or name[:80]


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.ops: list = []

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        return profile(activities=acts)

    def warm(self) -> None:
        """One empty trace, so that the measured one does not pay the
        profiler's first start."""
        prof = self._profile()
        prof.start()
        prof.stop()

    def start(self) -> None:
        """Start tracing; the window opens ``SETTLE_NS`` later, once the
        device queue that the profiler's start drained has refilled."""
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.time_ns() + SETTLE_NS

    def stop(self) -> None:
        self.t1 = time.time_ns()
        self.prof.stop()
        from torch.autograd import DeviceType

        self.ops = [(e.start_ns(), e.end_ns(), short_name(e.name()))
                    for e in self.prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()]
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None


def reduce(ops, t0: int, t1: int, spans=()) -> dict:
    """``ops`` = [(start ns, end ns, name)] of device operations, the window
    [t0, t1] in ns, ``spans`` = [(name, start ns, end ns)] of the host.
    Returns busy_s, window_s, idle_pct, device_ops (top 10 [name, s]),
    idle_gaps (top 10 [what the host did, s]) and kernels ({name: [launches
    inside the window, mean ns]})."""
    window = max(t1 - t0, 1)
    inside = sorted((max(s, t0), min(e, t1), n) for s, e, n in ops if min(e, t1) > max(s, t0))
    busy, by_name, gaps = 0, {}, []
    cur_s = cur_e = None
    prev_name = "window start"
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s, prev_name))
            elif s > t0:
                gaps.append((t0, s, prev_name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if e >= cur_e:
            prev_name = n
    if cur_e is None:
        gaps.append((t0, t1, prev_name))
    else:
        busy += cur_e - cur_s
        if cur_e < t1:
            gaps.append((cur_e, t1, prev_name))
    idle_by = {}
    for gs, ge, after in gaps:
        host = sorted({n for n, ss, se in spans if ss < ge and se > gs}) or ["no harness span"]
        label = f"host in {'+'.join(host)}, device after {after}"
        idle_by[label] = idle_by.get(label, 0) + (ge - gs)
    kernels: dict = {}
    for s, e, n in ops:
        if s >= t0 and e <= t1:
            k = kernels.setdefault(n, [0, 0])
            k[0] += 1
            k[1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": window / 1e9,
            "idle_pct": 100.0 * (1.0 - busy / window),
            "device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in idle],
            "kernels": {n: [c, tot / c] for n, (c, tot) in kernels.items()}}


def kernel_mean_ms(reduced: dict, names: tuple[str, ...]):
    """Mean device ms of the launches of the kernels whose short names
    (``short_name``) are in ``names``, each matched whole (None when the
    trace holds none)."""
    if isinstance(names, str):
        raise TypeError("names is a tuple of whole kernel names")
    hits = [(c, c * m) for n, (c, m) in reduced.get("kernels", {}).items() if n in names]
    count = sum(c for c, _ in hits)
    return None if not count else sum(t for _, t in hits) / count / 1e6
