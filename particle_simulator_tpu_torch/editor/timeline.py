"""Frame timeline: append-only history with time-indexed lookup.

Functional equivalent of the reference editor's ``Simulation`` module
(particle_editor/src/simulation.rs): every frame received from the engine is
kept in RAM; a piecewise-constant-dt interval index maps playback time to the
nearest frame (frames are equally spaced in sim-time *within* an interval;
live dt changes open a new interval — simulation.rs:63-85). ``frame(t)``
binary-searches the intervals (simulation.rs:97-147).

This is also one of the build's checkpoint/replay mechanisms: the timeline can
be scrubbed to any frame and that frame re-sent to the engine ("Edit & Resend
current", editor.rs:1087-1095). The port's own copy of
``particle_simulator_tpu/editor/timeline.py``, on the port's ``Frame``.
"""

from __future__ import annotations

import bisect
import dataclasses

from particle_simulator_tpu_torch.io.frame import Frame


@dataclasses.dataclass
class TimeInterval:
    """A run of frames sharing one frame_dt (reference: simulation.rs:10-42)."""

    start_time: float  # sim time of the first frame in the interval
    frame_dt: float  # sim time between consecutive frames
    first_frame: int  # index into the timeline's frame list
    frame_count: int

    def end_time(self) -> float:
        return self.start_time + self.frame_dt * (self.frame_count - 1)

    def frame_at(self, t: float) -> tuple[int, float]:
        """Nearest frame index (global) + its exact time, clamped in-range."""
        if self.frame_dt <= 0.0:
            return self.first_frame, self.start_time
        i = round((t - self.start_time) / self.frame_dt)
        i = max(0, min(self.frame_count - 1, i))
        return self.first_frame + i, self.start_time + self.frame_dt * i


class Timeline:
    """Append-only frame history with a time index."""

    def __init__(self):
        self._frames: list[Frame] = []
        self._intervals: list[TimeInterval] = []
        self._starts: list[float] = []  # interval start times, for bisect
        self._ram_bytes = 0

    # -- ingest (simulation.rs:63-85) -----------------------------------------
    def push_frame(self, frame: Frame) -> None:
        dt = frame.metadata.frame_dt()
        idx = len(self._frames)
        self._frames.append(frame)
        self._ram_bytes += len(frame.bytes)

        if self._intervals and self._intervals[-1].frame_dt == dt:
            self._intervals[-1].frame_count += 1
        else:
            start = self._intervals[-1].end_time() + dt if self._intervals else 0.0
            self._intervals.append(
                TimeInterval(start_time=start, frame_dt=dt, first_frame=idx, frame_count=1)
            )
            self._starts.append(start)

    # -- lookup (simulation.rs:97-147) ----------------------------------------
    def _locate(self, t: float) -> tuple[int, float] | None:
        """(frame index, exact frame time) nearest to sim-time ``t``.

        O(log intervals) — never compares frame contents (Frame.__eq__ scans
        full particle arrays; at 1M particles that must stay off hot paths
        like the stats poll)."""
        if not self._frames:
            return None
        k = bisect.bisect_right(self._starts, t) - 1
        if k < 0:
            k = 0
        iv = self._intervals[k]
        # t may fall in the gap between iv's end and the next interval: clamp
        if t > iv.end_time() and k + 1 < len(self._intervals):
            nxt = self._intervals[k + 1]
            if abs(t - nxt.start_time) < abs(t - iv.end_time()):
                iv = nxt
        return iv.frame_at(t)

    def frame(self, t: float) -> tuple[Frame, float] | None:
        """Nearest frame to sim-time ``t`` and that frame's exact time."""
        got = self._locate(t)
        if got is None:
            return None
        idx, exact = got
        return self._frames[idx], exact

    def frame_index_at(self, t: float) -> int | None:
        got = self._locate(t)
        return None if got is None else got[0]

    def at(self, t: float) -> tuple[Frame, float, int] | None:
        """(frame, exact frame time, frame index) nearest to sim-time ``t``
        from ONE locate — the stats poll needs all three per request."""
        got = self._locate(t)
        if got is None:
            return None
        idx, exact = got
        return self._frames[idx], exact, idx

    def last_frame(self) -> Frame | None:
        return self._frames[-1] if self._frames else None

    def frame_at_index(self, i: int) -> Frame:
        return self._frames[i]

    # -- stats / maintenance ----------------------------------------------------
    @property
    def frame_count(self) -> int:
        return len(self._frames)

    def sim_len(self) -> float:
        """Total simulated time spanned by the timeline (simulation.rs)."""
        return self._intervals[-1].end_time() if self._intervals else 0.0

    @property
    def timeline_ram(self) -> int:
        """Bytes of frame data held (the editor's Timeline RAM gauge,
        editor.rs:1291-1302)."""
        return self._ram_bytes

    def clear(self) -> None:
        self._frames.clear()
        self._intervals.clear()
        self._starts.clear()
        self._ram_bytes = 0
