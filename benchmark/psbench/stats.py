"""The arithmetic of the metrics, over every sample of the window."""

from __future__ import annotations

import bisect

import numpy as np


def percentile(values, q: float):
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks); None without values."""
    v = np.asarray(list(values), dtype=np.float64)
    return None if v.size == 0 else float(np.percentile(v, q))


def mean(values):
    v = list(values)
    return None if not v else float(sum(v) / len(v))


def in_window(times, t0: float, t1: float) -> list:
    return [t for t in times if t0 <= t <= t1]


def gaps_ms(times) -> list:
    """Gaps between consecutive arrivals, in ms."""
    return [(b - a) * 1e3 for a, b in zip(times, times[1:])]


def edit_indices(frame_cursors, edit_cursors) -> list:
    """The edit each frame was computed under: -1 for none (the scene's own
    cursor), else the earliest edit with the frame's cursor at or after the
    previous frame's edit (edits take effect in the order sent, and a cursor
    repeats only a revolution later); None for a cursor never sent."""
    where: dict = {}
    for i, c in enumerate(edit_cursors):
        where.setdefault(c, []).append(i)
    out, last = [], -1
    for c in frame_cursors:
        idx = where.get(c)
        if idx is None:
            out.append(-1 if last == -1 else None)
            continue
        k = bisect.bisect_left(idx, max(last, 0))
        if k == len(idx):
            out.append(None)
            continue
        last = idx[k]
        out.append(last)
    return out


def edit_lags(edit_times, frame_times, frame_edits) -> list:
    """For each edit: (its lag in ms, frames that arrived between its send
    and its answer), the answer being the first frame computed under it or
    under a later edit; None for an edit no frame answered."""
    best, running = [], -1
    for e in frame_edits:
        running = max(running, -1 if e is None else e)
        best.append(running)
    out = []
    for i, t_send in enumerate(edit_times):
        k = bisect.bisect_left(best, i)
        if k == len(best):
            out.append(None)
            continue
        between = bisect.bisect_right(frame_times, t_send)
        out.append(((frame_times[k] - t_send) * 1e3, max(0, k - between)))
    return out


def scene_frames(scene_times, scene_counts, frame_times, frame_counts) -> list:
    """For each scene sent: (index of its echo, index of its first stepped
    frame), the first two frames after its send that carry its live count;
    None where they never came."""
    out = []
    for t_send, count in zip(scene_times, scene_counts):
        found = [k for k in range(bisect.bisect_right(frame_times, t_send), len(frame_times))
                 if frame_counts[k] == count][:2]
        out.append(tuple(found) if len(found) == 2 else None)
    return out


def span_ms(run: dict, name: str):
    """Mean ms of the launcher's spans named ``name`` that started in the
    window (Unix ns); None without any."""
    t0, t1 = run.get("window_unix", (None, None))
    spans = (run.get("daemon") or {}).get("spans", ())
    return mean((e - s) / 1e6 for n, s, e in spans if n == name and t0 <= s <= t1)
