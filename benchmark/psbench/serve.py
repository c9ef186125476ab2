"""The ``serve`` runner: the harness plays the editor of a live scene.

The daemon runs in a process of its own (``benchmark/daemon_child.py``),
connected over 127.0.0.1 to a port the OS picks. The harness sends the
configuration's scene, drains every frame, and drives the mix:

- ``edits_hz`` > 0: a metadata-only edit at that rate, the cursor circling
  the box centre at ``cursor_radius`` of the box side, one revolution every
  ``cursor_period_s``, from a phase drawn from the seed (a cursor drag);
- ``resend_dwell_s``: a fresh seeded draw of the scene, a few particles
  fewer each time, sent that long after the previous scene's first stepped
  frame arrived ("send lattice", "Edit & Resend").

``correct`` compares what the daemon shipped with the reference that the
configuration names (``benchmark/references/<name>.py``, which draws the
scenes and knows their data layout): the echo of every checked scene and
its first stepped frame, computed from the scene the harness sent; and,
where the mix drags, the frame that follows each of the program's states
copied at seed-drawn instants of the window (the snapshot, itself compared
with its own shipped frame), computed from that state. Every comparison is
``refsim.mismatches`` of the shipped particles' 20 bytes, limit 0.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np

from psbench import cells, refsim, stats, wire

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_FRAME_TIMEOUT_S = 900.0  # the first run in a checkout builds the kernels
ANSWER_WAIT_S = 60.0


def _recv_exact(sock, view) -> bool:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], len(view) - got)
        if n == 0:
            return False
        got += n
    return True


class Link:
    """The editor's end of the link: a listening socket, the accepted
    connection, and a thread that drains every frame. Each frame's arrival
    (``time.perf_counter``), particle count and cursor are kept; the bytes
    of the first two frames of each run of one count (a scene's echo and
    its first stepped frame) and of the frames the snapshots name."""

    def __init__(self):
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(1)
        self.port = self.server.getsockname()[1]
        self.sock = None
        self.frames: list = []  # (arrival, count, cursor)
        self.kept: dict = {}
        # the newest frames, so a snapshot's report that reaches the harness
        # some frames after its frame still finds that frame and the one before
        self.recent: deque = deque(maxlen=16)
        self.snap_want: dict = {}  # k -> (cursor, requested at)
        self.snap_found: dict = {}  # k -> (index of the copied state's frame, of the next)
        self.cond = threading.Condition()
        self.thread = None

    def accept(self, timeout: float, child) -> None:
        self.server.settimeout(1.0)
        deadline = time.monotonic() + timeout
        while self.sock is None:
            try:
                self.sock, _ = self.server.accept()
            except socket.timeout:
                if child.poll() is not None or time.monotonic() > deadline:
                    raise RuntimeError("the daemon never connected") from None
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.thread = threading.Thread(target=self._receive, daemon=True)
        self.thread.start()

    def send(self, packet: bytes) -> float:
        t = time.perf_counter()
        self.sock.sendall(packet)
        return t

    def _receive(self) -> None:
        hdr = bytearray(wire.HEADER_SIZE)
        try:
            while _recv_exact(self.sock, memoryview(hdr)):
                count, meta = wire.decode_header(hdr)
                packet = bytearray(wire.HEADER_SIZE + wire.PARTICLE_SIZE * count)
                packet[:wire.HEADER_SIZE] = hdr
                if not _recv_exact(self.sock, memoryview(packet)[wire.HEADER_SIZE:]):
                    break
                t = time.perf_counter()
                cursor = (float(meta["cursor_pos"][0]), float(meta["cursor_pos"][1]))
                with self.cond:
                    idx = len(self.frames)
                    run = idx < 2 or self.frames[-1][1] != count or self.frames[-2][1] != count
                    self.frames.append((t, count, cursor))
                    if run:
                        self.kept[idx] = packet
                    self.recent.append((idx, packet))
                    self._match()
                    self.cond.notify_all()
        except OSError:
            pass
        with self.cond:
            self.cond.notify_all()

    def _match(self) -> None:
        """Find, for each snapshot, the first frame under its cursor that
        arrived after it was asked for, and keep that frame and the one
        before it (the copied state's own)."""
        for k, (cursor, t_req) in list(self.snap_want.items()):
            for idx, packet in self.recent:
                t, _, c = self.frames[idx]
                if c == cursor and t >= t_req and idx > 0:
                    prev = dict(self.recent).get(idx - 1)
                    if prev is None:
                        break
                    self.kept[idx - 1], self.kept[idx] = prev, packet
                    self.snap_found[k] = (idx - 1, idx)
                    del self.snap_want[k]
                    break

    def want_snapshot(self, k: int, cursor, t_req: float) -> None:
        with self.cond:
            self.snap_want[k] = (tuple(cursor), t_req)
            self._match()

    def wait(self, pred, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: pred(self.frames), timeout)

    def close(self) -> None:
        for s in (self.sock, self.server):
            if s is None:
                continue
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self.thread is not None:
            self.thread.join(timeout=30)


def _first_stepped(count: int, after: float):
    """A predicate: the second frame of ``count`` particles after ``after``
    has arrived (the first is the echo)."""
    def pred(frames):
        return sum(1 for t, c, _ in frames if t > after and c == count) >= 2
    return pred


def _cursor(traffic: dict, phase0: float, i: int) -> tuple:
    """Edit ``i``'s cursor: on the circle, its radius shrinking by
    ``cursor_shrink_per_s`` of itself a second, so that no cursor repeats
    and every frame names the edit it was computed under."""
    hz = traffic["edits_hz"]
    angle = phase0 + 2.0 * math.pi * i / (hz * traffic["cursor_period_s"])
    r = traffic["cursor_radius"] * (1.0 - traffic["cursor_shrink_per_s"] * i / hz)
    return (float(np.float32(0.5 + r * math.cos(angle))),
            float(np.float32(0.5 + r * math.sin(angle))))


def scene_packet(ref, cfg: dict, seed: int, k: int) -> tuple:
    """(packet, particles, metadata) of the ``k``-th scene of a run, drawn
    by the reference ``ref``: after the first, a few particles fewer each
    time, so that each scene's frames are told apart by their count."""
    drop = 0 if k == 0 else 1 + 3 * k + int(np.random.default_rng([seed, k, 7]).integers(3))
    parts, meta = ref.draw(cfg, seed, k, drop)
    return wire.encode(meta, parts), parts, meta


def _edit(meta: np.ndarray, cursor, size: float) -> np.ndarray:
    out = meta.copy()
    out["cursor_pos"] = cursor
    out["cursor_size"] = size
    return out


class Child:
    """The daemon's process: its standard input (commands, under a lock)
    and a thread that reads its reports; a snapshot's report names the
    cursor of the frame that follows the copied state, which the link then
    looks for among the frames that arrive after the request."""

    def __init__(self, link: Link, ctx: dict):
        env = dict(os.environ)
        env.pop("PS_EXT_IO", None)  # the daemon's default unless the mix names one
        env.update({k: str(v) for k, v in ctx["traffic"].get("env", {}).items()})
        self.log = open(os.path.join(ctx["workdir"], "daemon.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "daemon_child.py"), "--addr",
             f"127.0.0.1:{link.port}", "--out", ctx["workdir"], "--device", ctx["device"],
             "--trace", str(ctx["trace"])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True, env=env,
            cwd=os.path.dirname(HERE))
        self.link = link
        self.lock = threading.Lock()
        self.snap_req: list = []
        self.reports: list = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                rep = json.loads(line)
            except ValueError:
                continue
            self.reports.append(rep)
            if "snap" in rep:
                self.link.want_snapshot(rep["snap"], rep["cursor"], self.snap_req[rep["snap"]])

    def tell(self, cmd: str) -> None:
        with self.lock:
            if cmd == "snap":
                self.snap_req.append(time.perf_counter())
            self.proc.stdin.write(cmd + "\n")
            self.proc.stdin.flush()

    def tell_at(self, marks) -> None:
        """Send each (perf_counter instant, command) at its instant, from a
        thread of its own."""
        def run():
            for t, cmd in sorted(marks):
                time.sleep(max(0.0, t - time.perf_counter()))
                self.tell(cmd)
        threading.Thread(target=run, daemon=True).start()

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        self.log.close()


def _trace_marks(ctx: dict, t0: float) -> list:
    if not ctx["trace"]:
        return []
    trace_s = float(ctx["traffic"].get("trace_s", 3.0))
    mid = t0 + max(0.0, (ctx["seconds"] - trace_s) / 2)
    return [(mid, "trace_start"), (mid + trace_s, "trace_stop")]


def run(ctx: dict) -> dict:
    """Run one serve cell; returns the record the metric readers and the
    checks read."""
    cfg, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    ref = cells.reference(cfg, ctx["root"])
    rng = np.random.default_rng([seed, 1])
    steps = int(cfg["steps_per_frame"])
    link = Link()
    child = Child(link, ctx)
    scenes_sent: list = []  # (send time, count, particles, metadata)
    edits: list = []  # (send time, cursor)
    try:
        link.accept(300.0, child.proc)

        def draw(k: int) -> tuple:
            return scene_packet(ref, cfg, seed, k)

        def send_scene(scene) -> float:
            packet, parts, meta = scene
            t = link.send(packet)
            scenes_sent.append((t, len(parts), parts, meta))
            return t

        t_send = send_scene(draw(0))
        if not link.wait(_first_stepped(scenes_sent[0][1], t_send), FIRST_FRAME_TIMEOUT_S):
            raise RuntimeError("the first scene's first stepped frame never came")
        if ctx["trace"]:
            # the profiler's first start takes seconds: keep it out of the window
            child.tell("trace_warm")
            deadline = time.monotonic() + 300.0
            while not any("warm" in r for r in child.reports):
                if time.monotonic() > deadline or child.proc.poll() is not None:
                    raise RuntimeError("the daemon's profiler never warmed")
                time.sleep(0.05)
        if traffic.get("edits_hz"):
            t0, t1 = _drag(link, child, ctx, scenes_sent[0][3], rng, edits)
        else:
            t0, t1 = _resend(link, child, ctx, draw, send_scene, scenes_sent)
        t0_unix = time.time_ns() - int((time.perf_counter() - t0) * 1e9)
        t1_unix = t0_unix + int((t1 - t0) * 1e9)
        n_snaps = len(child.snap_req)
        link.wait(lambda f: len(link.snap_found) >= n_snaps, ANSWER_WAIT_S)
    finally:
        link.close()
        child.stop()
    if child.proc.returncode != 0:
        tail = open(os.path.join(ctx["workdir"], "daemon.log")).read()[-3000:]
        raise RuntimeError(f"the daemon exited {child.proc.returncode}:\n{tail}")
    with open(os.path.join(ctx["workdir"], "daemon.json")) as f:
        daemon = json.load(f)
    record = _record(ctx, ref, link, daemon, scenes_sent, edits, child.snap_req, (t0, t1),
                     (t0_unix, t1_unix), steps)
    with open(os.path.join(ctx["workdir"], "daemon.log")) as f:
        record["log_tail"] = [ln for ln in f.read().splitlines()
                              if ln.startswith(("daemon:", "engine: scene", "engine: ship",
                                                "Traceback", "  File"))][-40:]
    return record


def _drag(link, child, ctx, meta0, rng, edits):
    traffic, seconds = ctx["traffic"], ctx["seconds"]
    hz = float(traffic["edits_hz"])
    phase0 = float(rng.uniform(0.0, 2.0 * math.pi))
    start = time.perf_counter()
    t0 = start + float(traffic.get("warmup_s", 2.0))
    t1 = t0 + seconds
    snaps = sorted(rng.uniform(t0 + 0.2 * seconds, t0 + 0.8 * seconds,
                               size=int(traffic.get("snapshots", 2))))
    child.tell_at(_trace_marks(ctx, t0))
    i = 0
    while True:
        due = start + i / hz
        if due >= t1:
            break
        while snaps and snaps[0] <= due:
            snaps.pop(0)
            child.tell("snap")
        time.sleep(max(0.0, due - time.perf_counter()))
        cursor = _cursor(traffic, phase0, i)
        edits.append((link.send(wire.encode(_edit(meta0, cursor, traffic["cursor_size"]))),
                      cursor))
        i += 1
    cursors = [c for _, c in edits]
    last = len(edits) - 1
    link.wait(lambda f: last in stats.edit_indices([c for _, _, c in f], cursors),
              ANSWER_WAIT_S)
    return t0, t1


def _resend(link, child, ctx, draw_scene, send_scene, scenes_sent):
    traffic, seconds = ctx["traffic"], ctx["seconds"]
    dwell = float(traffic["resend_dwell_s"])

    def dwell_after_last() -> float:
        """Wait for the last scene's first stepped frame, then the dwell;
        return the instant the dwell ends."""
        t_prev, count = scenes_sent[-1][0], scenes_sent[-1][1]
        if not link.wait(_first_stepped(count, t_prev), ANSWER_WAIT_S):
            raise RuntimeError(f"scene {len(scenes_sent) - 1}'s first stepped frame never came")
        with link.cond:
            first = [t for t, c, _ in link.frames if t > t_prev and c == count][1]
        time.sleep(max(0.0, first + dwell - time.perf_counter()))
        return first + dwell

    # every scene is drawn and encoded in set-up, so the harness does no
    # host work of its own while the daemon loads one
    warm = int(traffic.get("warmup_resends", 1))
    drawn = [draw_scene(k) for k in range(1, 1 + warm + int(traffic["scenes_drawn"]))]

    def scene(k):
        return drawn[k - 1] if k <= len(drawn) else draw_scene(k)

    k = 1
    for _ in range(warm):
        dwell_after_last()
        send_scene(scene(k))
        k += 1
    dwell_after_last()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    child.tell_at(_trace_marks(ctx, t0))
    while True:
        send_scene(scene(k))
        k += 1
        if dwell_after_last() >= t1:
            break
    return t0, t1


def _record(ctx, ref, link, daemon, scenes_sent, edits, snap_req, window, window_unix, steps):
    import torch

    t0, t1 = window
    dev = ctx["device"]
    frames = link.frames
    times = [t for t, _, _ in frames]
    record = {"window_s": t1 - t0, "window": window, "window_unix": window_unix,
              "frame_times": stats.in_window(times, t0, t1), "steps": steps, "daemon": daemon,
              "memory_peak": daemon.get("memory_peak"), "trace": daemon.get("trace") or None}
    checks = []
    # the start: the first scene's echo and first stepped frame
    pairs_of = stats.scene_frames([s[0] for s in scenes_sent], [s[1] for s in scenes_sent],
                                  times, [c for _, c, _ in frames])
    in_win = [i for i, s in enumerate(scenes_sent) if t0 <= s[0] <= t1]
    checked = [0]
    if in_win:
        pick = np.random.default_rng([ctx["seed"], 2]).choice(
            in_win, size=min(len(in_win), int(ctx["traffic"].get("checked_scenes", 2))),
            replace=False)
        checked += sorted(int(i) for i in pick)
    bad_echo = bad_first = 0
    for i in checked:
        found = pairs_of[i]
        if found is None:
            bad_echo += 1
            continue
        parts, meta = scenes_sent[i][2], scenes_sent[i][3]
        lay = ref.loaded(parts, meta, dev)
        bad_echo += refsim.mismatches(ref.pack(lay), wire.particles(link.kept[found[0]]))
        nxt = ref.frame(lay, meta, steps, dev)
        bad_first += refsim.mismatches(ref.pack(nxt), wire.particles(link.kept[found[1]]))
        del lay, nxt
    checks += [("scene_echo_mismatch", bad_echo, 0), ("first_frame_mismatch", bad_first, 0)]
    if in_win or len(scenes_sent) > 1:
        sw = [pairs_of[i] for i in in_win]
        record["switch_ms"] = [(times[p[1]] - scenes_sent[i][0]) * 1e3
                               for i, p in zip(in_win, sw) if p is not None]
        record["attempted"], record["failed"] = len(in_win), sum(p is None for p in sw)
    if edits:
        cursors = [c for _, c in edits]
        frame_edits = stats.edit_indices([c for _, _, c in frames], cursors)
        lags = stats.edit_lags([t for t, _ in edits], times, frame_edits)
        win = [i for i, (t, _) in enumerate(edits) if t0 <= t <= t1]
        record["edit_lag_ms"] = [lags[i][0] for i in win if lags[i] is not None]
        record["edit_lag_frames"] = [lags[i][1] for i in win if lags[i] is not None]
        record["attempted"], record["failed"] = len(win), sum(lags[i] is None for i in win)
        first_edit = next((k for k, e in enumerate(frame_edits) if e is not None and e >= 0),
                          len(frames))
        unknown = sum(e is None for e in frame_edits[first_edit:])
        checks.append(("frames_under_unsent_cursor", unknown, 0))
        bad_pack = bad_next = missing = 0
        for k in range(len(snap_req)):
            path = os.path.join(ctx["workdir"], f"snap{k}.npz")
            if k not in link.snap_found or not os.path.exists(path):
                missing += 1
                continue
            with np.load(path) as z:
                snap = {n: z[n] for n in z.files}
            lay = ref.from_snapshot(snap, scenes_sent[0][2], scenes_sent[0][3], dev)
            if lay is None:
                missing += 1
                continue
            before, after = link.snap_found[k]
            bad_pack += refsim.mismatches(ref.pack(lay), wire.particles(link.kept[before]))
            meta = _edit(scenes_sent[0][3], tuple(float(v) for v in snap["cursor"]),
                         ctx["traffic"]["cursor_size"])
            nxt = ref.frame(lay, meta, steps, dev)
            bad_next += refsim.mismatches(ref.pack(nxt), wire.particles(link.kept[after]))
            if k == 0:
                least = ref.least(lay)
                if least is not None:
                    record["step_least"] = least
            del lay, nxt
        checks += [("snapshot_missing", missing, 0), ("snapshot_readback_mismatch", bad_pack, 0),
                   ("snapshot_next_frame_mismatch", bad_next, 0)]
    unanswered = record.get("failed", 0)
    checks.append(("requests_unanswered", unanswered, 0))
    record["checks"] = checks
    if dev == "cuda":
        torch.cuda.empty_cache()
    return record
