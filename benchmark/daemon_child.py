"""The engine daemon as users run it, in a process of its own, with the
benchmark's spans around the calls into the simulator.

    python benchmark/daemon_child.py --addr 127.0.0.1:PORT --out DIR [--trace 1]

It runs ``particle_simulator_tpu_torch.engine.daemon.serve`` (``PS_EXT_IO``
as the environment gives it) against the harness, which plays the editor,
and stops when the harness closes the connection. Lines on standard input
steer it, each acted on at the next frame the daemon dispatches:

- ``snap``: copy the state the next frame under a new cursor steps from
  (the program's own state, for the check that follows it one frame);
- ``trace_warm``, ``trace_start``, ``trace_stop``: the device trace.

With ``--trace 1`` it keeps a span (name, start, end in Unix ns) of every
``Simulator.read_frame`` and ``Simulator.load_frame`` call. When the daemon
stops, it writes ``DIR/daemon.json`` (spans, the trace's reduction, the
device's memory peak, the foreign modules it found) and ``DIR/snap<k>.npz``:
the live slots' fields, their ``index`` in the flat state and the
Simulator's ``data_structure``, whatever the layout; of a bucket grid also
its ``grid`` (bx_log2, by_log2, cap) and each slot's ``bucket`` and
``slot``. It exits 3 if it found a module of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from psbench import faults, nojax, trace  # noqa: E402


class Control:
    """What the harness asked for, read from standard input by a thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.snap = 0
        self.trace = []

    def listen(self) -> None:
        for line in sys.stdin:
            cmd = line.strip()
            with self.lock:
                if cmd == "snap":
                    self.snap += 1
                elif cmd.startswith("trace_"):
                    self.trace.append(cmd)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()

    from particle_simulator_tpu_torch.engine import daemon
    from particle_simulator_tpu_torch.engine.simulator import Simulator

    faults.apply()
    control = Control()
    threading.Thread(target=control.listen, daemon=True).start()
    spans: list = []
    snaps: list = []
    tracer = trace.DeviceTrace()
    reduced: dict = {}
    last_cursor = [None]
    load, read, dispatch = Simulator.load_frame, Simulator.read_frame, Simulator.frame_async

    def spanned(name, fn):
        def run(self, *a, **k):
            t0 = time.time_ns()
            try:
                return fn(self, *a, **k)
            finally:
                spans.append((name, t0, time.time_ns()))
        return run

    def frame_async(self):
        cursor = tuple(float(v) for v in self.meta_record["cursor_pos"])
        with control.lock:
            cmds, control.trace = control.trace, []
            take = control.snap > len(snaps) and cursor != last_cursor[0] and self.state is not None
            if take:
                snaps.append({"cursor": cursor, "grid": tuple(self.grid)[:3],
                              "data_structure": int(self.data_structure),
                              "state": tuple(a.clone() for a in self.state)})
        for cmd in cmds:
            t = time.perf_counter()
            if cmd == "trace_warm":
                tracer.warm()
                print(json.dumps({"warm": True}), flush=True)
            elif cmd == "trace_start" and not tracer.active:
                tracer.start()
            elif cmd == "trace_stop" and tracer.active:
                tracer.stop()
            print(f"daemon: {cmd} took {time.perf_counter() - t:.3f} s", file=sys.stderr)
        if take:
            print(json.dumps({"snap": len(snaps) - 1, "cursor": cursor}), flush=True)
        last_cursor[0] = cursor
        return dispatch(self)

    if args.trace:
        Simulator.load_frame = spanned("load_frame", load)
        Simulator.read_frame = spanned("read_frame", read)
    Simulator.frame_async = frame_async

    host, port = args.addr.rsplit(":", 1)
    if args.device == "cpu":
        torch.set_num_threads(2)  # the plain versions beside the harness, on a shared host
    sim = Simulator(device=args.device)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    shipped = daemon.serve((host, int(port)), sim, retry_s=60.0)
    if tracer.active:
        tracer.stop()
    if tracer.t1 is not None:
        reduced.update(trace.reduce(tracer.ops, tracer.t0, tracer.t1, spans))
    peak = torch.cuda.max_memory_allocated() if args.device == "cuda" else None
    for k, snap in enumerate(snaps):
        fields = [a.cpu().numpy() for a in snap["state"]]
        live = np.flatnonzero(fields[4].reshape(-1) >= 0)
        arrays = {name: a.reshape(-1)[live] for name, a in zip(("x", "y", "vx", "vy", "ty"),
                                                              fields)}
        if fields[0].ndim == 3:  # a (BY, BX, CAP) bucket grid
            cap = snap["grid"][2]
            arrays.update(grid=np.array(snap["grid"]), bucket=live // cap, slot=live % cap)
        np.savez(os.path.join(args.out, f"snap{k}.npz"),
                 cursor=np.array(snap["cursor"], np.float32),
                 data_structure=np.array(snap["data_structure"]), index=live, **arrays)
    foreign = nojax.foreign_modules()
    with open(os.path.join(args.out, "daemon.json"), "w") as f:
        json.dump({"shipped": shipped, "spans": spans, "trace": reduced, "memory_peak": peak,
                   "snaps": len(snaps), "foreign_modules": foreign}, f)
    if foreign:
        print(f"daemon: foreign modules {foreign}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
