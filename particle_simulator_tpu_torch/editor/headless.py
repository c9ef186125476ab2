"""Headless editor session: the editor's main loop without a window.

The reference editor is a winit/wgpu GUI (particle_editor/src/main.rs); on a
compute host there is no display, so this CLI runs the same loop headlessly:
serve TCP for the engine, send a lattice scene, ingest frames into the
timeline, optionally render PNGs of the playback, print stats. The port's own
copy of ``particle_simulator_tpu/editor/headless.py``: the same flags and the
same JSON stats line on standard output; on exit it also names, on standard
error, any module of ``jax`` or of the JAX package it imported (none).

Run (engine in another process):
    python -m particle_simulator_tpu_torch.editor.headless --frames 10 --render out/
    python -m particle_simulator_tpu_torch.engine.daemon --addr 127.0.0.1:53123
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from particle_simulator_tpu_torch.editor.backend import Backend
from particle_simulator_tpu_torch.editor.core import Editor
from particle_simulator_tpu_torch.editor.render import render_frame, write_png
from particle_simulator_tpu_torch.utils.log import report_foreign_modules


def main(argv=None) -> int:
    try:
        return _main(argv)
    finally:
        report_foreign_modules("editor")


def _main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--addr", default="0.0.0.0:53123", help="TCP listen address")
    ap.add_argument("--frames", type=int, default=10, help="frames to collect before exit")
    ap.add_argument("--lattice", default="50x50", help="initial lattice NxM (empty = none)")
    ap.add_argument("--distance-factor", type=float, default=1.1)
    ap.add_argument("--velocity", type=float, default=0.0)
    ap.add_argument("--steps-per-frame", type=int, default=None)
    ap.add_argument("--step-dt", type=float, default=None)
    ap.add_argument("--render", default=None, help="directory to write frame PNGs")
    ap.add_argument("--size", type=int, default=512, help="render resolution")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--replay", default=None,
                    help="replay a recorded frame stream file (no TCP, no engine) "
                         "— the checkpoint/replay path (reference backend files, "
                         "backend.rs:70-105)")
    args = ap.parse_args(argv)

    if args.replay:
        from particle_simulator_tpu_torch.io.transport import Disconnected, Reader

        editor = Editor(Backend(tcp=False))
        reader = Reader.open_file(args.replay)
        while True:
            try:
                frame = reader.read()
            except Disconnected:
                break
            if frame is None:
                time.sleep(0.001)
                continue
            editor.timeline.push_frame(frame)
        if args.render and editor.timeline.frame_count:
            os.makedirs(args.render, exist_ok=True)
            for i in range(editor.timeline.frame_count):
                img = render_frame(editor.timeline.frame_at_index(i), args.size, args.size)
                write_png(os.path.join(args.render, f"frame_{i:05d}.png"), img)
        editor.seek_live()
        print(json.dumps(editor.stats()))
        return 0

    host, port = args.addr.rsplit(":", 1)
    backend = Backend(addr=(host, int(port)))
    editor = Editor(backend)
    print(f"editor: {backend.tcp_server_status()}", file=sys.stderr)

    if args.steps_per_frame:
        editor.sim_params["steps_per_frame"] = args.steps_per_frame
    if args.step_dt:
        editor.sim_params["step_dt"] = args.step_dt

    sent_scene = False
    t_last = time.monotonic()
    deadline = t_last + args.timeout
    while editor.frames_received < args.frames and time.monotonic() < deadline:
        if not sent_scene and backend.is_connected:
            if args.lattice:
                nx, ny = (int(v) for v in args.lattice.split("x"))
                # grow the box when the lattice wouldn't fit at ~60% span
                # (u32 positions wrap outside the box — a too-small box
                # aliases the scene into overflowing buckets)
                from particle_simulator_tpu_torch.io.frame import FrameMetadata

                r0 = FrameMetadata(editor.sim_params).species(0).force0_r()
                span = max(nx, ny) * r0 * args.distance_factor
                need = span / 0.6
                if need > float(editor.sim_params["box_width"]):
                    editor.sim_params["box_width"] = need
                    editor.sim_params["box_height"] = need
                editor.send_lattice(
                    nx, ny,
                    distance_factor=args.distance_factor,
                    velocity=(0.0, args.velocity),
                    rng=np.random.default_rng(0),
                )
                print(f"editor: sent {nx}x{ny} lattice", file=sys.stderr)
            sent_scene = True
        now = time.monotonic()
        editor.tick(now - t_last)
        t_last = now
        time.sleep(0.002)

    stats = editor.stats()
    if args.render and editor.timeline.frame_count:
        os.makedirs(args.render, exist_ok=True)
        for i in range(editor.timeline.frame_count):
            img = render_frame(editor.timeline.frame_at_index(i), args.size, args.size)
            write_png(os.path.join(args.render, f"frame_{i:05d}.png"), img)
        print(f"editor: wrote {editor.timeline.frame_count} PNGs to {args.render}", file=sys.stderr)

    print(json.dumps(stats))
    backend.close()
    return 0 if editor.frames_received >= args.frames else 1


if __name__ == "__main__":
    sys.exit(main())
