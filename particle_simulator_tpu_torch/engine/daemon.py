"""The engine daemon: the TCP main loop speaking the editor protocol.

Counterpart of ``particle_simulator_tpu/engine/daemon.py`` in one process:

1. connect to the editor's TCP server as a client,
2. wait until a frame with particles arrives,
3. then loop: enqueue the next frame's kernels, poll the editor
   (metadata-only = live reconfigure, non-empty = scene reset + echo), and
   ship an earlier frame, so the device computes frame k+1 while the host
   reads back and sends frame k.

The wire codec and transport are the port's own copy (``io/``) of the frozen
wire format, so the unchanged editor connects as before. ``--devices N``
shards the bucket grid over N CUDA devices of this host
(``parallel/domain.py``).

Run:  python -m particle_simulator_tpu_torch.engine.daemon [--addr HOST:PORT]
"""

from __future__ import annotations

import argparse
import queue as queue_mod
import sys
import threading
import time
from collections import deque

import torch

from particle_simulator_tpu_torch.io.frame import Frame
from particle_simulator_tpu_torch.io.transport import (
    Disconnected,
    Reader,
    Writer,
    new_tcp_client,
)
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.parallel.domain import make_mesh
from particle_simulator_tpu_torch.utils.profiling import StepMeter


class Frontend:
    """Connection glue: newest-wins reads, compacted writes, an optional
    tee of every outbound frame to a file (replayable with
    ``particle_simulator_tpu.editor.headless --replay``)."""

    def __init__(self, reader: Reader, writer: Writer, verbose: bool = True,
                 record: Writer | None = None):
        self.reader = reader
        self.writer = writer
        self.is_connected = True
        self.verbose = verbose
        self.record = record

    @staticmethod
    def connect_tcp(addr, retry_s: float = 0.0, native: bool = False) -> "Frontend":
        """``native=True`` routes the transport through the C++ particle_io
        library (``io/native.py``)."""
        if native:
            from particle_simulator_tpu_torch.io.native import new_tcp_client_native as connect
        else:
            connect = new_tcp_client
        deadline = time.monotonic() + retry_s
        while True:
            try:
                reader, writer = connect(addr)
                return Frontend(reader, writer)
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    @staticmethod
    def open_files(in_path: str, out_path: str) -> "Frontend":
        """File-pair transport alternative."""
        return Frontend(Reader.open_file(in_path), Writer.open_file(out_path))

    def read(self) -> Frame | None:
        """Newest pending editor frame, or None."""
        if not self.is_connected:
            return None
        try:
            frame = self.reader.read_last()
        except Disconnected:
            self.is_connected = False
            return None
        if frame is not None and self.verbose:
            print(frame.print(), file=sys.stderr)
        return frame

    def write(self, frame: Frame) -> None:
        if not self.is_connected:
            return
        if self.record is not None:
            self.record.write(frame)
        if not self.writer.write(frame):
            self.is_connected = False


def main_loop(frontend: Frontend, sim: Simulator, max_frames: int | None = None,
              readback_depth: int = 1, ship_thread: bool = True) -> int:
    """The compute-frame loop. Returns the number of frames shipped.

    ``readback_depth`` pipelines the readback: each iteration starts the
    readback of the frame just enqueued, enqueues the next frame, and ships
    the ticket started ``readback_depth`` iterations ago (0 = ship frame k
    while k+1 computes). A scene reset flushes the queue first, so frame
    order on the wire never changes.

    ``ship_thread`` moves shipping onto two single-consumer FIFO workers
    (readback wait -> wire pack + TCP send), so a send overlaps the next
    readback and the next frames' compute. The wire byte stream is
    identical to inline shipping."""
    meter = StepMeter()
    pending: deque = deque()  # tickets awaiting shipment, oldest first
    shipped = 0  # frames written to the wire (owned by the send stage)
    next_report = time.monotonic() + 30.0

    def ship_readback(ticket, meta):
        """Stage 1: wait out the device->host copy; None when the budget is
        already spent (the authoritative gate is in ship_send)."""
        if max_frames is not None and shipped >= max_frames:
            return None
        return sim.read_frame(ticket, meta=meta)

    def ship_send(frame) -> None:
        """Stage 2: wire pack + TCP send + accounting; sole writer of
        ``shipped``."""
        nonlocal shipped, next_report
        if frame is None or (max_frames is not None and shipped >= max_frames):
            return
        frontend.write(frame)
        shipped += 1
        meter.tick(frame.metadata.steps_per_frame, frame.particle_count)
        # every 64 frames, but at least every 30 s
        if shipped % 64 == 0 or time.monotonic() >= next_report:
            print(f"engine: {meter.report()} [{sim.active_kernel}]", file=sys.stderr)
            next_report = time.monotonic() + 30.0

    # two single-consumer FIFO stages keep the wire order; bounded queues
    # keep backpressure (each pending ticket pins device and host buffers)
    ship_q: queue_mod.Queue | None = None
    workers: list = []
    if ship_thread:
        ship_q = queue_mod.Queue(maxsize=max(2, readback_depth + 1))
        send_q: queue_mod.Queue = queue_mod.Queue(maxsize=2)

        def _readback_loop() -> None:
            # after a failure keep consuming (dropping) so the main loop's
            # bounded put never deadlocks; it exits via is_connected
            failed = False
            while True:
                item = ship_q.get()
                if item is None:
                    send_q.put(None)  # propagate shutdown in order
                    return
                if failed:
                    continue
                try:
                    frame = ship_readback(*item)
                    if frame is not None:  # None on send_q means shutdown
                        send_q.put(frame)
                except Exception as e:  # surface, then stop shipping
                    print(f"engine: ship readback failed: {e!r}", file=sys.stderr)
                    frontend.is_connected = False
                    failed = True

        def _send_loop() -> None:
            failed = False
            while True:
                frame = send_q.get()
                if frame is None:
                    return
                if failed:
                    continue
                try:
                    ship_send(frame)
                except Exception as e:  # surface, then stop shipping
                    print(f"engine: ship send failed: {e!r}", file=sys.stderr)
                    frontend.is_connected = False
                    failed = True

        workers = [
            threading.Thread(target=_readback_loop, daemon=True, name="ship-rb"),
            threading.Thread(target=_send_loop, daemon=True, name="ship-tx"),
        ]
        for w in workers:
            w.start()

    def commit_ship(ticket, meta) -> None:
        if ship_q is not None:
            ship_q.put((ticket, meta))
        else:
            ship_send(ship_readback(ticket, meta))

    def ship_now() -> None:
        """Ship the current state (prime / scene-reset echo), with the
        metadata snapshot taken now."""
        commit_ship(sim.start_readback(), sim.meta_record.copy())

    def can_ship() -> bool:
        # gate on the wire count, not the commit count: the workers run the
        # wire behind the main loop by the queue depth
        return max_frames is None or shipped < max_frames

    def flush() -> None:
        while pending and can_ship():
            commit_ship(*pending.popleft())

    try:
        # prime: echo the loaded scene and enqueue its first frame
        ship_now()
        sim.frame_async()
        # the metadata each in-flight frame was computed under
        dispatched_meta = sim.meta_record.copy()

        while frontend.is_connected and can_ship():
            # start the readback of the frame just enqueued BEFORE enqueueing
            # the next one, so its pack runs right behind it on the stream
            prev_ticket = sim.start_readback()
            prev_meta = dispatched_meta
            sim.frame_async()
            dispatched_meta = sim.meta_record.copy()

            incoming = frontend.read()
            if incoming is not None:
                if incoming.particle_count == 0:
                    sim.update_metadata(incoming)  # applies to the next dispatch
                else:
                    flush()  # ship pending pre-reset frames in order
                    sim.load_frame(incoming)
                    # echo the loaded scene before its first step
                    if can_ship():
                        ship_now()
                    sim.frame_async()
                    dispatched_meta = sim.meta_record.copy()
                    continue

            pending.append((prev_ticket, prev_meta))
            if len(pending) > readback_depth:
                commit_ship(*pending.popleft())
        while pending and frontend.is_connected and can_ship():
            commit_ship(*pending.popleft())
    finally:
        if ship_q is not None:
            ship_q.put(None)
            for w in workers:
                w.join()
    return shipped


def _wait_for_scene(frontend: Frontend, sim: Simulator) -> bool:
    """Block until the first non-empty frame arrives and load it."""
    while frontend.is_connected:
        frame = frontend.read()
        if frame is not None and frame.particle_count > 0:
            sim.load_frame(frame)
            return True
        time.sleep(0.001)
    return False


def serve(addr=("127.0.0.1", 53123), sim: Simulator | None = None, max_frames=None,
          retry_s: float = 10.0, record: str | None = None, native_io: bool = False,
          readback_depth: int = 1, ship_thread: bool = True) -> int:
    """Connect to the editor at ``addr``, wait for a scene, and serve frames
    with ``sim`` (default: a new CUDA ``Simulator``) until the editor
    disconnects or ``max_frames`` have shipped. Returns the number of frames
    shipped."""
    sim = Simulator() if sim is None else sim
    frontend = Frontend.connect_tcp(addr, retry_s=retry_s, native=native_io)
    print(f"engine: connected to editor at {addr}", file=sys.stderr)
    try:
        if record:
            frontend.record = Writer.open_file(record)
            print(f"engine: recording outbound frames to {record}", file=sys.stderr)
        if not _wait_for_scene(frontend, sim):
            print("engine: editor disconnected before first scene", file=sys.stderr)
            return 0
        shipped = main_loop(frontend, sim, max_frames=max_frames,
                            readback_depth=readback_depth, ship_thread=ship_thread)
    finally:
        if frontend.record is not None:
            frontend.record.close()
    print(f"engine: disconnected after {shipped} frames", file=sys.stderr)
    return shipped


def make_simulator(devices: str | None = None) -> Simulator:
    """A CUDA ``Simulator``, sharded over a mesh of ``devices`` CUDA devices
    (a count, or ``"all"``) when that is more than one. Raises when fewer
    devices exist than asked for: a mesh never shrinks to fit."""
    if devices == "all":
        n = torch.cuda.device_count()
    else:
        n = 1 if devices is None else int(devices)
    if n > 1:
        mesh = make_mesh(n_devices=n)
        print(f"engine: sharding over a {mesh.shape} device mesh", file=sys.stderr)
        return Simulator(mesh=mesh)
    return Simulator()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--addr", default="127.0.0.1:53123", help="editor TCP address")
    ap.add_argument("--files", default=None,
                    help="DIR: use DIR/backend_in.bin + DIR/backend_out.bin instead of TCP")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--retry-s", type=float, default=10.0,
                    help="keep retrying the connection this long")
    ap.add_argument("--record", default=None,
                    help="tee every outbound frame to this file (replayable "
                         "with particle_simulator_tpu.editor.headless --replay)")
    ap.add_argument("--readback-pipeline", type=int, default=1,
                    help="frames of device->host readback pipelining (0 = "
                         "ship frame k while frame k+1 computes)")
    ap.add_argument("--ship-thread", default=True, action=argparse.BooleanOptionalAction,
                    help="ship frames (readback wait + pack + TCP send) from "
                         "worker threads; the wire stream is identical")
    ap.add_argument("--native-io", action="store_true",
                    help="use the C++ particle_io transport (native/) instead "
                         "of the Python codec for the editor connection")
    ap.add_argument("--devices", default=None,
                    help="shard the bucket grid over this many CUDA devices "
                         "('all' = every visible one; default: one device); "
                         "fails when fewer exist")
    args = ap.parse_args(argv)
    sim = make_simulator(args.devices)

    if args.files:
        frontend = Frontend.open_files(f"{args.files}/backend_in.bin",
                                       f"{args.files}/backend_out.bin")
        if not _wait_for_scene(frontend, sim):
            return 1
        return 0 if main_loop(frontend, sim, args.max_frames,
                              readback_depth=args.readback_pipeline,
                              ship_thread=args.ship_thread) else 1

    host, port = args.addr.rsplit(":", 1)
    serve((host, int(port)), sim, max_frames=args.max_frames, retry_s=args.retry_s,
          record=args.record, native_io=args.native_io,
          readback_depth=args.readback_pipeline, ship_thread=args.ship_thread)
    return 0


if __name__ == "__main__":
    sys.exit(main())
