"""The engine daemon: the TCP main loop speaking the editor protocol.

Counterpart of ``particle_simulator_tpu/engine/daemon.py``:

1. connect to the editor's TCP server as a client,
2. wait until a frame with particles arrives,
3. then loop: enqueue the next frame's kernels, poll the editor
   (metadata-only = live reconfigure, non-empty = scene reset + echo), and
   ship an earlier frame, so the device computes frame k+1 while the host
   reads back and sends frame k.

The wire codec and transport are the port's own copy (``io/``) of the frozen
wire format, so the unchanged editor connects as before. ``--devices N``
shards the bucket grid over N CUDA devices of this host
(``parallel/domain.py``). ``--torch-device cpu`` runs the plain versions on
the CPU instead of the card.

Several processes (``parallel/multihost.py``; one invocation of
``scripts/torch_launch_multihost.sh`` each): ``main`` joins the process group
the ``PS_TPU_*`` variables describe before anything else, ``--devices`` then
counts the shards of the global mesh (a multiple of the world size; ``all``
is one a process), only process 0 connects to the editor, and a
``DistributedFrontend`` broadcasts what it reads, so every process loads,
steps and reads back in the same order. Each process prints a ``rank
stats`` JSON line when it stops. Every run ends with an ``engine: foreign
modules [...]`` line on stderr (``utils/log.py:report_foreign_modules``).

``--spans PATH`` records the program's spans and counters while it serves
and writes them at exit as JSON (``utils/profiling.py:export``). One
frame's spans share its id (``Simulator.frame_id``): on the main thread
``sim.frame_async``, ``sim.start_readback``, ``daemon.poll`` (the editor
poll; its id is the next frame's, the first to answer what it read) and
``daemon.commit`` (the hand-over to the ship queue, which blocks while it
is full); on ``ship-rb`` ``sim.read_frame`` with ``readback.wait`` and
``readback.unpack``; on ``ship-tx`` ``daemon.send`` (wire pack and TCP
send). ``sim.load_frame`` (``load.grid_pick``, ``load.bucketize``,
``load.upload``) and ``sim.update_metadata`` mark scene loads and live
edits; the counters ``poll.superseded``, ``readback.redo`` and
``frame.live_tiles`` count the editor frames a poll dropped for a newer
one, the widened readbacks and the frames sent to the live-tile step;
``frame.allpairs`` and ``allpairs.swept_pairs`` the frames sent to the
all-pairs step and the pair evaluations they sweep; ``readback.records``
the bucket-grid frames read back through the record pack.

Run:  python -m particle_simulator_tpu_torch.engine.daemon [--addr HOST:PORT]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import queue as queue_mod
import sys
import threading
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from particle_simulator_tpu_torch.io.frame import Frame
from particle_simulator_tpu_torch.io.transport import (
    Disconnected,
    Reader,
    Writer,
    new_tcp_client,
)
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda
from particle_simulator_tpu_torch.parallel import domain, multihost
from particle_simulator_tpu_torch.parallel.domain import make_mesh
from particle_simulator_tpu_torch.utils import profiling
from particle_simulator_tpu_torch.utils.log import report_foreign_modules


class Frontend:
    """Connection glue: newest-wins reads, compacted writes, an optional
    tee of every outbound frame to a file (replayable with
    ``particle_simulator_tpu_torch.editor.headless --replay``)."""

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


class DistributedFrontend:
    """The editor link of a multi-process run. Every process must make the
    same calls in the same order (each frame, readback and ``live_count`` is
    a collective), but only process 0 holds the editor connection. So each
    poll, process 0 reads the editor and broadcasts a (code, length) header,
    then the frame bytes when there is a frame; every process then loads,
    reconfigures and steps alike from the same bytes. Writes are real on
    process 0 only, which also keeps each write's time (``write_times``); a
    failed write or a disconnect reaches the others as a CLOSED header on
    the next poll, so all leave their loops together. The broadcasts run
    over a gloo group of their own, so control bytes never touch a card,
    whatever the ring's backend. Constructing one is a collective."""

    _NONE, _FRAME, _CLOSED = 0, 1, 2

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self.is_proc0 = multihost.is_frame_owner()
        self.inner: Frontend | None = None  # the editor link, process 0's
        self.is_connected = True
        self.write_times: list[float] = []

    def _header(self, code: int, length: int) -> tuple[int, int]:
        hdr = torch.tensor([code, length], dtype=torch.int64)
        dist.broadcast(hdr, 0, group=self.group)
        return int(hdr[0]), int(hdr[1])

    def broadcast_abort(self) -> None:
        """One CLOSED header: releases the other processes, waiting in
        ``read``, when process 0 cannot reach the editor."""
        self._header(self._CLOSED, 0)

    def read(self) -> Frame | None:
        frame, code, payload = None, self._NONE, b""
        if self.is_proc0:
            frame = self.inner.read()
            # a frame read in the poll that saw the disconnect is still
            # delivered; CLOSED goes out on the next poll
            if frame is not None:
                code, payload = self._FRAME, frame.bytes
            elif not self.inner.is_connected:
                code = self._CLOSED
        code, length = self._header(code, len(payload))
        if code == self._CLOSED:
            self.is_connected = False
            return None
        if code == self._NONE:
            return None
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if self.is_proc0
               else torch.empty(length, dtype=torch.uint8))
        dist.broadcast(buf, 0, group=self.group)
        return frame if self.is_proc0 else Frame.from_bytes(buf.numpy().tobytes())

    def write(self, frame: Frame) -> None:
        if self.is_proc0:
            self.inner.write(frame)  # a failure surfaces through the next read()
            self.write_times.append(time.perf_counter())


def rate_report(total_steps: int, steps: int, particle_steps: int, seconds: float) -> dict:
    """The daemon's periodic ``engine: {...}`` line: the steps and
    particle-steps of the frames shipped since the last report, over the
    seconds since it, and the steps of every frame shipped."""
    seconds = max(seconds, 1e-9)
    return {"steps_per_sec": round(steps / seconds, 2),
            "particle_steps_per_sec": round(particle_steps / seconds, 1),
            "total_steps": total_steps}


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
    identical to inline shipping. A ``DistributedFrontend`` turns it off, as
    the JAX engine does: every process must issue its collectives in one
    order, and a worker's failure would end process 0's loop alone; the
    other processes count the empty frames their readback gives, so all
    leave the loop at the same iteration."""
    if isinstance(frontend, DistributedFrontend):
        ship_thread = False
    pending: deque = deque()  # tickets awaiting shipment, oldest first
    shipped = 0  # frames written to the wire (owned by the send stage)
    # the send stage's counts: every shipped frame's steps, and the steps
    # and particle-steps since the last report
    total_steps = steps = particle_steps = 0
    last_report = time.monotonic()

    def ship_readback(ticket, meta):
        """Stage 1: wait out the device->host copy; None when the budget is
        already spent (the authoritative gate is in ship_send)."""
        if max_frames is not None and shipped >= max_frames:
            return None
        return sim.read_frame(ticket, meta=meta)

    def ship_send(frame, frame_id) -> None:
        """Stage 2: wire pack + TCP send + accounting; sole writer of
        ``shipped``."""
        nonlocal shipped, total_steps, steps, particle_steps, last_report
        if frame is None or (max_frames is not None and shipped >= max_frames):
            return
        with profiling.annotate("daemon.send", frame_id):
            frontend.write(frame)
        shipped += 1
        n = frame.metadata.steps_per_frame
        total_steps += n
        steps += n
        particle_steps += n * frame.particle_count
        now = time.monotonic()
        # every 64 frames, but at least every 30 s
        if shipped % 64 == 0 or now >= last_report + 30.0:
            rates = rate_report(total_steps, steps, particle_steps, now - last_report)
            print(f"engine: {rates} [{sim.active_kernel}]", file=sys.stderr)
            last_report, steps, particle_steps = now, 0, 0

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
                        send_q.put((frame, item[0].frame))
                except Exception as e:  # surface, then stop shipping
                    print(f"engine: ship readback failed: {e!r}", file=sys.stderr)
                    frontend.is_connected = False
                    failed = True

        def _send_loop() -> None:
            failed = False
            while True:
                item = send_q.get()
                if item is None:
                    return
                if failed:
                    continue
                try:
                    ship_send(*item)
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
        with profiling.annotate("daemon.commit", ticket.frame):
            if ship_q is not None:
                ship_q.put((ticket, meta))
            else:
                ship_send(ship_readback(ticket, meta), ticket.frame)

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

            with profiling.annotate("daemon.poll", sim.frame_id + 1):
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
    """Block until the first non-empty frame arrives and load it (polling
    every 10 ms when each poll is a broadcast)."""
    pause = 0.01 if isinstance(frontend, DistributedFrontend) else 0.001
    while frontend.is_connected:
        frame = frontend.read()
        if frame is not None and frame.particle_count > 0:
            sim.load_frame(frame)
            return True
        time.sleep(pause)
    return False


def rank_stats(sim: Simulator, frontend: DistributedFrontend, shipped: int) -> dict:
    """What one process of a multi-process run did: its kernels' launches,
    its cross-process ring traffic a step, its backend and device, and, on
    process 0, the period between its wire writes after the echo and the
    first frame."""
    ex = dict(domain.EXCHANGE)
    steps = max(1, ex["steps"])
    dev = multihost.process_device(sim.device.type)
    periods = np.diff(frontend.write_times[2:]) * 1e3
    return {"rank": multihost.process_index(), "world": multihost.process_count(),
            "backend": dist.get_backend(), "host_staged": domain.host_staged(dev),
            "device": str(dev), "mesh": None if sim.mesh is None else list(sim.mesh.shape),
            "grid": list(sim.grid.grid_shape),
            "shipped": shipped, "launches": {**bucket_cuda.LAUNCHES, **allpairs_cuda.LAUNCHES},
            "exchange": {**ex, "bytes_per_step": ex["bytes"] / steps,
                         "host_ms_per_step": ex["seconds"] * 1e3 / steps,
                         "stage_ms_per_step": ex["stage_s"] * 1e3 / steps,
                         "comm_ms_per_step": ex["comm_s"] * 1e3 / steps},
            "frame_period_ms": None if not len(periods) else {
                "median": float(np.median(periods)), "p90": float(np.percentile(periods, 90)),
                "all": [round(float(v), 3) for v in periods]},
            "foreign_modules": multihost.foreign_modules()}


def load_hook(spec: str):
    """``MODULE:FUNCTION`` (``--inspect``) -> the function."""
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def _inspect(hook, label: str, sim: Simulator) -> None:
    if hook is not None:
        print("engine: inspect " + json.dumps(hook(label, sim)), file=sys.stderr, flush=True)


def serve(addr=("127.0.0.1", 53123), sim: Simulator | None = None, max_frames=None,
          retry_s: float = 10.0, record: str | None = None, native_io: bool = False,
          readback_depth: int = 1, ship_thread: bool = True, inspect=None) -> int:
    """Connect to the editor at ``addr``, wait for a scene, and serve frames
    with ``sim`` (default: a new CUDA ``Simulator``) until the editor
    disconnects or ``max_frames`` have shipped. Returns the number of frames
    shipped. Over several processes every process calls it; only process 0
    connects (and records), and when it cannot, it releases the others with
    a CLOSED broadcast before it raises. ``inspect(label, sim)``, when
    given, is called with the first scene as loaded and after the last
    frame (on every process at the same point), and what it returns is
    logged as an ``engine: inspect`` JSON line."""
    sim = Simulator() if sim is None else sim
    multiproc = multihost.process_count() > 1
    # the control group forms on every process before process 0 connects,
    # so that a failed connect can still reach the others
    dfront = DistributedFrontend() if multiproc else None
    link = None
    if dfront is None or dfront.is_proc0:
        try:
            link = Frontend.connect_tcp(addr, retry_s=retry_s, native=native_io)
        except OSError:
            if dfront is not None:
                dfront.broadcast_abort()
            raise
        print(f"engine: connected to editor at {addr}", file=sys.stderr)
    frontend = link
    if dfront is not None:
        dfront.inner = link
        frontend = dfront
    shipped = 0
    try:
        if record and link is not None:
            link.record = Writer.open_file(record)
            print(f"engine: recording outbound frames to {record}", file=sys.stderr)
        if not _wait_for_scene(frontend, sim):
            print("engine: editor disconnected before first scene", file=sys.stderr)
            return 0
        _inspect(inspect, "as loaded", sim)
        shipped = main_loop(frontend, sim, max_frames=max_frames,
                            readback_depth=readback_depth, ship_thread=ship_thread)
        _inspect(inspect, f"after {shipped} frames", sim)
    finally:
        if link is not None and link.record is not None:
            link.record.close()
        if dfront is not None:
            print("engine: rank stats " + json.dumps(rank_stats(sim, dfront, shipped)),
                  file=sys.stderr, flush=True)
    print(f"engine: disconnected after {shipped} frames", file=sys.stderr)
    return shipped


def make_simulator(devices: str | None = None, torch_device: str = "cuda") -> Simulator:
    """A ``Simulator`` on ``torch_device`` ("cuda" or "cpu"), sharded when
    ``devices`` (a count, or ``"all"``) asks for more than one shard: over
    that many CUDA devices of this host (or shards of one CPU block), and,
    in a multi-process run, over the global mesh of every process, where
    ``devices`` counts its shards and must span every process. Raises when
    fewer devices exist than asked for: a mesh never shrinks to fit."""
    world = multihost.process_count()
    if world > 1:
        if devices is None:
            raise SystemExit("engine: a multi-process run needs --devices all (or a shard "
                             "count spanning every process), so that every process owns shards")
        n = world if devices == "all" else int(devices)
        mesh = multihost.global_mesh(n, torch_device)
        print(f"engine: sharding over a {mesh.shape} device mesh", file=sys.stderr)
        return Simulator(device=multihost.process_device(torch_device), mesh=mesh)
    if devices == "all":
        n = torch.cuda.device_count() if torch_device == "cuda" else 1
    else:
        n = 1 if devices is None else int(devices)
    if n > 1:
        if torch_device == "cuda":
            mesh = make_mesh(n_devices=n)
        else:
            mesh = make_mesh(devices=[torch.device("cpu")] * n)
        print(f"engine: sharding over a {mesh.shape} device mesh", file=sys.stderr)
        return Simulator(device=torch_device, mesh=mesh)
    return Simulator(device=torch_device)


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
                         "with particle_simulator_tpu_torch.editor.headless --replay)")
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
                         "fails when fewer exist. In a multi-process run "
                         "(the PS_TPU_* variables; scripts/torch_launch_multihost.sh) "
                         "the shard count of the global mesh, a multiple of the "
                         "process count ('all' = one shard a process)")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the scene lives: the card (the kernels) or the "
                         "CPU (their plain versions)")
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="record the program's spans and counters while serving "
                         "and write them to PATH as JSON at exit (PATH.rank<N> "
                         "in a multi-process run)")
    ap.add_argument("--inspect", default=None, metavar="MODULE:FUNCTION",
                    help="a check of the served state: FUNCTION(label, simulator) "
                         "runs with the first scene as loaded and after the last "
                         "frame, on every process, and its JSON-able result is "
                         "logged as an 'engine: inspect' line")
    args = ap.parse_args(argv)
    hook = None if args.inspect is None else load_hook(args.inspect)
    # multi-process (nothing unless the PS_TPU_* variables are set): the
    # group forms before anything else touches a device
    if multihost.init_distributed(args.torch_device):
        print(f"engine: distributed {multihost.describe(args.torch_device)}", file=sys.stderr)
    try:
        with profiling.recording() if args.spans else contextlib.nullcontext():
            return _run(args, hook)
    finally:
        if args.spans:
            # every process of a multi-process run writes its own file
            path = (args.spans if multihost.process_count() == 1
                    else f"{args.spans}.rank{multihost.process_index()}")
            with open(path, "w") as f:
                json.dump(profiling.export(), f)
            print(f"engine: spans written to {path}", file=sys.stderr)
        if dist.is_initialized():
            dist.destroy_process_group()
        report_foreign_modules("engine")


def _run(args, hook) -> int:
    sim = make_simulator(args.devices, args.torch_device)

    if args.files:
        if multihost.process_count() > 1:
            raise SystemExit("engine: --files serves one process; use --addr")
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
          readback_depth=args.readback_pipeline, ship_thread=args.ship_thread,
          inspect=hook)
    return 0


if __name__ == "__main__":
    sys.exit(main())
