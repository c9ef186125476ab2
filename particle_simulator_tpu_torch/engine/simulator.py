"""The simulator core: the scene on the device and its frame schedule.

Counterpart of ``particle_simulator_tpu/engine/simulator.py``:

- ``load_frame`` lays the scene out for the requested data structure:
  MatrixBuckets picks a bucket grid for the scene's density (``_grid_for``)
  and bucketizes on the host; CompactArray keeps the live particles first,
  then tombstones up to ``max(1024, pow2 >= live)`` slots. It uploads to
  the device the request resolves to (``_target_device``);
- ``update_metadata`` applies a metadata-only frame on the next dispatch by
  rebuilding the small params tensor (no kernel is rebuilt); a change of the
  data structure, or of the device in effect, reads the running particles
  back and lays them out again through ``load_frame``;
- ``frame_async`` enqueues one frame of kernel launches on the current CUDA
  stream and returns (CUDA's own asynchrony gives the compute/readback
  overlap the daemon relies on); CPU tensors run the plain versions. The
  scene picks the runner: a MatrixBuckets scene whose occupancy leaves
  lane chunks to skip (``_lane_chunks_for``, chosen at load) steps its
  live tiles only (the ext-layout frame), since on the H100 that frame
  takes less time than the classic one at every live-tile share that
  leaves lane chunks (at most 75%); every other scene runs the classic
  frame. That is the rule of the JAX engine's ``PS_EXT_IO=auto``; the port
  reads no such variable. A scene that fills its box after load keeps its
  load-time choice, as it keeps its lane chunks. The live-tile frame
  steps its first run into the buffer the frame before it left beside the
  state (``_frame_spare``), so only the first frame after a load copies
  the grid;
- ``start_readback`` packs the live particles of a bucket grid into wire
  records (``ops/readback.py:pack_records``), or takes a CompactArray
  state whole, and starts the copy into pinned host memory; ``read_frame``
  waits on the ticket's CUDA event, widening the sticky pack length and
  packing again when the scene outgrew it. On the card the pack is one
  kernel, copied once on a copy stream that waits for the pack, so the
  next frame's kernels run while the copy engine works; its frame's
  particles are a view of that pinned buffer, which goes back to torch's
  caching host allocator when the frame is dropped. On the CPU the pack is
  its plain version (``records_plain``), with the same bytes.

Frame ids: each ``load_frame`` and each ``frame_async`` takes the next
number (``frame_id``), and a readback ticket carries the id of the state it
reads, so the spans of one frame (``utils/profiling.py:annotate``; nothing
is recorded unless recording is on) share it: ``sim.load_frame`` (with
``load.grid_pick``, ``load.bucketize``, ``load.upload``),
``sim.update_metadata``, ``sim.frame_async``, ``sim.start_readback`` and
``sim.read_frame`` (with ``readback.wait``, the wait for the copy, and
``readback.unpack``, the host work after it). The counter ``readback.redo``
counts the readbacks widened and done again, ``readback.records`` the frames
of a bucket grid read back through the record pack (on the card or the
CPU; a redo counts once), ``frame.live_tiles`` the frames sent to the
live-tile step, ``step.live_tile_launches`` the live-tile step's kernel
launches of those frames (one a step, on the card only), ``frame.allpairs``
the frames sent to the all-pairs step and ``allpairs.swept_pairs`` the pair
evaluations those frames' launches sweep (every slot, tombstones included,
squared, times the steps; beside the live pairs that a step's least time
counts, it shows the padding up to ``compact_capacity``).

Devices: a ``GPU`` request runs the CUDA kernels on a CUDA ``Simulator``;
``CPU_THREAD_POOL`` and ``CPU_MAIN_THREAD`` move the scene to CPU tensors,
run the plain PyTorch versions eagerly on the caller's thread and echo the
request. A ``Simulator(device="cpu")`` has no card, so it serves ``GPU``
requests on the CPU and echoes ``CPU_THREAD_POOL``, as the JAX engine does
on a host without an accelerator. A CUDA ``Simulator`` needs the card: it
never carries on on the CPU when the card was asked for.

With a ``mesh`` (``parallel/domain.py``), a MatrixBuckets scene is sharded
over the mesh's devices whatever the device request, as in the JAX engine:
``bx`` grows until it tiles the mesh's x axis, tombstone rows pad the y axis,
and every frame runs the sharded frame (halo kernels on CUDA meshes, their
plain versions on CPU meshes). The readback gathers the shards onto the
mesh's first device and drops the pad rows, then packs as on one device.
CompactArray runs unsharded on the requested device.

With a mesh over several processes (``parallel/multihost.py:global_mesh``),
the state is this process's blocks of the global mesh. Every process loads
the same broadcast frame bytes, so every process picks the same grid. Only
the sharded MatrixBuckets layout exists there: ``load_frame`` forces
MatrixBuckets and the accelerator request (and says so, as the JAX engine
does), and ``update_metadata`` ignores data-structure and device switches.
The readback gathers the grid onto rank 0's device and packs it there; on
the other processes a ticket holds nothing and ``read_frame`` returns a
frame without particles. ``sync`` and ``live_count`` cover every process;
like every frame, they are collectives.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from particle_simulator_tpu_torch.engine.state import (
    ParticleState,
    SimParams,
    state_from_numpy,
    state_to_numpy,
)
from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, DataStructure, Device, Frame
from particle_simulator_tpu_torch.ops.allpairs_cuda import run_frame_allpairs_cuda
from particle_simulator_tpu_torch.ops.bucket_cuda import FrameSpare, run_frame_bucket_cuda
from particle_simulator_tpu_torch.ops.readback import pack_records, pow2_at_least, record_view
from particle_simulator_tpu_torch.parallel import multihost
from particle_simulator_tpu_torch.parallel.domain import (
    DeviceMesh,
    make_sharded_frame_fn,
    pad_rows_for_mesh,
    shard_state,
)
from particle_simulator_tpu_torch.physics.bucket import (
    REFERENCE_GRID,
    GridConfig,
    bucketize_numpy,
)
from particle_simulator_tpu_torch.utils import profiling


class ReadbackTicket:
    """A started readback on its way to host memory until ``event``
    completes (``event`` is None on the CPU). For a bucket grid,
    ``records`` = the host words of its record pack
    (``ops/readback.py:pack_records``), ``ncap`` records and the header;
    for a CompactArray state, ``records`` is None and ``state`` is the
    whole state on the host. Otherwise ``state`` is kept for the
    widen-and-retry path. ``frame`` is the id of the frame whose state it
    reads (``Simulator.frame_id``). On a process other than the frame owner
    of a multi-process mesh every field but ``frame`` is None."""

    __slots__ = ("state", "ncap", "event", "frame", "records")

    def __init__(self, state, ncap=None, event=None, frame=None, records=None):
        self.state = state
        self.ncap = ncap
        self.event = event
        self.frame = frame
        self.records = records


def compact_capacity(live: int) -> int:
    """Slots of a CompactArray layout: ``max(1024, pow2 >= live)``."""
    return max(1024, pow2_at_least(live))


def _grid_for(
    live: np.ndarray,
    base: GridConfig,
    box_width: float,
    r0: float,
    box_height: float | None = None,
) -> GridConfig:
    """Density-aware grid selection (the JAX engine's, unchanged): grow the
    bucket grid until the fullest bucket fits, but never shrink buckets
    below ~2 equilibrium distances (the 3x3 neighbourhood must cover the
    force range); past that floor grow the capacity instead, up to 256.
    Then halve the capacity while splitting the wider axis as long as the
    scene fits and buckets stay >= 2 r0, and halve it in place when the
    occupancy leaves 2x headroom."""
    def max_occupancy(c: GridConfig) -> int:
        bx = (live["x"] >> np.uint32(32 - c.bx_log2)).astype(np.int64)
        by = (live["y"] >> np.uint32(32 - c.by_log2)).astype(np.int64)
        return int(np.bincount(by * c.bx + bx, minlength=c.buckets).max())

    cfg = base
    while cfg.capacity < len(live):
        cfg = GridConfig(cfg.bx_log2 + 1, cfg.by_log2 + 1, cfg.cap, cfg.move_every)
    if len(live) == 0:
        return cfg
    box_height = box_width if box_height is None else box_height
    while max_occupancy(cfg) > cfg.cap:
        bucket_side = min(box_width / cfg.bx, box_height / cfg.by)
        if bucket_side / 2.0 >= 2.0 * r0:
            cfg = GridConfig(cfg.bx_log2 + 1, cfg.by_log2 + 1, cfg.cap, cfg.move_every)
        elif cfg.cap < 256:
            cfg = GridConfig(cfg.bx_log2, cfg.by_log2, cfg.cap * 2, cfg.move_every)
        else:
            break  # accept drops (reference semantics)

    while cfg.cap > 8:
        if box_width / cfg.bx >= box_height / cfg.by:  # split the wider side
            finer = GridConfig(cfg.bx_log2 + 1, cfg.by_log2, cfg.cap // 2, cfg.move_every)
            side = box_width / finer.bx
        else:
            finer = GridConfig(cfg.bx_log2, cfg.by_log2 + 1, cfg.cap // 2, cfg.move_every)
            side = box_height / finer.by
        if side < 2.0 * r0 or max_occupancy(finer) > finer.cap:
            break
        cfg = finer

    while cfg.cap > 8 and 2 * max_occupancy(cfg) <= cfg.cap // 2:
        cfg = GridConfig(cfg.bx_log2, cfg.by_log2, cfg.cap // 2, cfg.move_every)
    return cfg


def _lane_chunk_candidates(grid: GridConfig) -> list[int]:
    """The lane-chunk counts a grid can be split into, largest first: each
    of 8, 4, 2 that divides BX into chunks of at least 1024 slot lanes, a
    multiple of 128 (the JAX engine's rule, kept so both pick alike)."""
    lanes = grid.bx * grid.cap
    return [c for c in (8, 4, 2)
            if not (grid.bx % c or (lanes // c) % 128 or lanes // c < 1024)]


def _lane_chunks_for(occ: np.ndarray, grid: GridConfig) -> int:
    """The lane-chunk count of a scene from its (BY, BX) bucket occupancy:
    the largest candidate whose 8-row tiles are at most 75% live, else 1
    (the JAX engine's ``_lane_chunks_for``). The live-tile frame runs only
    on scenes that get more than 1."""
    for c in _lane_chunk_candidates(grid):
        by8 = (grid.by + 7) // 8
        occ_p = np.pad(occ, ((0, by8 * 8 - grid.by), (0, 0)))
        tiles = occ_p.reshape(by8, 8, c, grid.bx // c).max(axis=(1, 3)) > 0
        if tiles.mean() <= 0.75:
            return c
    return 1


class Simulator:
    """Holds the scene on a device and advances it frame by frame.
    ``device`` is the card the ``GPU`` requests run on; it defaults to CUDA
    and must exist: there is no silent CPU fallback. ``device="cpu"`` runs
    every request through the plain versions. ``mesh`` (a ``DeviceMesh`` of
    the same device type) shards the MatrixBuckets grid over its devices."""

    def __init__(self, grid: GridConfig = REFERENCE_GRID, device="cuda",
                 mesh: Optional[DeviceMesh] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; Simulator(device='cpu') runs the "
                    "plain PyTorch versions instead"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {self.device.type} Simulator cannot run on {mesh}")
        self.mesh = mesh
        self.sharded = False  # the state is the mesh's blocks (parallel/domain.py)
        self._sharded_frame = None  # make_sharded_frame_fn of the loaded grid
        self.base_grid = grid
        self.grid = grid
        # one ParticleState, or a tuple of mesh blocks when sharded
        self.state = None
        self.params: Optional[SimParams] = None
        # params on the state's device, or one per mesh block when sharded
        self._pvec = None
        self.meta_record: Optional[np.ndarray] = None
        self.data_structure = DataStructure.MATRIX_BUCKETS
        # the device the state lives on, and the Device the wire echoes
        self.run_device, self.active_device = self._target_device(Device.GPU)
        # the Device the scene's frames asked for (a GPU request on a CPU
        # Simulator runs on the CPU but still takes the live-tile frame)
        self.requested_device = Device.GPU
        # the record pack's length (ops/readback.py): a sticky power of two
        # >= the live count, seeded at scene load
        self._readback_ncap = 1
        # the copy stream of each card's record-pack readbacks
        self._copy_streams: dict = {}
        # lane chunks of the live-tile frame, from the scene's occupancy at
        # load (_lane_chunks_for); 1 = the classic step
        self._lane_chunks = 1
        # the buffer the last live-tile frame stepped in beside the state it
        # returned (ops/bucket_cuda.py:FrameSpare), emptied at each load
        self._frame_spare = FrameSpare()
        # the runner of the last frame_async: "bucket-<where>",
        # "bucket-compact-<where>", "allpairs-<where>" or "sharded-<where>",
        # where is "cuda" or "torch-cpu"
        self.active_kernel: str | None = None
        # the id of the frame the state holds: each load_frame and each
        # frame_async takes the next
        self.frame_id = -1

    def _target_device(self, requested: Device) -> tuple[torch.device, Device]:
        """The tensor device and the echoed ``Device`` of a request: ``GPU``
        runs on this simulator's card (the CPU, echoed as
        ``CPU_THREAD_POOL``, when it has none); both CPU requests run on
        CPU tensors and echo themselves."""
        if requested == Device.GPU:
            if self.device.type == "cuda":
                return self.device, Device.GPU
            return torch.device("cpu"), Device.CPU_THREAD_POOL
        return torch.device("cpu"), requested

    def _set_meta(self, rec: np.ndarray) -> None:
        self.meta_record = rec
        self.params = SimParams.from_record(rec)
        if self.sharded:
            self._pvec = tuple(self.params.vector(dev) for dev, _ in self.mesh.blocks)
        else:
            self._pvec = self.params.vector(self.run_device)

    # -- scene / metadata ingest ----------------------------------------------
    @property
    def multi_process(self) -> bool:
        """Whether the mesh spans several processes."""
        return self.mesh is not None and self.mesh.multi_process

    def load_frame(self, frame: Frame) -> None:
        """Full scene reset from a non-empty editor frame."""
        self.frame_id += 1
        with profiling.annotate("sim.load_frame", self.frame_id):
            self._load(frame)

    def _load(self, frame: Frame) -> None:
        meta = frame.metadata
        rec = meta.copy()
        data_structure, requested = meta.data_structure, meta.device
        if self.multi_process and (data_structure != DataStructure.MATRIX_BUCKETS
                                   or requested != Device.GPU):
            # only the global sharded layout exists over several processes;
            # every process sees the same bytes, so all coerce alike
            print("engine: multi-process run forces MatrixBuckets/accelerator "
                  f"(requested {data_structure.name}/{requested.name})", file=sys.stderr)
            data_structure, requested = DataStructure.MATRIX_BUCKETS, Device.GPU
            rec["data_structure"] = int(data_structure)
        self.data_structure = data_structure
        self.requested_device = requested
        self.run_device, self.active_device = self._target_device(requested)
        # echo the device actually running in outbound metadata
        rec["device"] = int(self.active_device)

        parts = frame.particles
        live = parts[parts["ty"] >= 0]
        t0 = time.perf_counter()
        self.sharded = False
        self._lane_chunks = 1
        self._frame_spare = FrameSpare()
        if self.data_structure == DataStructure.COMPACT_ARRAY:
            capacity = compact_capacity(len(live))
            self.grid = self.base_grid
            with profiling.annotate("load.upload"):
                self.state = state_from_numpy(live, capacity, self.run_device)
            desc = f"compact capacity {capacity}"
        else:
            with profiling.annotate("load.grid_pick"):
                g = _grid_for(
                    live, self.base_grid, meta.box_width,
                    meta.species(0).force0_r(), box_height=meta.box_height,
                )
                if self.mesh is not None:
                    # grow bx until it tiles the mesh's (power-of-two) x axis;
                    # tombstone rows pad the y axis
                    while g.bx % self.mesh.shape[1]:
                        g = GridConfig(g.bx_log2 + 1, g.by_log2 + 1, g.cap, g.move_every)
            self.grid = g
            with profiling.annotate("load.bucketize"):
                # per-bucket placed counts pick the lane chunks (bucketize
                # fills slots ascending and drops past cap)
                bxi = (live["x"] >> np.uint32(32 - g.bx_log2)).astype(np.int64)
                byi = (live["y"] >> np.uint32(32 - g.by_log2)).astype(np.int64)
                occ = np.minimum(np.bincount(bxi + byi * g.bx, minlength=g.buckets), g.cap)
                self._readback_ncap = pow2_at_least(len(live))
                self._lane_chunks = _lane_chunks_for(occ.reshape(g.by, g.bx), g)
                layout = bucketize_numpy(live, g)
            desc = f"grid {g.bx}x{g.by}x{g.cap} lane_chunks {self._lane_chunks}"
            with profiling.annotate("load.upload"):
                if self.mesh is None:
                    self.state = state_from_numpy(layout, g.capacity, self.run_device).reshape(
                        g.grid_shape)
                else:
                    state = state_from_numpy(layout, g.capacity).reshape(g.grid_shape)
                    self.state = shard_state(pad_rows_for_mesh(state, self.mesh)[0], self.mesh)
                    self.sharded = True
                    self._sharded_frame = make_sharded_frame_fn(g, self.mesh)
                    desc += f" sharded over {self.mesh}"
        self._set_meta(rec)
        where = "mesh" if self.sharded else self.run_device
        print(
            f"engine: scene loaded ({len(live)} live, {desc}, {where}, "
            f"layout {time.perf_counter() - t0:.2f}s)",
            file=sys.stderr,
        )

    def update_metadata(self, frame: Frame) -> None:
        """Metadata-only frame (particle_count == 0): a live reconfigure that
        takes effect on the next dispatch. A change of the data structure,
        or of the device in effect, reads the running particles back and
        lays them out again (the JAX engine's live switch); otherwise the
        particles are untouched. Out-of-range enum bytes are ignored (the
        running values stay)."""
        with profiling.annotate("sim.update_metadata"):
            if self.meta_record is None:
                return
            new = frame.metadata.copy()
            try:
                requested_ds = DataStructure(int(new["data_structure"]))
                requested_dev = Device(int(new["device"]))
            except ValueError:
                requested_ds, requested_dev = self.data_structure, self.requested_device
            if self.multi_process:
                # only the global sharded layout exists: ignore switch requests
                requested_ds, requested_dev = self.data_structure, self.requested_device
            _, active_device = self._target_device(requested_dev)
            if requested_ds != self.data_structure or active_device != self.active_device:
                parts = state_to_numpy(self._grid_state())
                self.load_frame(Frame.from_particles(new, parts[parts["ty"] >= 0]))
                return
            self.requested_device = requested_dev
            new["data_structure"] = int(self.data_structure)
            new["device"] = int(self.active_device)
            self._set_meta(new)

    # -- frame stepping ---------------------------------------------------------
    def frame_async(self) -> None:
        """Enqueue one frame (steps_per_frame steps) and return. The
        wrappers launch the CUDA kernels for a state on the card and run the
        plain versions for a state on the CPU. An unsharded MatrixBuckets
        scene asked for on the GPU that has more than one lane chunk steps
        its live tiles only (counted as ``frame.live_tiles``, and on the
        card its steps' launches as ``step.live_tile_launches``); its tiles
        are ``2^(gpu_threads_per_block_log2 - 4)`` bucket rows where they
        fit (the JAX engine's launch-width mapping). A live edit of
        ``gpu_threads_per_block_log2`` is echoed in the metadata at once and
        read here, so it takes effect on the next live-tile frame without a
        reload (the JAX engine's served behaviour); the classic frame and
        every other runner ignore the field."""
        if self.state is None:
            return
        self.frame_id += 1
        with profiling.annotate("sim.frame_async", self.frame_id):
            steps = self.params.steps_per_frame
            if self.sharded:
                self.state = self._sharded_frame(self.state, self._pvec, steps)
                where = "cuda" if self.mesh.device_type == "cuda" else "torch-cpu"
                self.active_kernel = f"sharded-{where}"
                return
            where = "cuda" if self.run_device.type == "cuda" else "torch-cpu"
            if self.data_structure == DataStructure.COMPACT_ARRAY:
                slots = self.state.x.shape[0]
                profiling.count("frame.allpairs")
                profiling.count("allpairs.swept_pairs", slots * slots * steps)
                self.state = run_frame_allpairs_cuda(self.state, self._pvec, steps)
                self.active_kernel = f"allpairs-{where}"
            else:
                if self._lane_chunks > 1 and self.requested_device == Device.GPU:
                    profiling.count("frame.live_tiles")
                    if where == "cuda":
                        profiling.count("step.live_tile_launches", steps)
                    k = int(self.meta_record["gpu_threads_per_block_log2"])
                    self.state = run_frame_bucket_cuda(
                        self.state, self._pvec, steps, self.grid.move_every,
                        lane_chunks=self._lane_chunks, ext_io=True, compact_tiles=True,
                        block_rows=max(1, 1 << max(0, k - 4)), spare=self._frame_spare)
                    self.active_kernel = f"bucket-compact-{where}"
                else:
                    self.state = run_frame_bucket_cuda(self.state, self._pvec, steps,
                                                       self.grid.move_every)
                    self.active_kernel = f"bucket-{where}"

    def sync(self) -> None:
        """Block until every frame enqueued so far has run: the barrier a
        benchmark sets before it reads the clock. Waits on the state's card, on
        every card of the mesh's blocks when sharded, and then for every other
        process of a multi-process mesh to have done the same; CPU tensors,
        and a simulator with no scene, have nothing in flight."""
        if self.state is None:
            return
        blocks = self.state if self.sharded else (self.state,)
        for dev in {b.x.device for b in blocks}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if self.multi_process:
            multihost.barrier(blocks[0].x.device)

    # -- readback ----------------------------------------------------------------
    def _grid_state(self) -> ParticleState | None:
        """The scene as one state: a sharded grid gathered onto the mesh's
        first device (over several processes, rank 0's; None on the
        others), pad rows dropped."""
        if not self.sharded:
            return self.state
        state = multihost.gather_global(self.state, self.mesh)
        if state is None:
            return None
        return ParticleState(*(a[:self.grid.by] for a in state))

    def start_readback(self, state: Optional[ParticleState] = None) -> ReadbackTicket:
        """Start the device -> host copy of ``state`` (default: the current
        one, whose frame id the ticket carries): the record pack of a bucket
        grid, or a whole CompactArray state; ``read_frame`` consumes the
        ticket."""
        frame = self.frame_id if state is None else None
        with profiling.annotate("sim.start_readback", frame):
            state = self._grid_state() if state is None else state
            if state is None:  # not the frame owner: rank 0 holds the grid
                return ReadbackTicket(None, frame=frame)
            if state.x.dim() == 3:
                return self._start_records(state, frame)
            if not state.x.is_cuda:
                return ReadbackTicket(state, frame=frame)
            with torch.cuda.device(state.x.device):  # the copies and event share its stream
                host = []
                for t in state:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    host.append(h)
                event = torch.cuda.Event()
                event.record()
            return ReadbackTicket(ParticleState(*host), event=event, frame=frame)

    def _start_records(self, state: ParticleState, frame=None) -> ReadbackTicket:
        """The record-pack readback of a (BY, BX, CAP) grid at the sticky
        ``ncap``: the pack on the current stream, then, on the card, one copy
        into a fresh pinned buffer on the device's copy stream once the pack
        is done. The pack's device buffer is not reused before that copy has
        run (``record_stream``). A CPU grid's ticket holds its plain pack."""
        ncap = self._readback_ncap
        words = pack_records(state, ncap)
        if not words.is_cuda:
            return ReadbackTicket(state, ncap, frame=frame, records=words)
        dev = words.device
        with torch.cuda.device(dev):
            side = self._copy_streams.get(dev)
            if side is None:
                side = self._copy_streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                host.copy_(words, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            words.record_stream(side)
        return ReadbackTicket(state, ncap, event, frame, records=host)

    def read_frame(self, state=None, meta: Optional[np.ndarray] = None) -> Frame:
        """The live particles of a ticket (or of ``state``, default the
        current one) as a wire frame stamped with ``meta`` (default: the
        current metadata). A CompactArray state ships its live slots in slot
        order, as the JAX engine does. A ticket of a process other than the
        frame owner gives a frame without particles: the daemon counts it
        like a shipped one, so every process leaves its loop together."""
        ticket = state if isinstance(state, ReadbackTicket) else self.start_readback(state)
        rec = self.meta_record if meta is None else meta
        if ticket.state is None:
            return Frame.from_particles(rec, np.zeros(0, PARTICLE_DTYPE), owned=True)
        with profiling.annotate("sim.read_frame", ticket.frame):
            with profiling.annotate("readback.wait"):
                if ticket.event is not None:
                    ticket.event.synchronize()
            with profiling.annotate("readback.unpack"):
                return self._unpack(ticket, rec)

    def _unpack(self, ticket: ReadbackTicket, rec: np.ndarray) -> Frame:
        """The frame of a ticket whose copy has landed."""
        if ticket.records is not None:
            return self._unpack_records(ticket, rec)
        parts = state_to_numpy(ticket.state)
        # the boolean-mask gather is a fresh array: hand it over
        return Frame.from_particles(rec, parts[parts["ty"] >= 0], owned=True)

    def _unpack_records(self, ticket: ReadbackTicket, rec: np.ndarray) -> Frame:
        """The frame of a record-pack ticket: the header's two words, then a
        view of the first ``total`` records as the frame's particles. A live
        count past ``ncap`` widens the sticky ``ncap`` and packs again."""
        _, total, live = record_view(ticket.records.numpy(), ticket.ncap)
        if total > ticket.ncap:
            profiling.count("readback.redo")
            self._readback_ncap = max(ticket.ncap, pow2_at_least(total))
            ticket = self._start_records(ticket.state, ticket.frame)
            if ticket.event is not None:
                ticket.event.synchronize()
            _, total, live = record_view(ticket.records.numpy(), ticket.ncap)
        profiling.count("readback.records")
        # the view is the frame's alone: each ticket has its own buffer
        return Frame.from_particles(rec, live, owned=True)

    @property
    def live_count(self) -> int:
        """Live particles of the scene, of every process's blocks over a
        multi-process mesh (a collective there)."""
        if self.state is None:
            return 0
        blocks = self.state if self.sharded else (self.state,)
        count = sum(int((b.ty >= 0).sum()) for b in blocks)
        if self.multi_process:
            return multihost.all_sum(count, blocks[0].x.device)
        return count
