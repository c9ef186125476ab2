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
  overlap the daemon relies on); CPU tensors run the plain versions. A
  MatrixBuckets scene whose occupancy leaves lane chunks to skip
  (``_lane_chunks_for``, chosen at load) runs the ext-layout frame when
  ``PS_EXT_IO`` asks for it (``_ext_io_mode``; the default ``off`` keeps
  the classic step, as in the JAX engine);
- ``start_readback`` packs the live particles of a bucket grid on the
  device (``ops/readback.py``), or takes a CompactArray state whole, and
  starts the copy into pinned host buffers; ``read_frame`` waits on the
  ticket's CUDA event, widening the sticky pack sizes and retrying when the
  scene outgrew them.

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
"""

from __future__ import annotations

import os
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
from particle_simulator_tpu_torch.io.frame import DataStructure, Device, Frame
from particle_simulator_tpu_torch.ops.allpairs_cuda import run_frame_allpairs_cuda
from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
from particle_simulator_tpu_torch.ops.readback import (
    dense_readback,
    dense_to_particles,
    pow2_at_least,
)
from particle_simulator_tpu_torch.parallel.domain import (
    DeviceMesh,
    gather_state,
    make_sharded_frame_fn,
    pad_rows_for_mesh,
    shard_state,
)
from particle_simulator_tpu_torch.physics.bucket import (
    REFERENCE_GRID,
    GridConfig,
    bucketize_numpy,
)


class ReadbackTicket:
    """A started readback on its way to host memory until ``event``
    completes (``event`` is None on the CPU). For a bucket grid,
    ``scalars`` = ``[max_occupancy, total]`` and ``packed`` = the five
    device-packed fields, sized ``k``/``ncap``; for a CompactArray state,
    ``scalars`` is None and ``packed`` is the whole state. ``state`` is kept
    for the widen-and-retry path."""

    __slots__ = ("state", "scalars", "packed", "k", "ncap", "event")

    def __init__(self, state, scalars, packed, k, ncap, event=None):
        self.state = state
        self.scalars = scalars
        self.packed = packed
        self.k = k
        self.ncap = ncap
        self.event = event


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


def _ext_io_mode() -> tuple[bool, bool]:
    """(ext_io, compact_tiles) of the MatrixBuckets frame on the card, from
    ``PS_EXT_IO``, read at every frame as the JAX engine reads it:
    ``compact``, ``auto``, ``on`` or ``1`` run the ext-layout step on the
    live tiles only, ``nocompact`` on every tile; anything else, and the
    default ``off``, the classic step."""
    mode = os.environ.get("PS_EXT_IO", "off").lower()
    if mode in ("compact", "auto", "on", "1"):
        return True, True
    if mode == "nocompact":
        return True, False
    return False, True


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
    (the JAX engine's ``_lane_chunks_for``). The ext-layout frame runs only
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
        # Simulator runs on the CPU but still takes the ext-layout frame)
        self.requested_device = Device.GPU
        # readback pack sizes (ops/readback.py): kcap = the occupied slot
        # prefix the pack gathers from (sticky power of two; grows on
        # overflow, halves after a long low streak); ncap = the pack length
        # (sticky power of two >= the live count, seeded at scene load)
        self._readback_k = 8
        self._readback_ncap = 1
        self._readback_low_streak = 0
        # lane chunks of the ext-layout frame, from the scene's occupancy at
        # load (_lane_chunks_for); 1 = the classic step whatever PS_EXT_IO says
        self._lane_chunks = 1
        # the runner of the last frame_async: "bucket-<where>",
        # "bucket-ext-<where>", "bucket-compact-<where>", "allpairs-<where>"
        # or "sharded-<where>", where is "cuda" or "torch-cpu"
        self.active_kernel: str | None = None

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
    def load_frame(self, frame: Frame) -> None:
        """Full scene reset from a non-empty editor frame."""
        meta = frame.metadata
        self.data_structure = meta.data_structure
        self.requested_device = meta.device
        self.run_device, self.active_device = self._target_device(meta.device)
        rec = meta.copy()
        # echo the device actually running in outbound metadata
        rec["device"] = int(self.active_device)

        parts = frame.particles
        live = parts[parts["ty"] >= 0]
        t0 = time.perf_counter()
        self.sharded = False
        self._lane_chunks = 1
        if self.data_structure == DataStructure.COMPACT_ARRAY:
            capacity = compact_capacity(len(live))
            self.grid = self.base_grid
            self.state = state_from_numpy(live, capacity, self.run_device)
            desc = f"compact capacity {capacity}"
        else:
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
            # per-bucket placed counts seed the readback sizes (bucketize
            # fills slots ascending and drops past cap)
            bxi = (live["x"] >> np.uint32(32 - g.bx_log2)).astype(np.int64)
            byi = (live["y"] >> np.uint32(32 - g.by_log2)).astype(np.int64)
            occ = np.minimum(np.bincount(bxi + byi * g.bx, minlength=g.buckets), g.cap)
            self._readback_k = pow2_at_least(int(occ.max(initial=0)))
            self._readback_ncap = pow2_at_least(len(live))
            self._readback_low_streak = 0
            self._lane_chunks = _lane_chunks_for(occ.reshape(g.by, g.bx), g)
            layout = bucketize_numpy(live, g)
            desc = f"grid {g.bx}x{g.by}x{g.cap} lane_chunks {self._lane_chunks}"
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
        if self.meta_record is None:
            return
        new = frame.metadata.copy()
        try:
            requested_ds = DataStructure(int(new["data_structure"]))
            requested_dev = Device(int(new["device"]))
        except ValueError:
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
        scene asked for on the GPU runs the ext-layout frame when
        ``PS_EXT_IO`` asks for it and the scene has more than one lane
        chunk; its tiles are ``2^(gpu_threads_per_block_log2 - 4)`` bucket
        rows where they fit (the JAX engine's launch-width mapping)."""
        if self.state is None:
            return
        steps = self.params.steps_per_frame
        if self.sharded:
            self.state = self._sharded_frame(self.state, self._pvec, steps)
            where = "cuda" if self.mesh.device_type == "cuda" else "torch-cpu"
            self.active_kernel = f"sharded-{where}"
            return
        where = "cuda" if self.run_device.type == "cuda" else "torch-cpu"
        if self.data_structure == DataStructure.COMPACT_ARRAY:
            self.state = run_frame_allpairs_cuda(self.state, self._pvec, steps)
            self.active_kernel = f"allpairs-{where}"
        else:
            ext_io, compact = _ext_io_mode()
            if ext_io and self._lane_chunks > 1 and self.requested_device == Device.GPU:
                k = int(self.meta_record["gpu_threads_per_block_log2"])
                self.state = run_frame_bucket_cuda(
                    self.state, self._pvec, steps, self.grid.move_every,
                    lane_chunks=self._lane_chunks, ext_io=True, compact_tiles=compact,
                    block_rows=max(1, 1 << max(0, k - 4)))
                self.active_kernel = f"bucket-{'compact' if compact else 'ext'}-{where}"
            else:
                self.state = run_frame_bucket_cuda(self.state, self._pvec, steps,
                                                   self.grid.move_every)
                self.active_kernel = f"bucket-{where}"

    # -- readback ----------------------------------------------------------------
    def _grid_state(self) -> ParticleState:
        """The scene as one state: a sharded grid gathered onto the mesh's
        first device, pad rows dropped."""
        if not self.sharded:
            return self.state
        state = gather_state(self.state, self.mesh)
        return ParticleState(*(a[:self.grid.by] for a in state))

    def start_readback(self, state: Optional[ParticleState] = None) -> ReadbackTicket:
        """Start the device -> host copy of ``state`` (default: the current
        one): the dense pack of a bucket grid, or a whole CompactArray
        state; ``read_frame`` consumes the ticket."""
        state = self._grid_state() if state is None else state
        if state.x.dim() == 1:
            scalars, packed, k, ncap = None, state, None, None
        else:
            k = min(self._readback_k, state.x.shape[-1])
            ncap = self._readback_ncap
            scalars, packed = dense_readback(state, k, ncap)
        if not state.x.is_cuda:
            return ReadbackTicket(state, scalars, packed, k, ncap)
        with torch.cuda.device(state.x.device):  # the pack, copies and event share its stream
            host = []
            for t in (*([] if scalars is None else [scalars]), *packed):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            event = torch.cuda.Event()
            event.record()
        if scalars is not None:
            scalars, host = host[0], host[1:]
        return ReadbackTicket(state, scalars, ParticleState(*host), k, ncap, event)

    def read_frame(self, state=None, meta: Optional[np.ndarray] = None) -> Frame:
        """The live particles of a ticket (or of ``state``, default the
        current one) as a wire frame stamped with ``meta`` (default: the
        current metadata). A CompactArray state ships its live slots in slot
        order, as the JAX engine does."""
        ticket = state if isinstance(state, ReadbackTicket) else self.start_readback(state)
        rec = self.meta_record if meta is None else meta
        if ticket.event is not None:
            ticket.event.synchronize()
        if ticket.scalars is None:
            parts = state_to_numpy(ticket.packed)
            # the boolean-mask gather is a fresh array: hand it over
            return Frame.from_particles(rec, parts[parts["ty"] >= 0], owned=True)
        mx, total = (int(v) for v in ticket.scalars.tolist())
        k, ncap = ticket.k, ticket.ncap
        if mx > k or total > ncap:
            # a bucket outgrew the slot prefix (or, defensively, the live
            # count outgrew the pack): widen the sticky sizes and redo
            self._readback_k = min(pow2_at_least(mx), ticket.state.x.shape[-1])
            self._readback_ncap = max(ncap, pow2_at_least(total))
            self._readback_low_streak = 0
            ticket = self.start_readback(ticket.state)
            if ticket.event is not None:
                ticket.event.synchronize()
            mx, total = (int(v) for v in ticket.scalars.tolist())
        elif mx <= k // 2 and k > 1:
            self._readback_low_streak += 1
            if self._readback_low_streak >= 256:
                self._readback_k = max(1, k // 2)
                self._readback_low_streak = 0
        else:
            self._readback_low_streak = 0
        live = dense_to_particles(total, ticket.packed)
        return Frame.from_particles(rec, live, owned=True)

    @property
    def live_count(self) -> int:
        if self.state is None:
            return 0
        blocks = self.state if self.sharded else (self.state,)
        return sum(int((b.ty >= 0).sum()) for b in blocks)
