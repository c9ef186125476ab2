"""Spatial domain decomposition of the bucket grid over a mesh of devices.

Counterpart of ``particle_simulator_tpu/parallel/domain.py``. The JAX
package runs one ``shard_map`` in one process over every local device and
moves the halo with ``lax.ppermute``; here one process holds a mesh of
``torch.device``s and moves the halo by copies between them:

- the (BY, BX, CAP) grid splits into an (ny, nx) mesh of (LY, LX, CAP)
  shards (tombstone rows pad BY to a multiple of ny, ``pad_rows_for_mesh``);
  shard (iy, ix) lives on ``mesh.devices[iy][ix]``;
- shards that share a device are stacked into one block (n, LY, LX, CAP),
  so each kernel launches once per device and not once per shard. Four
  cards hold a block of one shard each; one card can hold all of them
  (``make_mesh(devices=[cuda:0] * 4)``, the analog of XLA's virtual
  devices); on the CPU, ``torch.device("cpu", i)`` entries make distinct
  blocks and plain ``"cpu"`` entries one;
- the halo exchange pads every shard with one ring of its neighbours' edge
  buckets. A ring cell's source is fixed by the mesh: the bucket across the
  edge, or at a corner the diagonal shard's corner bucket, which is what
  the JAX package's two-phase (x, then y rows that carry the x halo)
  exchange delivers. A side with no neighbour holds tombstones (x = y = 0,
  v = 0, ty = -1), written when the ring is built. Each (destination block,
  source block) pair moves its ring cells with one gather, one copy between
  devices where they differ, and one scatter per field; the indices are
  computed once per mesh and shard shape;
- the frame keeps every shard padded from one move to the next (the
  persistent ring of the JAX ``_local_frame``, reduced to what it
  computes): after each step the ring's x and y are refreshed (the force
  pass reads only x, y and ty of ring slots, and ty does not change
  between moves); before each move vx and vy are refreshed too, since the
  move pulls whole particles; the halo move (dest, then place) rebuckets
  each shard and migrates the ring's particles in; then the ring is built
  again. The schedule is ``physics/bucket.py:chunked_frame_schedule``, so
  the cadence is the single-device frame's.

Every interior receiver sees its 3x3 neighbourhood in the same order as on
one device, and the move ranks the same candidates, so a sharded frame is
bit-identical to ``run_frame_bucket_cuda`` (and, on CPU tensors, to
``run_frame_bucket``).

Several processes (``parallel/multihost.py``): every shard of the mesh also
has an owner rank, and a process holds only the blocks of the shards it
owns (``DeviceMesh.blocks``; ``all_blocks`` lists every process's). Ring
cells whose source lies in another process travel by point-to-point sends
over the default ``torch.distributed`` group: for each pair of processes,
one int32 message per refresh carries the ring cells of every field asked
for (f32 fields as their bits), sent and received for all neighbour ranks in
one ``batch_isend_irecv``. Under gloo, a message of CUDA blocks is staged
through pinned host memory (gloo sends CPU tensors only). Every process runs
the same schedule, so every rank issues the same sends in the same order.
With one process every shard is rank 0's and nothing is sent.

Not ported, because they are TPU mechanisms: the halo-column refresh forms
(``dus``/``select``/``refs``, ``PS_SHARD_REFRESH``), the x-padded lane
layout (``pad_x_state``, ``refresh_x_cols``, ``ship_edge_rows``,
``exchange_halo_x_rows``), ``x_pad_for_chunks`` and lane chunks, and the
``ty + 1`` encoding that turns ``ppermute``'s zero fill into tombstones.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.ops.bucket_cuda import (
    bucket_move_halo_cuda,
    bucket_step_halo_cuda,
)
from particle_simulator_tpu_torch.physics.bucket import (
    TOMBSTONE,
    GridConfig,
    chunked_frame_schedule,
    interior,
    pad_tombstone_halo,
)

ALL_FIELDS = (0, 1, 2, 3, 4)  # ParticleState field order
POS_FIELDS = (0, 1)  # what a step changes and a neighbour's force pass reads
VEL_FIELDS = (2, 3)  # what only the move reads

# This process's cross-process ring traffic since the counts were last set
# to 0: messages and bytes sent; host seconds spent in the exchange (pack,
# staging, send/receive, unpack), and of them in packing and staging (on
# CUDA under gloo, the wait for the step that wrote the cells) and in the
# sends and receives (the wait for the peers); and the frame's steps, so a
# caller reads bytes and host time per step.
EXCHANGE = {"messages": 0, "bytes": 0, "seconds": 0.0, "stage_s": 0.0, "comm_s": 0.0,
            "steps": 0}


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Factor n into the most-square (ny, nx) pair with nx a power of two:
    bucket counts are powers of two, so the x axis must divide them; the y
    axis may be any size (rows are padded)."""
    nx = 1
    while n_devices % (nx * 2) == 0 and (nx * 2) ** 2 <= n_devices:
        nx *= 2
    return n_devices // nx, nx


class DeviceMesh:
    """An (ny, nx) grid of ``torch.device``s: shard (iy, ix) lives on
    ``devices[iy][ix]`` in the process of rank ``owners[iy][ix]`` (every
    shard is rank 0's by default). ``rank`` is this process's rank.
    ``all_blocks`` lists each distinct (owner, device) with the shard ids
    (iy * nx + ix) it holds, in order of first appearance; ``blocks`` lists
    this process's as (device, ids), which with one process is all of them."""

    __slots__ = ("devices", "owners", "rank", "shape", "all_blocks", "blocks")

    def __init__(self, devices: Sequence[Sequence], owners: Sequence[Sequence] | None = None,
                 rank: int = 0):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs a non-empty rectangle of devices, got {devices}")
        self.devices = rows
        self.shape = (len(rows), len(rows[0]))
        if owners is None:
            owners = [[0] * self.shape[1]] * self.shape[0]
        self.owners = tuple(tuple(int(o) for o in row) for row in owners)
        if tuple(len(r) for r in self.owners) != (self.shape[1],) * self.shape[0]:
            raise ValueError(f"owners {owners} do not match the {self.shape} mesh")
        if rank not in self.owner_flat:
            raise ValueError(f"rank {rank} owns no shard of {owners}")
        self.rank = rank
        blocks: dict[tuple[int, torch.device], list[int]] = {}
        for s, key in enumerate(zip(self.owner_flat, self.flat)):
            blocks.setdefault(key, []).append(s)
        self.all_blocks = tuple((owner, dev, tuple(ids)) for (owner, dev), ids in blocks.items())
        self.blocks = tuple((dev, ids) for owner, dev, ids in self.all_blocks if owner == rank)

    @property
    def flat(self) -> tuple[torch.device, ...]:
        return tuple(d for row in self.devices for d in row)

    @property
    def owner_flat(self) -> tuple[int, ...]:
        return tuple(o for row in self.owners for o in row)

    @property
    def multi_process(self) -> bool:
        """Whether the shards belong to more than one process."""
        return len(set(self.owner_flat)) > 1

    @property
    def device_type(self) -> str:
        kinds = {d.type for d in self.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
        return kinds.pop()

    def __eq__(self, other) -> bool:
        return (isinstance(other, DeviceMesh) and self.devices == other.devices
                and self.owners == other.owners and self.rank == other.rank)

    def __hash__(self) -> int:
        return hash((self.devices, self.owners, self.rank))

    def __repr__(self) -> str:
        devs = [str(d) for d in self.flat]
        if not self.multi_process:
            return f"DeviceMesh({self.shape[0]}x{self.shape[1]}: {devs})"
        where = [f"{d}@{o}" for d, o in zip(devs, self.owner_flat)]
        return f"DeviceMesh({self.shape[0]}x{self.shape[1]}, rank {self.rank}: {where})"


def make_mesh(devices=None, n_devices: int | None = None) -> DeviceMesh:
    """An (ny, nx) mesh (``factor_mesh``) over the given devices, by default
    every visible CUDA device; the first ``n_devices`` of them when given.
    Raises when fewer than ``n_devices`` exist: a mesh never shrinks."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices < 1 or n_devices > len(devices):
            raise RuntimeError(f"a mesh of {n_devices} devices was asked for, but "
                               f"{len(devices)} exist: {[str(d) for d in devices]}")
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("no CUDA device for a mesh (torch.cuda.device_count() is 0)")
    ny, nx = factor_mesh(len(devices))
    return DeviceMesh([devices[i * nx:(i + 1) * nx] for i in range(ny)])


def pad_rows_for_mesh(state: ParticleState, mesh: DeviceMesh) -> tuple[ParticleState, int]:
    """Append tombstone bucket rows so the row count divides the mesh's y
    axis. Pad rows are never force-visible (tombstones) and never targeted
    (targets come from coordinate bits). Returns (padded state, rows)."""
    ny = mesh.shape[0]
    by = state.x.shape[0]
    target = ny * -(-by // ny)
    if target == by:
        return state, by
    pad = []
    for a, fill in zip(state, TOMBSTONE):
        rows = torch.full((target - by, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        pad.append(torch.cat([a, rows]))
    return ParticleState(*pad), by


def shard_state(state: ParticleState, mesh: DeviceMesh) -> tuple[ParticleState, ...]:
    """Split a (BY, BX, CAP) grid into the mesh's shards: one block
    (n, BY/ny, BX/nx, CAP) per distinct device of this process, on that
    device, its shards in the order of ``mesh.blocks``. Shards of other
    processes are left out."""
    by, bx, cap = state.x.shape
    ny, nx = mesh.shape
    if by % ny or bx % nx:
        raise ValueError(f"a {by}x{bx} grid does not split over a {ny}x{nx} mesh")
    ly, lx = by // ny, bx // nx
    shards = [a.reshape(ny, ly, nx, lx, cap).transpose(1, 2).reshape(ny * nx, ly, lx, cap)
              for a in state]
    blocks = []
    for dev, ids in mesh.blocks:
        idx = torch.tensor(ids, device=state.x.device)
        blocks.append(ParticleState(*(a[idx].to(dev) for a in shards)))
    return tuple(blocks)


def gather_state(blocks: Sequence[ParticleState], mesh: DeviceMesh) -> ParticleState:
    """Join the blocks of ``shard_state`` back into one (BY, BX, CAP) grid on
    the mesh's first device. ``blocks`` are every block of ``all_blocks``, in
    its order (with one process, this process's)."""
    ny, nx = mesh.shape
    dev0 = blocks[0].x.device
    ly, lx, cap = blocks[0].x.shape[-3:]
    order = [s for _, _, ids in mesh.all_blocks for s in ids]
    # a pageable host-to-device index upload would stall the stream, so the
    # usual mesh (blocks in shard order) takes no index at all
    inverse = None if order == sorted(order) else torch.tensor(np.argsort(order), device=dev0)
    out = []
    for f in range(len(ParticleState._fields)):
        shards = torch.cat([b[f].to(dev0) for b in blocks])
        if inverse is not None:
            shards = shards[inverse]
        out.append(shards.reshape(ny, nx, ly, lx, cap).transpose(1, 2)
                   .reshape(ny * ly, nx * lx, cap))
    return ParticleState(*out)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

class RingPlan(NamedTuple):
    """Where every ring cell of this process's shards comes from, and where
    its edge cells go, for one mesh and shard shape. ``pairs`` holds
    (destination block, source block, destination cells, source cells) for
    the ring cells whose source is a block of this process: int64 indices
    into the blocks' (cells, CAP) views, on the respective devices.
    ``sends`` holds (peer rank, segments) and ``recvs`` (peer rank, cells,
    segments) for the cells that cross to or from another process; a
    segment is (block, cells), and a message lists its cells segment after
    segment, in the order both ranks derive from the mesh alone. ``offsets``
    holds each block's int32 (n, 2) global (row, column) bucket offsets of
    its shards."""

    pairs: tuple[tuple[int, int, torch.Tensor, torch.Tensor], ...]
    sends: tuple[tuple[int, tuple[tuple[int, torch.Tensor], ...]], ...]
    recvs: tuple[tuple[int, int, tuple[tuple[int, torch.Tensor], ...]], ...]
    offsets: tuple[torch.Tensor, ...]


def _segments(entries: list, devs) -> tuple[tuple[int, torch.Tensor], ...]:
    """(block, cells) entries in message order -> runs of one block, each
    run's cells one index tensor on the block's device."""
    runs: list[tuple[int, list]] = []
    for block, cells in entries:
        if runs and runs[-1][0] == block:
            runs[-1][1].append(cells)
        else:
            runs.append((block, [cells]))
    return tuple((b, torch.tensor(np.concatenate(c), device=devs[b])) for b, c in runs)


@functools.lru_cache(maxsize=16)
def ring_plan(mesh: DeviceMesh, ly: int, lx: int) -> RingPlan:
    """The ``RingPlan`` of (LY, LX) shards on ``mesh``, for its ``rank``."""
    ny, nx = mesh.shape
    py, px = ly + 2, lx + 2
    local = {}  # global block index -> this process's block index
    where = {}  # shard -> (global block, position in it, owner)
    for gb, (owner, _, ids) in enumerate(mesh.all_blocks):
        if owner == mesh.rank:
            local[gb] = len(local)
        for pos, s in enumerate(ids):
            where[s] = (gb, pos, owner)
    r, c = np.meshgrid(np.arange(py), np.arange(px), indexing="ij")
    ring = (r == 0) | (r == py - 1) | (c == 0) | (c == px - 1)
    r, c = r[ring], c[ring]
    # the side of each ring cell, and its source cell in the neighbour's
    # padded coordinates: the neighbour's interior edge (or corner) bucket
    side_y = np.where(r == 0, -1, np.where(r == py - 1, 1, 0))
    side_x = np.where(c == 0, -1, np.where(c == px - 1, 1, 0))
    src_r = np.where(r == 0, ly, np.where(r == py - 1, 1, r))
    src_c = np.where(c == 0, lx, np.where(c == px - 1, 1, c))
    cells: dict[tuple[int, int], tuple[list, list]] = {}
    sends: dict[int, list] = {}
    recvs: dict[int, list] = {}
    for s in range(ny * nx):
        iy, ix = divmod(s, nx)
        for sy, sx in ((sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if sy or sx):
            ty_, tx_ = iy + sy, ix + sx
            if not (0 <= ty_ < ny and 0 <= tx_ < nx):
                continue  # no neighbour: the ring keeps its tombstones
            sel = (side_y == sy) & (side_x == sx)
            (gd, pd, od), (gs, ps, os_) = where[s], where[ty_ * nx + tx_]
            dst_cells = pd * py * px + r[sel] * px + c[sel]
            src_cells = ps * py * px + src_r[sel] * px + src_c[sel]
            if od == os_ == mesh.rank:
                dst, src = cells.setdefault((local[gd], local[gs]), ([], []))
                dst.append(dst_cells)
                src.append(src_cells)
            elif os_ == mesh.rank:
                sends.setdefault(od, []).append((local[gs], src_cells))
            elif od == mesh.rank:
                recvs.setdefault(os_, []).append((local[gd], dst_cells))
    devs = [dev for dev, _ in mesh.blocks]
    pairs = tuple(
        (bd, bs, torch.tensor(np.concatenate(dst), device=devs[bd]),
         torch.tensor(np.concatenate(src), device=devs[bs]))
        for (bd, bs), (dst, src) in sorted(cells.items())
    )
    offsets = tuple(
        torch.tensor([[(s // nx) * ly, (s % nx) * lx] for s in ids], dtype=torch.int32,
                     device=dev)
        for dev, ids in mesh.blocks
    )
    return RingPlan(
        pairs,
        tuple((peer, _segments(e, devs)) for peer, e in sorted(sends.items())),
        tuple((peer, sum(len(cl) for _, cl in e), _segments(e, devs))
              for peer, e in sorted(recvs.items())),
        offsets,
    )


def _bits(a: torch.Tensor) -> torch.Tensor:
    """A field's int32 bit pattern (f32 fields as a view, bits unchanged)."""
    return a if a.dtype == torch.int32 else a.view(torch.int32)


def pack_ring(padded: Sequence[ParticleState], segments, fields: Sequence[int]) -> torch.Tensor:
    """The (len(fields), cells, CAP) int32 message of ``segments``' cells:
    the source cells of each segment's block, segment after segment, for
    each field, on the first segment's device."""
    dev = padded[segments[0][0]].x.device
    rows = []
    for f in fields:
        parts = [_bits(padded[b][f]).view(-1, padded[b][f].shape[-1]).index_select(0, cl).to(dev)
                 for b, cl in segments]
        rows.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return torch.stack(rows)


def unpack_ring(padded: Sequence[ParticleState], segments, fields: Sequence[int],
                msg: torch.Tensor) -> None:
    """Write a message of ``pack_ring``'s layout into the ring cells that
    ``segments`` name, in place, each field back in its own dtype."""
    start = 0
    for b, cl in segments:
        n = cl.numel()
        for i, f in enumerate(fields):
            dst = padded[b][f]
            part = msg[i, start:start + n].to(dst.device, non_blocking=True)
            dst.view(-1, dst.shape[-1]).index_copy_(0, cl, part.view(dst.dtype))
        start += n


def host_staged(device: torch.device) -> bool:
    """Whether messages of tensors on ``device`` go through host memory: a
    CUDA tensor under gloo, which sends CPU tensors only."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def to_host(msgs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Pinned host copies of CUDA messages, complete on return (gloo reads
    them as soon as they are handed over)."""
    host = []
    for m in msgs:
        h = torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
        h.copy_(m, non_blocking=True)
        host.append(h)
    if msgs:
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    return host


def _refresh_remote(padded: Sequence[ParticleState], plan: RingPlan,
                    fields: Sequence[int]) -> None:
    """The cross-process part of ``refresh_ring``: one message to and one
    from every neighbour rank, in one ``batch_isend_irecv``."""
    t0 = time.perf_counter()
    dev = padded[0].x.device
    staged = host_staged(dev)
    cap = padded[0].x.shape[-1]
    out = [pack_ring(padded, segs, fields) for _, segs in plan.sends]
    if staged:
        out = to_host(out)
    t1 = time.perf_counter()
    inbox = [torch.empty((len(fields), n, cap), dtype=torch.int32,
                         device="cpu" if staged else dev, pin_memory=staged)
             for _, n, _ in plan.recvs]
    ops = [dist.P2POp(dist.isend, m, peer) for (peer, _), m in zip(plan.sends, out)]
    ops += [dist.P2POp(dist.irecv, m, peer) for (peer, _, _), m in zip(plan.recvs, inbox)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    t2 = time.perf_counter()
    for (_, _, segs), m in zip(plan.recvs, inbox):
        unpack_ring(padded, segs, fields, m)
    EXCHANGE["messages"] += len(out)
    EXCHANGE["bytes"] += sum(m.numel() * 4 for m in out)
    EXCHANGE["stage_s"] += t1 - t0
    EXCHANGE["comm_s"] += t2 - t1
    EXCHANGE["seconds"] += time.perf_counter() - t0


def refresh_ring(padded: Sequence[ParticleState], plan: RingPlan,
                 fields: Sequence[int] = ALL_FIELDS) -> None:
    """Write the neighbours' current edge buckets into the rings of the
    padded blocks, in place, for the given fields. Rings read only
    interiors, so the pairs may run in any order; cells from other
    processes arrive by ``_refresh_remote``."""
    for bd, bs, dst_cells, src_cells in plan.pairs:
        for f in fields:
            dst, src = padded[bd][f], padded[bs][f]
            cap = dst.shape[-1]
            moved = src.view(-1, cap).index_select(0, src_cells)
            dst.view(-1, cap).index_copy_(0, dst_cells, moved.to(dst.device, non_blocking=True))
    if plan.sends or plan.recvs:
        _refresh_remote(padded, plan, fields)


def exchange_halo(blocks: Sequence[ParticleState], mesh: DeviceMesh) -> list[ParticleState]:
    """(n, LY, LX, CAP) blocks -> (n, LY+2, LX+2, CAP) blocks whose rings
    hold the neighbour shards' edge buckets, corners included, and
    tombstones where the mesh ends."""
    ly, lx = blocks[0].x.shape[-3:-1]
    padded = [pad_tombstone_halo(b) for b in blocks]
    refresh_ring(padded, ring_plan(mesh, ly, lx))
    return padded


# ---------------------------------------------------------------------------
# sharded frame
# ---------------------------------------------------------------------------

def make_sharded_frame_fn(cfg: GridConfig, mesh: DeviceMesh):
    """The sharded frame runner for a grid config and mesh:
    ``fn(blocks, params, steps) -> blocks``, where ``blocks`` is what
    ``shard_state`` returns (rows padded to the mesh; this process's blocks)
    and ``params`` holds one (10,) f32 params vector per block, on the
    block's device. The kernels launch for blocks on CUDA devices, the plain
    versions run for blocks on the CPU (``ops/bucket_cuda.py``). Over
    several processes every process calls it at the same point with the
    same ``steps``."""
    nx = mesh.shape[1]
    if cfg.bx % nx:
        raise ValueError(f"grid bx={cfg.bx} is not divisible by the mesh's nx={nx}")

    def frame(blocks, params, steps: int):
        ly, lx = blocks[0].x.shape[-3:-1]
        plan = ring_plan(mesh, ly, lx)

        def step(padded):
            out = [bucket_step_halo_cuda(b, p) for b, p in zip(padded, params)]
            refresh_ring(out, plan, POS_FIELDS)
            EXCHANGE["steps"] += 1
            return out

        def move(padded):
            refresh_ring(padded, plan, VEL_FIELDS)
            moved = [bucket_move_halo_cuda(b, cfg.bx_log2, cfg.by_log2, off)
                     for b, off in zip(padded, plan.offsets)]
            return exchange_halo(moved, mesh)

        padded = chunked_frame_schedule(exchange_halo(blocks, mesh), steps, cfg.move_every,
                                        step, move)
        return tuple(ParticleState(*(a.contiguous() for a in interior(b))) for b in padded)

    return frame
