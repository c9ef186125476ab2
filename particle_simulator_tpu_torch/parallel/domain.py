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

Not ported, because they are TPU mechanisms: the halo-column refresh forms
(``dus``/``select``/``refs``, ``PS_SHARD_REFRESH``), the x-padded lane
layout (``pad_x_state``, ``refresh_x_cols``, ``ship_edge_rows``,
``exchange_halo_x_rows``), ``x_pad_for_chunks`` and lane chunks, and the
``ty + 1`` encoding that turns ``ppermute``'s zero fill into tombstones.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

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
    ``devices[iy][ix]``. ``blocks`` lists each distinct device with the
    shard ids (iy * nx + ix) it holds, in order of first appearance."""

    __slots__ = ("devices", "shape", "blocks")

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs a non-empty rectangle of devices, got {devices}")
        self.devices = rows
        self.shape = (len(rows), len(rows[0]))
        blocks: dict[torch.device, list[int]] = {}
        for s, dev in enumerate(self.flat):
            blocks.setdefault(dev, []).append(s)
        self.blocks = tuple((dev, tuple(ids)) for dev, ids in blocks.items())

    @property
    def flat(self) -> tuple[torch.device, ...]:
        return tuple(d for row in self.devices for d in row)

    @property
    def device_type(self) -> str:
        kinds = {d.type for d in self.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
        return kinds.pop()

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape[0]}x{self.shape[1]}: {[str(d) for d in self.flat]})"


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
    (n, BY/ny, BX/nx, CAP) per distinct device, on that device, its shards
    in the order of ``mesh.blocks``."""
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
    the mesh's first device."""
    ny, nx = mesh.shape
    dev0 = mesh.devices[0][0]
    ly, lx, cap = blocks[0].x.shape[-3:]
    order = [s for _, ids in mesh.blocks for s in ids]
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
    """Where every ring cell of every shard comes from, for one mesh and
    shard shape. ``pairs`` holds (destination block, source block,
    destination cells, source cells): int64 indices into the blocks' (cells,
    CAP) views, on the respective devices. ``offsets`` holds each block's
    int32 (n, 2) global (row, column) bucket offsets of its shards."""

    pairs: tuple[tuple[int, int, torch.Tensor, torch.Tensor], ...]
    offsets: tuple[torch.Tensor, ...]


@functools.lru_cache(maxsize=16)
def ring_plan(mesh: DeviceMesh, ly: int, lx: int) -> RingPlan:
    """The ``RingPlan`` of (LY, LX) shards on ``mesh``."""
    ny, nx = mesh.shape
    py, px = ly + 2, lx + 2
    where = {s: (bi, pos) for bi, (_, ids) in enumerate(mesh.blocks) for pos, s in enumerate(ids)}
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
    for s in range(ny * nx):
        iy, ix = divmod(s, nx)
        for sy, sx in ((sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if sy or sx):
            ty_, tx_ = iy + sy, ix + sx
            if not (0 <= ty_ < ny and 0 <= tx_ < nx):
                continue  # no neighbour: the ring keeps its tombstones
            sel = (side_y == sy) & (side_x == sx)
            (bd, pd), (bs, ps) = where[s], where[ty_ * nx + tx_]
            dst, src = cells.setdefault((bd, bs), ([], []))
            dst.append(pd * py * px + r[sel] * px + c[sel])
            src.append(ps * py * px + src_r[sel] * px + src_c[sel])
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
    return RingPlan(pairs, offsets)


def refresh_ring(padded: Sequence[ParticleState], plan: RingPlan,
                 fields: Sequence[int] = ALL_FIELDS) -> None:
    """Write the neighbours' current edge buckets into the rings of the
    padded blocks, in place, for the given fields. Rings read only
    interiors, so the pairs may run in any order."""
    for bd, bs, dst_cells, src_cells in plan.pairs:
        for f in fields:
            dst, src = padded[bd][f], padded[bs][f]
            cap = dst.shape[-1]
            moved = src.view(-1, cap).index_select(0, src_cells)
            dst.view(-1, cap).index_copy_(0, dst_cells, moved.to(dst.device, non_blocking=True))


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
    ``shard_state`` returns (rows padded to the mesh) and ``params`` holds
    one (10,) f32 params vector per block, on the block's device. The
    kernels launch for blocks on CUDA devices, the plain versions run for
    blocks on the CPU (``ops/bucket_cuda.py``)."""
    nx = mesh.shape[1]
    if cfg.bx % nx:
        raise ValueError(f"grid bx={cfg.bx} is not divisible by the mesh's nx={nx}")

    def frame(blocks, params, steps: int):
        ly, lx = blocks[0].x.shape[-3:-1]
        plan = ring_plan(mesh, ly, lx)

        def step(padded):
            out = [bucket_step_halo_cuda(b, p) for b, p in zip(padded, params)]
            refresh_ring(out, plan, POS_FIELDS)
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
