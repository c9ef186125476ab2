"""MatrixBuckets path: the plain PyTorch versions of the three kernels.

Counterpart of ``particle_simulator_tpu/physics/bucket.py``. The box is a
``2^by_log2 x 2^bx_log2`` grid of ``cap``-slot buckets; a particle's bucket is
the top bits of its u32 coordinates; forces come from the 3x3 neighbouring
buckets; every ``move_every`` steps a pull-ordered rebucket pass keeps the
first ``cap`` particles each bucket pulls and drops the rest, and drops any
particle that drifted more than one bucket.

State lives as ``(BY, BX, CAP)`` tensors. These functions are what
``ops/bucket_cuda.py``'s wrappers run for CPU tensors and what
``chip_smoke.py`` holds the CUDA kernels against on the card:

- ``bucket_step``         <-> ``ops/csrc/bucket_step.cu``
- ``move_dest_direct``    <-> ``ops/csrc/bucket_dest.cu``
- ``bucket_place``        <-> ``ops/csrc/bucket_place.cu``

and their halo modes, which the sharded frame (``parallel/domain.py``) runs
on a shard padded with one ring of its neighbours' buckets:

- ``bucket_step_halo``      <-> ``bucket_step.cu`` with ``ring = 1``
- ``move_dest_direct_halo`` <-> ``bucket_dest.cu`` with ``ring = 1``
- ``bucket_place_halo``     <-> ``bucket_place.cu`` with an interior output

The single-device functions are the halo ones on a tombstone ring. The halo
functions take a stack of shards (leading axes) as well as one shard.

The ext-layout step, the step of a lane-chunked frame that the JAX package
runs on its persistent pad-extended layout, works on tiles of the plain
grid: ``ext_step_aux`` computes the per-tile liveness, the live-tiles-first
visit order and the occupancy bound once per move chunk, and

- ``bucket_step_ext`` <-> ``bucket_step.cu``'s tile-scheduled instance
  (``compact`` False: every tile in natural order; True: the live tiles
  only; ``bucket_step_ext_into`` writes the slots the kernel writes);
- ``ext_step_aux``    <-> ``bucket_tiles.cu``'s ``ps_tile_aux``;
- ``tile_retire``     <-> ``ps_tile_aux``'s retire, which lets the
  live-tile frame step a run in a buffer of an earlier run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu_torch.engine.state import NPARAMS, ParticleState, empty_state
from particle_simulator_tpu_torch.physics.mie import (
    bucket_of,
    leapfrog_apply,
    pair_force_accum,
)
from particle_simulator_tpu_torch.physics.step import external_forces


class GridConfig(NamedTuple):
    """Bucket grid shape and rebucket cadence."""

    bx_log2: int = 6
    by_log2: int = 6
    cap: int = 16
    move_every: int = 16  # rebucket cadence in steps

    @property
    def bx(self) -> int:
        return 1 << self.bx_log2

    @property
    def by(self) -> int:
        return 1 << self.by_log2

    @property
    def buckets(self) -> int:
        return self.bx * self.by

    @property
    def capacity(self) -> int:
        return self.buckets * self.cap

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.by, self.bx, self.cap)


REFERENCE_GRID = GridConfig(6, 6, 16)  # 65,536 particles — the reference's max


def grid_log2(state: ParticleState) -> tuple[int, int]:
    """(bx_log2, by_log2) of a (BY, BX, CAP) state; both sides must be powers
    of two, since bucket ids are coordinate top bits."""
    by, bx, _ = state.x.shape
    if by & (by - 1) or bx & (bx - 1):
        raise ValueError(f"grid sides must be powers of two, got {by}x{bx}")
    return bx.bit_length() - 1, by.bit_length() - 1


# ---------------------------------------------------------------------------
# host-side bucketize (scene prep)
# ---------------------------------------------------------------------------

def bucketize_numpy(parts: np.ndarray, cfg: GridConfig) -> np.ndarray:
    """Scatter a compact PARTICLE_DTYPE array into bucket layout: shape
    (buckets * cap,), slot b*cap+i holds the i-th particle of bucket b
    (row-major bucket id = bx + by*BX), tombstone-filled. Overflow past
    ``cap`` per bucket is dropped."""
    out = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    out["ty"] = -1

    live = parts[parts["ty"] >= 0]
    bx = live["x"] >> np.uint32(32 - cfg.bx_log2)
    by = live["y"] >> np.uint32(32 - cfg.by_log2)
    bucket = (bx + by * cfg.bx).astype(np.int64)

    order = np.argsort(bucket, kind="stable")
    bucket_sorted = bucket[order]
    starts = np.searchsorted(bucket_sorted, bucket_sorted)
    rank = np.arange(len(bucket_sorted)) - starts
    keep = rank < cfg.cap
    out[bucket_sorted[keep] * cfg.cap + rank[keep]] = live[order][keep]
    return out


def state_to_grid(state: ParticleState, cfg: GridConfig) -> ParticleState:
    return state.reshape(cfg.grid_shape)


# ---------------------------------------------------------------------------
# halo ring and 3x3 neighbourhood
# ---------------------------------------------------------------------------

TOMBSTONE = (0, 0, 0.0, 0.0, -1)  # x, y, vx, vy, ty of an empty slot


def _pad_grid(a: torch.Tensor, fill) -> torch.Tensor:
    """One ring of ``fill`` buckets around a (..., BY, BX, CAP) grid."""
    *lead, by, bx, cap = a.shape
    out = torch.full((*lead, by + 2, bx + 2, cap), fill, dtype=a.dtype, device=a.device)
    out[..., 1:-1, 1:-1, :] = a
    return out


def pad_tombstone_halo(state: ParticleState) -> ParticleState:
    """Single-device halo: (..., BY, BX, CAP) -> (..., BY+2, BX+2, CAP) with
    one ring of tombstone buckets. The sharded path fills the ring from the
    neighbour shards instead (``parallel/domain.py``); everything downstream
    is shared between the two."""
    return ParticleState(*(_pad_grid(a, fill) for a, fill in zip(state, TOMBSTONE)))


def interior(padded: ParticleState) -> ParticleState:
    """The (..., BY, BX, CAP) interior of a halo-padded grid (views)."""
    return ParticleState(*(a[..., 1:-1, 1:-1, :] for a in padded))


def stack9(padded: ParticleState) -> ParticleState:
    """(..., BY+2, BX+2, CAP) -> (..., BY, BX, 9*CAP): the 3x3 neighbour
    buckets of every interior bucket of a halo-padded grid, blocks in
    (dy, dx) order with slots ascending (the reference's scan order)."""
    by, bx = padded.x.shape[-3] - 2, padded.x.shape[-2] - 2
    return ParticleState(*(
        torch.cat([a[..., dy:dy + by, dx:dx + bx, :] for dy in (0, 1, 2) for dx in (0, 1, 2)],
                  dim=-1)
        for a in padded
    ))


def gather_neighborhood(state: ParticleState) -> ParticleState:
    """(BY, BX, CAP) -> (BY, BX, 9*CAP): the 3x3 neighbour buckets of every
    bucket; neighbours outside the grid are tombstones (no periodic wrap)."""
    return stack9(pad_tombstone_halo(state))


def _self_pair_mask(cap: int, device) -> torch.Tensor:
    """(CAP, 9*CAP) mask of i == j pairs: block 4 of the stack is the bucket
    itself."""
    mask = torch.zeros((cap, 9 * cap), dtype=torch.bool, device=device)
    mask[:, 4 * cap:5 * cap] = torch.eye(cap, dtype=torch.bool, device=device)
    return mask


# ---------------------------------------------------------------------------
# step, dest, place
# ---------------------------------------------------------------------------

def bucket_step_halo(padded: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step of a halo-padded (..., BY+2, BX+2, CAP) grid: every
    live interior slot feels the cursor, the walls and the Mie pairs of its
    3x3 neighbourhood (ring included), then leapfrogs. Every other slot (the
    ring, tombstones) passes through, and ``ty`` is the input's tensor.
    Candidates are added one at a time in the stack's order, the kernel's
    per-thread order. The counterpart of the JAX ``bucket_step_nbr``."""
    # contiguous receivers: the same element layout as an unpadded grid
    inner = ParticleState(*(a.contiguous() for a in interior(padded)))
    nbr = stack9(padded)
    fx, fy = external_forces(inner, params)
    fx, fy = pair_force_accum(
        inner.x, inner.y, nbr.x, nbr.y, nbr.ty, params,
        exclude=_self_pair_mask(inner.x.shape[-1], inner.x.device), fx=fx, fy=fy,
    )
    stepped = leapfrog_apply(*inner, fx, fy, params)
    out = []
    for a, s in zip(padded[:4], stepped):
        a = a.clone()
        a[..., 1:-1, 1:-1, :] = s
        out.append(a)
    return ParticleState(*out, padded.ty)


def bucket_step(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step over the (BY, BX, CAP) grid: the halo step on a
    tombstone ring. ``ty`` passes through."""
    out = interior(bucket_step_halo(pad_tombstone_halo(state), params))
    return ParticleState(*(a.contiguous() for a in out[:4]), state.ty)


def _shift_pad(a: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """``a`` (..., BY, BX) shifted by (+sy, +sx) with zero fill:
    out[..., y, x] = a[..., y-sy, x-sx]."""
    by, bx = a.shape[-2:]
    out = torch.zeros_like(a)
    out[..., max(sy, 0):by + min(sy, 0), max(sx, 0):bx + min(sx, 0)] = (
        a[..., max(-sy, 0):by + min(-sy, 0), max(-sx, 0):bx + min(-sx, 0)]
    )
    return out


def move_dest_direct_halo(padded: ParticleState, bx_log2: int, by_log2: int,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Destination slot of every slot of a halo-padded (..., LY+2, LX+2, CAP)
    shard under the pull order, as an int32 tensor of the same shape:
    ``(tgt_by*LX + tgt_bx)*CAP + rank`` in the shard's interior numbering,
    or -1. The counterpart of the JAX ``move_ranks_direct_halo`` composed
    as in ``bucket_move_direct_halo``.

    A slot's target is the top ``by_log2``/``bx_log2`` bits of its
    coordinates (the global grid's) minus the shard's global bucket
    offsets, ``offsets`` = int32 (..., 2) of (row, column). The slot is kept
    when it is live, targets an interior bucket, lies within one bucket of
    it, and ranks below CAP. Ring slots get ids too: the place pulls the
    neighbours' particles that migrate in.

    The rank of p in its target bucket T follows T's scan: source buckets
    T + (dy, dx) with dy outer and dx inner, from -1 to 1, slots ascending.
    So rank(p) = the particles of earlier scan blocks that target T plus the
    earlier slots of p's own source bucket that target T."""
    *_, py, px, cap = padded.x.shape
    ly, lx = py - 2, px - 2
    dev = padded.x.device
    offsets = offsets.to(torch.int32)
    tgt_by = bucket_of(padded.y, by_log2) - offsets[..., 0, None, None, None]
    tgt_bx = bucket_of(padded.x, bx_log2) - offsets[..., 1, None, None, None]
    dy = torch.arange(-1, py - 1, dtype=torch.int32, device=dev)[:, None, None] - tgt_by
    dx = torch.arange(-1, px - 1, dtype=torch.int32, device=dev)[None, :, None] - tgt_bx
    pullable = ((padded.ty >= 0) & (tgt_by >= 0) & (tgt_by < ly) & (tgt_bx >= 0)
                & (tgt_bx < lx) & (dy.abs() <= 1) & (dx.abs() <= 1))

    rank = torch.zeros(padded.x.shape, dtype=torch.int32, device=dev)
    # per target cell, in padded coordinates
    block_prefix = torch.zeros(padded.x.shape[:-1], dtype=torch.int32, device=dev)
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        mk = (pullable & (dy == dyk) & (dx == dxk)).to(torch.int32)
        inc = torch.cumsum(mk, dim=-1, dtype=torch.int32)
        # the target of a block-k particle at cell C is C - (dyk, dxk)
        at_cell = _shift_pad(block_prefix, dyk, dxk)
        rank = rank + mk * (at_cell[..., None] + inc - mk)
        block_prefix = block_prefix + _shift_pad(inc[..., -1], -dyk, -dxk)

    keep = pullable & (rank < cap)
    dest = (tgt_by * lx + tgt_bx) * cap + rank
    return torch.where(keep, dest, -1).to(torch.int32)


def move_dest_direct(state: ParticleState) -> torch.Tensor:
    """Destination slot of every source slot of the (BY, BX, CAP) grid, as
    an int32 tensor of its shape: ``(tgt_by*BX + tgt_bx)*CAP + rank``, or -1
    for a dead particle, a drift of more than one bucket, or overflow
    (rank >= CAP). The halo dest on a tombstone ring at offset (0, 0)."""
    bx_log2, by_log2 = grid_log2(state)
    zero = torch.zeros(2, dtype=torch.int32, device=state.x.device)
    dest = move_dest_direct_halo(pad_tombstone_halo(state), bx_log2, by_log2, zero)
    return dest[1:-1, 1:-1].contiguous()


def _place(state: ParticleState, destid: torch.Tensor, out_grid) -> ParticleState:
    """Move each kept slot's five fields of every (..., PY, PX, CAP) grid of
    ``state`` to slot ``destid`` of that grid's ``out_grid``-shaped output;
    every other output slot becomes a tombstone (x = y = 0, v = 0,
    ty = -1). Destination ids are unique within a grid, so the result does
    not depend on write order."""
    lead = tuple(state.x.shape[:-3])
    n_src = int(np.prod(state.x.shape[-3:]))
    n_out = int(np.prod(out_grid))
    n_grids = int(np.prod(lead))
    dev = state.x.device
    out = empty_state((n_grids * n_out,), dev)
    d = destid.reshape(n_grids, n_src)
    src = d >= 0
    grid_base = torch.arange(n_grids, dtype=torch.int64, device=dev)[:, None] * n_out
    dst = (d.long() + grid_base)[src]
    for o, a in zip(out, state):
        o[dst] = a.reshape(n_grids, n_src)[src]
    return out.reshape((*lead, *out_grid))


def bucket_place(state: ParticleState, destid: torch.Tensor) -> ParticleState:
    """Move each kept particle's five fields to its ``destid`` slot of the
    (BY, BX, CAP) grid; every other slot becomes a tombstone."""
    return _place(state, destid, state.x.shape)


def bucket_place_halo(padded: ParticleState, destid: torch.Tensor) -> ParticleState:
    """The halo place: every kept slot of a (..., LY+2, LX+2, CAP) shard,
    ring included, moves to its interior-numbered ``destid`` slot of a
    (..., LY, LX, CAP) output; every other output slot is a tombstone."""
    *_, py, px, cap = padded.x.shape
    return _place(padded, destid, (py - 2, px - 2, cap))


def bucket_move_direct(state: ParticleState) -> ParticleState:
    """The rebucket pass: ``move_dest_direct`` then ``bucket_place``."""
    return bucket_place(state, move_dest_direct(state))


def bucket_move_direct_halo(padded: ParticleState, bx_log2: int, by_log2: int,
                            offsets: torch.Tensor) -> ParticleState:
    """The shard-local rebucket and migration pass: ``move_dest_direct_halo``
    then ``bucket_place_halo``, (..., LY+2, LX+2, CAP) -> (..., LY, LX, CAP)."""
    return bucket_place_halo(padded, move_dest_direct_halo(padded, bx_log2, by_log2, offsets))


# ---------------------------------------------------------------------------
# ext-layout step: tiles, their aux, and the plain version
# ---------------------------------------------------------------------------

class ExtStepAux(NamedTuple):
    """The ty-derived inputs of the ext-layout step, computed once per move
    chunk (ty does not change between rebucket passes). A tile is
    ``ty_rows`` bucket rows x ``BX / lane_chunks`` buckets; tile
    ``block * lane_chunks + chunk`` is row block ``block``, lane chunk
    ``chunk`` (the JAX package's numbering)."""

    params: torch.Tensor  # (11,) f32: SimParams.vector, then omax
    flags: torch.Tensor   # (n_tiles,) i32: 1 where the tile holds a live slot
    order: torch.Tensor   # (n_tiles,) i32: live tiles ascending, then the last one repeated
    sizes: torch.Tensor   # (1,) i32: max(live tiles, 1), the real visits of ``order``
    ty_rows: int
    lane_chunks: int
    bucket_max: torch.Tensor  # (BY, BX) i32: each bucket's largest live slot + 1


def _pick_ty_rows(by: int, lanes: int, requested: int | None = None) -> int:
    """Bucket rows per tile: ``requested`` where it divides ``by`` and fits
    the budget of ``max(8, 32768 // lanes)`` rows, else 16, else 8, else
    ``by`` (``lanes`` = BX * CAP). The JAX package's ``_pick_ty_rows``,
    unchanged, so both number the tiles alike."""
    budget = max(8, 32768 // lanes)
    candidates = (requested,) if requested else ()
    for ty in (*candidates, 16, 8):
        if ty and ty <= budget and by % ty == 0 and by >= ty:
            return ty
    return by


def ext_tiling(shape, lane_chunks: int, block_rows: int | None = None) -> tuple[int, int]:
    """(ty_rows, n_tiles) of the tiles of a (BY, BX, CAP) grid cut into
    ``lane_chunks`` chunks and tiles of ``block_rows`` rows where they fit
    (``_pick_ty_rows``)."""
    by, bx, cap = shape
    c = int(lane_chunks)
    if c < 1 or bx % c:
        raise ValueError(f"lane_chunks={lane_chunks} must divide bx={bx}")
    ty_rows = _pick_ty_rows(by, bx * cap, block_rows)
    return ty_rows, by // ty_rows * c


def ext_step_aux(state: ParticleState, params: torch.Tensor, lane_chunks: int,
                 block_rows: int | None = None) -> ExtStepAux:
    """The tile aux of a (BY, BX, CAP) state, on its device and without a
    host sync: ``omax`` (the largest live slot index + 1 over the grid)
    appended to ``params``, the tile flags, and the visit order, with an
    all-dead grid visiting tile 0 once (``sizes`` = [1]), and each bucket's
    largest live slot + 1. The plain version of ``ops/csrc/bucket_tiles.cu``'s
    ``ps_tile_aux``."""
    by, bx, cap = state.ty.shape
    c = int(lane_chunks)
    ty_rows, _ = ext_tiling(state.ty.shape, c, block_rows)
    n_blocks = by // ty_rows
    dev = state.ty.device
    slot_no = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
    bucket_max = torch.where(state.ty >= 0, slot_no, 0).amax(dim=-1)
    omax = bucket_max.amax()
    params = torch.cat([params[:NPARAMS], omax.to(torch.float32).reshape(1)])
    tiles = state.ty.reshape(n_blocks, ty_rows, c, (bx // c) * cap).amax(dim=(1, 3))
    live = (tiles >= 0).reshape(-1)
    n_real = live.sum(dtype=torch.int32).clamp(min=1).reshape(1)
    order0 = torch.argsort((~live).to(torch.int32), stable=True)
    last_live = order0[(n_real - 1).long()]
    idx = torch.arange(live.numel(), device=dev)
    order = torch.where(idx < n_real, order0, last_live).to(torch.int32)
    return ExtStepAux(params, live.to(torch.int32), order, n_real, ty_rows, c, bucket_max)


def _tile_slots(tiles: torch.Tensor, aux: ExtStepAux, shape) -> torch.Tensor:
    """A per-tile (n_tiles,) mask spread over the slots of a (BY, BX, CAP)
    grid, as a broadcastable (BY, BX, 1) mask."""
    by, bx, _ = shape
    c = aux.lane_chunks
    per_tile = tiles.reshape(by // aux.ty_rows, 1, c, 1)
    return per_tile.expand(-1, aux.ty_rows, -1, bx // c).reshape(by, bx, 1)


def _visited(aux: ExtStepAux, compact: bool) -> torch.Tensor:
    """(n_tiles,) bool: the live tiles the ext step visits."""
    if not compact:
        return aux.flags != 0
    first = torch.arange(aux.order.numel(), device=aux.order.device) < aux.sizes
    visits = torch.zeros_like(aux.flags).index_add_(0, aux.order.long(), first.to(torch.int32))
    return (visits > 0) & (aux.flags != 0)


def bucket_step_ext(state: ParticleState, aux: ExtStepAux, compact: bool) -> ParticleState:
    """The ext-layout step: ``bucket_step`` on the tiles the kernel visits,
    the input on the others. ``compact`` False visits the live tiles of the
    natural tile grid (a dead tile is copied through); True visits the
    first ``sizes[0]`` entries of ``order`` that are live. Either way the
    result equals ``bucket_step(state)`` bit for bit: a tile left alone
    holds only tombstones, which the step passes through, and the receivers
    of the others are stepped on the whole grid's element layout, as
    ``bucket_step`` steps them (no gather of live receivers)."""
    keep_new = _tile_slots(_visited(aux, compact), aux, state.ty.shape)
    stepped = bucket_step(state, aux.params[:NPARAMS])
    return ParticleState(*(torch.where(keep_new, s, a) for s, a in zip(stepped[:4], state[:4])),
                         state.ty)


def bucket_step_ext_into(state: ParticleState, aux: ExtStepAux, compact: bool,
                         out: ParticleState) -> None:
    """``bucket_step_ext`` written into ``out``'s x, y, vx, vy where the
    tile-scheduled kernel writes: with ``compact`` the live slots of the
    visited tiles only (every other slot of ``out`` keeps its bytes), else
    every slot."""
    stepped = bucket_step_ext(state, aux, compact)
    if compact:
        written = _tile_slots(_visited(aux, True), aux, state.ty.shape) & (state.ty >= 0)
        stepped = [torch.where(written, s, o) for s, o in zip(stepped[:4], out[:4])]
    for o, s in zip(out[:4], stepped[:4]):
        o.copy_(s)


def tile_retire(spare: ParticleState, ty: torch.Tensor, old: ExtStepAux) -> None:
    """Tombstone, in place, the x, y, vx, vy of ``spare`` on every slot that
    is dead in ``ty`` and lies below its bucket's ``old.bucket_max``. A
    buffer that holds tombstones wherever the ty of ``old`` was dead (the
    live-tile step wrote its live slots only) then holds them wherever
    ``ty`` is dead. The plain version of the retire that
    ``ops/csrc/bucket_tiles.cu``'s ``ps_tile_aux`` does beside the aux."""
    slot = torch.arange(ty.shape[-1], device=ty.device)
    stale = (slot < old.bucket_max[..., None]) & (ty < 0)
    for a in spare[:4]:
        a.masked_fill_(stale, 0)


# ---------------------------------------------------------------------------
# frame schedule
# ---------------------------------------------------------------------------

def frame_runs(steps: int, move_every: int) -> list[int]:
    """The runs of steps of a frame of ``steps`` steps: one step, then runs
    of at most ``move_every`` steps, a rebucket pass before each run but the
    first (so before steps 1, 1+k, 1+2k, ...)."""
    if steps < 1:
        return []
    return [1] + [min(move_every, steps - done) for done in range(1, steps, move_every)]


def chunked_frame_schedule(
    state: ParticleState,
    steps: int,
    move_every: int,
    step: Callable,
    move: Callable[[ParticleState], ParticleState],
) -> ParticleState:
    """``steps`` physics steps with ``move`` before each run of
    ``frame_runs`` but the first."""
    for i, run in enumerate(frame_runs(steps, move_every)):
        if i:
            state = move(state)
        for _ in range(run):
            state = step(state)
    return state


def run_frame_bucket(state: ParticleState, params: torch.Tensor, steps: int,
                     move_every: int = 16) -> ParticleState:
    """One frame of ``steps`` bucket steps with a rebucket pass every
    ``move_every`` steps, through the plain versions."""
    return chunked_frame_schedule(
        state, steps, move_every,
        lambda s: bucket_step(s, params), bucket_move_direct,
    )
