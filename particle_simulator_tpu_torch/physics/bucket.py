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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu_torch.engine.state import ParticleState, empty_state
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
# 3x3 neighbourhood
# ---------------------------------------------------------------------------

def _pad_grid(a: torch.Tensor, fill) -> torch.Tensor:
    """One halo ring of ``fill`` buckets around the (BY, BX, CAP) grid."""
    by, bx, cap = a.shape
    out = torch.full((by + 2, bx + 2, cap), fill, dtype=a.dtype, device=a.device)
    out[1:-1, 1:-1] = a
    return out


def gather_neighborhood(state: ParticleState) -> ParticleState:
    """(BY, BX, CAP) -> (BY, BX, 9*CAP): the 3x3 neighbour buckets of every
    bucket, blocks in (dy, dx) order with slots ascending; neighbours outside
    the grid are tombstones (no periodic wrap)."""
    by, bx, _ = state.x.shape
    fills = (0, 0, 0.0, 0.0, -1)
    out = []
    for a, fill in zip(state, fills):
        p = _pad_grid(a, fill)
        out.append(torch.cat(
            [p[dy:dy + by, dx:dx + bx] for dy in (0, 1, 2) for dx in (0, 1, 2)],
            dim=-1,
        ))
    return ParticleState(*out)


def _self_pair_mask(cap: int, device) -> torch.Tensor:
    """(CAP, 9*CAP) mask of i == j pairs: block 4 of the stack is the bucket
    itself."""
    mask = torch.zeros((cap, 9 * cap), dtype=torch.bool, device=device)
    mask[:, 4 * cap:5 * cap] = torch.eye(cap, dtype=torch.bool, device=device)
    return mask


# ---------------------------------------------------------------------------
# step, dest, place
# ---------------------------------------------------------------------------

def bucket_step(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step over the (BY, BX, CAP) grid: cursor + wall + 3x3
    neighbourhood Mie forces, then leapfrog. ``ty`` passes through."""
    nbr = gather_neighborhood(state)
    fx, fy = external_forces(state, params)
    # pair forces add onto the external ones, candidates in the stack's
    # order: the kernel's per-thread summation order
    fx, fy = pair_force_accum(
        state.x, state.y, nbr.x, nbr.y, nbr.ty, params,
        exclude=_self_pair_mask(state.x.shape[-1], state.x.device), fx=fx, fy=fy,
    )
    nx, ny, nvx, nvy = leapfrog_apply(
        state.x, state.y, state.vx, state.vy, state.ty, fx, fy, params
    )
    return ParticleState(nx, ny, nvx, nvy, state.ty)


def _shift_pad(a: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """``a`` shifted by (+sy, +sx) with zero fill: out[y, x] = a[y-sy, x-sx]."""
    by, bx = a.shape
    out = torch.zeros_like(a)
    out[max(sy, 0):by + min(sy, 0), max(sx, 0):bx + min(sx, 0)] = (
        a[max(-sy, 0):by + min(-sy, 0), max(-sx, 0):bx + min(-sx, 0)]
    )
    return out


def move_dest_direct(state: ParticleState) -> torch.Tensor:
    """Destination slot of every source slot under the pull order, as a
    (BY, BX, CAP) int32 tensor: ``(tgt_by*BX + tgt_bx)*CAP + rank``, or -1
    for a dead particle, a drift of more than one bucket, or overflow
    (rank >= CAP).

    The rank of p in its target bucket T follows T's scan: source buckets
    T + (dy, dx) with dy outer and dx inner, from -1 to 1, slots ascending.
    So rank(p) = the particles of earlier scan blocks that target T plus the
    earlier slots of p's own source bucket that target T."""
    by, bx, cap = state.x.shape
    bx_log2, by_log2 = grid_log2(state)
    dev = state.x.device
    tgt_bx = bucket_of(state.x, bx_log2)
    tgt_by = bucket_of(state.y, by_log2)
    dy = torch.arange(by, dtype=torch.int32, device=dev)[:, None, None] - tgt_by
    dx = torch.arange(bx, dtype=torch.int32, device=dev)[None, :, None] - tgt_bx
    pullable = (state.ty >= 0) & (dy.abs() <= 1) & (dx.abs() <= 1)

    rank = torch.zeros((by, bx, cap), dtype=torch.int32, device=dev)
    block_prefix = torch.zeros((by, bx), dtype=torch.int32, device=dev)  # per target
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        mk = (pullable & (dy == dyk) & (dx == dxk)).to(torch.int32)
        inc = torch.cumsum(mk, dim=-1, dtype=torch.int32)
        # the target of a block-k particle at cell C is C - (dyk, dxk)
        at_cell = _shift_pad(block_prefix, dyk, dxk)
        rank = rank + mk * (at_cell[..., None] + inc - mk)
        block_prefix = block_prefix + _shift_pad(inc[..., -1], -dyk, -dxk)

    keep = pullable & (rank < cap)
    dest = (tgt_by * bx + tgt_bx) * cap + rank
    return torch.where(keep, dest, -1).to(torch.int32)


def bucket_place(state: ParticleState, destid: torch.Tensor) -> ParticleState:
    """Move each kept particle's five fields to its ``destid`` slot; every
    other slot becomes a tombstone (x = y = 0, v = 0, ty = -1). Destination
    ids are unique, so the result does not depend on write order."""
    shape = state.x.shape
    out = empty_state((state.capacity,), state.x.device)
    src = destid.reshape(-1) >= 0
    dst = destid.reshape(-1)[src].long()
    for o, a in zip(out, state):
        o[dst] = a.reshape(-1)[src]
    return out.reshape(shape)


def bucket_move_direct(state: ParticleState) -> ParticleState:
    """The rebucket pass: ``move_dest_direct`` then ``bucket_place``."""
    return bucket_place(state, move_dest_direct(state))


# ---------------------------------------------------------------------------
# frame schedule
# ---------------------------------------------------------------------------

def chunked_frame_schedule(
    state: ParticleState,
    steps: int,
    move_every: int,
    step: Callable[[ParticleState], ParticleState],
    move: Callable[[ParticleState], ParticleState],
) -> ParticleState:
    """``steps`` physics steps with ``move`` before steps 1, 1+k, 1+2k, ...
    (k = ``move_every``): one step, then chunks of (move, <= k steps)."""
    if steps < 1:
        return state
    state = step(state)
    done = 1
    while done < steps:
        state = move(state)
        for _ in range(min(move_every, steps - done)):
            state = step(state)
        done += min(move_every, steps - done)
    return state


def run_frame_bucket(state: ParticleState, params: torch.Tensor, steps: int,
                     move_every: int = 16) -> ParticleState:
    """One frame of ``steps`` bucket steps with a rebucket pass every
    ``move_every`` steps, through the plain versions."""
    return chunked_frame_schedule(
        state, steps, move_every,
        lambda s: bucket_step(s, params), bucket_move_direct,
    )
