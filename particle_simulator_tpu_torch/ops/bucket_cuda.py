"""Wrappers of the three bucket-grid CUDA kernels.

Counterpart of ``particle_simulator_tpu/ops/bucket_pallas.py``:

- ``bucket_step_cuda``  -> ``csrc/bucket_step.cu``  (``_step_kernel``)
- ``move_dest_cuda``    -> ``csrc/bucket_dest.cu``  (``_dest_kernel``)
- ``bucket_place_cuda`` -> ``csrc/bucket_place.cu`` (``_place_kernel``)
- ``bucket_move_cuda`` = dest then place; ``run_frame_bucket_cuda`` = the
  frame schedule over step and move;
- the halo modes, which the sharded frame (``parallel/domain.py``) runs on a
  stack of halo-padded shards (..., LY+2, LX+2, CAP):
  ``bucket_step_halo_cuda``  -> ``csrc/bucket_step.cu`` with ``ring = 1``
  (the step of ``bucket_step_pallas(edge_rows=..., halo_cols=...)``),
  ``move_dest_halo_cuda``    -> ``csrc/bucket_dest.cu`` with ``ring = 1``
  (``_dest_kernel(halo=True)``), ``bucket_place_halo_cuda`` ->
  ``csrc/bucket_place.cu`` into the interior (``_place_edge_kernel``), and
  ``bucket_move_halo_cuda`` = dest then place;
- the ext-layout step, which a lane-chunked frame runs with ``ext_io``
  (``run_frame_bucket_pallas``'s ext branch): ``bucket_step_ext_cuda`` ->
  ``csrc/bucket_step.cu``'s tile-scheduled instance, ``compact=True``
  (``_step_kernel_compact``, live tiles only) or ``compact=False``
  (``_step_kernel`` with ``out_off=0``, every tile).

Every step kernel is the same block-level design (``csrc/bucket_stage.cuh``):
a block stages a sub-tile's live candidates compacted in shared memory and
gives its threads to the live receivers only; the dest kernel stages a
sub-tile plus one ring too and adds each target bucket's nine source counts
once. Both keep the plain versions' orders, so they agree with them to the
bit.

Each wrapper checks dtype, shape, contiguity and device. A state on the CPU
goes to the plain PyTorch version in ``physics/bucket.py``; a state on a
CUDA device launches the kernel on ``torch.cuda.current_stream()``; any other
device raises. Outputs are allocated fresh on every call, or, for the
ext-layout step, are the spare buffer of a pair the frame allocated for its
move chunk, so a state a readback still holds is never overwritten.
``LAUNCHES`` counts kernel launches per kernel, and only those.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from particle_simulator_tpu_torch.engine.state import NPARAMS, ParticleState
from particle_simulator_tpu_torch.physics import bucket

LAUNCHES = {"step": 0, "dest": 0, "place": 0,
            "step_halo": 0, "dest_halo": 0, "place_halo": 0,
            "step_ext": 0, "step_compact": 0}

# blocks (of 256 threads, one sub-tile of a tile each) of one ext-layout step
# launch per SM of the card (ps_bucket_step_tiles); 16 to 64 time alike on the
# H100, fewer leave the tile walk too few walkers
TILE_BLOCKS_PER_SM = 64

_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32)


def check_fields(state: ParticleState) -> bool:
    """Validate the five fields' dtypes, shapes, devices and contiguity;
    True for CUDA, False for the CPU, and raise for any other device."""
    shape, device = state.x.shape, state.x.device
    for name, a, dtype in zip(ParticleState._fields, state, _DTYPES):
        if a.dtype != dtype:
            raise TypeError(f"field {name}: expected {dtype}, got {a.dtype}")
        if a.shape != shape or a.device != device:
            raise ValueError(f"field {name}: shape/device {tuple(a.shape)}/{a.device} "
                             f"differ from x's {tuple(shape)}/{device}")
        if not a.is_contiguous():
            raise ValueError(f"field {name} is not contiguous")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: the kernels run on CUDA, "
                         "the plain versions on the CPU")
    return True


def _on_cuda(state: ParticleState) -> bool:
    """Validate a (BY, BX, CAP) state; True for CUDA, False for the CPU."""
    shape = state.x.shape
    if len(shape) != 3:
        raise ValueError(f"expected a (BY, BX, CAP) grid, got shape {tuple(shape)}")
    bucket.grid_log2(state)
    if shape[0] < 2 or shape[1] < 2:
        raise ValueError(f"grid must be at least 2x2 buckets, got {shape[0]}x{shape[1]}")
    if state.capacity >= 2**31:
        raise ValueError(f"{state.capacity} slots exceed the int32 slot ids")
    return check_fields(state)


def check_aux(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(name: str, *args) -> None:
    from particle_simulator_tpu_torch.ops.build import library

    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def bucket_step_cuda(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step (cursor, wall, 3x3 Mie pairs, leapfrog); ``params``
    is the (10,) f32 vector of ``SimParams.vector`` on the state's device."""
    on_cuda = _on_cuda(state)
    check_aux(params, "params", torch.float32, (NPARAMS,), state.x.device)
    if not on_cuda:
        return bucket.bucket_step(state, params)
    by, bx, cap = state.x.shape
    with torch.cuda.device(state.x.device):
        out = [torch.empty_like(a) for a in state[:4]]
        launch("ps_bucket_step", *(a.data_ptr() for a in state), params.data_ptr(),
               *(o.data_ptr() for o in out), 1, by, bx, cap, 0)
    LAUNCHES["step"] += 1
    return ParticleState(*out, state.ty)


def move_dest_cuda(state: ParticleState) -> torch.Tensor:
    """(BY, BX, CAP) int32 destination slot per source slot, -1 = dropped."""
    if not _on_cuda(state):
        return bucket.move_dest_direct(state)
    by, bx, cap = state.x.shape
    bx_log2, by_log2 = bucket.grid_log2(state)
    with torch.cuda.device(state.x.device):
        destid = torch.empty_like(state.ty)
        launch("ps_bucket_dest", state.x.data_ptr(), state.y.data_ptr(),
               state.ty.data_ptr(), None, destid.data_ptr(), 1, by, bx, cap,
               bx_log2, by_log2, 0)
    LAUNCHES["dest"] += 1
    return destid


def bucket_place_cuda(state: ParticleState, destid: torch.Tensor) -> ParticleState:
    """Move kept particles to their ``destid`` slots, tombstone the rest."""
    on_cuda = _on_cuda(state)
    check_aux(destid, "destid", torch.int32, state.x.shape, state.x.device)
    if not on_cuda:
        return bucket.bucket_place(state, destid)
    with torch.cuda.device(state.x.device):
        out = [torch.empty_like(a) for a in state]
        launch("ps_bucket_place", *(a.data_ptr() for a in state), destid.data_ptr(),
               *(o.data_ptr() for o in out), 1, state.capacity, state.capacity)
    LAUNCHES["place"] += 1
    return ParticleState(*out)


def bucket_move_cuda(state: ParticleState) -> ParticleState:
    """The rebucket pass: dest kernel, then place kernel."""
    return bucket_place_cuda(state, move_dest_cuda(state))


class ExtPair(NamedTuple):
    """The two buffers a move chunk's ext-layout steps run between: ``cur``
    is the chunk's state, ``spare`` the buffer the next step writes (its x,
    y, vx, vy; its ty is ``cur``'s, which no step writes). Both hold the
    same bytes on every slot no step of the chunk writes: every tombstone,
    so every dead tile."""

    cur: ParticleState
    spare: ParticleState


def ext_pair(state: ParticleState) -> ExtPair:
    """A fresh pair for ``state``: two copies of its x, y, vx, vy, never
    its own buffers (a readback may hold them), sharing its ty."""
    def copy():
        return ParticleState(*(a.clone() for a in state[:4]), state.ty)

    return ExtPair(copy(), copy())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bucket_step_ext_cuda(pair, aux: bucket.ExtStepAux, compact: bool):
    """One ext-layout step (``bucket_step_pallas_ext``) over the tiles of
    ``aux`` (``physics/bucket.py:ext_step_aux`` of the chunk's state):
    ``compact`` visits the live tiles only, else every tile. ``pair`` is an
    ``ExtPair``, and the result the pair after the step (the stepped state
    in ``cur``, the input's buffers as the spare); a ``ParticleState`` is
    stepped through a fresh pair and the stepped state returned."""
    if isinstance(pair, ParticleState):
        return bucket_step_ext_cuda(ext_pair(pair), aux, compact).cur
    cur, spare = pair
    on_cuda = _on_cuda(cur)
    check_fields(spare)
    if spare.x.shape != cur.x.shape or spare.x.device != cur.x.device:
        raise ValueError(f"spare buffers {tuple(spare.x.shape)} on {spare.x.device} differ "
                         f"from the state's {tuple(cur.x.shape)} on {cur.x.device}")
    if any(a.data_ptr() == b.data_ptr() for a in cur[:4] for b in spare[:4]):
        raise ValueError("the spare buffers share memory with the state")
    by, bx, cap = cur.x.shape
    if aux.lane_chunks < 1 or bx % aux.lane_chunks or by % aux.ty_rows:
        raise ValueError(f"tiles of {aux.ty_rows} rows x {aux.lane_chunks} chunks do not "
                         f"divide a {by}x{bx} grid")
    n_tiles = by // aux.ty_rows * aux.lane_chunks
    device = cur.x.device
    check_aux(aux.params, "params", torch.float32, (NPARAMS + 1,), device)
    for name in ("flags", "order"):
        check_aux(getattr(aux, name), name, torch.int32, (n_tiles,), device)
    check_aux(aux.sizes, "sizes", torch.int32, (1,), device)
    if not on_cuda:
        return ExtPair(bucket.bucket_step_ext(cur, aux, compact), cur)
    with torch.cuda.device(device):
        budget = TILE_BLOCKS_PER_SM * _sm_count(torch.cuda.current_device())
        launch("ps_bucket_step_tiles", *(a.data_ptr() for a in cur),
               *(t.data_ptr() for t in aux[:4]), *(o.data_ptr() for o in spare[:4]),
               by, bx, cap, aux.ty_rows, aux.lane_chunks, int(compact), budget)
    LAUNCHES["step_compact" if compact else "step_ext"] += 1
    return ExtPair(ParticleState(*spare[:4], cur.ty), cur)


def run_frame_bucket_cuda(state: ParticleState, params: torch.Tensor, steps: int,
                          move_every: int = 16, lane_chunks: int = 1, ext_io: bool = False,
                          compact_tiles: bool = True,
                          block_rows: int | None = None) -> ParticleState:
    """One frame: ``steps`` kernel steps, rebucketing before steps 1, 1+k, ...
    (``physics/bucket.py:chunked_frame_schedule``). ``steps`` is a plain int,
    so a live steps-per-frame edit changes nothing but the loop count.

    With ``ext_io`` and ``lane_chunks`` > 1, the ext-layout frame
    (``run_frame_bucket_pallas``'s ext branch): each run of steps enters by
    computing the tile aux (``lane_chunks`` chunks, tiles of ``block_rows``
    rows where they fit) and a fresh buffer pair, steps with the
    tile-scheduled kernel (live tiles only with ``compact_tiles``), and
    exits with the current buffer. The rebucket is the classic one.
    Otherwise every step is the classic step."""
    if ext_io and lane_chunks > 1:
        def enter(s):
            return ext_pair(s), bucket.ext_step_aux(s, params, lane_chunks, block_rows)

        def step(carry):
            pair, aux = carry
            return bucket_step_ext_cuda(pair, aux, compact_tiles), aux

        return bucket.chunked_frame_schedule(
            state, steps, move_every, step, bucket_move_cuda,
            enter=enter, exit=lambda carry: carry[0].cur,
        )
    return bucket.chunked_frame_schedule(
        state, steps, move_every, lambda s: bucket_step_cuda(s, params), bucket_move_cuda,
    )


def _halo_grids(padded: ParticleState, bx_log2: int | None = None,
                by_log2: int | None = None) -> tuple[bool, int, int, int, int]:
    """Validate a stack of halo-padded shards (..., LY+2, LX+2, CAP); return
    (on CUDA, number of shards, LY+2, LX+2, CAP)."""
    shape = padded.x.shape
    if len(shape) < 3 or shape[-3] < 3 or shape[-2] < 3:
        raise ValueError(f"expected halo-padded (..., LY+2, LX+2, CAP) shards, got "
                         f"shape {tuple(shape)}")
    if padded.capacity >= 2**31:
        raise ValueError(f"{padded.capacity} slots exceed the int32 slot ids")
    for log2 in (bx_log2, by_log2):
        if log2 is not None and not 1 <= log2 <= 31:
            raise ValueError(f"grid log2 {log2} outside [1, 31]")
    gy, gx, cap = shape[-3:]
    return check_fields(padded), padded.capacity // (gy * gx * cap), gy, gx, cap


def bucket_step_halo_cuda(padded: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step of the interior of every halo-padded shard; ring
    slots and tombstones pass through, ``ty`` is the input's tensor."""
    on_cuda, n, gy, gx, cap = _halo_grids(padded)
    check_aux(params, "params", torch.float32, (NPARAMS,), padded.x.device)
    if not on_cuda:
        return bucket.bucket_step_halo(padded, params)
    with torch.cuda.device(padded.x.device):
        out = [torch.empty_like(a) for a in padded[:4]]
        launch("ps_bucket_step", *(a.data_ptr() for a in padded), params.data_ptr(),
               *(o.data_ptr() for o in out), n, gy, gx, cap, 1)
    LAUNCHES["step_halo"] += 1
    return ParticleState(*out, padded.ty)


def move_dest_halo_cuda(padded: ParticleState, bx_log2: int, by_log2: int,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Interior-numbered destination slot of every slot of every
    halo-padded shard, -1 = dropped; ``bx_log2``/``by_log2`` describe the
    global grid, ``offsets`` is int32 (..., 2): each shard's global
    (row, column) bucket offsets."""
    on_cuda, n, gy, gx, cap = _halo_grids(padded, bx_log2, by_log2)
    check_aux(offsets, "offsets", torch.int32, (*padded.x.shape[:-3], 2), padded.x.device)
    if not on_cuda:
        return bucket.move_dest_direct_halo(padded, bx_log2, by_log2, offsets)
    with torch.cuda.device(padded.x.device):
        destid = torch.empty_like(padded.ty)
        launch("ps_bucket_dest", padded.x.data_ptr(), padded.y.data_ptr(),
               padded.ty.data_ptr(), offsets.data_ptr(), destid.data_ptr(), n, gy, gx, cap,
               bx_log2, by_log2, 1)
    LAUNCHES["dest_halo"] += 1
    return destid


def bucket_place_halo_cuda(padded: ParticleState, destid: torch.Tensor) -> ParticleState:
    """Move the kept slots of every halo-padded shard, ring included, to
    their ``destid`` slots of the shard's (..., LY, LX, CAP) interior;
    tombstone the rest."""
    on_cuda, n, gy, gx, cap = _halo_grids(padded)
    check_aux(destid, "destid", torch.int32, padded.x.shape, padded.x.device)
    if not on_cuda:
        return bucket.bucket_place_halo(padded, destid)
    shape = (*padded.x.shape[:-3], gy - 2, gx - 2, cap)
    with torch.cuda.device(padded.x.device):
        out = [torch.empty(shape, dtype=a.dtype, device=a.device) for a in padded]
        launch("ps_bucket_place", *(a.data_ptr() for a in padded), destid.data_ptr(),
               *(o.data_ptr() for o in out), n, gy * gx * cap, (gy - 2) * (gx - 2) * cap)
    LAUNCHES["place_halo"] += 1
    return ParticleState(*out)


def bucket_move_halo_cuda(padded: ParticleState, bx_log2: int, by_log2: int,
                          offsets: torch.Tensor) -> ParticleState:
    """The shard-local rebucket and migration pass: halo dest, then halo
    place, (..., LY+2, LX+2, CAP) -> (..., LY, LX, CAP)."""
    return bucket_place_halo_cuda(padded, move_dest_halo_cuda(padded, bx_log2, by_log2, offsets))
