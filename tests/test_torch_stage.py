"""What the redesigned classic/halo step, live-tile step and dest kernels
rely on, held on the CPU by Python models of their block-level algorithms.

The CUDA kernels (``ops/csrc/bucket_step.cu:bucket_step_kernel<HALO>`` on
``bucket_stage.cuh``, ``ops/csrc/bucket_dest.cu``) run only on the card,
where ``chip_smoke.py`` holds them against the plain versions bit for bit.
Here a model of each walks the same sub-tiles with the same index
arithmetic and is held against the plain versions and the JAX package:

- the step: a block stages a sub-tile of receiver buckets plus one ring,
  compacts the live candidates in (row, bucket, slot) order, gives threads to
  the interior's live slots, adds three contiguous runs a receiver, copies
  the dead slots through and, in halo mode, the ring strips. Contract: every
  field and slot equal to ``bucket_step`` / ``bucket_step_halo`` (bit for
  bit), every output slot written exactly once; on a lattice scene inside the
  North star's step envelope of JAX's ``bucket_step_pallas`` (interpret mode;
  ty equal, x/y within 8 fixed-point units, live vx/vy within rtol 1e-4,
  atol 1e-6: f32 pair sums in another order);
- the dest: a block stages one code a slot for its sub-tile plus one ring
  (the scan block at which the slot's target meets its bucket where it is
  pullable, else -1), ranks each bucket's slots by scan block, adds each
  target's nine counts once in pull order, and writes the ids of the slots
  its targets pull and -1 to its own unpullable slots.
  Contract: integer ids equal to ``move_dest_direct`` /
  ``move_dest_direct_halo`` and to JAX's ``move_dest_pallas`` /
  ``move_dest_pallas_halo`` (interpret mode), every slot written exactly
  once, on scenes whose move drops particles by overflow and by drift;
- the live-tile step (``bucket_step_kernel_tiles<true>``): a block a
  sub-tile of a visit, the blocks of one sub-tile walking the visits of
  ``order`` below ``sizes[0]``, each region staged 16 bytes at a time where
  cap and omax allow. Contract: every sub-tile of every live tile visited
  once, every live slot written once and no other slot, and the stepped
  slots equal to ``bucket_step_ext`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.io.frame import Frame, MieParams, default_metadata
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.ops.bucket_pallas import (
    bucket_step_pallas,
    move_dest_pallas,
    move_dest_pallas_halo,
)
from particle_simulator_tpu_torch.engine.state import (
    ParticleState,
    SimParams,
    from_reference,
    state_from_numpy,
    to_reference,
)
from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu_torch.parallel import domain
from particle_simulator_tpu_torch.physics import bucket, mie
from particle_simulator_tpu_torch.physics.step import external_forces

import chip_smoke

torch.set_num_threads(2)

SUB = (8, 16)  # the kernels' sub-tile, TILE_SUB_ROWS x TILE_SUB_COLS


def step_params():
    meta = default_metadata()
    meta["step_dt"] = 10e-15
    return SimParams.from_record(meta).vector()


def stress_state():
    cfg = bucket.GridConfig(4, 4, 16)
    parts, meta = chip_smoke.stress_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    return state, SimParams.from_record(meta).vector(), cfg


def padded_shards(state: ParticleState, n: int) -> tuple[ParticleState, torch.Tensor]:
    """The stack of halo-padded shards of ``state`` on an ``n``-shard CPU
    mesh, and each shard's global (row, column) bucket offsets."""
    mesh = domain.make_mesh(devices=["cpu"] * n)
    (padded,) = domain.exchange_halo(
        domain.shard_state(domain.pad_rows_for_mesh(state, mesh)[0], mesh), mesh)
    (offsets,) = domain.ring_plan(mesh, padded.x.shape[1] - 2, padded.x.shape[2] - 2).offsets
    return padded, offsets


def sub_tiles(rows: int, cols: int, sub_r: int, sub_b: int):
    """(sy, sx, first row, first column, in_rows, in_cols, last_y, last_x)
    of every sub-tile of a rows x cols rectangle, the last ones cut."""
    subs_y, subs_x = -(-rows // sub_r), -(-cols // sub_b)
    for sy in range(subs_y):
        for sx in range(subs_x):
            yield (sy, sx, sy * sub_r, sx * sub_b, min(sub_r, rows - sy * sub_r),
                   min(sub_b, cols - sx * sub_b), sy == subs_y - 1, sx == subs_x - 1)


# ---------------------------------------------------------------------------
# the staged step
# ---------------------------------------------------------------------------

def staged_subtile_step(state: ParticleState, pv: torch.Tensor, halo: bool,
                        sub=SUB) -> tuple[ParticleState, np.ndarray]:
    """``bucket_step_kernel<HALO>`` block by block on a (..., gy, gx, cap)
    stack of grids; returns the stepped state and how often each output slot
    was written. Outputs start as garbage, so a slot nobody writes shows."""
    gy, gx, cap = state.ty.shape[-3:]
    n_grids = state.capacity // (gy * gx * cap)
    ring = 1 if halo else 0
    ry, rx = gy - 2 * ring, gx - 2 * ring
    sub_r, sub_b = min(ry, sub[0]), min(rx, sub[1])
    rows, cols = sub_r + 2, sub_b + 2
    assert rows * cols <= 256, "stage_region needs a thread per staged bucket"
    live = (state.ty.numpy() >= 0).reshape(n_grids, gy, gx, cap)
    writes = np.zeros(state.capacity, np.int64)
    copied = np.zeros(state.capacity, bool)
    receivers, runs = [], []

    def copy(first, row_stride, n_rows, row_slots, width):
        """copy_dead_slots: slots at or past ``width`` in their bucket, or
        dead, of a rectangle of slots"""
        for r in range(n_rows):
            idx = first + r * row_stride + np.arange(row_slots)
            dead = (np.arange(row_slots) % cap >= width) | ~live.reshape(-1)[idx]
            writes[idx[dead]] += 1
            copied[idx[dead]] = True

    for grid in range(n_grids):
        base = grid * gy * gx * cap
        for sy, sx, r0, c0, in_rows, in_cols, last_y, last_x in sub_tiles(ry, rx, sub_r, sub_b):
            row, col = ring + r0, ring + c0  # first receiver bucket
            # stage_region: compact the region's live slots, bucket starts
            cand, start = [], [0]
            for rr in range(rows):
                for rb in range(cols):
                    by, bx = row - 1 + rr, col - 1 + rb
                    if 0 <= by < gy and 0 <= bx < gx:
                        slots = np.flatnonzero(live[grid, by, bx])
                        cand.extend(base + (by * gx + bx) * cap + slots)
                    start.append(len(cand))
            cand, start = np.asarray(cand, np.int64), np.asarray(start)
            row_recv = [0]
            for r in range(in_rows):
                st = (r + 1) * cols + 1
                row_recv.append(row_recv[-1] + start[st + in_cols] - start[st])
            n_recv = row_recv[-1]
            if n_recv < in_rows * in_cols * cap:
                copy(base + (row * gx + col) * cap, gx * cap, in_rows, in_cols * cap,
                     cap if n_recv else 0)
            if halo:
                c_lo, c_hi = (0 if sx == 0 else col), (gx if last_x else col + in_cols)
                if sy == 0:
                    copy(base + c_lo * cap, gx * cap, 1, (c_hi - c_lo) * cap, 0)
                if last_y:
                    copy(base + ((gy - 1) * gx + c_lo) * cap, gx * cap, 1, (c_hi - c_lo) * cap, 0)
                if sx == 0:
                    copy(base + row * gx * cap, gx * cap, in_rows, cap, 0)
                if last_x:
                    copy(base + (row * gx + gx - 1) * cap, gx * cap, in_rows, cap, 0)
            for k in range(n_recv):  # staged_receiver, staged_pair_forces
                r = max(i for i in range(in_rows) if row_recv[i] <= k)
                pos = start[(r + 1) * cols + 1] + k - row_recv[r]
                b = np.searchsorted(start, pos, side="right") - 1
                assert b // cols == r + 1 and 1 <= b % cols <= in_cols
                run = np.concatenate([
                    cand[start[b - cols - 1]:start[b - cols + 2]],
                    cand[start[b - 1]:pos], cand[pos + 1:start[b + 2]],
                    cand[start[b + cols - 1]:start[b + cols + 2]]])
                receivers.append(cand[pos])
                runs.append(run)
                writes[cand[pos]] += 1

    fx, fy = sequential_pair_sum(state, pv, receivers, runs)
    stepped = mie.leapfrog_apply(*(a.reshape(-1) for a in state), fx, fy, pv)
    recv = torch.zeros(state.capacity, dtype=torch.bool)
    recv[torch.as_tensor(receivers, dtype=torch.int64)] = True
    keep = torch.from_numpy(copied)
    garbage = (torch.full((state.capacity,), 0x5A5A5A5A, dtype=torch.int32),) * 2 + (
        torch.full((state.capacity,), float("nan")),) * 2
    out = [torch.where(recv, s, torch.where(keep, a.reshape(-1), g)).reshape(a.shape)
           for s, a, g in zip(stepped, state[:4], garbage)]
    return ParticleState(*out, state.ty), writes.reshape(state.ty.shape)


def sequential_pair_sum(state, pv, receivers, runs):
    """Each receiver's cursor + wall force plus its run's pair terms, added
    one candidate at a time in the run's order (a thread's f32 accumulator);
    (capacity,) force arrays, zero off the receivers."""
    n, longest = len(receivers), max((len(c) for c in runs), default=0)
    idx = np.zeros((n, longest), np.int64)
    for k, c in enumerate(runs):
        idx[k, :len(c)] = c
    idx = torch.from_numpy(idx)
    count = torch.tensor([len(c) for c in runs], dtype=torch.int64)
    recv = torch.tensor(receivers, dtype=torch.int64)
    x, y = state.x.reshape(-1), state.y.reshape(-1)
    scale_x, scale_y = mie.pair_scales(pv)
    coeffs = mie.mie_log_coeffs(pv)
    ext_x, ext_y = external_forces(state, pv)
    fx, fy = ext_x.reshape(-1)[recv], ext_y.reshape(-1)[recv]
    for k in range(longest):
        on = k < count
        dx = mie.wrap_dist(x[recv], x[idx[:, k]], scale_x)
        dy = mie.wrap_dist(y[recv], y[idx[:, k]], scale_y)
        tx, ty = mie.pair_terms(dx, dy, on, coeffs)
        fx = torch.where(on, fx + tx, fx)
        fy = torch.where(on, fy + ty, fy)
    full_x = torch.zeros(state.capacity).index_put_((recv,), fx)
    full_y = torch.zeros(state.capacity).index_put_((recv,), fy)
    return full_x, full_y


def random_state(shape, seed, live=0.5) -> ParticleState:
    """Random positions and velocities on a (..., gy, gx, cap) stack, a
    ``live`` share of the slots live, one corner of every grid dead."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    fields = (rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
              rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
              rng.normal(0, 50, n).astype(np.float32),
              rng.normal(0, 50, n).astype(np.float32),
              np.where(rng.random(n) < live, 0, -1).astype(np.int32))
    state = ParticleState(*(torch.from_numpy(a).reshape(shape) for a in fields))
    state.ty[..., : shape[-3] // 2, : shape[-2] // 2, :] = -1
    return state


def assert_same(a: ParticleState, b: ParticleState, label=""):
    for name, u, v in zip(ParticleState._fields, a, b):
        assert torch.equal(u, v), f"{label} field {name} differs"


CLASSIC_CASES = {
    # the sides no multiple of the sub-tile, cap no multiple of 4
    "5x7x6": lambda: (random_state((5, 7, 6), 0), step_params(), SUB),
    # 3 x 3 sub-tiles, the last row 3 buckets and the last column 1 bucket
    "19x33x8": lambda: (random_state((19, 33, 8), 1), step_params(), SUB),
    # a large cap narrows the sub-tile (as the launch does to fit shared memory)
    "8x8x64-narrow": lambda: (random_state((8, 8, 64), 2, live=0.1), step_params(), (8, 3)),
    # every slot live: no pass-through copy at all
    "4x4x8-full": lambda: (random_state((4, 4, 8), 3, live=1.1), step_params(), SUB),
    # the cursor, a full bucket, crossers; two sub-tiles down
    "stress": lambda: (*stress_state()[:2], SUB),
}


@pytest.mark.parametrize("case", sorted(CLASSIC_CASES))
def test_staged_subtiles_give_the_classic_step(case):
    """Sub-tiles that cut the grid, boxes edges as empty buckets, dead slots
    copied: ``bucket_step`` on every field and slot, each written once."""
    state, pv, sub = CLASSIC_CASES[case]()
    if case == "4x4x8-full":
        state.ty[:] = 0
    got, writes = staged_subtile_step(state, pv, halo=False, sub=sub)
    assert (writes == 1).all(), f"{int((writes != 1).sum())} slots not written exactly once"
    assert_same(got, bucket.bucket_step(state, pv), case)


def stress_shards(n):
    state, pv, _ = stress_state()
    return padded_shards(state, n)[0], pv


HALO_CASES = {
    "1x5x7x6": lambda: (random_state((1, 5, 7, 6), 4), step_params(), SUB),
    "3x19x33x8": lambda: (random_state((3, 19, 33, 8), 5), step_params(), SUB),
    # one interior bucket: the four strips are the whole ring
    "2x3x3x12": lambda: (random_state((2, 3, 3, 12), 6, live=0.9), step_params(), SUB),
    "4x12x20x4-small-subtiles": lambda: (random_state((4, 12, 20, 4), 7), step_params(), (3, 5)),
    # the stress scene's four padded shards (10 x 10 x 16): live rings
    "stress-2x2": lambda: (*stress_shards(4), SUB),
}


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_staged_subtiles_give_the_halo_step(case):
    """A stack of halo-padded shards: interior receivers, the ring supplies
    candidates and passes through whole (live slots too), each ring slot
    written by exactly one block: ``bucket_step_halo`` bit for bit."""
    padded, pv, sub = HALO_CASES[case]()
    ring_live = padded.ty.clone()
    ring_live[..., 1:-1, 1:-1, :] = -1
    assert (ring_live >= 0).any(), "the ring holds live slots"
    got, writes = staged_subtile_step(padded, pv, halo=True, sub=sub)
    assert (writes == 1).all(), f"{int((writes != 1).sum())} slots not written exactly once"
    assert_same(got, bucket.bucket_step_halo(padded, pv), case)


def test_staged_step_in_the_envelope_of_jax():
    """A thermal lattice on 16 x 32 x 8 (a few particles a bucket): the
    staged model inside the step envelope of JAX's Pallas step."""
    cfg = bucket.GridConfig(5, 4, 8)
    rng = np.random.default_rng(3)
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    meta.box_width, meta.box_height, meta.step_dt = 2 * r0 * cfg.bx, 2 * r0 * cfg.by, 1e-14
    ParticleLattice((50, 26), distance_factor=1.1, velocity=(0.0, 0.0)).hex_square(
        frame, (meta.box_width / 2, meta.box_height / 2), rng=rng)
    parts = frame.particles.copy()
    parts["vx"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    parts["vy"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    layout = bucket.bucketize_numpy(parts, cfg)
    fields = tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names)
    state, params = from_reference(fields, meta.copy())
    got, writes = staged_subtile_step(state, params.vector(), halo=False)
    assert (writes == 1).all()
    got = to_reference(got, params)[0]
    ref = [np.asarray(a) for a in bucket_step_pallas(
        JState(*(jnp.asarray(a) for a in fields)), JSimParams.from_record(meta.copy()),
        interpret=True)]
    np.testing.assert_array_equal(got[4], ref[4])
    for r, g in zip(ref[:2], got[:2]):
        delta = np.abs(r.astype(np.int64) - g.astype(np.int64))
        assert np.minimum(delta, 2**32 - delta).max() <= 8
    live = ref[4] >= 0
    assert live.sum() == 50 * 26
    for r, g in zip(ref[2:4], got[2:4]):
        np.testing.assert_allclose(g[live], r[live], rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(g[~live], r[~live])


# ---------------------------------------------------------------------------
# the target-centred dest
# ---------------------------------------------------------------------------

def target_centred_dest(state: ParticleState, bx_log2: int, by_log2: int, offsets, halo: bool,
                        sub=SUB) -> tuple[np.ndarray, np.ndarray]:
    """``bucket_dest_kernel<HALO>`` block by block on a (..., gy, gx, cap)
    stack of grids: the ids, and how often each slot was written."""
    gy, gx, cap = state.ty.shape[-3:]
    n_grids = state.capacity // (gy * gx * cap)
    ring = 1 if halo else 0
    sub_r, sub_b = min(gy, sub[0]), min(gx, sub[1])
    ty = state.ty.numpy().reshape(-1)
    tgt_y = mie.bucket_of(state.y, by_log2).numpy().reshape(-1).astype(np.int64)
    tgt_x = mie.bucket_of(state.x, bx_log2).numpy().reshape(-1).astype(np.int64)
    dest = np.full(state.capacity, -99, np.int64)
    writes = np.zeros(state.capacity, np.int64)
    lx = gx - 2 * ring
    for grid in range(n_grids):
        base = grid * gy * gx * cap
        row_off = int(offsets[grid][0]) - ring if halo else 0
        col_off = int(offsets[grid][1]) - ring if halo else 0
        for _, _, row, col, in_rows, in_cols, _, _ in sub_tiles(gy, gx, sub_r, sub_b):
            cols = sub_b + 2
            nb = (in_rows + 2) * cols
            brow = row - 1 + np.arange(nb) // cols
            bcol = col - 1 + np.arange(nb) % cols
            code = np.full(nb * cap, -1, np.int64)
            count = np.zeros(nb * 9, np.int64)
            for i in range(nb * cap):  # 1. a code a slot of the region
                b, s = divmod(i, cap)
                by, bx = brow[b], bcol[b]
                if not (0 <= by < gy and 0 <= bx < gx):
                    continue
                j = base + (by * gx + bx) * cap + s
                if ty[j] < 0:
                    continue
                tby, tbx = tgt_y[j] - row_off, tgt_x[j] - col_off
                dy, dx = by - tby, bx - tbx
                if (ring <= tby < gy - ring and ring <= tbx < gx - ring
                        and abs(dy) <= 1 and abs(dx) <= 1):
                    code[i] = (dy + 1) * 3 + (dx + 1)
            for b in range(nb):  # 2. a slot's rank in its bucket and scan block
                for s in range(cap):
                    c = code[b * cap + s]
                    if c >= 0:
                        w = count[b * 9 + c]
                        count[b * 9 + c] = w + 1
                        code[b * cap + s] = c | (w << 4)
            for t in range(in_rows * in_cols):  # 3. a target's pull scan
                tr, tc = divmod(t, in_cols)
                start = 0
                for k in range(9):
                    at = ((tr + k // 3) * cols + tc + k % 3) * 9 + k
                    start, count[at] = start + count[at], start
            for i in range(nb * cap):  # 4. the ids
                b, s = divmod(i, cap)
                c = code[i]
                by, bx = brow[b], bcol[b]
                k = c & 15
                dy, dx = (0, 0) if c < 0 else (k // 3 - 1, k % 3 - 1)
                tr, tc = by - dy - row, bx - dx - col
                if not (0 <= tr < in_rows and 0 <= tc < in_cols):
                    continue
                j = base + (by * gx + bx) * cap + s
                dest[j] = -1
                if c >= 0:
                    rank = count[b * 9 + k] + (c >> 4)
                    if rank < cap:
                        dest[j] = ((by - dy - ring) * lx + (bx - dx - ring)) * cap + rank
                writes[j] += 1
    return dest.reshape(state.ty.shape), writes.reshape(state.ty.shape)


def drift_state(cfg, density, drift, seed) -> ParticleState:
    """Buckets filled to a random slot prefix, each particle up to ``drift``
    bucket widths from its bucket: crossers, far drifters and overflow."""
    rng = np.random.default_rng(seed)
    by, bx, cap = cfg.grid_shape
    occ = np.arange(cap) < rng.binomial(cap, density, (by, bx))[..., None]

    def coord(n_log2, index):
        pos = (index + rng.uniform(-drift, 1 + drift, cfg.grid_shape)) * 2.0 ** (32 - n_log2)
        return (np.floor(pos).astype(np.int64) % 2**32).astype(np.uint32)

    x = coord(cfg.bx_log2, np.arange(bx)[None, :, None])
    y = coord(cfg.by_log2, np.arange(by)[:, None, None])
    zeros = np.zeros(cfg.grid_shape, np.float32)
    fields = (np.where(occ, x, 0).astype(np.uint32), np.where(occ, y, 0).astype(np.uint32),
              zeros, zeros, np.where(occ, 0, -1).astype(np.int32))
    return from_reference(fields, default_metadata())[0]


DEST_SCENES = {
    "stress": lambda: stress_state()[0],  # 16 x 16 x 16: overflow and far drifters
    "drift": lambda: drift_state(bucket.GridConfig(4, 4, 4), 0.6, 1.4, 10),
    "overflow": lambda: drift_state(bucket.GridConfig(5, 3, 6), 0.95, 0.8, 11),  # 8 x 32 x 6
}


def jax_fields(state: ParticleState):
    return JState(*(jnp.asarray(a.numpy().view(np.uint32) if i < 2 else a.numpy())
                    for i, a in enumerate(state)))


@pytest.mark.parametrize("sub", [SUB, (3, 5)], ids=["sub8x16", "sub3x5"])
@pytest.mark.parametrize("case", sorted(DEST_SCENES))
def test_target_centred_dest_equals_the_plain_dest_and_jax(case, sub):
    state = DEST_SCENES[case]()
    bx_log2, by_log2 = bucket.grid_log2(state)
    got, writes = target_centred_dest(state, bx_log2, by_log2, None, halo=False, sub=sub)
    assert (writes == 1).all(), f"{int((writes != 1).sum())} slots not written exactly once"
    ref = bucket.move_dest_direct(state).numpy()
    np.testing.assert_array_equal(got, ref)
    live = state.ty.numpy() >= 0
    assert (ref[live] < 0).any(), "the move drops particles"
    if sub == SUB:
        pallas = np.asarray(move_dest_pallas(jax_fields(state), interpret=True))
        np.testing.assert_array_equal(got, pallas.reshape(got.shape))


@pytest.mark.parametrize("sub", [SUB, (3, 5)], ids=["sub8x16", "sub3x5"])
@pytest.mark.parametrize("case, shards", [("stress", 4), ("drift", 6), ("overflow", 2)])
def test_target_centred_halo_dest_equals_the_plain_dest_and_jax(case, shards, sub):
    """On the padded shards of a mesh: ring slots get ids too (migration),
    targets are interior buckets only, ids in the interior's numbering."""
    state = DEST_SCENES[case]()
    bx_log2, by_log2 = bucket.grid_log2(state)
    padded, offsets = padded_shards(state, shards)
    got, writes = target_centred_dest(padded, bx_log2, by_log2, offsets.numpy(), halo=True,
                                      sub=sub)
    assert (writes == 1).all(), f"{int((writes != 1).sum())} slots not written exactly once"
    ref = bucket.move_dest_direct_halo(padded, bx_log2, by_log2, offsets).numpy()
    np.testing.assert_array_equal(got, ref)
    ring = ref.copy()
    ring[:, 1:-1, 1:-1] = -1
    assert (ring >= 0).any(), "ring particles migrate in"
    interior_live = padded.ty.numpy()[:, 1:-1, 1:-1] >= 0
    assert (ref[:, 1:-1, 1:-1][interior_live] < 0).any(), "the move drops particles"
    if sub == SUB:
        _, py, px, cap = padded.x.shape
        lx = px - 2
        shard = ParticleState(*(a[0] for a in padded))
        pid = np.asarray(move_dest_pallas_halo(
            jax_fields(shard), bx_log2, by_log2, int(offsets[0, 0]), int(offsets[0, 1]),
            interpret=True)).reshape(py, px, cap)
        b, r = pid // cap, pid % cap  # the padded lane numbering -> the interior's
        mapped = np.where(pid >= 0, ((b // px) * lx + b % px - 1) * cap + r, -1)
        np.testing.assert_array_equal(got[0], mapped)


# ---------------------------------------------------------------------------
# the live-tile step: its walk over the visits and its 16-byte stage
# ---------------------------------------------------------------------------

STAGE_BUDGET = 40 * 1024  # bucket_step.cu:pick_sub_tile's shared-memory budget


def stage_bytes(rows: int, cols: int, cap: int) -> int:
    """``bucket_stage.cuh:stage_bytes``: cand, info, start, row prefix and
    the scan's scratch of a rows x cols region."""
    nb = rows * cols
    return nb * cap * 12 + (nb + 1 + rows + 32) * 4


def pick_sub_tile(rows: int, cols: int, cap: int) -> tuple[int, int]:
    """``bucket_step.cu:pick_sub_tile``: at most SUB of a rows x cols tile,
    fewer columns until the staged region fits the budget."""
    r, c = min(rows, SUB[0]), min(cols, SUB[1])
    while c > 1 and stage_bytes(r + 2, c + 2, cap) > STAGE_BUDGET:
        c -= 1
    return r, c


def live_tile_model(state: ParticleState, aux: bucket.ExtStepAux, walkers: int):
    """``bucket_step_kernel_tiles<true>`` block by block: blocks
    (sub-tile, walker) of a (tile_x, walkers) launch, walker w taking visits
    w, w + walkers, ... below sizes[0]; a dead tile is skipped; the region
    staged as ``stage_region_vec`` does where cap is a multiple of 4 and
    omax at most 32 (16-byte groups of ty, a live mask, x and y of the live
    groups), else as ``stage_region``; the receivers are the interior's live
    slots. Returns the (tile, sub-tile) visits, how often each slot was
    written, and each receiver's candidates in the step's order."""
    gy, gx, cap = state.ty.shape
    ty = state.ty.numpy().reshape(-1)
    omax = int(aux.params[-1])
    chunks, ty_rows = aux.lane_chunks, aux.ty_rows
    row_buckets = gx // chunks
    sub_r, sub_b = pick_sub_tile(ty_rows, row_buckets, cap)
    rows, cols = sub_r + 2, sub_b + 2
    assert rows * cols <= 256, "a thread per staged bucket"
    subs_x = -(-row_buckets // sub_b)
    tile_x = -(-ty_rows // sub_r) * subs_x
    wide = cap % 4 == 0 and omax <= 32
    n_visits = int(aux.sizes[0])
    order, flags = aux.order.numpy(), aux.flags.numpy()
    visits, writes, runs = {}, np.zeros(ty.size, np.int64), {}

    def bucket_live(base):
        if not wide:
            return [s for s in range(omax) if ty[base + s] >= 0]
        live = 0
        for s in range(0, omax, 4):  # one 16-byte load of ty
            assert s + 4 <= cap, "a load past the bucket"
            for e in range(4):
                live |= int(ty[base + s + e] >= 0) << (s + e)
        live &= (1 << omax) - 1
        slots = [s for s in range(32) if live >> s & 1]
        for s in range(0, 32, 4):  # x and y of a group with a live slot
            if live >> s & 0xF:
                assert s + 4 <= cap
        return slots

    for bx in range(tile_x):
        sub_y, sub_x = divmod(bx, subs_x)
        in_rows = min(sub_r, ty_rows - sub_y * sub_r)
        in_cols = min(sub_b, row_buckets - sub_x * sub_b)
        for w in range(walkers):
            for k in range(w, n_visits, walkers):
                tile = int(order[k])
                if not flags[tile]:
                    continue
                visits[tile, bx] = visits.get((tile, bx), 0) + 1
                row0 = (tile // chunks) * ty_rows + sub_y * sub_r - 1
                col0 = (tile % chunks) * row_buckets + sub_x * sub_b - 1
                cand, start = [], [0]
                for rr in range(rows):
                    for rb in range(cols):
                        by, bx_ = row0 + rr, col0 + rb
                        if 0 <= by < gy and 0 <= bx_ < gx:
                            base = (by * gx + bx_) * cap
                            cand.extend(base + s for s in bucket_live(base))
                        start.append(len(cand))
                for r in range(1, in_rows + 1):
                    for c in range(1, in_cols + 1):
                        b = r * cols + c
                        for pos in range(start[b], start[b + 1]):
                            writes[cand[pos]] += 1
                            runs[cand[pos]] = (cand[start[b - cols - 1]:start[b - cols + 2]]
                                               + cand[start[b - 1]:pos] + cand[pos + 1:start[b + 2]]
                                               + cand[start[b + cols - 1]:start[b + cols + 2]])
    return visits, writes.reshape(state.ty.shape), runs, (sub_r, sub_b, tile_x)


def live_tile_state(shape, seed, width=None) -> ParticleState:
    """A random half-live grid, live slots only below ``width`` of each
    bucket (so that omax is small, as on a served lattice), one corner
    dead."""
    state = random_state(shape, seed)
    if width is not None:
        state.ty[..., width:] = -1
    return state


# (grid, lane chunks, rows a tile asked for, width of the live slots, walkers)
LIVE_TILE_CASES = {
    "cap6-scalar-stage-one-walker": ((16, 32, 6), 2, 8, None, 1),
    "cap8-omax5-fewer-walkers": ((16, 32, 8), 2, 8, 5, 3),
    "cap12-more-walkers": ((8, 64, 12), 4, 8, None, 100),
    "cap16-4-row-tiles": ((32, 64, 16), 4, 4, 7, 5),
    "cap16-16-row-tiles": ((32, 32, 16), 2, 16, 8, 2),
    "cap16-8-row-tiles-8-chunks": ((16, 128, 16), 8, 8, 8, 13),
    "cap64-omax-over-32-ragged": ((32, 16, 64), 1, 16, None, 1),
    "cap64-omax20-wide-ragged": ((16, 16, 64), 1, 8, 20, 4),
    "one-bucket-tiles": ((4, 4, 16), 4, 4, 6, 16),
    "all-dead": ((16, 32, 16), 2, 8, 0, 7),
}


@pytest.mark.parametrize("case", sorted(LIVE_TILE_CASES))
def test_live_tile_walk_steps_every_live_slot_once(case):
    """The live-tile step's walk visits every sub-tile of every live tile
    once (the all-dead grid: its one visit, and nothing written), writes
    every live slot once and no other slot, and each receiver's candidates
    are the classic step's order with the tombstones left out, so the
    stepped slots equal the plain ext step's bit for bit."""
    shape, chunks, rows, width, walkers = LIVE_TILE_CASES[case]
    state = live_tile_state(shape, seed=len(case), width=width)
    pv = step_params()
    aux = bucket.ext_step_aux(state, pv, chunks, rows)
    visits, writes, runs, (sub_r, sub_b, tile_x) = live_tile_model(state, aux, walkers)
    live_tiles = set(np.flatnonzero(aux.flags.numpy()).tolist())
    if case == "all-dead":
        assert not live_tiles and int(aux.sizes[0]) == 1
    if case.endswith("ragged"):
        assert (shape[1] // chunks) % sub_b, "the last sub-tile of a tile is cut"
    assert visits == {(t, s): 1 for t in live_tiles for s in range(tile_x)}
    live = (state.ty >= 0).numpy()
    np.testing.assert_array_equal(writes, live.astype(np.int64))
    receivers = sorted(runs)
    if not receivers:
        return
    fx, fy = sequential_pair_sum(state, pv, receivers, [runs[r] for r in receivers])
    stepped = mie.leapfrog_apply(*(a.reshape(-1) for a in state), fx, fy, pv)
    plain = bucket.bucket_step_ext(state, aux, compact=True)
    idx = torch.as_tensor(receivers)
    for name, got, want in zip(ParticleState._fields, stepped, plain[:4]):
        assert torch.equal(got[idx], want.reshape(-1)[idx]), f"{case}: {name}"
