"""The port against the JAX package at the sizes of that package's recorded
runs (``chip_smoke.py`` phase 23: the dense bench at 4M and 16M particles,
the sharded 16M grid, the user scene at 4M), on the CPU and without running
a frame at those sizes; then phase 23 itself at a tiny size.

Contract:
- the 4M user scene (a 2048 x 2048 lattice): the port's ``_grid_for`` and
  ``_lane_chunks_for`` pick JAX's grid, cap and lane chunks (2048 x 2048 x
  16, 8 chunks); the tile aux (``ext_step_aux``) on that grid and its
  occupancy equals JAX's: params bit for bit, flags, order and sizes;
- the device pack's int32 header and order (``ops/readback.py``) on grids
  whose live totals are the 4M user scene's and the dense 16M grid's: equal
  to a numpy int64 reckoning;
- phase 23's rows are bench.py's commands, their live counts and grids the
  dense grid pick's; its ``--sharded --per-frame`` key set is bench.py's;
- phase 23 passes on the CPU at 512 particles, and fails when a held kernel
  differs from its plain version.

The 4M scene's ty is built from the lattice's bucket occupancy (live slots
are a prefix of each bucket, all of species 0, as ``bucketize_numpy`` lays
them out), so the tile aux and the pack see the scene's layout without its
1.3 GB of particle records.
"""

import json

import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
import jax
from particle_simulator_tpu.engine import simulator as jsimulator
from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.ops.bucket_pallas import ext_state_chunks
from particle_simulator_tpu.ops.bucket_pallas import ext_step_aux as jext_step_aux
from particle_simulator_tpu.physics.bucket import GridConfig as JGridConfig
from particle_simulator_tpu_torch import bench
from particle_simulator_tpu_torch.engine import simulator
from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams, state_from_numpy
from particle_simulator_tpu_torch.ops.readback import dense_readback, pow2_at_least
from particle_simulator_tpu_torch.physics import bucket

torch.set_num_threads(2)

USER_SIDE = 2048  # bench.py --user-scene --particles 4194304
TILE_ROWS = 8  # the ext frame's tile rows at the default launch width


@pytest.fixture(scope="module")
def user_4m():
    """The 4M user scene: its metadata, live particles, the grid the port
    picks and the (BY, BX) bucket occupancy there."""
    frame = chip_smoke.user_scene(USER_SIDE)
    parts = frame.particles
    live = parts[parts["ty"] >= 0]
    meta = frame.metadata
    grid = simulator._grid_for(live, simulator.REFERENCE_GRID, meta.box_width,
                               meta.species(0).force0_r(), box_height=meta.box_height)
    bxi = (live["x"] >> np.uint32(32 - grid.bx_log2)).astype(np.int64)
    byi = (live["y"] >> np.uint32(32 - grid.by_log2)).astype(np.int64)
    occ = np.minimum(np.bincount(bxi + byi * grid.bx, minlength=grid.buckets), grid.cap)
    return meta, live, grid, occ.reshape(grid.by, grid.bx)


def ty_from_occupancy(occ: np.ndarray, cap: int) -> np.ndarray:
    """The ty grid of a scene bucketized with this occupancy: each bucket's
    live slots a prefix, species 0."""
    return np.where(np.arange(cap) < occ[..., None], 0, -1).astype(np.int32)


def test_grid_and_lane_chunks_match_jax_at_4m(user_4m):
    meta, live, grid, occ = user_4m
    jgrid = jsimulator._grid_for(live, jsimulator.REFERENCE_GRID, meta.box_width,
                                 meta.species(0).force0_r(), box_height=meta.box_height)
    assert len(live) == USER_SIDE ** 2
    assert tuple(grid) == tuple(jgrid)
    assert grid.grid_shape == (2048, 2048, 16)
    chunks = simulator._lane_chunks_for(occ, grid)
    assert chunks == jsimulator._lane_chunks_for(occ, JGridConfig(*grid)) == 8
    # the Simulator's readback sizes at load: every particle placed
    assert occ.sum() == len(live)
    assert pow2_at_least(occ.max()) == 8 and pow2_at_least(len(live)) == 4_194_304


def test_ext_step_aux_matches_jax_at_4m(user_4m):
    """The tile aux on the 4M grid: 256 x 8 tiles of 8 rows. The step reads
    only ty, so the other fields are ty as well (JAX's jit drops their pad
    copies)."""
    meta, _, grid, occ = user_4m
    ty = ty_from_occupancy(occ, grid.cap)
    chunks = simulator._lane_chunks_for(occ, grid)
    t = torch.from_numpy(ty)
    rec = meta.copy()
    aux = bucket.ext_step_aux(ParticleState(t, t, t, t, t), SimParams.from_record(rec).vector(),
                              chunks, TILE_ROWS)
    jparams = JSimParams.from_record(rec)

    @jax.jit
    def jaux_of(jty):
        return jext_step_aux(ext_state_chunks(JState(jty, jty, jty, jty, jty), chunks),
                             jparams, chunks, TILE_ROWS)

    jaux = jaux_of(ty)
    del ty
    np.testing.assert_array_equal(aux.params.numpy().view(np.int32),
                                  np.asarray(jaux.params).view(np.int32))
    for name in ("flags", "order", "sizes"):
        np.testing.assert_array_equal(getattr(aux, name).numpy(),
                                      np.asarray(getattr(jaux, name)), err_msg=name)
    n_tiles = grid.by // TILE_ROWS * chunks
    assert aux.flags.numel() == n_tiles == 2048
    assert float(aux.params[-1]) == occ.max()  # omax
    live_tiles = int(aux.sizes[0])
    assert 0 < live_tiles < n_tiles and live_tiles == int(aux.flags.sum())


def _pack_case(case, user_4m):
    """(ty, live total) of the 4M user grid or the dense 16M grid."""
    if case == "user 4M":
        _, live, grid, occ = user_4m
        return ty_from_occupancy(occ, grid.cap), len(live)
    cfg = bench.dense_grid_config(16_000_000)
    ty = np.full(cfg.grid_shape, -1, np.int32)
    ty[1:-1, 1:-1] = 0  # every interior bucket full, as dense_grid_scene fills it
    return ty, (cfg.by - 2) * (cfg.bx - 2) * cfg.cap


@pytest.mark.parametrize("case", ["user 4M", "dense 16M"])
def test_readback_header_and_order_at_scale(case, user_4m):
    """The pack's int32 counts, offsets and header against numpy int64:
    x carries each slot's bucket and y its slot (broadcast views), so the
    pack's order is read off its output."""
    ty_np, total = _pack_case(case, user_4m)
    by, bx, cap = ty_np.shape
    b = by * bx
    counts = (ty_np >= 0).sum(-1, dtype=np.int64).reshape(-1)
    assert counts.sum() == total
    ty = torch.from_numpy(ty_np)
    del ty_np
    x = torch.arange(b, dtype=torch.int32).reshape(by, bx, 1).expand(by, bx, cap)
    y = torch.arange(cap, dtype=torch.int32).expand(by, bx, cap)
    v = torch.zeros((), dtype=torch.float32).expand(by, bx, cap)
    kcap, ncap = pow2_at_least(counts.max()), pow2_at_least(total)
    scalars, packed = dense_readback(ParticleState(x, y, v, v, ty), kcap, ncap)
    assert scalars.dtype == torch.int32
    assert scalars.tolist() == [int(counts.max()), total]
    offsets = np.cumsum(counts) - counts
    bucket_of = np.repeat(np.arange(b, dtype=np.int64), counts)
    slot_of = np.arange(total, dtype=np.int64) - np.repeat(offsets, counts)
    np.testing.assert_array_equal(packed.x[:total].numpy(), bucket_of)
    np.testing.assert_array_equal(packed.y[:total].numpy(), slot_of)
    assert bool((packed.ty[:total] == 0).all()) and bool((packed.ty[total:] == -1).all())
    assert packed.x.numel() == ncap


# ---------------------------------------------------------------------------
# phase 23's rows
# ---------------------------------------------------------------------------

def test_scale_rows_are_the_recorded_commands():
    """Each row's live count and grid: the dense grid pick at 4M and 16M,
    the 2048 x 2048 lattice at 4M."""
    def parsed(label):
        return bench.parser().parse_args(list(chip_smoke.SCALE_RUNS[label][2]))

    want = {"dense 4M": (4_169_760, (1024, 512, 8)), "dense 16M": (16_728_096, (2048, 1024, 8)),
            "sharded 16M": (16_728_096, (2048, 1024, 8))}
    for label, (live, shape) in want.items():
        args = parsed(label)
        assert chip_smoke.bench_particles(args) == live
        assert bench.dense_grid_config(args.particles).grid_shape == shape
        assert args.per_frame and args.frames == 24
    args = parsed("user 4M")
    assert args.user_scene and not args.sharded
    assert chip_smoke.bench_particles(args) == USER_SIDE ** 2 and args.frames == 10
    assert chip_smoke.SCALE_RUNS["user 4M"][1][0] == "step_compact"  # its 8 lane chunks
    assert parsed("sharded 16M").sharded
    assert chip_smoke.SCALE_READBACK == "user 4M"


def test_sharded_per_frame_keys_match_bench_py(capsys):
    argv = ["--particles", "512", "--frames", "2", "--steps", "4", "--sharded", "--per-frame"]
    assert jbench.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.run(argv + ["--torch-device", "cpu"], devices=["cpu"] * 4)
    assert set(got) == set(ref) == chip_smoke.BENCH_KEYS["sharded per-frame"]


def _sparse_state():
    """A 16 x 128 x 16 grid whose left half holds the dense lattice: two
    lane chunks."""
    cfg = bucket.GridConfig(7, 4, 16)
    parts, meta, _ = bench.dense_grid_scene(cfg, 16)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    state.ty[:, cfg.bx // 2:] = -1
    return state, SimParams.from_record(meta).vector()


def test_scale_times_cover_each_kernel_of_the_path():
    """On a sparse grid (two lane chunks): the classic step, the dest, the
    place (with the library call) and the live-tile step, each with a bound
    (the live slots' for the steps) and no time on the CPU."""
    state, pv = _sparse_state()
    out = chip_smoke.scale_times(state, pv, chip_smoke.not_timed)
    assert out["lane_chunks"] == 2
    kernels = out["kernels"]
    assert set(kernels) == {"step", "dest", "place", "step_compact"}
    assert kernels["step"]["bound_ms"] == kernels["step_compact"]["bound_ms"] == \
        chip_smoke.ext_bound(state, chip_smoke.FORCE_LAW_COUNTS)["bound_ms"]
    slots, live = state.capacity, int((state.ty >= 0).sum())
    dest = bucket.move_dest_direct(state)
    kept = int((dest >= 0).sum())
    assert 0 < kept <= live < slots
    for name, nbytes in (("dest", 8 * slots + 8 * live), ("place", 24 * slots + 20 * kept)):
        assert kernels[name]["bound_ms"] == 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S
        assert kernels[name]["bound_by"] == "bytes"
    assert all(k["ms"] is None and k["share"] is None for k in kernels.values())
    assert "library_ms" in kernels["place"]


def test_phase_scale_runs_on_the_cpu(capsys):
    """Phase 23 end to end at 512 particles, 2 frames of 4 steps, the
    sharded row on a (2, 2) mesh of CPU entries: every row passes phase
    22's checks and holds two states, the CPU launches no kernel, and the
    readback check runs after its row."""
    size = ("--particles", "512", "--frames", "2", "--steps", "4")
    out = chip_smoke.phase_scale("cpu", size=size, devices=[torch.device("cpu")] * 4)
    assert sorted(out["records"]) == sorted(chip_smoke.SCALE_RUNS)
    assert not any(out["launches"].values()) and not any(out["err"].values())
    lines = out["lines"]
    assert lines["sharded 16M"]["record"]["sharded_mesh"] == [2, 2]
    assert lines["sharded 16M"]["block"] == [4, 6, 6, 8]
    assert set(lines["user 4M"]["readback"]) >= {"active_kernel", "particles"}
    for line in lines.values():
        assert line["memory_peak_bytes"] == {"run": None, "holds": None}
        assert line["seconds"]["row"] >= line["seconds"]["frames"] > 0
        assert len(line["held"]) == 2
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("scale ")]
    assert len(printed) == len(chip_smoke.SCALE_RUNS)


def test_phase_scale_fails_on_a_held_kernel_difference(monkeypatch):
    """A dest one id off in one slot fails the row's hold."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    real = bucket_cuda.move_dest_cuda

    def off_by_one(state):
        out = real(state).clone()
        out.view(-1)[0] += 1
        return out

    monkeypatch.setattr(bucket_cuda, "move_dest_cuda", off_by_one)
    with pytest.raises(AssertionError, match="dest ids differ"):
        chip_smoke.phase_scale("cpu", runs=("dense 4M",),
                               size=("--particles", "512", "--frames", "1", "--steps", "2"))
