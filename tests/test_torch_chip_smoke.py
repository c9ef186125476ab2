"""The CPU-side helpers of ``chip_smoke.py``: the SASS loop count that sets
the arithmetic bounds, the bound arithmetic, the bucket-step pair counts,
the place library calls, the device busy-share arithmetic, the ext step's
bound and live-tile share and the readback check. The card's own
phases run only on the card."""

import numpy as np
import pytest
import torch

import chip_smoke
from particle_simulator_tpu_torch.engine.state import state_from_numpy
from particle_simulator_tpu_torch.physics import bucket

# the shape of `cuobjdump -sass` output: an outer loop (0x0040 -> 0x00e0)
# around two inner loops; the second inner loop holds more MUFU.EX2
SASS = """
\t\tFunction : _ZN12_GLOBAL__N_1other_kernelEv
        /*0000*/                   MUFU.EX2 R1, R1 ;   /* 0x0 */
        /*0010*/                   BRA 0x0 ;           /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_120allpairs_step_kernelEPKj
        /*0000*/                   S2R R8, SR_TID.X ;  /* 0x0 */
        /*0010*/                   ISETP.NE.AND P0, PT, R8, RZ, PT ;
        /*0020*/               @P0 BRA 0x100 ;
        /*0030*/                   MOV R2, RZ ;
        /*0040*/                   LDS R3, [R2] ;
        /*0050*/                   MUFU.EX2 R4, R3 ;
        /*0060*/              @!P1 BRA 0x40 ;
        /*0070*/                   FFMA R5, R4, R3, R5 ;
        /*0080*/                   FMUL R6, R5, R5 ;
        /*0090*/                   MUFU.EX2 R7, R6 ;
        /*00a0*/                   MUFU.EX2 R8, R6 ;
        /*00b0*/                   I2FP.F32.S32 R9, R8 ;
        /*00c0*/                   FADD R9, R9, R7 ;
        /*00d0*/               @P2 BRA 0x70 ;
        /*00e0*/                   BRA 0x30 ;
        /*0100*/                   EXIT ;
"""


def test_main_loop_sass_picks_the_inner_loop_with_most_ex2():
    loop = chip_smoke.main_loop_sass(SASS, "allpairs_step_kernel")
    assert loop == ["FFMA", "FMUL", "MUFU.EX2", "MUFU.EX2", "I2FP.F32.S32", "FADD", "BRA"]


def test_bounds_from_pair_counts():
    counts = {"fp32_per_pair": 50.0, "mufu_per_pair": 2.0}
    pairs = 16384 * 16383
    ms = chip_smoke.ops_bound_ms(pairs, counts)
    # 50 f32 instructions a pair at 67e12/2 a second outweigh 2 MUFU at 1/8 that
    assert np.isclose(ms, 1e3 * pairs * 50 / (67e12 / 2))
    assert chip_smoke.bound(36 * 16384, ms) == {"bound_ms": ms, "bound_by": "operations"}
    by_bytes = chip_smoke.bound(44 * 2**20)
    assert by_bytes["bound_by"] == "bytes"
    assert np.isclose(by_bytes["bound_ms"], 1e3 * 44 * 2**20 / 3.35e12)


def test_bucket_pairs_and_place_library_call():
    cfg = bucket.GridConfig(3, 3, 8)
    parts, _, live = chip_smoke.dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    nbr = bucket.gather_neighborhood(state)
    own = bucket._self_pair_mask(cfg.cap, "cpu")
    valid = (nbr.ty[..., None, :] >= 0) & ~own & (state.ty[..., :, None] >= 0)
    assert chip_smoke.bucket_pairs(state) == int(valid.sum()) > 0
    destid = bucket.move_dest_direct(state)
    table, _ = chip_smoke.place_library_call(state, destid, 1, timer=lambda fn, reps: 0.0)
    placed = bucket.bucket_place(state, destid)
    assert torch.equal(table, torch.stack([a.reshape(-1).view(torch.int32) for a in placed], 1))
    assert live == int((state.ty >= 0).sum())


def test_halo_pairs_and_halo_place_library_call():
    """On a stack of tombstone-padded grids the halo pair count is the
    single-device count summed, and the halo place's library call is the
    halo place."""
    cfg = bucket.GridConfig(3, 3, 8)
    parts, _, _ = chip_smoke.dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    stack = bucket.ParticleState(*(torch.stack([a, a]) for a in state))
    padded = bucket.pad_tombstone_halo(stack)
    assert chip_smoke.halo_pairs(padded) == 2 * chip_smoke.bucket_pairs(state)
    offsets = torch.zeros(2, 2, dtype=torch.int32)
    destid = bucket.move_dest_direct_halo(padded, cfg.bx_log2, cfg.by_log2, offsets)
    table, _ = chip_smoke.place_library_call(padded, destid, 1, timer=lambda fn, reps: 0.0,
                                             out_grid=cfg.grid_shape)
    placed = bucket.bucket_place_halo(padded, destid)
    assert torch.equal(table, torch.stack([a.reshape(-1).view(torch.int32) for a in placed], 1))


def test_busy_summary_merges_overlaps_and_windows():
    ops = [(0, 10, "upload"), (20, 30, "step_kernel"), (25, 35, "copy"),
           (40, 50, "step_kernel"), (60, 70, "step_kernel"), (70, 80, "fill")]
    whole = chip_smoke.busy_summary(ops)
    assert np.isclose(whole["busy_share"], 55 / 80)  # 10 + 15 + 10 + 20 of 80 us
    # gaps: 10 us after the upload, 5 after the copy, 10 after the second step
    assert whole["idle_ms_after"] == {"upload": 0.01, "step_kernel": 0.01, "copy": 0.005}
    steady = chip_smoke.busy_summary(ops, window_kernel="step_kernel", skip=1)
    assert np.isclose(steady["busy_share"], 20 / 30)  # from 40 to 70 us
    assert steady["busy_ms_by_op"] == {"step_kernel": 0.02}
    assert chip_smoke.busy_summary([]) is None


def quarter_live_dense(cfg):
    """The dense bench scene with only its top-left quarter kept."""
    parts, _, _ = chip_smoke.dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    state.ty[cfg.by // 2:] = -1
    state.ty[:, cfg.bx // 2:] = -1
    return state


def test_ext_bound_counts_live_slots_pairs_and_tiles():
    """Phase 12's bound of a tile-scheduled state: the live slots' bytes and
    the live pairs (a dead tile adds neither), and its live-tile share."""
    cfg = bucket.GridConfig(4, 4, 8)  # 16 x 16 buckets: 2 x 2 tiles of 8 rows x 8 buckets
    state = quarter_live_dense(cfg)
    params = torch.zeros(10)
    aux = bucket.ext_step_aux(state, params, 2, 8)
    assert aux.flags.tolist() == [1, 0, 0, 0]
    assert chip_smoke.live_tile_share(aux) == 0.25
    nbr = bucket.gather_neighborhood(state)
    own = bucket._self_pair_mask(cfg.cap, "cpu")
    valid = (nbr.ty[..., None, :] >= 0) & ~own & (state.ty[..., :, None] >= 0)
    pairs = chip_smoke.bucket_pairs(state)
    assert pairs == int(valid.sum()) > 0
    counts = {"fp32_per_pair": 50.0, "mufu_per_pair": 2.0}
    live = int((state.ty >= 0).sum())
    assert live == 7 * 7 * 8  # the outer ring of the dense scene is empty
    assert chip_smoke.ext_bound(state, counts) == chip_smoke.bound(
        36 * live, chip_smoke.ops_bound_ms(pairs, counts))


def lattice_frame():
    """A hex lattice in the left of a 16:1 box: a 256 x 16 x 8 grid whose
    occupancy picks 2 lane chunks."""
    from particle_simulator_tpu_torch.io.frame import Frame, MieParams
    from particle_simulator_tpu_torch.io.presets import ParticleLattice

    frame = Frame.new()
    meta = frame.metadata
    side = 12 * MieParams.nitrogen().force0_r() * 1.1 / 0.5
    meta.box_width, meta.box_height = 16 * side, side
    meta.step_dt, meta.steps_per_frame = 1e-14, 4
    ParticleLattice((12, 12), distance_factor=1.1, velocity=(0.0, 30.0)).hex_square(
        frame, (side, side / 2), rng=np.random.default_rng(5))
    return frame


def test_readback_check_compares_ticket_bytes_and_held_state(monkeypatch):
    """Phase 13's readback check, driven through a CPU Simulator on the
    ext frame; its comparison fails on other bytes or a written held state."""
    from particle_simulator_tpu_torch.engine.simulator import Simulator

    monkeypatch.setenv("PS_EXT_IO", "compact")
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    sim.load_frame(lattice_frame())
    assert sim._lane_chunks == 2
    assert chip_smoke.readback_check(sim) == {"active_kernel": "bucket-compact-torch-cpu",
                                              "particles": 144}
    state = sim.state
    copy = bucket.ParticleState(*(a.clone() for a in state))
    frame = sim.read_frame().bytes
    chip_smoke.compare_readback(frame, frame, state, copy)
    with pytest.raises(AssertionError, match="other bytes"):
        chip_smoke.compare_readback(frame, frame[:-1] + bytes([frame[-1] ^ 1]), state, copy)
    copy.vy[0, 0, 0] += 1.0
    with pytest.raises(AssertionError, match="held state's vy"):
        chip_smoke.compare_readback(frame, frame, state, copy)


def test_frozen_force_law_counts_reproduce_the_recorded_bounds():
    """The bounds come from ``FORCE_LAW_COUNTS``, not from the SASS of the
    kernel under test: they give the operation bounds recorded for the
    kernels these counts were read from (16,384 all-pairs slots: 0.4086 ms;
    the 1M user scene's 38,708,704 live pairs: 0.0589 ms)."""
    counts = chip_smoke.FORCE_LAW_COUNTS
    assert counts == {"fp32_per_pair": 51.0, "mufu_per_pair": 2.0}
    assert chip_smoke.ops_bound_ms(16384 * 16383) == chip_smoke.ops_bound_ms(16384 * 16383, counts)
    assert round(chip_smoke.ops_bound_ms(16384 * 16383), 4) == 0.4086
    assert round(chip_smoke.ops_bound_ms(38708704), 4) == 0.0589


def test_ptxas_summary_names_each_kernel():
    log = """$ nvcc -c bucket_step.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab324bucket_step_tiles_kernelILb1EEEvPKjS2_PKfS4_PKiS4_S6_S6_S6_PjS7_PfS8_iiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab324bucket_step_tiles_kernelILb1EEEvPKjS2_PKfS4_PKiS4_S6_S6_S6_PjS7_PfS8_iiiiiiii
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes smem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__2a10dead_16_allpairs_step_cu_ad9a7de720allpairs_step_kernelEPKjS1_PKfS3_PKiS3_PjS6_PfS7_i' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 27464 bytes smem
"""
    assert chip_smoke.ptxas_summary(log) == {
        "bucket_step_tiles_kernel<1>": {"spill_stores": 8, "spill_loads": 4, "registers": 64,
                                        "smem": 80},
        "allpairs_step_kernel": {"spill_stores": 0, "spill_loads": 0, "registers": 63,
                                 "smem": 27464},
    }


def test_ext_geometry_sweep_runs_through_the_plain_versions():
    """The card-side sweep of tile geometries, rehearsed on CPU tensors (the
    wrappers run the plain versions): every case bit-identical, and between
    them a cap that is no multiple of 4, 16-row and 4-row tiles and dead
    tiles."""
    lines = chip_smoke.ext_geometry_sweep("cpu")
    assert [tuple(ln["grid"]) for ln in lines] == [g for g, _, _ in chip_smoke.EXT_GEOMETRIES]
    assert {ln["ty_rows"] for ln in lines} == {4, 8, 16}
    assert any(ln["grid"][2] % 4 for ln in lines)
    assert any(ln["live_tile_share"] < 1 for ln in lines) and all(ln["live"] for ln in lines)


@pytest.mark.parametrize("kernel, mangled", [
    ("bucket_step_kernel<0>",
     "_ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab318bucket_step_kernelILb0EEEvPKjS2_"
     "PKfS4_PKiS4_PjS7_PfS8_iiiiiii"),
    ("bucket_step_kernel<1>",
     "_ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab318bucket_step_kernelILb1EEEvPKjS2_"
     "PKfS4_PKiS4_PjS7_PfS8_iiiiiii"),
    ("bucket_dest_kernel<0>",
     "_ZN47_GLOBAL__N__1f2e3d4c_14_bucket_dest_cu_0a1b2c3d18bucket_dest_kernelILb0EEEvPKjS2_"
     "PKiS4_Piiiiiiii"),
    ("bucket_dest_kernel<1>",
     "_ZN47_GLOBAL__N__1f2e3d4c_14_bucket_dest_cu_0a1b2c3d18bucket_dest_kernelILb1EEEvPKjS2_"
     "PKiS4_Piiiiiiii"),
])
def test_ptxas_summary_names_the_step_and_dest_instances(kernel, mangled):
    """The build line's figures of the staged step and the target-centred
    dest: each template instance under its own name, with its dynamic
    shared memory left out (ptxas reports the static part only)."""
    log = f"""ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'
ptxas info    : Function properties for {mangled}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 72 bytes smem
"""
    assert chip_smoke.ptxas_summary(log) == {
        kernel: {"spill_stores": 0, "spill_loads": 0, "registers": 56, "smem": 72}}


def test_step_dest_geometry_sweep_runs_through_the_plain_versions():
    """The card-side sweep of the classic and halo step and dest, rehearsed
    on CPU tensors (the wrappers run the plain versions): between its cases
    sides that no sub-tile divides, caps 6, 8, 12 and 64, stacks of 1 to 4
    shards, and moves that drop particles and pull ring particles in."""
    lines = chip_smoke.step_dest_geometry_sweep("cpu")
    shapes = [tuple(ln["shape"]) for ln in lines]
    assert shapes == list(chip_smoke.STEP_DEST_GEOMETRIES)
    assert {s[-1] for s in shapes} >= {6, 8, 12, 64}
    assert {s[0] for s in shapes if len(s) == 4} == {1, 2, 3, 4}
    assert any((s[-3] - 2) % 8 and (s[-2] - 2) % 16 for s in shapes if len(s) == 4)
    for halo in (False, True):
        assert any(ln["dropped_by_move"] for ln in lines if ln["halo"] == halo)
    assert all(ln["receivers"] for ln in lines)
    assert any(ln["pulled_in_from_ring"] for ln in lines)


def test_drift_grid_places_shards_in_the_global_grid():
    """The sweep's scenes: slot prefixes with holes, a dead corner, shards
    inside a 64 x 64 global grid with the first at its origin, and most
    particles within one bucket of where they are stored."""
    state, bx_log2, by_log2, offsets = chip_smoke.drift_grid((3, 19, 33, 8), 1)
    assert (bx_log2, by_log2) == (6, 6) and offsets.dtype == torch.int32
    assert offsets[0].tolist() == [0, 0]
    assert (offsets[:, 0] + 17 <= 64).all() and (offsets[:, 1] + 31 <= 64).all()
    assert not (state.ty[:, :9, :16] >= 0).any() and (state.ty[:, 9:, 16:] >= 0).any()
    dest = bucket.move_dest_direct_halo(state, bx_log2, by_log2, offsets)
    live = state.ty >= 0
    assert 0.3 < float((dest[live] >= 0).float().mean()) < 0.95
    grid, bx, by, none = chip_smoke.drift_grid((16, 64, 16), 2)
    assert (bx, by, none) == (6, 4, None) and grid.x.shape == (16, 64, 16)
    assert all(a.is_contiguous() for a in grid)
