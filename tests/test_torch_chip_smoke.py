"""The CPU-side helpers of ``chip_smoke.py``: the SASS loop count that sets
the arithmetic bounds, the bound arithmetic, the bucket-step pair counts,
the place library calls, the device busy-share arithmetic, the ext step's
bound and live-tile share, the readback check, phase 20's child lines,
launch check and grid identity, and phase 21's module reports, FIFO frame
check, served-grid hold and checks (the whole phase once, on the CPU at a
small size), and phase 22's bench-line checks and holds (the whole phase
once, on the CPU at a tiny size). The card's own phases run only on the
card."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from particle_simulator_tpu_torch.bench import dense_grid_scene
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


def test_kernel_lookups_tell_the_two_step_kernels_apart():
    """``bucket_step_kernel`` is the start of ``bucket_step_kernel_tiles``:
    the SASS lookup and the mangled-name reader take a kernel by its whole
    identifier, whichever function comes first."""
    ns = "_ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab3"
    tiles, classic = ns + "24bucket_step_kernel_tilesILb1EEEvPKj", ns + "18bucket_step_kernelILb0EEEvPKj"

    def function(name, op):
        return (f"\t\tFunction : {name}\n"
                f"        /*0000*/                   {op} R1, R2, R3 ;\n"
                "        /*0010*/                   MUFU.EX2 R4, R1 ;\n"
                "        /*0020*/                   BRA 0x0 ;\n")

    sass = "\n" + function(tiles, "FADD") + function(classic, "FMUL")
    assert chip_smoke.main_loop_sass(sass, "bucket_step_kernel") == ["FMUL", "MUFU.EX2", "BRA"]
    assert chip_smoke.main_loop_sass(sass, "bucket_step_kernel_tiles")[0] == "FADD"
    assert chip_smoke.kernel_name(tiles) == "bucket_step_kernel_tiles<1>"
    assert chip_smoke.kernel_name(classic) == "bucket_step_kernel<0>"
    assert chip_smoke.kernel_name("tombstone_fill_kernel") == "tombstone_fill_kernel"


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
    parts, _, live = dense_grid_scene(cfg)
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
    parts, _, _ = dense_grid_scene(cfg)
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
    parts, _, _ = dense_grid_scene(cfg)
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


def test_readback_bound_and_hold_on_the_cpu(monkeypatch):
    """Phase 24's byte bound of the record pack (each bucket's ty to its
    first tombstone, the live records read, ncap records and the header
    written) and its hold, which on the CPU compares the plain version with
    itself and raises on a word the pack changed."""
    from particle_simulator_tpu_torch.ops import readback

    state = quarter_live_dense(bucket.GridConfig(4, 4, 8))
    counts = (state.ty >= 0).sum(-1)
    live, full = int(counts.sum()), int((counts == 8).sum())
    assert 0 < full < counts.numel()
    nbytes = 4 * (live + counts.numel() - full) + 20 * live + 20 * 512 + 16
    assert chip_smoke.readback_bound(state, 512) == chip_smoke.bound(nbytes)
    assert chip_smoke.hold_readback(state, 512, "quarter") == live == 392
    pack = readback.pack_records

    def off_by_one(state, ncap):
        words = pack(state, ncap)
        words[7] += 1
        return words

    monkeypatch.setattr(readback, "pack_records", off_by_one)
    with pytest.raises(AssertionError, match="1 record words differ from the plain pack, "
                                             "first at \\[7\\]"):
        chip_smoke.hold_readback(state, 512, "quarter")


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
    live-tile frame its scene picks; its comparison fails on other bytes or
    a written held state."""
    from particle_simulator_tpu_torch.engine.simulator import Simulator

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
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab324bucket_step_kernel_tilesILb1EEEvPKjS2_PKfS4_PKiS4_S6_S6_S6_PjS7_PfS8_iiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__9040dbc3_14_bucket_step_cu_13312ab324bucket_step_kernel_tilesILb1EEEvPKjS2_PKfS4_PKiS4_S6_S6_S6_PjS7_PfS8_iiiiiiii
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes smem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__2a10dead_16_allpairs_step_cu_ad9a7de720allpairs_step_kernelEPKjS1_PKfS3_PKiS3_PjS6_PfS7_i' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 27464 bytes smem
"""
    assert chip_smoke.ptxas_summary(log) == {
        "bucket_step_kernel_tiles<1>": {"spill_stores": 8, "spill_loads": 4, "registers": 64,
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


def test_live_tile_sweep_runs_through_the_plain_versions():
    """Phase 25's small grids, rehearsed on CPU tensors (the wrappers run
    the plain versions): every case held, and between them omax below cap
    (the 16-byte stage's case on the card), 4-, 8- and 16-row tiles, a tile
    one bucket wide and the all-dead grid."""
    lines = chip_smoke.live_tile_sweep("cpu")
    assert [tuple(ln["grid"]) for ln in lines] == [g for g, *_ in chip_smoke.LIVE_TILE_GEOMETRIES]
    assert {ln["ty_rows"] for ln in lines} == {4, 8, 16}
    assert all(ln["omax"] < ln["grid"][2] for ln in lines)
    assert any(ln["grid"][1] == ln["lane_chunks"] for ln in lines)
    assert [ln["live"] for ln in lines].count(0) == 1


def test_drag_edit_circles_the_centre():
    """Phase 25's drag: a metadata-only frame a served frame, the cursor on
    the circle of a quarter of the box about its centre, a turn every
    ``DRAG_TURN_FRAMES`` frames, the particles untouched."""
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.physics import bucket
    from particle_simulator_tpu_torch.scenes.library import _scene

    sim = Simulator(bucket.GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(_scene(8, 8, distance_factor=1.1, speed=1.0, box_fill=0.5))
    before = sim.state.x.clone()
    seen = []
    for frame in (0, chip_smoke.DRAG_TURN_FRAMES // 4, chip_smoke.DRAG_TURN_FRAMES):
        edit = chip_smoke.drag_edit(sim, frame)
        assert edit.particle_count == 0
        sim.update_metadata(edit)
        seen.append(tuple(float(v) for v in sim.meta_record["cursor_pos"]))
        assert float(sim.meta_record["cursor_size"]) == pytest.approx(chip_smoke.DRAG_SIZE)
    np.testing.assert_allclose(seen, [(0.75, 0.5), (0.5, 0.75), (0.75, 0.5)], atol=1e-6)
    assert torch.equal(sim.state.x, before)


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


# -- phases 15-19: the scene runner's and the config scripts' path ---------------

def test_counted_launches_zeroes_and_reports(monkeypatch):
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda

    monkeypatch.setitem(bucket_cuda.LAUNCHES, "step", 7)
    monkeypatch.setitem(allpairs_cuda.LAUNCHES, "allpairs", 3)
    with chip_smoke.counted_launches() as seen:
        assert bucket_cuda.LAUNCHES["step"] == 0 and allpairs_cuda.LAUNCHES["allpairs"] == 0
        bucket_cuda.LAUNCHES["step"] += 2
        assert seen == {}
    assert seen["step"] == 2 and seen["allpairs"] == 0
    assert set(seen) == set(bucket_cuda.LAUNCHES) | set(allpairs_cuda.LAUNCHES)


def _soak_grid():
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    cfg = GridConfig(4, 4, 16)
    parts, meta = chip_smoke.stress_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity, "cpu").reshape(cfg.grid_shape)
    return state, SimParams.from_record(meta).vector("cpu")


def test_kernel_hold_compares_each_kernel_and_keeps_the_counts(monkeypatch):
    """A grid holds the step, the dest and the place, a flat state the
    all-pairs step (the plain versions on the CPU); the launch counts read
    afterwards what they read before."""
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda

    state, pv = _soak_grid()
    monkeypatch.setitem(bucket_cuda.LAUNCHES, "step", 7)
    monkeypatch.setitem(allpairs_cuda.LAUNCHES, "allpairs", 3)
    real = bucket_cuda.bucket_step_cuda

    def counting(state, pv):  # as the wrapper does where it launches
        bucket_cuda.LAUNCHES["step"] += 1
        return real(state, pv)

    monkeypatch.setattr(bucket_cuda, "bucket_step_cuda", counting)
    hold = chip_smoke.KernelHold()
    hold("grid", state, pv)
    flat = type(state)(*(a.reshape(-1)[:300] for a in state))
    hold("flat", flat, pv)
    assert bucket_cuda.LAUNCHES["step"] == 7 and allpairs_cuda.LAUNCHES["allpairs"] == 3
    assert hold.err == {"step": 0.0, "dest": 0.0, "place": 0.0, "allpairs": 0.0}
    grid, line = hold.held
    assert grid["at"] == "grid" and grid["shape"] == [16, 16, 16] and grid["moved_by_dest"] > 0
    assert line == {"at": "flat", "shape": [300], "live": int((flat.ty >= 0).sum())}


@pytest.mark.parametrize("wrapper", ["bucket_step_cuda", "move_dest_cuda", "bucket_place_cuda"])
def test_kernel_hold_raises_on_a_difference(monkeypatch, wrapper):
    """One slot off in one kernel's output is a failure, whichever kernel."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    state, pv = _soak_grid()
    real = getattr(bucket_cuda, wrapper)

    def off_by_one(*args):
        out = real(*args)
        if wrapper == "move_dest_cuda":
            out = out.clone()
            out[0, 0, 0] += 1
            return out
        x = out.x.clone()
        x[3, 3, 0] += 1
        return out._replace(x=x)

    monkeypatch.setattr(bucket_cuda, wrapper, off_by_one)
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.KernelHold()("grid", state, pv)


def test_kernel_hold_raises_on_an_allpairs_difference(monkeypatch):
    from particle_simulator_tpu_torch.ops import allpairs_cuda

    state, pv = _soak_grid()
    flat = type(state)(*(a.reshape(-1)[:300] for a in state))
    real = allpairs_cuda.allpairs_step_cuda
    monkeypatch.setattr(allpairs_cuda, "allpairs_step_cuda",
                        lambda s, p: real(s, p)._replace(vx=real(s, p).vx + 1.0))
    with pytest.raises(AssertionError, match="vx differs"):
        chip_smoke.KernelHold()("flat", flat, pv)


def test_integrator_drift_helpers():
    assert chip_smoke.quarter_points([1, 2, 3, 4, 5, 6, 7, 8]) == [2, 4, 6, 8]
    assert chip_smoke.secular_growth([0.1, 0.2, 0.3, 0.4])
    assert not chip_smoke.secular_growth([0.1, 0.3, 0.2, 0.4])
    assert chip_smoke.secular_growth([np.inf])
    # leapfrog through the all-pairs wrapper (the plain version on the CPU)
    from particle_simulator_tpu_torch.ops.allpairs_cuda import allpairs_step_cuda
    from particle_simulator_tpu_torch.physics.step import allpairs_step

    got = chip_smoke.integrator_drifts(allpairs_step_cuda, 4, 5)
    assert got == chip_smoke.integrator_drifts(allpairs_step, 4, 5)
    assert len(got) == 4 and all(0 <= d < 0.05 for d in got)

    def explode(state, params):
        return state._replace(vx=state.vx * float("inf"))

    assert chip_smoke.integrator_drifts(explode, 3, 1) == [np.inf]


def test_integrator_contrast_accepts_and_refuses():
    leapfrog = [4e-4, 7e-4, 1.3e-3, 2e-4, 2e-4, 2e-4, 4e-5, 2e-6, 3e-4]
    euler = [0.02, 0.04, 0.057, 0.063, 0.068, 0.073, 0.076, 0.078]
    line = chip_smoke.integrator_contrast(leapfrog, euler)
    assert line["leapfrog_worst_drift_same_horizon"] == 1.3e-3
    assert line["euler_over_leapfrog_same_horizon"] == pytest.approx(60.0)
    assert line["euler_quarter_points"] == [0.04, 0.063, 0.073, 0.078]
    assert chip_smoke.integrator_contrast(leapfrog, [np.inf])["euler_quarter_points"] == [np.inf] * 4
    with pytest.raises(AssertionError, match="shorter"):
        chip_smoke.integrator_contrast(leapfrog[:4], euler)
    with pytest.raises(AssertionError, match="not secular"):
        chip_smoke.integrator_contrast(leapfrog, euler[::-1])
    with pytest.raises(AssertionError, match="every read"):
        chip_smoke.integrator_contrast([0.03] + leapfrog[1:], euler)
    with pytest.raises(AssertionError, match="no contrast"):
        chip_smoke.integrator_contrast([x * 4 for x in leapfrog], euler)


def test_integrator_contrast_holds_on_the_cpu():
    """Phase 18's comparison on the CPU over Euler's whole horizon and the
    same 2,000 steps of leapfrog, both read every 250 steps."""
    from particle_simulator_tpu_torch.physics.step import allpairs_step, allpairs_step_euler

    leapfrog = chip_smoke.integrator_drifts(allpairs_step, 8, 250)
    euler = chip_smoke.integrator_drifts(allpairs_step_euler, 8, 250)
    line = chip_smoke.integrator_contrast(leapfrog, euler)
    assert max(leapfrog) < 0.05
    assert line["euler_over_leapfrog_same_horizon"] > chip_smoke.EULER_OVER_LEAPFROG_MIN


def test_png_gif_and_trace_readers(tmp_path):
    from particle_simulator_tpu_torch.editor.render import write_gif, write_png

    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (20, 30, 3), dtype=np.uint8) for _ in range(4)]
    write_png(str(tmp_path / "a.png"), imgs[0])
    assert chip_smoke.png_size(tmp_path / "a.png") == (30, 20)
    write_gif(str(tmp_path / "a.gif"), imgs)
    assert chip_smoke.gif_shape(tmp_path / "a.gif") == (30, 20, 4)
    (tmp_path / "bad.png").write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(AssertionError):
        chip_smoke.png_size(tmp_path / "bad.png")
    with pytest.raises(AssertionError):
        chip_smoke.gif_shape(tmp_path / "a.png")
    trace = {"traceEvents": [
        {"name": "dispatch", "cat": "user_annotation"},
        {"name": "void bucket_step_kernel<false>(...)", "cat": "kernel"},
        {"name": "aten::add", "cat": "cpu_op"}, {"name": "meta"}]}
    (tmp_path / "t.json").write_text(json.dumps(trace))
    assert chip_smoke.trace_names(tmp_path / "t.json") == (
        {"dispatch"}, {"void bucket_step_kernel<false>(...)"})


def test_kernel_entry_keeps_the_contract_keys():
    entry = chip_smoke.kernel_entry("bucket_step", "bucket_step.cu", chip_smoke.STEP_KERNEL, 1100,
                                    0.0, 0.2, 19.9, {"bound_ms": 0.1, "bound_by": "operations"},
                                    None, 337_500)
    assert set(entry) == {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                          "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_scripts",
                          "launches_multiprocess", "launches_config5", "launches_bench",
                          "launches_scale"}
    assert entry["launches"] == 1100 and entry["launches_scripts"] == 337_500
    assert entry["launches_multiprocess"] == 0 and entry["launches_config5"] == 0
    assert entry["launches_bench"] == 0 and entry["launches_scale"] == 0
    halo = chip_smoke.kernel_entry("bucket_step_halo", "bucket_step.cu",
                                   chip_smoke.STEP_HALO_KERNEL, 1800, 0.0, 0.2, 23.4,
                                   {"bound_ms": 0.1, "bound_by": "operations"}, None,
                                   launches_multiprocess=2600)
    assert halo["launches_multiprocess"] == 2600 and halo["launches_scripts"] == 0


# phase 20's pure helpers: the child lines, the launch check, the bit
# identity of the gathered grid

def _grid(seed=0):
    from particle_simulator_tpu_torch.engine.state import ParticleState

    rng = np.random.default_rng(seed)
    ty = torch.from_numpy(rng.integers(-1, 2, (4, 4, 2)).astype(np.int32))
    return ParticleState(torch.from_numpy(rng.integers(0, 2**31, (4, 4, 2)).astype(np.int32)),
                         torch.from_numpy(rng.integers(0, 2**31, (4, 4, 2)).astype(np.int32)),
                         torch.from_numpy(rng.normal(size=(4, 4, 2)).astype(np.float32)),
                         torch.from_numpy(rng.normal(size=(4, 4, 2)).astype(np.float32)), ty)


def test_same_grid_holds_live_slots_and_reports_all_slots():
    ref = _grid()
    assert chip_smoke.same_grid(ref, ref, "x") == {"bit_identical_live": True,
                                                   "bit_identical_all_slots": True}
    dead = ref.ty < 0
    vx = ref.vx.clone()
    vx[dead] += 1.0  # a tombstone's velocity differs: live slots still hold
    assert chip_smoke.same_grid(ref._replace(vx=vx), ref, "x")["bit_identical_all_slots"] is False
    vx = ref.vx.clone()
    vx[~dead] = torch.nextafter(vx[~dead], torch.tensor(9.0))
    with pytest.raises(AssertionError, match="live vx"):
        chip_smoke.same_grid(ref._replace(vx=vx), ref, "x")
    ty = ref.ty.clone()
    ty[0, 0, 0] = 5
    with pytest.raises(AssertionError, match="ty differs at 1 slots"):
        chip_smoke.same_grid(ref._replace(ty=ty), ref, "x")


def _line(rank, **launches):
    base = {k: 0 for k in ("step", "dest", "place", "step_halo", "dest_halo", "place_halo",
                           "step_ext", "step_compact", "allpairs")}
    return {"rank": rank, "backend": "gloo", "launches": {**base, **launches},
            "foreign_modules": []}


def test_child_and_daemon_lines_parse_and_refuse():
    good = _line(0, step_halo=3)
    outs = [(0, "noise\n" + json.dumps(good) + "\n", ""), (0, json.dumps(_line(1)), "")]
    assert chip_smoke.child_lines(outs, "t") == [good, _line(1)]
    with pytest.raises(AssertionError, match="process 1 exited 3"):
        chip_smoke.child_lines([outs[0], (3, "", "boom")], "t")
    with pytest.raises(AssertionError, match="printed no line"):
        chip_smoke.child_lines([(0, "  \n", "")], "t")
    err = "engine: scene loaded\nengine: rank stats " + json.dumps(good) + "\nengine: bye\n"
    assert chip_smoke.rank_stats_lines([(0, "", err)], "t") == [good]
    with pytest.raises(AssertionError, match="daemon 0 exited 1"):
        chip_smoke.rank_stats_lines([(1, "", err)], "t")
    with pytest.raises(AssertionError, match="0 stats lines"):
        chip_smoke.rank_stats_lines([(0, "", "engine: bye")], "t")


def test_check_processes_sums_the_halo_path_and_refuses_the_rest():
    halo = dict(step_halo=100, dest_halo=7, place_halo=7)
    lines = [_line(0, **halo), _line(1, **halo)]
    total = chip_smoke.check_processes(lines, backend="gloo")
    assert {k: total[k] for k in halo} == {"step_halo": 200, "dest_halo": 14, "place_halo": 14}
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_processes([_line(0, step_halo=100, dest_halo=7)])
    with pytest.raises(AssertionError, match="another path"):
        chip_smoke.check_processes([_line(0, **halo, step=1)])
    with pytest.raises(AssertionError, match="ran over gloo, not nccl"):
        chip_smoke.check_processes(lines, backend="nccl")
    with pytest.raises(AssertionError, match="imported"):
        chip_smoke.check_processes([{**_line(0, **halo), "foreign_modules": ["jax"]}])


def test_multiprocess_env_puts_sharing_processes_on_the_first_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1")
    env = chip_smoke.multiprocess_env(2, 1, "127.0.0.1:9", own_cards=False)
    assert (env["PS_TPU_COORDINATOR"], env["PS_TPU_NUM_PROCESSES"], env["PS_TPU_PROCESS_ID"]) == (
        "127.0.0.1:9", "2", "1")
    assert env["CUDA_VISIBLE_DEVICES"] == "3"  # both processes on the first card
    assert chip_smoke.multiprocess_env(4, 0, "c", own_cards=True)["CUDA_VISIBLE_DEVICES"] == "3,1"


def _halo_blocks():
    """The stress scene's (16, 16, 16) grid as the blocks of a one-process
    (2, 2) CPU mesh, with its grid config and params."""
    from particle_simulator_tpu_torch.parallel import domain
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    state, pv = _soak_grid()
    mesh = domain.make_mesh(devices=[torch.device("cpu")] * 4)
    return domain.shard_state(state, mesh), mesh, GridConfig(4, 4, 16), [pv]


def test_hold_halo_compares_each_halo_kernel_and_keeps_the_counts(monkeypatch):
    """Phase 20's hold on a process's own blocks: the three halo kernels
    against their plain versions (the plain versions on the CPU), the ring
    filled by the mesh's exchange; the launch and exchange counts read
    afterwards what they read before."""
    from particle_simulator_tpu_torch.ops import bucket_cuda
    from particle_simulator_tpu_torch.parallel import domain

    blocks, mesh, cfg, pvs = _halo_blocks()
    monkeypatch.setitem(bucket_cuda.LAUNCHES, "step_halo", 7)
    monkeypatch.setitem(domain.EXCHANGE, "bytes", 5)
    real = bucket_cuda.bucket_step_halo_cuda

    def counting(padded, pv):  # as the wrapper does where it launches
        bucket_cuda.LAUNCHES["step_halo"] += 1
        return real(padded, pv)

    monkeypatch.setattr(bucket_cuda, "bucket_step_halo_cuda", counting)
    line = chip_smoke.hold_halo("loaded", blocks, mesh, cfg, pvs)
    assert bucket_cuda.LAUNCHES["step_halo"] == 7 and domain.EXCHANGE["bytes"] == 5
    assert line["max_abs_err"] == {"step_halo": 0.0, "dest_halo": 0.0, "place_halo": 0.0}
    assert line["blocks"] == [[4, 10, 10, 16]] and line["migrating_in_from_ring"] > 0
    assert line["live"] > 0 and line["at"] == "loaded"
    assert chip_smoke.held_errors([line, {**line, "max_abs_err": {
        "step_halo": 0.5, "dest_halo": 0.0, "place_halo": 0.0}}])["step_halo"] == 0.5
    with pytest.raises(AssertionError, match="no halo hold"):
        chip_smoke.held_errors([])


@pytest.mark.parametrize("wrapper", ["bucket_step_halo_cuda", "move_dest_halo_cuda",
                                     "bucket_place_halo_cuda"])
def test_hold_halo_raises_on_a_difference(monkeypatch, wrapper):
    """One slot off in one halo kernel's output is a failure, whichever."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    blocks, mesh, cfg, pvs = _halo_blocks()
    real = getattr(bucket_cuda, wrapper)

    def off_by_one(*args):
        out = real(*args)
        if wrapper == "move_dest_halo_cuda":
            out = out.clone()
            out[0, 1, 1, 0] += 1
            return out
        x = out.x.clone()
        x[0, 3, 3, 0] += 1
        return out._replace(x=x)

    monkeypatch.setattr(bucket_cuda, wrapper, off_by_one)
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.hold_halo("loaded", blocks, mesh, cfg, pvs)


def test_inspect_lines_want_two_holds_a_daemon():
    held = {"at": "as loaded", "max_abs_err": dict.fromkeys(chip_smoke.HALO_KERNELS, 0.0)}
    err = "".join(f"engine: inspect {json.dumps({**held, 'n': i})}\n" for i in range(2))
    got = chip_smoke.inspect_lines([(0, "", "engine: x\n" + err), (0, "", err)], "t")
    assert [h["n"] for h in got] == [0, 1, 0, 1]
    with pytest.raises(AssertionError, match="daemon 1 held its blocks 1 times"):
        chip_smoke.inspect_lines([(0, "", err), (0, "", err.splitlines()[0])], "t")


# phase 21: config 5's children, frames and served grid

def test_child_modules_wants_one_empty_report():
    from particle_simulator_tpu_torch.utils.log import FOREIGN_MODULES_TAG

    line = f"engine: {FOREIGN_MODULES_TAG}"
    assert chip_smoke.child_modules(f"x\n{line}[]\n", "engine", "t") == []
    with pytest.raises(AssertionError, match="imported"):
        chip_smoke.child_modules(f'{line}["jax", "jax.numpy"]\n', "engine", "t")
    with pytest.raises(AssertionError, match="printed 0"):
        chip_smoke.child_modules("engine: disconnected after 3 frames\n", "engine", "t")
    with pytest.raises(AssertionError, match="printed 2"):
        chip_smoke.child_modules(f"{line}[]\n{line}[]\n", "engine", "t")
    with pytest.raises(AssertionError, match="printed 0"):
        chip_smoke.child_modules(f"{line}[]\n", "editor UI", "t")


def _wire_frames(counts, nan_at=()):
    from particle_simulator_tpu_torch.io.frame import Frame

    frames = []
    for i, n in enumerate(counts):
        f = Frame.new()
        parts = np.zeros(n, dtype=f.particles.dtype)
        parts["vx"] = np.arange(n, dtype=np.float32)
        if i in nan_at:
            parts["vy"][n // 2] = np.nan
        f.extend(parts)
        frames.append(f)
    return frames


def test_frame_check_counts_frames_particles_and_non_finite(tmp_path):
    from particle_simulator_tpu_torch.io.transport import Writer

    fifo = str(tmp_path / "frames.fifo")
    os.mkfifo(fifo)
    check = chip_smoke.FrameCheck(fifo)
    writer = Writer.open_file(fifo)
    for f in _wire_frames([5, 300, 0, 17], nan_at=(1,)):
        assert writer.write(f)
    writer.close()
    check.finish(30)
    assert (check.frames, check.particles, check.nonfinite, check.error) == (
        4, [0, 300], [1], None)


def test_frame_check_reports_a_cut_stream_and_a_missing_writer(tmp_path):
    from particle_simulator_tpu_torch.io.frame import HEADER_SIZE

    fifo = str(tmp_path / "frames.fifo")
    os.mkfifo(fifo)
    check = chip_smoke.FrameCheck(fifo)
    raw = _wire_frames([10])[0].bytes
    with open(fifo, "wb") as f:
        f.write(raw[:HEADER_SIZE + 30])
    check.finish(30)
    assert check.frames == 0 and "mid-frame" in check.error
    os.unlink(fifo)
    os.mkfifo(fifo)
    idle = chip_smoke.FrameCheck(fifo)  # no writer ever opens it
    idle.finish(1)
    assert idle.frames == 0 and idle.error is None


def _served_sim():
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.io.frame import Frame
    from particle_simulator_tpu_torch.io.presets import ParticleLattice
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    frame = Frame.new()
    meta = frame.metadata
    ParticleLattice((8, 8), distance_factor=4.0, velocity=(0.0, 10.0)).hex_square(
        frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(0))
    meta.steps_per_frame = 3
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(frame)
    return sim


def test_hold_grid_holds_the_served_grid_and_reports_launches(monkeypatch):
    from particle_simulator_tpu_torch.ops import bucket_cuda

    sim = _served_sim()
    monkeypatch.setitem(bucket_cuda.LAUNCHES, "step", 7)
    line = chip_smoke.hold_grid("as loaded", sim)
    assert line["at"] == "as loaded" and line["shape"] == [16, 16, 8] and line["live"] == 64
    assert line["finite"] and line["launches"]["step"] == 7
    assert line["max_abs_err"] == {"step": 0.0, "dest": 0.0, "place": 0.0}
    assert bucket_cuda.LAUNCHES["step"] == 7  # the hold's own launches are taken out
    json.dumps(line)
    sim.state = sim.state._replace(vx=torch.full_like(sim.state.vx, float("nan")))
    with pytest.raises(AssertionError):  # the step of a NaN state differs from itself
        chip_smoke.hold_grid("after", sim)


def _config5_inputs():
    rec = {"particles": 1024, "engine_fps": 4.0, "fetch_errors": 0, "engine_frames": 8}
    check = chip_smoke.FrameCheck.__new__(chip_smoke.FrameCheck)
    check.frames, check.particles, check.nonfinite, check.error = 10, [1024, 1024], [], None
    launches = {"step": 300, "dest": 21, "place": 21, "step_halo": 0, "allpairs": 0}
    err = {"step": 0.0, "dest": 0.0, "place": 0.0}
    held = [{"finite": True, "launches": dict.fromkeys(launches, 0), "max_abs_err": err},
            {"finite": True, "launches": launches, "max_abs_err": err}]
    return rec, check, held


@pytest.mark.parametrize("fault, match", [
    (None, None),
    (("rec", "particles", 900), "fewer than 0.9"),
    (("rec", "engine_fps", 0.0), "engine fps"),
    (("rec", "fetch_errors", 2), "fetches failed"),
    (("check", "error", "ValueError()"), "frame check failed"),
    (("check", "frames", 7), "FIFO carried 7"),
    (("check", "frames", 13), "FIFO carried 13"),
    (("check", "nonfinite", [4]), "not finite"),
    (("check", "particles", [512, 1024]), "held 512 particles"),
    (("held", "finite", False), "finite"),
    (("launches", "dest", 0), "never launched"),
    (("launches", "step_halo", 5), "another path"),
])
def test_config5_checks_accept_and_refuse(fault, match):
    rec, check, held = _config5_inputs()
    if fault is not None:
        where, key, value = fault
        target = {"rec": rec, "check": check.__dict__, "held": held[1],
                  "launches": held[1]["launches"]}[where]
        target[key] = value
    if match is None:
        got = chip_smoke.config5_checks(rec, check, held, 11, 1024)
        assert got["launches"]["step"] == 300 and got["err"]["place"] == 0.0
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.config5_checks(rec, check, held, 11, 1024)


def test_config5_checks_follow_the_served_step():
    """A daemon that served config 5 through the live-tile step passes the
    checks of that path, and fails those of the classic one."""
    rec, check, held = _config5_inputs()
    launches = {"step": 0, "step_compact": 300, "dest": 21, "place": 21}
    held[1]["launches"] = launches
    held[1]["max_abs_err"] = {"step_compact": 0.0, "dest": 0.0, "place": 0.0}
    got = chip_smoke.config5_checks(rec, check, held, 11, 1024, ("step_compact", "dest", "place"))
    assert got["launches"]["step_compact"] == 300
    assert got["err"] == {"step": 0.0, "step_compact": 0.0, "dest": 0.0, "place": 0.0}
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.config5_checks(rec, check, held, 11, 1024)


def test_phase_config5_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 21 end to end at 32x32 with the daemon on the CPU: the script's
    record, the FIFO, the daemon's two holds through --inspect, both module
    reports; the CPU launches no kernel."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    verdict = chip_smoke.phase_config5(str(tmp_path), seconds=3, n_side=32, steps_per_frame=1,
                                       torch_device="cpu")
    assert not any(verdict["launches"].values())
    assert verdict["err"] == {"step": 0.0, "dest": 0.0, "place": 0.0}
    out = capsys.readouterr().out
    rec = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("config 5: "))[len("config 5: "):])
    assert rec["particles"] == 1024 and rec["engine_frames"] > 0
    held = json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("config 5 held: "))[len("config 5 held: "):])
    assert [h["at"] for h in held["states"]][0] == "as loaded"
    assert held["fifo_frames"] >= rec["engine_frames"] and not held["nonfinite_frames"]


# phase 22's pure helpers: the bench's line checks, the hold on the bench's
# states, and the whole phase once on the CPU at a tiny size

def _bench_line(mode="dense", **kw):
    rec = {k: 1 for k in chip_smoke.BENCH_KEYS[mode]}
    rec.update(device="cuda", particles=288, value=5.0e9, frames=2, steps_per_frame=4)
    if mode == "sharded":
        rec["sharded_mesh"] = [1, 1]
    rec.update(kw)
    return rec


@pytest.mark.parametrize("fault, match", [
    (None, None),
    (("rec", "live_fraction_end", None), "keys"),
    (("rec", "frame_s", 1), "keys"),
    (("rec", "device", "cpu"), "expected 288 on cuda"),
    (("rec", "particles", 287), "expected 288"),
    (("rec", "value", float("nan")), "rate"),
    (("rec", "value", 0.0), "rate"),
    (("launches", "step", 11), "expected 12 step"),
    (("launches", "place", 0), "every kernel"),
    (("launches", "step_halo", 3), "another path"),
])
def test_bench_checks_accept_and_refuse(fault, match):
    rec = _bench_line()
    launches = {"step": 12, "dest": 1, "place": 1, "step_halo": 0, "allpairs": 0}
    if fault is not None:
        where, key, value = fault
        target = rec if where == "rec" else launches
        if value is None:
            del target[key]
        else:
            target[key] = value
    args = ("dense", "dense", rec, launches, chip_smoke.CONFIG5_PATH, 288, "cuda")
    if match is None:
        chip_smoke.bench_checks(*args)
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.bench_checks(*args)


def test_bench_checks_count_a_step_a_block_on_a_mesh():
    """Sharded: one halo step launch a step per block, and the mesh's shape."""
    from particle_simulator_tpu_torch.parallel import domain

    mesh = domain.make_mesh(devices=[torch.device("cpu", i) for i in range(4)])
    launches = {"step_halo": 4 * 12, "dest_halo": 4, "place_halo": 4, "step": 0}
    rec = _bench_line("sharded", sharded_mesh=[2, 2])
    chip_smoke.bench_checks("s", "sharded", rec, launches, chip_smoke.HALO_KERNELS, 288,
                            "cuda", mesh)
    with pytest.raises(AssertionError, match="mesh"):
        chip_smoke.bench_checks("s", "sharded", {**rec, "sharded_mesh": [1, 1]}, launches,
                                chip_smoke.HALO_KERNELS, 288, "cuda", mesh)
    with pytest.raises(AssertionError, match="expected 48"):
        chip_smoke.bench_checks("s", "sharded", rec, {**launches, "step_halo": 12},
                                chip_smoke.HALO_KERNELS, 288, "cuda", mesh)


def test_bench_particles_follow_the_arguments():
    from particle_simulator_tpu_torch import bench

    def count(*argv):
        return chip_smoke.bench_particles(bench.parser().parse_args(list(argv)))

    assert count() == 510 * 254 * 8 == 1_036_320
    assert count("--particles", "512") == 6 * 6 * 8
    assert count(*chip_smoke.BENCH_USER) == 1_000_000
    assert count("--user-scene") == 1024 * 1024
    assert bench.dense_grid_scene(bench.dense_grid_config(512))[2] == count("--particles", "512")


def _sparse_grid():
    """A 16 x 128 x 16 grid whose left half holds the dense lattice: two
    lane chunks, two of its four 8-row tiles live."""
    from particle_simulator_tpu_torch import bench
    from particle_simulator_tpu_torch.engine.state import SimParams
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    cfg = GridConfig(7, 4, 16)
    parts, meta, _ = bench.dense_grid_scene(cfg, 16)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    state.ty[:, cfg.bx // 2:] = -1
    return state, SimParams.from_record(meta).vector()


def test_kernel_hold_holds_the_live_tile_step_where_the_unset_default_runs_it(monkeypatch):
    """A grid that the Simulator sends to the live-tile step (two lane
    chunks) holds that step too and names it and its chunks on its line; a
    grid of one lane chunk holds the classic step alone, whatever
    ``PS_EXT_IO`` holds."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    state, pv = _sparse_grid()
    one, one_pv = _soak_grid()
    calls = []
    real = bucket_cuda.bucket_step_ext_cuda

    def counting(pair, aux, compact):
        calls.append(compact)
        return real(pair, aux, compact)

    monkeypatch.setattr(bucket_cuda, "bucket_step_ext_cuda", counting)
    hold = chip_smoke.KernelHold()
    hold("sparse", state, pv)
    hold("one chunk", one, one_pv)
    assert [h["served_step"] for h in hold.held] == ["step_compact", "step"]
    assert [h["lane_chunks"] for h in hold.held] == [2, 1]
    assert calls == [True] and hold.err["step_compact"] == 0.0
    monkeypatch.setenv("PS_EXT_IO", "off")
    hold("set", state, pv)
    assert hold.held[-1]["served_step"] == "step_compact" and calls == [True, True]


@pytest.mark.parametrize("ext", ["compact"])
def test_bench_hold_holds_the_ext_step_and_keeps_the_counts(monkeypatch, ext):
    """A grid of two lane chunks holds the ``ext`` (live-tile) step, the one
    the Simulator runs on it, and the launch counts read afterwards what
    they read before; a grid of one lane chunk holds no ext step."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    state, pv = _sparse_grid()
    name = f"step_{ext}"
    monkeypatch.setitem(bucket_cuda.LAUNCHES, name, 7)
    real = bucket_cuda.bucket_step_ext_cuda

    def counting(pair, aux, compact):  # as the wrapper does where it launches
        bucket_cuda.LAUNCHES["step_compact" if compact else "step_ext"] += 1
        return real(pair, aux, compact)

    monkeypatch.setattr(bucket_cuda, "bucket_step_ext_cuda", counting)
    hold = chip_smoke.BenchHold()
    hold("loaded", state, pv)
    assert bucket_cuda.LAUNCHES[name] == 7
    assert hold.held[0]["lane_chunks"] == 2 and hold.held[0]["moved_by_dest"] >= 0
    assert set(hold.err) == {"step", "dest", "place", "allpairs", "step_compact",
                             *chip_smoke.HALO_KERNELS}
    assert not any(hold.err.values())
    # one lane chunk: the ext frame does not run, so nothing more is held
    one, _ = _soak_grid()
    hold("one chunk", one, _soak_grid()[1])
    assert hold.held[1]["lane_chunks"] == 1


def test_bench_hold_raises_on_an_ext_difference(monkeypatch):
    from particle_simulator_tpu_torch.ops import bucket_cuda

    state, pv = _sparse_grid()
    real = bucket_cuda.bucket_step_ext_cuda

    def off_by_one(pair, aux, compact):
        out = real(pair, aux, compact)
        x = out.cur.x.clone()
        x[3, 3, 0] += 1
        return out._replace(cur=out.cur._replace(x=x))

    monkeypatch.setattr(bucket_cuda, "bucket_step_ext_cuda", off_by_one)
    one, one_pv = _soak_grid()
    chip_smoke.BenchHold()("one chunk: classic only", one, one_pv)
    with pytest.raises(AssertionError, match="live-tile step"):
        chip_smoke.BenchHold()("loaded", state, pv)


def test_bench_hold_takes_a_mesh_s_blocks_to_hold_halo():
    blocks, mesh, cfg, pvs = _halo_blocks()
    hold = chip_smoke.BenchHold(mesh=mesh, cfg=cfg)
    hold("sharded", blocks, pvs)
    assert hold.held[0]["blocks"] == [[4, 10, 10, 16]]
    assert hold.err["step_halo"] == 0.0 and hold.held[0]["migrating_in_from_ring"] > 0


def test_phase_bench_runs_on_the_cpu(capsys):
    """Phase 22 end to end at 512 particles, 2 frames of 4 steps, on the
    CPU: every mode's line passes its checks, each run held two states;
    the CPU launches no kernel."""
    size = ("--particles", "512", "--frames", "2", "--steps", "4")
    out = chip_smoke.phase_bench("cpu", size=size)
    assert sorted(out["records"]) == sorted(chip_smoke.BENCH_RUNS)
    assert not any(out["launches"].values()) and not any(out["err"].values())
    assert out["records"]["sharded"]["sharded_mesh"] == [1, 1]
    assert out["records"]["user"]["ext_io"] == "auto"
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("bench ")]
    assert len(lines) == len(chip_smoke.BENCH_RUNS)



def test_phase_entry_runs_on_the_cpu(capsys):
    """Phase 22's entry points on the CPU: ``entry()``'s frame of the tiny
    scene (32 of its 144 particles fit the four full 8-slot buckets it
    covers; the frame ends with 31, as ``__graft_entry__.py``'s does), and
    the dry run for each shard count asked."""
    line = chip_smoke.phase_entry("cpu", shards=(1, 3))
    assert line["live"] == [32, 31] and line["dryrun_shards"] == [1, 3]
    assert "entry: " in capsys.readouterr().out


def test_phase_entry_fails_on_a_difference(monkeypatch):
    """A frame of ``entry()`` one unit off in one slot fails the phase."""
    from particle_simulator_tpu_torch import entry

    real = entry.entry

    def off_by_one(device="cuda"):
        fn, args = real(device)

        def wrong(state, params):
            out = fn(state, params)
            x = out.x.clone()
            x.view(-1)[0] += 1
            return out._replace(x=x)

        return wrong, args

    monkeypatch.setattr(entry, "entry", off_by_one)
    with pytest.raises(AssertionError, match="field x differs from the plain frame"):
        chip_smoke.phase_entry("cpu", shards=())
