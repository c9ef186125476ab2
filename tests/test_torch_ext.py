"""The port's ext-layout MatrixBuckets path against the JAX package: the
tile aux, the plain version of the tile-scheduled step (rows 5 and 6 of
PERF.md's kernel table, ``bucket_step_pallas_ext`` with ``compact`` True
and False), the ext frame and its runs (the JAX schedule's enter/exit
hooks), the buffers the live-tile frame steps in (no run enters with a
copy; the retire and the ``FrameSpare`` carried from frame to frame), a
model of the tile aux kernel, the Simulator's lane-chunk choice (the JAX
engine's) and its runner, which the scene alone picks: the live-tile step
wherever the scene got lane chunks, the rule of the JAX engine's
``PS_EXT_IO=auto``, whatever the environment holds. The JAX kernels run in
interpret mode.

Contract:
- the aux (params with omax, flags, order, sizes): bit-identical to JAX;
- the plain ext step and the ext frame: bit-identical to the port's classic
  plain step and frame, on every field and slot, over frames in a row that
  share one ``FrameSpare``, the given state's bytes unchanged;
- against JAX's ext step (two steps): ``ty`` equal, x/y within 8
  fixed-point units, live vx/vy within rtol 1e-4, atol 1e-6 (the North
  star's step envelope: f32 pair sums in another order);
- against JAX's ext frame (10 steps, rebucket every 4): the same envelope.

The CUDA kernel runs only on the card; ``chip_smoke.py`` phases 12 and 13 hold
it against these plain versions there. What its design relies on is held
here: a model of "compact each bucket row's live candidates, then three
contiguous runs a receiver" (``ops/csrc/bucket_stage.cuh``) gives
``bucket_step``'s result bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_simulator_tpu.engine import simulator as jsimulator
from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, Frame, MieParams, default_metadata
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.ops.bucket_pallas import (
    bucket_step_pallas_ext,
    ext_state_chunks,
    run_frame_bucket_pallas,
    unext_state_chunks,
)
from particle_simulator_tpu.ops.bucket_pallas import ext_step_aux as jext_step_aux
from particle_simulator_tpu.physics import bucket as jbucket
from particle_simulator_tpu.physics.bucket import GridConfig as JGridConfig
from particle_simulator_tpu_torch.engine import simulator
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import ParticleState, from_reference, to_reference
from particle_simulator_tpu_torch.io.frame import Frame as TFrame
from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
from particle_simulator_tpu_torch.ops import bucket_cuda
from particle_simulator_tpu_torch.physics import bucket, mie
from particle_simulator_tpu_torch.physics.step import external_forces
from particle_simulator_tpu_torch.scenes.library import _scene
from particle_simulator_tpu_torch.utils import profiling

import chip_smoke

torch.set_num_threads(2)

CFG = bucket.GridConfig(5, 4, 8)  # 16 rows x 32 columns x 8 slots, as tests/test_pallas.py
C = 2
ROWS = 8  # two row blocks: four tiles


def random_fields(seed, quarter):
    """tests/test_pallas.py's random ext-step state: random positions,
    half the slots live; ``quarter`` keeps only the top-left quarter."""
    rng = np.random.default_rng(seed)
    n = CFG.capacity
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    vx = rng.normal(0, 50, n).astype(np.float32)
    vy = rng.normal(0, 50, n).astype(np.float32)
    ty = np.where(rng.random(n) < 0.5, 0, -1).astype(np.int32)
    if quarter:
        g = ty.reshape(CFG.grid_shape)
        g[:, CFG.bx // 2:, :] = -1
        g[CFG.by // 2:, :, :] = -1
    return tuple(a.reshape(CFG.grid_shape) for a in (x, y, vx, vy, ty))


def empty_fields():
    z = np.zeros(CFG.grid_shape)
    return (z.astype(np.uint32), z.astype(np.uint32), z.astype(np.float32),
            z.astype(np.float32), np.full(CFG.grid_shape, -1, np.int32))


def step_meta():
    meta = default_metadata()
    meta["step_dt"] = 10e-15
    return meta


SCENES = {
    "quarter": lambda: random_fields(1, True),
    "full": lambda: random_fields(2, False),
    "empty": empty_fields,
}


def _jax(fields):
    return JState(*(jnp.asarray(a) for a in fields))


def _np(state):
    return [np.asarray(a) for a in state]


def assert_step_envelope(ref, got):
    """ref: JAX fields; got: port fields via to_reference."""
    np.testing.assert_array_equal(got[4], ref[4])
    for r, g in zip(ref[:2], got[:2]):
        delta = np.abs(r.astype(np.int64) - g.astype(np.int64))
        delta = np.minimum(delta, 2**32 - delta)  # u32 wrap
        assert delta.max(initial=0) <= 8, f"position off by {delta.max()} units"
    live = ref[4] >= 0
    for r, g in zip(ref[2:4], got[2:4]):
        np.testing.assert_allclose(g[live], r[live], rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(g[~live], r[~live])


def assert_same(a: ParticleState, b: ParticleState, label=""):
    for name, u, v in zip(ParticleState._fields, a, b):
        assert torch.equal(u, v), f"{label} field {name} differs"


@pytest.mark.parametrize("case", sorted(SCENES))
def test_ext_step_aux_matches_jax(case):
    fields = SCENES[case]()
    meta = step_meta()
    state, params = from_reference(fields, meta)
    aux = bucket.ext_step_aux(state, params.vector(), C, ROWS)
    jaux = jext_step_aux(ext_state_chunks(_jax(fields), C), JSimParams.from_record(meta), C, ROWS)
    np.testing.assert_array_equal(aux.params.numpy().view(np.int32),
                                  np.asarray(jaux.params).view(np.int32))
    for name in ("flags", "order", "sizes"):
        np.testing.assert_array_equal(getattr(aux, name).numpy(),
                                      np.asarray(getattr(jaux, name)), err_msg=name)
        assert getattr(aux, name).dtype == torch.int32
    assert (aux.ty_rows, aux.lane_chunks) == (ROWS, C)
    if case == "empty":
        assert aux.sizes.tolist() == [1] and not aux.order.any() and not aux.flags.any()
    if case == "quarter":  # live tiles first, the last one repeated
        assert aux.flags.tolist() == [1, 0, 0, 0] and aux.order.tolist() == [0, 0, 0, 0]


def lattice_fields(cfg, nx, ny, center_frac, seed=3, drift=0.0):
    """A hex lattice at 1.1 r0 in a box of 2 r0 buckets, centred at
    ``center_frac`` of its sides, thermal velocities (~150 m/s an axis)
    plus ``drift`` m/s along x, dt = 10 fs, on ``cfg``: a few particles a
    bucket, none dropped."""
    rng = np.random.default_rng(seed)
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    meta.box_width = 2 * r0 * cfg.bx
    meta.box_height = 2 * r0 * cfg.by
    meta.step_dt = 1e-14
    meta.steps_per_frame = 10
    lat = ParticleLattice((nx, ny), distance_factor=1.1, velocity=(0.0, 0.0))
    lat.hex_square(frame, (meta.box_width * center_frac[0], meta.box_height * center_frac[1]),
                   rng=rng)
    parts = frame.particles.copy()
    parts["vx"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    parts["vy"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    parts["vx"] += np.float32(drift)
    layout = bucket.bucketize_numpy(parts, cfg)
    assert (layout["ty"] >= 0).sum() == nx * ny
    return tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names), meta.copy()


# lattice scenes for the JAX envelope, with their tile flags
LATTICES = {
    "lattice-quarter": (lambda: lattice_fields(CFG, 8, 8, (0.25, 0.25)), [1, 0, 0, 0]),
    "lattice-full": (lambda: lattice_fields(CFG, 50, 26, (0.5, 0.5)), [1, 1, 1, 1]),
}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", sorted(SCENES) + sorted(LATTICES))
def test_plain_ext_step_matches_classic_and_jax(case, compact):
    """Two consecutive ext steps on one aux: bit-identical to the classic
    plain step; on the lattice scenes also inside the step envelope of
    JAX's ext step. (On the random states pairs sit a few fixed-point units
    apart and fly at ~1e9 m/s: the velocities agree to 3e-6 relative, but
    one ulp of such a velocity moves a particle hundreds of units.)"""
    if case in LATTICES:
        make, flags = LATTICES[case]
        fields, meta = make()
    else:
        fields, meta, flags = SCENES[case](), step_meta(), None
    state, params = from_reference(fields, meta)
    pv = params.vector()
    aux = bucket.ext_step_aux(state, pv, C, ROWS)
    assert flags is None or aux.flags.tolist() == flags
    jp = JSimParams.from_record(meta)
    e = ext_state_chunks(_jax(fields), C)
    jaux = jext_step_aux(e, jp, C, ROWS)
    got = ref = state
    for k in range(2):
        got = bucket.bucket_step_ext(got, aux, compact)
        ref = bucket.bucket_step(ref, pv)
        assert_same(got, ref, f"{case} step {k}")
        if case in LATTICES:
            e = bucket_step_pallas_ext(e, jp, jaux, lane_chunks=C, block_rows=ROWS,
                                       compact=compact, interpret=True)
            assert_step_envelope(_np(unext_state_chunks(e, C)), to_reference(got, params)[0])


@pytest.mark.parametrize("compact", [False, True])
def test_ext_frame_matches_classic_and_jax(compact):
    """A 10-step frame (rebucket every 4) through ``run_frame_bucket_cuda``'s
    ext branch on CPU tensors: bit-identical to the classic plain frame,
    inside the step envelope of JAX's ext frame; no kernel launched."""
    cfg = bucket.GridConfig(5, 4, 8, move_every=4)
    fields, meta = lattice_fields(cfg, 14, 14, (0.25, 0.5))  # the right chunk stays dead
    state, params = from_reference(fields, meta)
    pv = params.vector()
    assert bucket.ext_step_aux(state, pv, C, ROWS).flags.tolist() == [1, 0, 1, 0]
    before = dict(bucket_cuda.LAUNCHES)
    got = bucket_cuda.run_frame_bucket_cuda(state, pv, 10, 4, lane_chunks=C, ext_io=True,
                                            compact_tiles=compact, block_rows=ROWS)
    assert bucket_cuda.LAUNCHES == before
    assert_same(got, bucket.run_frame_bucket(state, pv, 10, 4), "frame")
    jp = JSimParams.from_record(meta)
    ref = _np(run_frame_bucket_pallas(_jax(fields), jp, move_every=4, interpret=True,
                                      block_rows=ROWS, lane_chunks=C, ext_io=True,
                                      compact_tiles=compact))
    assert_step_envelope(ref, to_reference(got, params)[0])


@pytest.mark.parametrize("unroll", [False, True])
def test_schedule_enter_exit_sequence_matches_jax(unroll):
    """The runs of ``frame_runs`` are the runs that the JAX schedule's
    enter/exit hooks bracket, the moves between them: the same call
    sequence, whose hooks run traced inside its loops (so each logs into an
    array carried through them). ``chunked_frame_schedule`` (the classic
    and sharded frames) and the ext frame (``_ext_frame``, which enters each
    run with its aux and buffers) walk those runs."""
    codes = {"enter": 1, "step": 2, "exit": 3, "move": 4}

    def jlog(code):
        def f(carry):
            log, i = carry
            return log.at[i].set(code), i + 1
        return f

    for steps in (0, 1, 2, 5, 9, 10):
        log = []
        for i, run in enumerate(bucket.frame_runs(steps, 4)):
            log += [4] * (i > 0) + [1] + [2] * run + [3]
        jl, n = jbucket.chunked_frame_schedule(
            (jnp.zeros(64, jnp.int32), jnp.int32(0)), steps, 4, jlog(2), jlog(4),
            unroll=unroll, enter=jlog(1), exit=jlog(3))
        assert log == np.asarray(jl)[:int(n)].tolist(), steps
        walked = []
        bucket.chunked_frame_schedule(None, steps, 4, lambda c: walked.append(2),
                                      lambda c: walked.append(4))
        assert walked == [c for c in log if c in (2, 4)], steps
    assert log == [1, 2, 3] + [4, 1, 2, 2, 2, 2, 3] * 2 + [4, 1, 2, 3]


def test_lane_chunks_match_jax(monkeypatch):
    rng = np.random.default_rng(7)
    grids = [(10, 10, 16), (9, 9, 16), (10, 9, 8), (8, 8, 8), (7, 3, 16), (6, 6, 16)]
    for g in grids:
        tcfg, jcfg = bucket.GridConfig(*g), JGridConfig(*g)
        assert simulator._lane_chunk_candidates(tcfg) == jsimulator._lane_chunk_candidates(jcfg)
        for fill in (0.0, 0.02, 0.1, 0.3, 1.0):
            occ = (rng.random((tcfg.by, tcfg.bx)) < fill) * rng.integers(1, tcfg.cap + 1)
            occ[: tcfg.by // 3] = 0  # a band of empty rows, so sparse tiles die
            assert simulator._lane_chunks_for(occ, tcfg) == jsimulator._lane_chunks_for(occ, jcfg)
    # the 1M user scene's grid and occupancy class pick 8 chunks
    occ = np.zeros((1024, 1024), int)
    occ[256:768, 256:768] = 3
    assert simulator._lane_chunks_for(occ, bucket.GridConfig(10, 10, 16)) == 8
    # the rule the port always follows is the JAX engine's `auto`: the live
    # tiles of a scene that got lane chunks
    monkeypatch.setenv("PS_EXT_IO", "auto")
    assert tuple(jsimulator._ext_io_mode()) == (True, True)


def test_lane_chunks_either_side_of_the_live_tile_limit():
    """Hand-built occupancies of the 1M user scene's grid (1024 x 1024 x 16:
    1024 tiles of 8 rows x 128 buckets at 8 lane chunks) with k live tiles,
    one live bucket each, in tile order: at 768 (75%) the scene keeps 8
    lane chunks, so the Simulator steps its live tiles; at 769 no
    candidate is 75% live (385 of 512 tiles at 4 chunks, 193 of 256 at 2),
    so it gets one and the classic step."""
    grid = bucket.GridConfig(10, 10, 16)
    for k, chunks in ((768, 8), (769, 1)):
        occ = np.zeros((1024, 1024), int)
        tiles = np.arange(k)
        occ[tiles // 8 * 8 + 7, tiles % 8 * 128 + 127] = 3
        assert simulator._lane_chunks_for(occ, grid) == chunks, k
        assert jsimulator._lane_chunks_for(occ, JGridConfig(10, 10, 16)) == chunks, k


def sparse_scene(n_side=12, centre_x=1.0) -> TFrame:
    """A hex lattice in the left sixth of a 16:1 box: ``_grid_for`` puts it
    on a 256 x 16 x 8 grid (2048 slot lanes, so 2 lane chunks are valid)
    and its live tiles are two of four (both 8-row blocks of the left
    chunk). Centred at ``centre_x`` 8 (in box heights) it straddles the two
    chunks, every tile is live, and the scene gets one lane chunk."""
    frame = TFrame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    side = n_side * r0 * 1.1 / 0.5
    meta.box_width = 16 * side
    meta.box_height = side
    meta.step_dt = 1e-14
    meta.steps_per_frame = 6
    lat = ParticleLattice((n_side, n_side), distance_factor=1.1, velocity=(0.0, 30.0))
    lat.hex_square(frame, (side * centre_x, side / 2), rng=np.random.default_rng(5))
    return frame


def served_frames(scene, frames, grid=bucket.GridConfig(8, 4, 8), classic=False):
    """A CPU Simulator's wire frames of ``scene`` after each of ``frames``
    frames (with ``classic``, the classic runner forced after load), its
    runner and its ``frame.live_tiles`` count."""
    sim = Simulator(grid, device="cpu")
    sim.load_frame(scene)
    chunks = sim._lane_chunks
    if classic:
        sim._lane_chunks = 1
    out = []
    real, profiling.RECORDER = profiling.RECORDER, profiling.Recorder()
    try:
        with profiling.recording():
            for _ in range(frames):
                sim.frame_async()
                out.append(sim.read_frame().bytes)
        counted = profiling.RECORDER.counters.get("frame.live_tiles", 0)
    finally:
        profiling.RECORDER = real
    return out, sim.active_kernel, counted, chunks


@pytest.mark.parametrize("mode, kernel", [("compact", "bucket-compact-torch-cpu")])
def test_simulator_runs_ext_frames_on_gpu_requests(mode, kernel):
    """A CPU Simulator serving a GPU request runs the ``mode`` ext frame on
    a scene of two lane chunks; its particles are bit-identical to the
    classic frame's, which a CPU_THREAD_POOL request of the scene runs."""
    scene = sparse_scene()
    cpu = scene.copy()
    cpu.metadata.device = simulator.Device.CPU_THREAD_POOL
    runs = {}
    for name, frame in (("gpu", scene), ("cpu", cpu)):
        sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
        sim.load_frame(frame)
        assert sim._lane_chunks == 2 and tuple(sim.grid.grid_shape) == (16, 256, 8)
        parts = []
        for _ in range(2):
            sim.frame_async()
            parts.append(sim.read_frame().particles.tobytes())
        runs[name] = (parts, sim.active_kernel)
    assert runs["gpu"][1] == kernel == f"bucket-{mode}-torch-cpu"
    assert runs["cpu"][1] == "bucket-torch-cpu"
    assert runs["gpu"][0] == runs["cpu"][0]


def test_the_scene_picks_the_live_tile_step_on_a_sparse_scene():
    """A scene of two lane chunks and two live tiles of four runs the
    live-tile step, its frames byte-equal to the classic frame's;
    ``frame.live_tiles`` counts each of its frames, and none of the
    classic ones."""
    scene = sparse_scene()
    live, kernel, counted, chunks = served_frames(scene, 3)
    classic = served_frames(scene, 3, classic=True)
    assert chunks == 2
    assert (kernel, counted) == ("bucket-compact-torch-cpu", 3)
    assert classic[1:3] == ("bucket-torch-cpu", 0)
    assert live == classic[0]


def test_the_simulator_keeps_the_live_tile_buffer_beside_its_state():
    """The Simulator's ``FrameSpare`` holds, after each live-tile frame, the
    buffer kept beside the state it serves (read back between frames), and
    a scene load empties it; the frames equal the classic runner's."""
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    sim.load_frame(sparse_scene())
    spare = sim._frame_spare
    assert spare.state is None and sim._lane_chunks == 2
    frames = []
    for _ in range(3):
        sim.frame_async()
        assert sim._frame_spare is spare and spare.state is sim.state
        assert not bucket_cuda._shares(spare.buffer, sim.state)
        frames.append(sim.read_frame(sim.start_readback()).bytes)
    assert frames == served_frames(sparse_scene(), 3, classic=True)[0]
    sim.load_frame(sparse_scene())
    assert sim._frame_spare.state is None and sim._frame_spare.buffer is None


@pytest.mark.parametrize("device, launches", [("cpu", 0), ("cuda", 3 * 6)])
def test_live_tile_launches_are_counted_where_the_kernel_runs(monkeypatch, device, launches):
    """``step.live_tile_launches`` adds a live-tile frame's steps (one
    kernel launch each) where the state is on the card, beside
    ``frame.live_tiles``; a CPU Simulator's live-tile frames run the plain
    versions and launch nothing. The card's runner is stood in for, so that
    the count is read here."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    sim.load_frame(sparse_scene())
    assert sim._lane_chunks == 2 and sim.params.steps_per_frame == 6
    if device == "cuda":
        sim.run_device = torch.device("cuda")
        monkeypatch.setattr(simulator, "run_frame_bucket_cuda", lambda state, *a, **k: state)
    with profiling.recording():
        for _ in range(3):
            sim.frame_async()
    counters = profiling.export()["counters"]
    assert sim.active_kernel == f"bucket-compact-{'cuda' if device == 'cuda' else 'torch-cpu'}"
    assert counters["frame.live_tiles"] == 3
    assert counters.get("step.live_tile_launches", 0) == launches


# the values PS_EXT_IO took before the scene alone picked the runner
OLD_EXT_IO = ("compact", "auto", "on", "1", "nocompact", "off")


@pytest.mark.parametrize("value", OLD_EXT_IO)
def test_the_environment_does_not_pick_the_runner(monkeypatch, value):
    """``PS_EXT_IO``, whatever its value, changes nothing: on the two-chunk
    sparse scene and on a one-chunk scene, the runner, the frame bytes and
    the ``frame.live_tiles`` count equal those with it unset."""
    scenes = (sparse_scene(), sparse_scene(centre_x=8.0))
    monkeypatch.delenv("PS_EXT_IO", raising=False)
    unset = [served_frames(scene, 2) for scene in scenes]
    monkeypatch.setenv("PS_EXT_IO", value)
    assert [served_frames(scene, 2) for scene in scenes] == unset
    assert [u[1:] for u in unset] == [("bucket-compact-torch-cpu", 2, 2),
                                      ("bucket-torch-cpu", 0, 1)]


@pytest.mark.parametrize("case", ["no candidate", "tiles over 75% live"])
def test_the_scene_picks_the_classic_step_with_one_lane_chunk(monkeypatch, case):
    """A scene of one lane chunk runs the classic step, and
    ``frame.live_tiles`` counts nothing: a grid too narrow to split, and a
    grid that could split but whose tiles are all live."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    if case == "no candidate":
        scene = _scene(12, 12, distance_factor=1.1, speed=30.0, steps_per_frame=6)
        sim = Simulator(bucket.GridConfig(4, 4, 8), device="cpu")
    else:
        scene = sparse_scene(centre_x=8.0)
        sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    sim.load_frame(scene)
    assert sim._lane_chunks == 1
    assert bool(simulator._lane_chunk_candidates(sim.grid)) == (case != "no candidate")
    with profiling.recording():
        sim.frame_async()
    assert sim.active_kernel == "bucket-torch-cpu"
    assert "frame.live_tiles" not in profiling.export()["counters"]


@pytest.mark.parametrize("case", ["cpu mesh", "cpu request"])
def test_the_scene_picks_no_live_tiles_for_sharded_and_cpu_requests(monkeypatch, case):
    """The scene that runs the live-tile step on a GPU request keeps the
    sharded runner on a mesh and the classic step on a
    ``CPU_THREAD_POOL`` request."""
    from particle_simulator_tpu_torch.parallel import domain

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    scene = sparse_scene()
    mesh = None
    if case == "cpu mesh":
        mesh = domain.make_mesh(devices=["cpu"] * 2)
    else:
        scene.metadata.device = simulator.Device.CPU_THREAD_POOL
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu", mesh=mesh)
    sim.load_frame(scene)
    with profiling.recording():
        sim.frame_async()
    assert sim.active_kernel == ("sharded-torch-cpu" if mesh else "bucket-torch-cpu")
    assert "frame.live_tiles" not in profiling.export()["counters"]


def test_ext_wrapper_validates_and_keeps_held_buffers():
    """The ext step's wrapper checks its pair and aux, and neither it nor
    the ext frame writes a buffer of the state it was given."""
    fields, meta = lattice_fields(CFG, 8, 8, (0.25, 0.25))
    state, params = from_reference(fields, meta)
    pv = params.vector()
    aux = bucket.ext_step_aux(state, pv, C, ROWS)
    held = ParticleState(*(a.clone() for a in state))
    pair = bucket_cuda.ext_pair(state)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(pair.cur[:4], state[:4]))
    out = bucket_cuda.bucket_step_ext_cuda(pair, aux, True)
    assert out.spare is pair.cur
    assert_same(out.cur, bucket.bucket_step(state, pv))
    assert_same(bucket_cuda.bucket_step_ext_cuda(state, aux, False), out.cur)
    bucket_cuda.run_frame_bucket_cuda(state, pv, 6, 4, lane_chunks=C, ext_io=True,
                                      block_rows=ROWS)
    assert_same(state, held)
    with pytest.raises(ValueError, match="share memory"):
        bucket_cuda.bucket_step_ext_cuda(bucket_cuda.ExtPair(state, state), aux, True)
    with pytest.raises(ValueError):  # an aux of another tiling
        bucket_cuda.bucket_step_ext_cuda(state, aux._replace(lane_chunks=4), True)
    with pytest.raises(ValueError):  # params without omax
        bucket_cuda.bucket_step_ext_cuda(state, aux._replace(params=pv), True)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        bucket_cuda.bucket_step_ext_cuda(state.to("meta"), aux, True)
    with pytest.raises(ValueError):
        bucket.ext_step_aux(state, pv, 3)
    spare = bucket_cuda.ext_pair(state).spare
    with pytest.raises(ValueError, match="other tiles"):  # a retire under another tiling
        bucket_cuda.ext_step_aux_cuda(state, pv, C, ROWS, (spare, aux._replace(ty_rows=4)))
    with pytest.raises(ValueError):  # an old aux of another grid
        bucket_cuda.ext_step_aux_cuda(state, pv, C, ROWS,
                                      (spare, aux._replace(bucket_max=aux.bucket_max[1:])))
    assert_same(spare, bucket_cuda.ext_pair(state).spare)  # neither retired anything


def test_ext_frame_enters_no_run_with_a_copy(monkeypatch):
    """No run of the ext frame enters with a copy of a grid: the first run
    steps the given state into the buffer the frame before left beside it
    (under the aux kept with it), each later run between the rebucket's
    output and a buffer of an earlier run, retired by its aux; only the
    first frame for a state (nothing kept) copies it once and zero-fills
    once. The given state is never a buffer a step writes, the frames equal
    the classic ones."""
    fields, meta = lattice_fields(CFG, 8, 8, (0.45, 0.25), drift=6000.0)
    state, params = from_reference(fields, meta)
    pv = params.vector()
    entries, moved, returned = [], [], []
    real_step, real_move = bucket_cuda._launch_ext, bucket_cuda.bucket_move_cuda

    def step(pair, aux, compact):
        if not any(pair is r for r in returned):  # a run's entry, not a step's result
            entries.append(pair)
        returned.append(real_step(pair, aux, compact))
        return returned[-1]

    def move(s):
        moved.append(real_move(s))
        return moved[-1]

    auxes = []
    real_aux = bucket_cuda.ext_step_aux_cuda

    def aux(*args):
        auxes.append(args[4] if len(args) > 4 else None)
        return real_aux(*args)

    monkeypatch.setattr(bucket_cuda, "_launch_ext", step)
    monkeypatch.setattr(bucket_cuda, "bucket_move_cuda", move)
    monkeypatch.setattr(bucket_cuda, "ext_step_aux_cuda", aux)
    spare = bucket_cuda.FrameSpare()
    ref = state
    for frame in range(3):
        entries.clear()
        moved.clear()
        auxes.clear()
        kept = spare.buffer
        held = ParticleState(*(a.clone() for a in state))
        out = bucket_cuda.run_frame_bucket_cuda(state, pv, 10, 4, lane_chunks=C, ext_io=True,
                                                block_rows=ROWS, spare=spare)
        assert len(entries) == 4  # steps 1 | 4 | 4 | 1
        assert entries[0].cur is state
        known = [state, *moved] + ([kept] if kept is not None else [])
        fresh = {id(p.spare.x) for p in entries if not any(p.spare.x is k.x for k in known)}
        # a spare of a later run is one of the earlier runs' buffers
        for i, p in enumerate(entries[1:], 1):
            assert p.cur is moved[i - 1]
            earlier = {id(e.cur.x) for e in entries[:i]} | {id(e.spare.x) for e in entries[:i]}
            assert id(p.spare.x) in earlier or (frame == 0 and i == 1), (frame, i)
        assert len(fresh) == (2 if frame == 0 else 0), frame  # the copy and the zeros
        # an aux a run but the first of a frame that finds the aux kept; a
        # retire with each later one but the first frame's second
        retires = [r is not None for r in auxes]
        assert retires == ([False, False, True, True] if frame == 0 else [True] * 3), frame
        assert not any(bucket_cuda._shares(p.spare, state) for p in entries)
        assert_same(state, held, f"frame {frame}: the given state")
        ref = bucket.run_frame_bucket(ref, pv, 10, 4)
        assert_same(out, ref, f"frame {frame}")
        assert spare.state is out and not bucket_cuda._shares(spare.buffer, out)
        state = out


# scenes for the live-tile frame across frames: a lattice blob that drifts
# across a lane chunk's edge (tiles going live and dead between rebuckets),
# the same blob drifting back, a thermal lattice over the whole box, a random
# half-live grid with non-zero tombstones (the first frame must keep them),
# and the all-dead grid
FRAME_SCENES = {
    "drift-right": lambda: lattice_fields(CFG, 4, 4, (0.42, 0.3), drift=15000.0),
    "drift-left": lambda: lattice_fields(CFG, 4, 4, (0.58, 0.7), drift=-15000.0),
    "thermal": lambda: lattice_fields(CFG, 50, 26, (0.5, 0.5)),
    "random": lambda: (SCENES["quarter"](), step_meta()),
    "empty": lambda: (empty_fields(), step_meta()),
}


@pytest.mark.parametrize("steps", [1, 10, 8])
@pytest.mark.parametrize("chunks", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(FRAME_SCENES))
def test_live_tile_frames_with_one_spare_match_the_classic_frames(case, chunks, steps):
    """Three live-tile frames in a row that share one ``FrameSpare`` (each
    given the state the one before returned, as the Simulator serves) equal
    the classic plain frames on all five fields of every slot; ``steps``
    of 1 (no rebucket: nothing is kept), 10 (not a multiple of the
    rebucket cadence, 4) and 8; the given state's bytes are unchanged after
    each frame. The drifting blobs take tiles from live to dead and from
    dead to live between rebuckets."""
    fields, meta = FRAME_SCENES[case]()
    state, params = from_reference(fields, meta)
    pv = params.vector()
    flags = []
    spare, ref = bucket_cuda.FrameSpare(), state
    for frame in range(3):
        held = ParticleState(*(a.clone() for a in state))
        out = bucket_cuda.run_frame_bucket_cuda(state, pv, steps, 4, lane_chunks=chunks,
                                                ext_io=True, block_rows=ROWS, spare=spare)
        assert_same(state, held, f"{case} frame {frame}: the given state")
        ref = bucket.run_frame_bucket(ref, pv, steps, 4)
        assert_same(out, ref, f"{case} frame {frame}")
        assert (spare.buffer is None) == (steps == 1)
        flags.append(bucket.ext_step_aux(out, pv, chunks, ROWS).flags)
        state = out
    if case.startswith("drift") and steps == 10:
        loaded = from_reference(fields, meta)[0]
        tiles = torch.stack([bucket.ext_step_aux(loaded, pv, chunks, ROWS).flags] + flags)
        went_dead = ((tiles[:-1] == 1) & (tiles[1:] == 0)).any()
        went_live = ((tiles[:-1] == 0) & (tiles[1:] == 1)).any()
        assert bool(went_dead) and bool(went_live), tiles.tolist()


def tile_aux_model(ty: torch.Tensor, params: torch.Tensor, chunks: int, rows: int,
                   threads: int = 1024) -> bucket.ExtStepAux:
    """``ps_tile_aux`` as its two launches compute it: each tile's largest
    live slot + 1 (parked in ``order``), then one block of ``threads``
    takes omax as their max and writes ``order`` as the stable partition of
    the flags, ``threads`` tiles at a time (ballot, per-warp popcounts,
    their exclusive scan), the tail filled with the last live tile; and each
    bucket's largest live slot + 1."""
    by, bx, cap = ty.shape
    ty_rows, n_tiles = bucket.ext_tiling(ty.shape, chunks, rows)
    slot = np.arange(cap) + 1
    t = ty.numpy().reshape(by // ty_rows, ty_rows, chunks, bx // chunks, cap)
    tile_max = np.where(t >= 0, slot, 0).max(axis=(1, 3, 4)).reshape(-1)
    flags = (tile_max > 0).astype(np.int32)
    order = tile_max.astype(np.int32)
    omax = int(order.max())  # every read of the maxima comes before a write
    base = 0
    for start in range(0, n_tiles, threads):
        live = np.zeros(threads, bool)
        seg = flags[start:start + threads] != 0
        live[:len(seg)] = seg
        warps = live.reshape(-1, 32)
        counts = warps.sum(1)
        warp_off = np.cumsum(counts) - counts
        for w, lanes in enumerate(warps):
            for lane in np.nonzero(lanes)[0]:
                order[base + warp_off[w] + lanes[:lane].sum()] = start + w * 32 + lane
        base += int(counts.sum())
    order[base:] = order[base - 1] if base else 0
    out = torch.cat([params, torch.tensor([float(omax)])]).to(torch.float32)
    bucket_max = np.where(ty.numpy() >= 0, slot, 0).max(axis=-1).astype(np.int32)
    return bucket.ExtStepAux(out, torch.from_numpy(flags), torch.from_numpy(order),
                             torch.tensor([max(base, 1)], dtype=torch.int32), ty_rows, chunks,
                             torch.from_numpy(bucket_max))


def single_tile_ty(shape, chunks, rows, tile, slot=3):
    """A dead grid with one live slot, in tile ``tile``."""
    ty = torch.full(shape, -1, dtype=torch.int32)
    ty_rows, n_tiles = bucket.ext_tiling(shape, chunks, rows)
    block, chunk = divmod(tile % n_tiles, chunks)
    ty[block * ty_rows + ty_rows - 1, (chunk + 1) * (shape[1] // chunks) - 1, slot] = 0
    return ty


AUX_GRIDS = {  # name -> (ty, chunks, rows)
    **{f"{case}-{c}": (lambda case=case: torch.from_numpy(SCENES[case]()[4]), c, ROWS)
       for case in SCENES for c in (2, 4, 8)},
    **{f"one-tile-{t}": (lambda t=t: single_tile_ty(CFG.grid_shape, 4, ROWS, t), 4, ROWS)
       for t in (0, 3, 7)},
    # 2,048 tiles of one bucket row: the partition in two chunks of 1,024
    "tall": (lambda: torch.from_numpy(np.where(np.random.default_rng(9).random((1024, 4, 2))
                                               < 0.3, 0, -1).astype(np.int32)), 2, 1),
    "tall-one-tile": (lambda: single_tile_ty((1024, 4, 2), 2, 1, 1500, slot=1), 2, 1),
}


@pytest.mark.parametrize("name", sorted(AUX_GRIDS))
def test_tile_aux_kernel_model_and_wrapper_match_ext_step_aux(name):
    """The two-launch partition of ``ps_tile_aux`` (modelled at the
    kernel's 1,024 threads and at 64, so the tall grids take many chunks)
    and ``ext_step_aux_cuda`` on a CPU state give ``ext_step_aux`` bit for
    bit: random half-live grids, the all-dead grid, single live tiles; and
    each bucket's largest live slot + 1 there."""
    make, chunks, rows = AUX_GRIDS[name]
    ty = make()
    state = ParticleState(ty, ty, ty.float(), ty.float(), ty)
    pv = SimParams.from_record(step_meta()).vector()
    want = bucket.ext_step_aux(state, pv, chunks, rows)
    for got in (tile_aux_model(ty, pv, chunks, rows), tile_aux_model(ty, pv, chunks, rows, 64),
                bucket_cuda.ext_step_aux_cuda(state, pv, chunks, rows)):
        for field in ("params", "flags", "order", "sizes", "bucket_max"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        assert (got.ty_rows, got.lane_chunks) == (want.ty_rows, want.lane_chunks)
    if name.startswith("one-tile") or name == "tall-one-tile":
        assert int(want.sizes) == 1 and int(want.flags.sum()) == 1


@pytest.mark.parametrize("case", ["drift-right", "thermal", "one-tile", "empty"])
def test_tile_retire_tombstones_what_went_dead(case):
    """The plain retire (and the aux wrapper's on the CPU): a buffer the
    live-tile step wrote under the old aux, retired against the rebucket's
    ty, holds tombstones on every slot dead in the new state, so it agrees
    with the rebucket's output there; the slots it changed are the ones
    that were live and went dead (it writes below each bucket's old
    ``bucket_max`` only, on slots that are tombstones already or were
    live)."""
    pv = SimParams.from_record(step_meta()).vector()
    if case == "one-tile":
        ty = single_tile_ty(CFG.grid_shape, C, ROWS, 2)
        fields = (torch.zeros(CFG.grid_shape, dtype=torch.int32),) * 2 + (
            torch.zeros(CFG.grid_shape),) * 2 + (ty,)
        old = ParticleState(*fields)
    else:
        fields, meta = FRAME_SCENES[case]()
        old, params = from_reference(fields, meta)
        pv = params.vector()
    aux = bucket.ext_step_aux(old, pv, C, ROWS)
    written = bucket_cuda.ext_pair(old).spare
    for _ in range(3):
        bucket.bucket_step_ext_into(ParticleState(*written[:4], old.ty), aux, True, written)
    new = bucket.bucket_move_direct(ParticleState(*written[:4], old.ty))

    def through_the_aux(buf, ty, old_aux):
        got = bucket_cuda.ext_step_aux_cuda(new, pv, C, ROWS, (buf, old_aux))
        want = bucket.ext_step_aux(new, pv, C, ROWS)
        for field in ("params", "flags", "order", "sizes", "bucket_max"):
            assert torch.equal(getattr(got, field), getattr(want, field))

    for retire in (bucket.tile_retire, through_the_aux):
        buf = ParticleState(*(a.clone() for a in written[:4]), new.ty)
        retire(buf, new.ty, aux)
        dead = new.ty < 0
        changed = torch.zeros_like(dead)
        for name, a, b, w in zip(ParticleState._fields, buf[:4], new[:4], written[:4]):
            assert torch.equal(a[dead], b[dead]), (case, name)
            changed |= a != w
        assert not (changed & ~(dead & (old.ty >= 0))).any(), case
    if case == "one-tile":
        assert bool(changed.any())  # the one particle left its slot


def staged_runs_step(state: ParticleState, pv: torch.Tensor) -> ParticleState:
    """The tile-scheduled kernel's candidate walk, modelled on the whole
    grid: every bucket row's live slots compacted in (bucket, slot) order
    with each bucket's start offset; a live receiver in bucket (r, b) adds,
    one at a time onto its cursor + wall force, the candidates of three
    contiguous runs (rows r-1, r, r+1: from the start of bucket b-1 to the
    end of bucket b+1, clamped at the box edge), skipping itself by its
    position in the middle run; then the leapfrog."""
    by, bx, cap = state.ty.shape
    live = state.ty.numpy() >= 0
    start = np.zeros((by, bx + 1), np.int64)
    start[:, 1:] = np.cumsum(live.sum(-1), axis=1)
    compacted = [np.flatnonzero(live[r].reshape(-1)) + r * bx * cap for r in range(by)]
    receivers, runs = [], []
    for r, b, s in np.argwhere(live):
        pos = start[r, b] + live[r, b, :s].sum()
        cands = []
        for rr in (r - 1, r, r + 1):
            if not 0 <= rr < by:
                continue
            lo, hi = start[rr, max(b - 1, 0)], start[rr, min(b + 2, bx)]
            run = compacted[rr][lo:hi]
            if rr == r:
                assert run[pos - lo] == (r * bx + b) * cap + s
                run = np.delete(run, pos - lo)
            cands.append(run)
        receivers.append((r * bx + b) * cap + s)
        runs.append(np.concatenate(cands))
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
    full_x = torch.zeros(state.capacity).index_put_((recv,), fx).reshape(state.x.shape)
    full_y = torch.zeros(state.capacity).index_put_((recv,), fy).reshape(state.x.shape)
    out = mie.leapfrog_apply(*state, full_x, full_y, pv)
    return ParticleState(*out, state.ty)


def stress_state():
    cfg = bucket.GridConfig(4, 4, 16)
    parts, meta = chip_smoke.stress_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    return state, SimParams.from_record(meta).vector()


def quarter_state():
    state, params = from_reference(random_fields(1, True), step_meta())
    return state, params.vector()


@pytest.mark.parametrize("case", ["stress", "quarter"])
def test_compacted_candidate_runs_give_the_classic_step(case):
    """The ordering argument of the tile-scheduled kernel: compacted rows and
    three runs a receiver reproduce ``bucket_step`` on every field and slot,
    with the box edges, a full bucket (stress) and empty buckets (quarter)."""
    state, pv = stress_state() if case == "stress" else quarter_state()
    live = state.ty >= 0
    if case == "stress":
        assert live.all(-1).any(), "the stress scene has a full bucket"
        assert live[0].any() and live[-1].any() and live[:, 0].any() and live[:, -1].any()
    else:
        assert (~live.any(-1)).any() and live[0, 0].any()
    assert_same(staged_runs_step(state, pv), bucket.bucket_step(state, pv), case)
