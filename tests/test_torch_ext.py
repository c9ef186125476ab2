"""The port's ext-layout MatrixBuckets path against the JAX package: the
tile aux, the plain version of the tile-scheduled step (rows 5 and 6 of
PERF.md's kernel table, ``bucket_step_pallas_ext`` with ``compact`` True
and False), the ext frame, the schedule's enter/exit hooks, the Simulator's lane-chunk
choice and ``PS_EXT_IO`` mode. The JAX kernels run in interpret mode.

Contract:
- the aux (params with omax, flags, order, sizes): bit-identical to JAX;
- the plain ext step and the ext frame: bit-identical to the port's classic
  plain step and frame, on every field and slot;
- against JAX's ext step (two steps): ``ty`` equal, x/y within 8
  fixed-point units, live vx/vy within rtol 1e-4, atol 1e-6 (the North
  star's step envelope: f32 pair sums in another order);
- against JAX's ext frame (10 steps, rebucket every 4): the same envelope.

The CUDA kernel runs only on the card; ``chip_smoke.py`` phases 12-14 hold
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


def lattice_fields(cfg, nx, ny, center_frac, seed=3):
    """A hex lattice at 1.1 r0 in a box of 2 r0 buckets, centred at
    ``center_frac`` of its sides, thermal velocities (~150 m/s an axis),
    dt = 10 fs, on ``cfg``: a few particles a bucket, none dropped."""
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
    """enter/exit bracket each run of steps, the moves stay outside: the
    same call sequence as the JAX schedule, whose hooks run traced inside
    its loops (so each logs into an array carried through them)."""
    codes = {"enter": 1, "step": 2, "exit": 3, "move": 4}

    def jlog(code):
        def f(carry):
            log, i = carry
            return log.at[i].set(code), i + 1
        return f

    for steps in (0, 1, 2, 5, 9, 10):
        log = []
        hooks = {k: (lambda c, k=k: log.append(codes[k]) or c) for k in codes}
        bucket.chunked_frame_schedule(None, steps, 4, hooks["step"], hooks["move"],
                                      enter=hooks["enter"], exit=hooks["exit"])
        jl, n = jbucket.chunked_frame_schedule(
            (jnp.zeros(64, jnp.int32), jnp.int32(0)), steps, 4, jlog(2), jlog(4),
            unroll=unroll, enter=jlog(1), exit=jlog(3))
        assert log == np.asarray(jl)[:int(n)].tolist(), steps
    assert log == [1, 2, 3] + [4, 1, 2, 2, 2, 2, 3] * 2 + [4, 1, 2, 3]


def test_lane_chunks_and_ext_io_mode_match_jax(monkeypatch):
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
    for value in (None, "off", "compact", "auto", "on", "1", "nocompact", "COMPACT", "x"):
        if value is None:
            monkeypatch.delenv("PS_EXT_IO", raising=False)
        else:
            monkeypatch.setenv("PS_EXT_IO", value)
        ext_io, compact = jsimulator._ext_io_mode()
        assert simulator._ext_io_mode() == (bool(ext_io), compact), value


def sparse_scene(n_side=12) -> TFrame:
    """A hex lattice in the left sixth of a 16:1 box: ``_grid_for`` puts it
    on a 256 x 16 x 8 grid (2048 slot lanes, so 2 lane chunks are valid)
    and its live tiles are one of four."""
    frame = TFrame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    side = n_side * r0 * 1.1 / 0.5
    meta.box_width = 16 * side
    meta.box_height = side
    meta.step_dt = 1e-14
    meta.steps_per_frame = 6
    lat = ParticleLattice((n_side, n_side), distance_factor=1.1, velocity=(0.0, 30.0))
    lat.hex_square(frame, (side, side / 2), rng=np.random.default_rng(5))
    return frame


@pytest.mark.parametrize("mode, kernel", [("compact", "bucket-compact-torch-cpu"),
                                          ("nocompact", "bucket-ext-torch-cpu")])
def test_simulator_runs_ext_frames_on_gpu_requests(monkeypatch, mode, kernel):
    """A CPU Simulator serving a GPU request runs the ext frame when
    PS_EXT_IO asks for it; its frames are bit-identical to PS_EXT_IO=off.
    A CPU_THREAD_POOL request keeps the classic step."""
    scene = sparse_scene()
    runs = {}
    for value in (mode, "off"):
        monkeypatch.setenv("PS_EXT_IO", value)
        sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
        sim.load_frame(scene)
        assert sim._lane_chunks == 2 and tuple(sim.grid.grid_shape) == (16, 256, 8)
        frames = []
        for _ in range(2):
            sim.frame_async()
            frames.append(sim.read_frame().bytes)
        runs[value] = (frames, sim.active_kernel)
    assert runs[mode][1] == kernel and runs["off"][1] == "bucket-torch-cpu"
    assert runs[mode][0] == runs["off"][0]
    monkeypatch.setenv("PS_EXT_IO", mode)
    cpu = scene.copy()
    cpu.metadata.device = simulator.Device.CPU_THREAD_POOL
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    sim.load_frame(cpu)
    sim.frame_async()
    assert sim.active_kernel == "bucket-torch-cpu"


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
