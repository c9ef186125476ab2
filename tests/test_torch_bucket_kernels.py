"""The port's three bucket-grid kernels, through their plain PyTorch
versions, against the JAX package: the Pallas kernels in interpret mode and
the jnp bucket path.

Contract (the envelope the JAX suite holds its own kernels to):
- step: ``ty`` equal, x/y within 8 fixed-point units, live vx/vy within
  rtol 1e-4, atol 1e-6 (f32 pair sums in another order);
- dest and place: bit-identical (integer work, one order);
- frame (10 steps, rebucket every 4): ``ty`` equal, x within 16 units, vx
  within rtol 1e-3, atol 0.05 (tests/test_pallas.py's frame envelope).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each one against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, Frame, MieParams
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.ops.bucket_pallas import (
    bucket_move_pallas,
    bucket_step_pallas,
    move_dest_pallas,
)
from particle_simulator_tpu.physics import bucket as jbucket
from particle_simulator_tpu_torch.engine.state import from_reference, to_reference
from particle_simulator_tpu_torch.ops import bucket_cuda, build
from particle_simulator_tpu_torch.physics import bucket

torch.set_num_threads(2)

CFG_A = bucket.GridConfig(4, 4, 8)  # 16 x 16 buckets x 8 slots
CFG_B = bucket.GridConfig(5, 4, 4)  # 16 rows x 32 columns x 4 slots


def lattice_scene(cfg, n_side, spacing=1.1, box_fill=0.8, cursor=None, seed=1):
    """A hex lattice spanning ``box_fill`` of the box, thermal velocities
    (~150 m/s per axis), bucketized onto ``cfg``. Returns the five numpy
    fields in grid shape and the metadata record."""
    rng = np.random.default_rng(seed)
    frame = Frame.new()
    meta = frame.metadata
    box = n_side * MieParams.nitrogen().force0_r() * spacing / box_fill
    meta.box_width = box
    meta.box_height = box
    meta.step_dt = 1e-14
    if cursor is not None:
        meta.cursor_pos = cursor
        meta.cursor_size = 0.3
    lat = ParticleLattice((n_side, n_side), distance_factor=spacing, velocity=(0.0, 0.0))
    lat.hex_square(frame, (box / 2, box / 2), rng=rng)
    parts = frame.particles.copy()
    parts["vx"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    parts["vy"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    layout = bucket.bucketize_numpy(parts, cfg)
    assert layout.tobytes() == jbucket.bucketize_numpy(parts, jbucket.GridConfig(*cfg)).tobytes()
    return tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names), meta.copy()


def drift_scene(cfg, density, drift, seed):
    """Buckets filled to a random slot prefix (the grid invariant), each
    particle displaced up to ``drift`` bucket widths from its bucket: with
    drift > 1 some particles are more than one bucket from their target
    (dropped), and dense neighbourhoods overflow their target (dropped)."""
    rng = np.random.default_rng(seed)
    by, bx, cap = cfg.grid_shape
    cnt = rng.binomial(cap, density, (by, bx))
    occ = np.arange(cap)[None, None, :] < cnt[..., None]
    shape = cfg.grid_shape

    def coord(n_log2, axis_index):
        width = 2 ** (32 - n_log2)
        pos = (axis_index + rng.uniform(-drift, 1 + drift, shape)) * width
        return (np.floor(pos).astype(np.int64) % 2**32).astype(np.uint32)

    x = coord(cfg.bx_log2, np.arange(bx)[None, :, None])
    y = coord(cfg.by_log2, np.arange(by)[:, None, None])
    fields = (
        np.where(occ, x, 0).astype(np.uint32),
        np.where(occ, y, 0).astype(np.uint32),
        np.where(occ, rng.normal(size=shape), 0).astype(np.float32),
        np.where(occ, rng.normal(size=shape), 0).astype(np.float32),
        np.where(occ, rng.integers(0, 2, shape), -1).astype(np.int32),
    )
    return fields


def _jax_state(fields):
    return JState(*(jnp.asarray(a) for a in fields))


def _np(state):
    return [np.asarray(a) for a in state]


def assert_step_envelope(ref, got):
    """ref: JAX fields (x/y uint32); got: port fields via to_reference."""
    rx, ry, rvx, rvy, rty = ref
    gx, gy, gvx, gvy, gty = got
    np.testing.assert_array_equal(gty, rty)
    for r, g in ((rx, gx), (ry, gy)):
        delta = np.abs(r.astype(np.int64) - g.astype(np.int64))
        delta = np.minimum(delta, 2**32 - delta)  # u32 wrap
        assert delta.max() <= 8, f"position off by {delta.max()} units"
    live = rty >= 0
    np.testing.assert_allclose(gvx[live], rvx[live], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gvy[live], rvy[live], rtol=1e-4, atol=1e-6)
    dead = ~live
    for r, g in zip((rx, ry, rvx, rvy), (gx, gy, gvx, gvy)):
        np.testing.assert_array_equal(g[dead], r[dead])


STEP_CASES = {
    "lattice": lambda: lattice_scene(CFG_A, 24),
    "cursor": lambda: lattice_scene(CFG_A, 24, cursor=(0.5, 0.5), seed=2),
    "sparse": lambda: lattice_scene(CFG_B, 10, spacing=3.0, box_fill=0.5, seed=3),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_plain_step_matches_pallas_and_jnp(case):
    fields, meta = STEP_CASES[case]()
    jp = JSimParams.from_record(meta)
    js = _jax_state(fields)
    state, params = from_reference(fields, meta)
    got, _ = to_reference(bucket.bucket_step(state, params.vector()), params)

    live = fields[4] >= 0
    assert live.sum() > 30
    ref_jnp = _np(jax.jit(jbucket.bucket_step)(js, jp))
    assert_step_envelope(ref_jnp, got)
    ref_pallas = _np(bucket_step_pallas(js, jp, interpret=True))
    assert_step_envelope(ref_pallas, got)
    if case == "cursor":  # the cursor really pushed some particles
        no_cursor = meta.copy()
        no_cursor["cursor_pos"] = (-1.0, -1.0)
        alt, _ = to_reference(
            bucket.bucket_step(state, type(params).from_record(no_cursor).vector()), params)
        assert not np.array_equal(alt[2][live], got[2][live])


DEST_CASES = {
    "drift-a": lambda: drift_scene(CFG_A, 0.6, 1.4, seed=10),
    "overflow-b": lambda: drift_scene(CFG_B, 0.95, 0.8, seed=11),
    "lattice": lambda: lattice_scene(CFG_A, 24, seed=12)[0],
}


@pytest.mark.parametrize("case", sorted(DEST_CASES))
def test_dest_and_place_bit_identical_to_pallas(case):
    fields = DEST_CASES[case]()
    js = _jax_state(fields)
    state, params = from_reference(fields, default_meta())
    destid = bucket.move_dest_direct(state)
    by, bx, cap = state.x.shape

    ref_dest = np.asarray(move_dest_pallas(js, interpret=True)).reshape(by, bx, cap)
    np.testing.assert_array_equal(destid.numpy(), ref_dest)
    jdest, jkeep = jbucket.move_dest_direct(js)
    np.testing.assert_array_equal(
        destid.numpy().reshape(-1), np.where(np.asarray(jkeep), np.asarray(jdest), -1)
    )
    if case != "lattice":  # the stress scenes really drop particles
        live = fields[4] >= 0
        assert (destid.numpy()[live] < 0).any()

    moved, _ = to_reference(bucket.bucket_move_direct(state), params)
    for name, r, g in zip(PARTICLE_DTYPE.names, _np(bucket_move_pallas(js, interpret=True)), moved):
        np.testing.assert_array_equal(g, r, err_msg=f"field {name}")
    for name, r, g in zip(PARTICLE_DTYPE.names, _np(jax.jit(jbucket.bucket_move)(js)), moved):
        np.testing.assert_array_equal(g, r, err_msg=f"field {name} (jnp pull)")


def default_meta():
    return lattice_scene(CFG_A, 4)[1]


def test_move_drops_crossers_escapers_and_overflow():
    """The drop cases of tests/test_bucket.py on the port: a misplaced
    particle is pulled into its bucket, one 8 buckets from home is lost, and
    a target pulling more than CAP keeps the first CAP in scan order."""
    cfg = bucket.GridConfig(4, 4, 4)
    layout = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    layout["ty"] = -1
    w = 2 ** 28  # one bucket width
    # bucket (0, 0): a crosser (belongs to (0, 1)) and a resident
    layout[0] = (w + 1, 1, 7.0, 0.0, 0)
    layout[1] = (1, 1, 8.0, 0.0, 1)
    # bucket (0, 2): an escaper whose coordinates say bucket (0, 10)
    layout[2 * cfg.cap] = (10 * w + 5, 1, 9.0, 0.0, 0)
    # buckets (2, 2) and (2, 3) both full of particles targeting (3, 3):
    # 8 candidates for 4 slots; the (2, 2) block comes first in the scan
    for b, base_vx in ((2 * 16 + 2, 100.0), (2 * 16 + 3, 200.0)):
        for s in range(cfg.cap):
            layout[b * cfg.cap + s] = (3 * w + s, 3 * w + s, base_vx + s, 0.0, 0)
    fields = tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names)
    state, params = from_reference(fields, default_meta())
    moved = bucket.bucket_move_direct(state)
    out = moved.vx.numpy()
    assert 7.0 in out[0, 1] and 8.0 in out[0, 0]
    assert 9.0 not in out
    np.testing.assert_array_equal(out[3, 3], [100.0, 101.0, 102.0, 103.0])
    assert int((moved.ty >= 0).sum()) == 2 + 4
    ref = _np(bucket_move_pallas(_jax_state(fields), interpret=True))
    for r, g in zip(ref, to_reference(moved, params)[0]):
        np.testing.assert_array_equal(g, r)


def test_frame_matches_jax_run_frame_bucket():
    cfg = bucket.GridConfig(4, 4, 8, move_every=4)
    fields, meta = lattice_scene(cfg, 24, seed=4)
    meta["steps_per_frame"] = 10  # step, then (move, 4) x 2 and (move, 1)
    jp = JSimParams.from_record(meta)
    ref = _np(jax.jit(lambda s, p: jbucket.run_frame_bucket(s, p, move_every=4))(
        _jax_state(fields), jp))
    state, params = from_reference(fields, meta)
    got, _ = to_reference(
        bucket.run_frame_bucket(state, params.vector(), params.steps_per_frame, move_every=4),
        params)
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_allclose(got[0].astype(np.int64), ref[0].astype(np.int64), rtol=0, atol=16)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=0.05)


def test_chunked_schedule_places_moves_before_steps_1_1k_1_2k():
    log = []

    def step(s):
        log.append("s")
        return s

    def move(s):
        log.append("m")
        return s

    for steps in (0, 1, 2, 5, 9, 10):
        log.clear()
        bucket.chunked_frame_schedule(None, steps, 4, step, move)
        expect = []
        for i in range(steps):
            if i >= 1 and (i - 1) % 4 == 0:
                expect.append("m")
            expect.append("s")
        assert log == expect, steps


def test_wrappers_route_cpu_tensors_to_plain_versions():
    fields, meta = lattice_scene(CFG_A, 16, seed=5)
    state, params = from_reference(fields, meta)
    pv = params.vector()
    before = dict(bucket_cuda.LAUNCHES)
    for a, b in zip(bucket_cuda.bucket_step_cuda(state, pv), bucket.bucket_step(state, pv)):
        assert torch.equal(a, b)
    assert torch.equal(bucket_cuda.move_dest_cuda(state), bucket.move_dest_direct(state))
    for a, b in zip(bucket_cuda.bucket_move_cuda(state), bucket.bucket_move_direct(state)):
        assert torch.equal(a, b)
    out = bucket_cuda.run_frame_bucket_cuda(state, pv, 3, move_every=2)
    for a, b in zip(out, bucket.run_frame_bucket(state, pv, 3, move_every=2)):
        assert torch.equal(a, b)
    assert bucket_cuda.LAUNCHES == before  # no kernel launched for CPU tensors


def test_wrappers_validate_inputs():
    fields, meta = lattice_scene(CFG_A, 8, seed=6)
    state, params = from_reference(fields, meta)
    pv = params.vector()
    with pytest.raises(TypeError):
        bucket_cuda.bucket_step_cuda(state._replace(vx=state.vx.double()), pv)
    with pytest.raises(ValueError):
        bucket_cuda.bucket_step_cuda(state.reshape((-1,)), pv)
    with pytest.raises(ValueError):
        bucket_cuda.bucket_step_cuda(state, pv[:5])
    with pytest.raises(ValueError):
        bucket_cuda.move_dest_cuda(state._replace(x=state.x.transpose(0, 1)))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        bucket_cuda.move_dest_cuda(state.to("meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build" / build.LIB_NAME).exists()
    assert [p.name for p in build.sources()] == [
        "allpairs_step.cu", "bucket_dest.cu", "bucket_place.cu", "bucket_step.cu",
        "bucket_tiles.cu", "readback_pack.cu"]
