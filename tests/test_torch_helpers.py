"""The port's helper modules against the JAX package, on the CPU.

Exact where the module is numpy on both sides (``precision_report``,
``oracle_step``, ``total_energy``: equal to the last bit). The f32 force-law
functions ``mie_force``, ``mie_force_repulsive`` and ``mie_potential`` agree
with JAX's within rtol 1e-6 (torch's and XLA's ``pow`` may round the last bit
differently). ``euler_apply`` on the same forces is exact; a single
``allpairs_step_euler`` is inside the all-pairs envelope the port's leapfrog
step is held to (``tests/test_torch_allpairs.py``): ``ty`` equal, x/y within
2 fixed-point units, vx/vy within rtol 1e-4, atol 1e-3. The sums differ in
order (JAX a row reduction, the port the kernel's segmented sum). Over
thousands of steps trajectories diverge chaotically, so the integrator claim
compares drift statistics, not states.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.engine.state import state_from_numpy as j_state_from_numpy
from particle_simulator_tpu.io.frame import Frame as JFrame
from particle_simulator_tpu.io.presets import ParticleLattice as JParticleLattice
from particle_simulator_tpu.physics import mie as jmie
from particle_simulator_tpu.physics import oracle as joracle
from particle_simulator_tpu.physics.step import allpairs_step_euler as j_allpairs_step_euler
from particle_simulator_tpu.utils import log as jlog
from particle_simulator_tpu.utils import precision as jprecision
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import SimParams, from_reference, to_reference
from particle_simulator_tpu_torch.io.frame import DataStructure, Frame, MieParams
from particle_simulator_tpu_torch.io.presets import ParticleLattice
from particle_simulator_tpu_torch.parallel.domain import make_mesh
from particle_simulator_tpu_torch.physics import bucket, mie, oracle, step
from particle_simulator_tpu_torch.utils import log, precision, profiling

torch.set_num_threads(2)


def lattice(n_side=8, distance_factor=1.1, velocity=(0.0, 50.0), seed=0, cursor=False):
    """A JAX-package hex lattice scene: (particles, metadata record)."""
    frame = JFrame.new()
    meta = frame.metadata
    lat = JParticleLattice((n_side, n_side), distance_factor=distance_factor, velocity=velocity)
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(seed))
    if cursor:
        meta.cursor_pos = (0.5, 0.5)
        meta.cursor_size = 0.3
    return frame.particles.copy(), meta.copy()


# -- utils/precision.py, physics/oracle.py: numpy on both sides, exact ---------

@pytest.mark.parametrize("kwargs", [
    {}, {"box_width": 200e-9, "at_fraction": 0.5},
    {"params": "argon", "box_width": 10e-9, "at_fraction": 0.99},
])
def test_precision_report_equals_jax_package(kwargs):
    kw, jkw = dict(kwargs), dict(kwargs)
    if kwargs.get("params") == "argon":
        from particle_simulator_tpu.io.frame import MieParams as JMieParams

        kw["params"] = MieParams(3.4e-10, 1.65e-21, 12.0, 6.0)
        jkw["params"] = JMieParams(3.4e-10, 1.65e-21, 12.0, 6.0)
    got, want = precision.precision_report(**kw), jprecision.precision_report(**jkw)
    assert got == want  # every float to the last bit
    assert json.dumps(got) == json.dumps(want)
    assert set(got["reps"]) == {"f64", "f32", "u32_fixed", "u64_fixed"}


def test_log_precision_prints_the_report(capsys):
    precision.log_precision()
    assert json.loads(capsys.readouterr().err) == precision.precision_report()


@pytest.mark.parametrize("case", ["lattice", "cursor", "hot_dense"])
def test_oracle_equals_jax_package_bit_for_bit(case):
    parts, meta = {
        "lattice": lambda: lattice(),
        "cursor": lambda: lattice(6, cursor=True, seed=3),
        "hot_dense": lambda: lattice(6, distance_factor=1.05, velocity=(0.0, 400.0), seed=1),
    }[case]()
    meta["step_dt"] = 10e-15
    got, want = oracle.oracle_step(parts, meta), joracle.oracle_step(parts, meta)
    assert got.tobytes() == want.tobytes()
    got, want = oracle.oracle_run(parts, meta, 5), joracle.oracle_run(parts, meta, 5)
    assert got.tobytes() == want.tobytes()
    assert oracle.total_energy(got, meta) == joracle.total_energy(want, meta)
    assert oracle.total_energy(parts, meta) == joracle.total_energy(parts, meta)


# -- physics/mie.py: the direct-form force law ---------------------------------

@pytest.mark.parametrize("name", ["mie_force", "mie_force_repulsive", "mie_potential"])
def test_mie_functions_match_jax(name):
    _, meta = lattice()
    jp, params = JSimParams.from_record(meta), SimParams.from_record(meta)
    r0 = MieParams.nitrogen().force0_r()
    rng = np.random.default_rng(11)
    r = (r0 * rng.uniform(0.8, 3.0, 512)).astype(np.float32)
    want = np.asarray(getattr(jmie, name)(jnp.asarray(r), jp))
    got = getattr(mie, name)(torch.from_numpy(r), params.vector()).numpy()
    assert got.dtype == np.float32
    # rtol 1e-6 of the value, plus as much of the scale of the terms that
    # cancel near r0 (F(r0) = 0 is a difference of two ~1e-11 N terms)
    scale = np.abs(np.asarray(jmie.mie_force_repulsive(jnp.asarray(r), jp)) if "force" in name
                   else want).max()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    # a number or an array works as the distance too
    one = getattr(mie, name)(float(r[0]), params.vector())
    assert one.shape == () and np.isclose(float(one), want[0], rtol=1e-5)


def test_mie_force_signs_and_zero():
    pv = SimParams.from_record(lattice()[1]).vector()
    r0 = MieParams.nitrogen().force0_r()
    # the pair term is F/r * (x_j - x_i): negative F pushes i away from j
    assert float(mie.mie_force(0.9 * r0, pv)) < 0 < float(mie.mie_force(1.2 * r0, pv))
    assert float(mie.mie_potential(r0, pv)) < 0 < float(mie.mie_potential(0.8 * r0, pv))
    assert float(mie.mie_force_repulsive(1.2 * r0, pv)) > 0


# -- euler_apply, allpairs_step_euler -------------------------------------------

def states(parts, meta, capacity=None):
    capacity = capacity or len(parts)
    jstate = j_state_from_numpy(parts, capacity)
    state, params = from_reference([np.asarray(a) for a in jstate], meta)
    return jstate, JSimParams.from_record(meta), state, params


@pytest.mark.parametrize("integrator", ["euler_apply", "leapfrog_apply"])
def test_integrators_match_jax_on_the_same_forces(integrator):
    """Same state, same forces: the update is elementwise f32 and a
    fixed-point conversion, equal on every slot (tombstones pass through)."""
    parts, meta = lattice(6, velocity=(30.0, 400.0))
    meta["step_dt"] = 10e-15
    jstate, jp, state, params = states(parts, meta, capacity=48)
    rng = np.random.default_rng(5)
    fx = (rng.normal(0, 2e-11, 48)).astype(np.float32)
    fy = (rng.normal(0, 2e-11, 48)).astype(np.float32)
    want = getattr(jmie, integrator)(*jstate, jnp.asarray(fx), jnp.asarray(fy), jp)
    got = getattr(mie, integrator)(*state, torch.from_numpy(fx), torch.from_numpy(fy),
                                   params.vector())
    for name, g, w in zip(("x", "y", "vx", "vy"), got, want):
        g, w = g.numpy(), np.asarray(w)
        g = g.view(np.uint32) if name in "xy" else g
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the only difference between the two: which velocity drifts x
    e = mie.euler_apply(*state, torch.from_numpy(fx), torch.from_numpy(fy), params.vector())
    lf = mie.leapfrog_apply(*state, torch.from_numpy(fx), torch.from_numpy(fy), params.vector())
    assert torch.equal(e[2], lf[2]) and torch.equal(e[3], lf[3])
    assert not torch.equal(e[1], lf[1])


def assert_envelope(got, ref):
    names = ("x", "y", "vx", "vy", "ty")
    got = dict(zip(names, got))
    ref = dict(zip(names, (np.asarray(a) for a in ref)))
    np.testing.assert_array_equal(got["ty"], ref["ty"])
    for name in ("x", "y"):
        np.testing.assert_allclose(got[name].astype(np.int64), ref[name].astype(np.int64),
                                   rtol=0, atol=2, err_msg=name)
    for name in ("vx", "vy"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("case", ["cap64", "cap128_tombstones", "cap160_cursor"])
def test_allpairs_step_euler_matches_jax(case):
    n_side, capacity, cursor = {"cap64": (8, 64, False), "cap128_tombstones": (10, 128, False),
                                "cap160_cursor": (12, 160, True)}[case]
    parts, meta = lattice(n_side, velocity=(0.0, 30.0), seed=2, cursor=cursor)
    jstate, jp, state, params = states(parts, meta, capacity)
    ref = jax.device_get(j_allpairs_step_euler(jstate, jp))
    got, _ = to_reference(step.allpairs_step_euler(state, params.vector()), params)
    assert_envelope(got, ref)
    # Euler drifts with the old velocity: x differs from the leapfrog step's,
    # v is the same kick
    lf = step.allpairs_step(state, params.vector())
    eu = step.allpairs_step_euler(state, params.vector())
    assert torch.equal(lf.vx, eu.vx) and torch.equal(lf.vy, eu.vy)
    assert not torch.equal(lf.y, eu.y)


# Over a tenth of the reference report's 100 ps horizon (10 x 1000 steps at
# dt = 1 fs) Euler's energy drift already grows strictly from quarter point
# to quarter point and stands this many times above leapfrog's worst on the
# same scene; the CPU run reads 0.182 against 2.8e-4 (647x), the bound leaves
# a margin under it.
EULER_OVER_LEAPFROG_TENTH = 100.0


def test_euler_grows_where_leapfrog_holds_tenth_horizon():
    euler = chip_smoke.integrator_drifts(step.allpairs_step_euler, 10, 1000)
    assert chip_smoke.secular_growth(euler), chip_smoke.quarter_points(euler)
    leapfrog = max(chip_smoke.integrator_drifts(step.allpairs_step, 10, 1000))
    assert leapfrog < 0.05, f"leapfrog drifted {leapfrog:.2%}"
    assert euler[-1] > EULER_OVER_LEAPFROG_TENTH * leapfrog, (
        f"no contrast: euler {euler[-1]:.3g} vs leapfrog {leapfrog:.3g}")


@pytest.mark.slow
def test_euler_explodes_where_leapfrog_holds():
    """tests/test_physics.py:test_euler_explodes_where_leapfrog_holds through
    the port, over the full 100 x 1000 steps, with its four assertions."""
    euler = chip_smoke.integrator_drifts(step.allpairs_step_euler, 100, 1000)
    final = euler[-1]
    assert chip_smoke.secular_growth(euler), chip_smoke.quarter_points(euler)
    assert final > 0.5, f"Euler only drifted {final:.2%} in 100 ps"
    leapfrog = max(chip_smoke.integrator_drifts(step.allpairs_step, 100, 1000))
    assert leapfrog < 0.05, f"leapfrog drifted {leapfrog:.2%} on the Euler scene"
    assert final > 100 * leapfrog, f"no contrast: euler {final:.3g} vs leapfrog {leapfrog:.3g}"


def test_integrator_scene_is_the_jax_suite_scene():
    parts, rec = chip_smoke.integrator_scene()
    want, jrec = lattice(6, distance_factor=1.05, velocity=(0.0, 400.0), seed=0)
    assert parts.tobytes() == want.tobytes()
    assert float(rec["step_dt"]) == np.float32(1e-15) and tuple(rec["cursor_pos"]) == (-1.0, -1.0)
    assert float(rec["box_width"]) == float(jrec["box_width"])


# -- utils/log.py ---------------------------------------------------------------

def test_log_prefix_names_the_caller(capsys):
    log.log("hello", 3)
    line = capsys.readouterr().err.strip()
    import inspect

    here = inspect.currentframe().f_lineno - 4
    assert line == f"[{os.path.basename(__file__)}:{here}] hello 3"
    log.warn("w")
    log.error("e")
    err = capsys.readouterr().err
    assert err.count(os.path.basename(__file__)) == 2
    log.debug("hidden at the default threshold")
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("level, shown", [("debug", 4), ("info", 3), ("warn", 2), ("error", 1),
                                          ("WARN", 2), ("nonsense", 3)])
def test_log_threshold_follows_ps_tpu_log(monkeypatch, capsys, level, shown):
    """The same variable, the same levels and the same fallback as the JAX
    package's module (the threshold is read at import)."""
    import importlib

    monkeypatch.setenv("PS_TPU_LOG", level)
    counts = []
    for module in (log, jlog):
        fresh = importlib.reload(module)
        for fn in (fresh.debug, fresh.log, fresh.warn, fresh.error):
            fn("x")
        counts.append(len(capsys.readouterr().err.splitlines()))
    monkeypatch.delenv("PS_TPU_LOG")
    importlib.reload(log)
    importlib.reload(jlog)
    assert counts == [shown, shown]


# -- utils/profiling.py -----------------------------------------------------------

def test_trace_writes_a_chrome_trace_and_annotate_nests(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                a = a @ a
            a = a + 1
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    ranges, kernels = chip_smoke.trace_names(files[0])
    assert {"outer", "inner"} <= ranges and kernels == set()
    spans = {e.name: e.time_range for e in prof.events() if e.name in ("outer", "inner")}
    assert spans["outer"].start <= spans["inner"].start
    assert spans["inner"].end <= spans["outer"].end
    # annotate outside a trace is a no-op context; an error inside leaves it closed
    with pytest.raises(ZeroDivisionError):
        with profiling.annotate("boom"):
            1 / 0
    with profiling.annotate("after"):
        pass


def test_step_meter_and_card_line(monkeypatch, capsys):
    from particle_simulator_tpu_torch.engine import daemon

    assert daemon.rate_report(6400, 200, 200_000, 2.0) == {
        "steps_per_sec": 100.0, "particle_steps_per_sec": 100_000.0, "total_steps": 6400}
    # the daemon's line every 64 frames: the steps and particle-steps of the
    # frames shipped since its last report, over the same interval

    class Quiet:
        is_connected = True

        def read(self):
            return None

        def write(self, frame):
            pass

    scene = small_scene(steps=1)
    sim = Simulator(bucket.GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(scene)
    assert daemon.main_loop(Quiet(), sim, max_frames=64, readback_depth=0) == 64
    (line,) = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("engine: {")]
    rep = ast.literal_eval(line[len("engine: "):line.rindex(" [")])
    assert rep["total_steps"] == 64 and rep["steps_per_sec"] > 0
    assert rep["particle_steps_per_sec"] == pytest.approx(
        rep["steps_per_sec"] * scene.particle_count, rel=1e-3)

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\nsecond card, 1 W\n"

    monkeypatch.setattr(profiling.subprocess, "run", lambda *a, **k: Done())
    assert profiling.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"


# -- Simulator.sync, the echoed launch width --------------------------------------

def small_scene(n_side=6, steps=2, structure=DataStructure.MATRIX_BUCKETS) -> Frame:
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    meta.box_width = meta.box_height = n_side * r0 * 1.1 / 0.5
    meta.step_dt = 10e-15
    meta.steps_per_frame = steps
    meta.data_structure = structure
    lat = ParticleLattice((n_side, n_side), distance_factor=1.1, velocity=(0.0, 30.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(4))
    return frame


@pytest.mark.parametrize("case", ["no_state", "cpu_buckets", "cpu_compact", "cpu_mesh"])
def test_sync_on_cpu_states(case, monkeypatch):
    """Nothing is in flight on the CPU: ``sync`` returns, calls no CUDA
    synchronize, and leaves the state as it was."""
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: called.append(a))
    grid = bucket.GridConfig(3, 3, 8)
    if case == "no_state":
        sim = Simulator(grid, device="cpu")
        sim.sync()
        assert sim.state is None and not called
        return
    mesh = make_mesh(devices=["cpu"] * 4) if case == "cpu_mesh" else None
    structure = DataStructure.COMPACT_ARRAY if case == "cpu_compact" else DataStructure.MATRIX_BUCKETS
    sim = Simulator(grid, device="cpu", mesh=mesh)
    sim.load_frame(small_scene(structure=structure))
    sim.frame_async()
    before = sim.read_frame().bytes
    sim.sync()
    assert not called and sim.sharded == (case == "cpu_mesh")
    assert sim.read_frame().bytes == before


def sparse_scene(n_side=12, centre_x=1.0) -> Frame:
    """A hex lattice in the left sixth of a 16:1 box: two lane chunks, so a
    GPU request runs the live-tile frame. Centred at ``centre_x`` 8 (in box
    heights) it straddles both chunks and gets one, so the classic frame."""
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    side = n_side * r0 * 1.1 / 0.5
    meta.box_width = 16 * side
    meta.box_height = side
    meta.step_dt = 1e-14
    meta.steps_per_frame = 2
    lat = ParticleLattice((n_side, n_side), distance_factor=1.1, velocity=(0.0, 30.0))
    lat.hex_square(frame, (side * centre_x, side / 2), rng=np.random.default_rng(5))
    return frame


@pytest.mark.parametrize("mode", ["off", "compact"])
def test_live_launch_width_edit_is_echoed_and_read_by_the_ext_frame(monkeypatch, mode):
    """A metadata-only frame that changes ``gpu_threads_per_block_log2`` is
    echoed by the next frame read; the live-tile frame's tile height follows
    it (2^(k - 4) bucket rows) without a reload, the classic frame of a
    one-chunk scene (``off``) ignores it."""
    from particle_simulator_tpu_torch.engine import simulator

    seen = []
    real = simulator.run_frame_bucket_cuda

    def spy(*args, **kwargs):
        seen.append(kwargs.get("block_rows"))
        return real(*args, **kwargs)

    monkeypatch.setattr(simulator, "run_frame_bucket_cuda", spy)
    sim = Simulator(bucket.GridConfig(8, 4, 8), device="cpu")
    scene = sparse_scene(centre_x=1.0 if mode == "compact" else 8.0)
    sim.load_frame(scene)
    assert sim._lane_chunks == (2 if mode == "compact" else 1)
    loaded = sim.state
    sim.frame_async()
    assert sim.read_frame().metadata.gpu_threads_per_block_log2 == 7
    edit = Frame.new()
    edit.header["metadata"] = scene.metadata.copy()
    edit.metadata.gpu_threads_per_block_log2 = 5
    assert edit.particle_count == 0
    sim.update_metadata(edit)
    assert sim.read_frame().metadata.gpu_threads_per_block_log2 == 5  # echoed at once
    sim.frame_async()
    assert sim.read_frame().metadata.gpu_threads_per_block_log2 == 5
    assert sim.read_frame().particle_count == scene.particle_count  # no reload, nothing lost
    if mode == "compact":
        assert sim.active_kernel == "bucket-compact-torch-cpu" and seen == [8, 2]
    else:
        assert sim.active_kernel == "bucket-torch-cpu" and seen == [None, None]
    assert sim.state is not loaded  # frames ran
