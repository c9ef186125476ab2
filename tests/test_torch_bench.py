"""The port's headline bench and entry points (``particle_simulator_tpu_torch/
bench.py``, ``entry.py``) against ``bench.py`` and ``__graft_entry__.py`` on
the CPU, at tiny sizes.

Contract:
- the dense scene and the grid pick: bit-identical to bench.py's (particles,
  metadata; every particle count from 1 to 2^24 that the test tries);
- the JSON line: bench.py's keys in each mode, and the same ``particles``,
  ``grid``, ``lane_chunks``, ``readback_ncap`` and ``ext_io`` (``"auto"``,
  the rule the Simulator follows); ``readback_k`` is the grid's ``cap``,
  the slot prefix the record pack reads;
- ``entry()``'s frame against JAX ``run_frame_bucket``: the North-star
  envelope (``ty`` equal, x/y within 8 fixed-point units, live-lane
  velocities within rtol 1e-4, atol 1e-6); the bench's dense frames: the
  same but atol 5e-5 m/s, since on that cold lattice JAX's own f32 step
  leaves atol 1e-6 against a float64 step, and the port's error there is
  of the same size;
- ``--sharded`` and ``dryrun_multichip``: bit-identical to the one-device
  frame on every field and slot, the (1, 1) mesh included; the mesh's shape
  is JAX ``make_mesh``'s for the same device count;
- without a card, the entry points raise unless asked for the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as jbench
import chip_smoke
import jax
from particle_simulator_tpu.parallel import domain as jdomain
from particle_simulator_tpu.physics import bucket as jbucket
from particle_simulator_tpu_torch import bench, entry
from particle_simulator_tpu_torch.engine.state import (
    ParticleState,
    SimParams,
    from_reference,
    state_from_numpy,
    to_reference,
)
from particle_simulator_tpu_torch.parallel import domain
from particle_simulator_tpu_torch.physics.bucket import GridConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--particles", "512", "--frames", "2", "--steps", "4"]


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """bench.py points jax at a persistent compile cache under $HOME, and
    reads PS_EXT_IO: keep the cache off and the variable unset."""
    monkeypatch.setenv("PS_TPU_COMPILE_CACHE", "")
    monkeypatch.delenv("PS_EXT_IO", raising=False)


def _np(state):
    return [np.asarray(a) for a in state]


def assert_envelope(got, ref):
    """The North-star envelope between a port state and a JAX one (numpy
    fields, x/y as uint32)."""
    np.testing.assert_array_equal(got[4], ref[4])
    for i in (0, 1):
        delta = np.abs(got[i].astype(np.int64) - ref[i].astype(np.int64))
        assert delta.max() <= 8, f"field {i}: max delta {delta.max()}"
    live = ref[4] >= 0
    for i in (2, 3):
        np.testing.assert_allclose(got[i][live], ref[i][live], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the scene and the grid pick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg, fill", [
    (GridConfig(2, 2, 8), 8),
    (GridConfig(3, 4, 8), 8),
    (GridConfig(3, 3, 16), 16),
    (GridConfig(4, 3, 12), 12),
    (GridConfig(3, 3, 8), 4),  # fill below cap: bench.py's slot order kept
    (GridConfig(9, 10, 8), 8),  # --particles 4194304, BASELINE.md's 4M run
], ids=["4x4x8", "16x8x8", "8x8x16", "8x16x12", "8x8x8-fill4", "1024x512x8-4M"])
def test_dense_grid_scene_matches_bench_py(cfg, fill):
    """Particles and metadata bit for bit, both ways through the port's
    ``from_reference`` / ``to_reference``."""
    jstate, jparams, jn = jbench.dense_grid_scene(jbucket.GridConfig(*cfg), fill)
    parts, meta, n = bench.dense_grid_scene(cfg, fill)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    params = SimParams.from_record(meta)
    assert n == jn > 0
    back, back_params = from_reference(_np(jstate), meta)
    for name, a, b in zip(ParticleState._fields, state, back):
        assert torch.equal(a, b), name
    fields, record = to_reference(state, params)
    for name, a, b in zip(ParticleState._fields, fields, _np(jstate)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, value in jparams._asdict().items():
        np.testing.assert_array_equal(np.asarray(value), np.asarray(getattr(params, name)),
                                      err_msg=name)
    assert back_params == params
    assert SimParams.from_record(record) == params


def _bench_py_grid_pick():
    """bench.py's grid loop (``kx = ky = 2`` and the ``while`` after it in
    ``main``), compiled from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    i = next(k for k, st in enumerate(main.body) if ast.unparse(st) == "kx = ky = 2")
    assert isinstance(main.body[i + 1], ast.While)
    code = compile(ast.Module(main.body[i:i + 2], []), "bench.py", "exec")

    def pick(particles, fill):
        ns = {"args": SimpleNamespace(particles=particles, fill=fill)}
        exec(code, ns)
        return ns["kx"], ns["ky"]

    return pick


def test_dense_grid_config_matches_bench_py():
    pick = _bench_py_grid_pick()
    rng = np.random.default_rng(0)
    counts = {1, 2**24} | {max(1, 2**k + d) for k in range(25) for d in (-1, 0, 1)}
    counts |= set(rng.integers(1, 2**24 + 1, 500).tolist())
    for fill in (4, 8, 16):
        for particles in sorted(counts):
            cfg = bench.dense_grid_config(particles, fill)
            assert (cfg.bx_log2, cfg.by_log2) == pick(particles, fill), (particles, fill)
            assert cfg.cap == fill and cfg.buckets * fill >= particles
    assert bench.dense_grid_config(1_048_576).grid_shape == (512, 256, 8)


# ---------------------------------------------------------------------------
# the JSON line
# ---------------------------------------------------------------------------

def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    return json.loads(lines[-1])


MODES = {"dense": [], "per-frame": ["--per-frame"], "user": ["--user-scene"]}
# bench.py's own: no compiles of the sibling lane-chunk variants
JAX_ONLY = {"user": ["--no-warm-siblings"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_line_matches_bench_py(mode, capsys):
    """Same keys (and chip_smoke's frozen copy of them), same sizes; the
    port's line is the last on stdout and says where it ran."""
    argv = TINY + MODES[mode]
    assert jbench.main(argv + JAX_ONLY.get(mode, [])) == 0
    ref = _last_json(capsys.readouterr().out)
    assert bench.main(argv + ["--torch-device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(ref) == chip_smoke.BENCH_KEYS[mode]
    assert got["device"] == ref["device"] == "cpu"
    same = ["particles", "steps_per_frame", "frames", "metric", "unit"]
    if mode == "user":
        same += ["grid", "lane_chunks", "readback_ncap", "ext_io", "scene"]
        assert got["readback_k"] == got["grid"][2] and got["ext_io"] == "auto"
    else:
        same += ["live_fraction_end"]
    assert {k: got[k] for k in same} == {k: ref[k] for k in same}
    if mode == "per-frame":
        assert len(got["frame_s_series"]) == 2
        assert got["frame_s"]["min"] <= got["frame_s"]["p50"] <= got["frame_s"]["max"]
    assert got["value"] > 0 and np.isclose(got["vs_baseline"], got["value"] / 6.0e7)


def test_sharded_line_matches_bench_py(capsys):
    """bench.py's ``--sharded`` on the 8 virtual CPU devices and the port's
    over an 8-shard CPU mesh: same keys, particles and mesh shape."""
    assert jbench.main(TINY + ["--sharded"]) == 0
    ref = _last_json(capsys.readouterr().out)
    got = bench.run(TINY + ["--sharded", "--torch-device", "cpu"], devices=["cpu"] * 8)
    assert set(got) == set(ref) == chip_smoke.BENCH_KEYS["sharded"]
    assert got["sharded_mesh"] == ref["sharded_mesh"] == list(jdomain.make_mesh().devices.shape)
    assert got["particles"] == ref["particles"]
    assert got["live_fraction_end"] == ref["live_fraction_end"]


# ---------------------------------------------------------------------------
# the frames
# ---------------------------------------------------------------------------

def _dense_run(argv, devices=None):
    """The record and the state (the mesh's blocks when sharded) after the
    last frame of a port bench run."""
    seen = {}

    def inspect(label, state, params):
        seen[label] = state

    rec = bench.run(argv + ["--torch-device", "cpu"], devices=devices, inspect=inspect)
    assert sorted(seen) == ["dense after 3 frames", "dense as loaded"]
    return rec, seen["dense after 3 frames"]


def test_dense_frames_hold_against_jax_run_frame_bucket():
    """The bench's warm-up frame and its two timed frames (4 steps each)
    against three JAX ``run_frame_bucket`` frames on bench.py's own scene:
    ``ty`` equal and x/y within 8 fixed-point units (the North star's
    envelope); live velocities within rtol 1e-4, atol 5e-5 m/s. The North
    star's atol 1e-6 is below f32's own error on this scene: see
    ``test_dense_step_leaves_atol_1e_6_in_f32``."""
    rec, state = _dense_run(TINY)
    cfg = bench.dense_grid_config(512)
    jstate, jparams, _ = jbench.dense_grid_scene(jbucket.GridConfig(*cfg), 8)
    jparams = jparams._replace(steps_per_frame=np.int32(4))
    fn = jax.jit(lambda s, p: jbucket.run_frame_bucket(s, p, move_every=cfg.move_every))
    for _ in range(3):
        jstate = fn(jstate, jparams)
    ref = _np(jstate)
    got, _ = to_reference(state, SimParams.from_record(bench.dense_grid_scene(cfg)[1]))
    live = ref[4] >= 0
    np.testing.assert_array_equal(got[4], ref[4])
    for i in (0, 1):
        assert np.abs(got[i].astype(np.int64) - ref[i].astype(np.int64)).max() <= 8
    for i in (2, 3):
        np.testing.assert_allclose(got[i][live], ref[i][live], rtol=1e-4, atol=5e-5)
    assert rec["live_fraction_end"] == float(live.sum()) / rec["particles"]


def _f64_step_velocities(fields, jp):
    """One bucket step's velocities in float64 from the same u32 positions
    and f32 velocities: the wall force and the Mie pairs of the 3x3
    neighbourhood in the direct power form, then the kick."""
    from particle_simulator_tpu.engine.state import PARTICLE_MASS

    x, y, vx, vy, ty = fields
    p = {k: float(np.asarray(v)) for k, v in jp._asdict().items()}
    sigma, eps, n, m = p["sigma"], p["epsilon"], p["n"], p["m"]
    ce = n / (n - m) * (n / m) ** (m / (n - m)) * eps
    by, bx, cap = x.shape
    half, top = 2147483647, 4294967295.0
    force = []
    for u, box in ((x, p["box_width"]), (y, p["box_height"])):
        pos = u.astype(np.float64) / top * box
        wall = np.where(u < half, pos, (top - u.astype(np.float64)) / top * box)
        force.append(np.where(u < half, 1.0, -1.0) * ce * m * (sigma / wall) ** m / wall)
    halo = ((1, 1), (1, 1), (0, 0))  # tombstones around the grid
    px = np.pad(x.astype(np.float64) / top * p["box_width"], halo)
    py = np.pad(y.astype(np.float64) / top * p["box_height"], halo)
    pty = np.pad(ty, halo, constant_values=-1)
    me = np.arange(cap)
    for oy in range(3):
        for ox in range(3):
            dx = px[oy:oy + by, ox:ox + bx][:, :, None, :] - px[1:-1, 1:-1, :, None]
            dy = py[oy:oy + by, ox:ox + bx][:, :, None, :] - py[1:-1, 1:-1, :, None]
            valid = (pty[oy:oy + by, ox:ox + bx][:, :, None, :] >= 0) & (ty[..., None] >= 0)
            if (oy, ox) == (1, 1):
                valid &= me[:, None] != me[None, :]
            r = np.where(valid, np.hypot(dx, dy), 1.0)
            f_over_r = np.where(valid, ce * (m * (sigma / r) ** m - n * (sigma / r) ** n) / r / r,
                                0.0)
            force[0] = force[0] + (f_over_r * dx).sum(-1)
            force[1] = force[1] + (f_over_r * dy).sum(-1)
    kick = p["step_dt"] / float(PARTICLE_MASS)
    return vx.astype(np.float64) + force[0] * kick, vy.astype(np.float64) + force[1] * kick


def test_dense_step_leaves_atol_1e_6_in_f32():
    """Why the dense frames are held at atol 5e-5 and not the North star's
    1e-6: against one step of bench.py's dense scene in float64, JAX's own
    jnp step leaves rtol 1e-4 / atol 1e-6 at some live velocity (the cold
    lattice's pair forces nearly cancel, so f32 rounding shows at the
    slowest particles), and the port's step is off by no more than 1.5x
    JAX's worst. The cursor pushes no particle here, so the float64 step
    leaves it out."""
    from particle_simulator_tpu.physics.mie import cursor_force
    from particle_simulator_tpu_torch.physics import bucket as tbucket

    cfg = bench.dense_grid_config(512)
    parts, meta, _ = bench.dense_grid_scene(cfg)
    jstate, jp, _ = jbench.dense_grid_scene(jbucket.GridConfig(*cfg), 8)
    fields = _np(jstate)
    assert not any(np.any(np.asarray(f)) for f in cursor_force(jstate.x, jstate.y, jp))
    truth = _f64_step_velocities(fields, jp)
    state = state_from_numpy(parts, cfg.capacity, "cpu").reshape(cfg.grid_shape)
    port, _ = to_reference(tbucket.bucket_step(state, SimParams.from_record(meta).vector("cpu")),
                           SimParams.from_record(meta))
    jax_out = _np(jax.jit(jbucket.bucket_step)(jstate, jp))
    live = fields[4] >= 0
    worst, excess = {}, {}
    for name, out in (("port", port), ("jax", jax_out)):
        d = [np.abs(out[i][live] - truth[i - 2][live]) for i in (2, 3)]
        worst[name] = max(a.max() for a in d)
        excess[name] = max((a - (1e-6 + 1e-4 * np.abs(t[live]))).max() for a, t in zip(d, truth))
    assert excess["jax"] > 0, excess
    assert worst["port"] <= 1.5 * worst["jax"], worst


@pytest.mark.parametrize("n, blocks", [(1, False), (2, False), (3, False), (4, False),
                                       (4, True)],
                         ids=["1x1", "2", "3-padded-rows", "4", "4-blocks"])
def test_sharded_frames_equal_the_one_device_frames(n, blocks):
    """``--sharded`` over an n-shard CPU mesh (one block, or one block a
    shard): the gathered grid equals the dense runner's, bit for bit."""
    devices = [torch.device("cpu", i) for i in range(n)] if blocks else ["cpu"] * n
    _, single = _dense_run(TINY)
    rec, out = _dense_run(TINY + ["--sharded"], devices=devices)
    mesh = domain.make_mesh(devices=devices)
    got = domain.gather_state(out, mesh)
    by = bench.dense_grid_config(512).by
    for name, a, b in zip(ParticleState._fields, got, single):
        assert torch.equal(a[:by], b), name
        assert torch.equal(a[by:], torch.full_like(a[by:], -1 if name == "ty" else 0)), name
    assert rec["sharded_mesh"] == list(mesh.shape) == list(
        jdomain.make_mesh(n_devices=n).devices.shape)
    assert rec["live_fraction_end"] == float((single.ty >= 0).sum()) / rec["particles"]


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------

def _without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


@pytest.mark.parametrize("mode", [[], ["--sharded"], ["--user-scene"]],
                         ids=["dense", "sharded", "user"])
def test_bench_raises_without_a_card(mode, capsys):
    _without_a_card()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(TINY + mode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(TINY + mode)
    out, err = capsys.readouterr()
    assert out == "" and "bench: foreign modules" in err


def test_entry_points_raise_without_a_card():
    _without_a_card()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(4, device="cuda")


def test_module_run_exits_non_zero_without_a_card_and_prints_no_line():
    """``python -m particle_simulator_tpu_torch.bench`` as a user runs it;
    on the CPU when asked, its last stdout line is the record."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "particle_simulator_tpu_torch.bench", *TINY]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    if not torch.cuda.is_available():
        assert proc.returncode != 0 and proc.stdout == ""
        assert "CUDA is not available" in proc.stderr
    proc = subprocess.run(cmd + ["--torch-device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _last_json(proc.stdout)
    assert set(rec) == chip_smoke.BENCH_KEYS["dense"] and rec["device"] == "cpu"
    assert "bench: foreign modules []" in proc.stderr


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_frame_holds_against_graft_entry():
    """The same tiny scene (bit for bit) and one frame of each inside the
    envelope."""
    fn, (state, params) = entry.entry("cpu")
    jfn, (jstate, jparams) = graft.entry()
    back, _ = from_reference(_np(jstate), jparams_record(jparams))
    for name, a, b in zip(ParticleState._fields, state, back):
        assert torch.equal(a, b), name
    assert int(jparams.steps_per_frame) == entry.STEPS
    out = fn(state, params)
    got, _ = to_reference(out, SimParams.from_record(jparams_record(jparams)))
    assert_envelope(got, _np(jax.jit(jfn)(jstate, jparams)))
    assert not torch.equal(out.y, state.y)  # it moved


def jparams_record(jparams):
    """A metadata record carrying a JAX ``SimParams``' values."""
    return SimParams(**{k: int(v) if k == "steps_per_frame" else np.float32(np.asarray(v))
                        for k, v in jparams._asdict().items()}).record()


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_dryrun_multichip_passes(n):
    entry.dryrun_multichip(n, device="cpu")


def test_dryrun_multichip_fails_on_a_difference(monkeypatch):
    """A sharded frame one unit off in one slot fails the dry run."""
    real = domain.make_sharded_frame_fn

    def off_by_one(cfg, mesh):
        frame = real(cfg, mesh)

        def wrong(blocks, params, steps):
            out = frame(blocks, params, steps)
            x = out[0].x.clone()
            x.view(-1)[0] += 1
            return (out[0]._replace(x=x), *out[1:])

        return wrong

    monkeypatch.setattr(domain, "make_sharded_frame_fn", off_by_one)
    with pytest.raises(AssertionError, match="field x differs"):
        entry.dryrun_multichip(4, device="cpu")
