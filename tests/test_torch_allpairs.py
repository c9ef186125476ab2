"""The port's all-pairs (CompactArray) step against the JAX package.

The same numpy-seeded scene reaches both packages as the same arrays
(``engine/state.py:from_reference``/``to_reference``). The port's plain
``allpairs_step`` is held against the JAX jnp ``allpairs_step`` and against
the Pallas kernel ``allpairs_step_pallas`` in interpret mode.

Tolerance: ``ty`` equal, x/y within 2 fixed-point units, vx/vy within
rtol 1e-4, atol 1e-3, the envelope the JAX suite holds its own all-pairs
kernels to (tests/test_pallas.py). The sums differ in order: JAX adds the
pair terms in a tree (a row reduction), the port one j at a time (the CUDA
kernel's order within a segment of ``step.SEGMENT`` sources, then the
segments' partials in ascending order), so the last bits differ where the
forces cancel. The segmented sum is also held, bit for bit, against a numpy
float32 re-computation and, on scenes of one segment, against the
one-at-a-time sum.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.engine.state import state_from_numpy as j_state_from_numpy
from particle_simulator_tpu.io.frame import Frame
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.ops.allpairs_pallas import allpairs_step_pallas
from particle_simulator_tpu.physics import oracle
from particle_simulator_tpu.physics.step import allpairs_step as j_allpairs_step
from particle_simulator_tpu_torch.engine.state import (
    SimParams,
    from_reference,
    state_from_numpy,
    state_to_numpy,
    to_reference,
)
from particle_simulator_tpu_torch.ops import allpairs_cuda
from particle_simulator_tpu_torch.physics import mie, step

torch.set_num_threads(2)


def compact_scene(n_side=10, capacity=128, cursor=False, distance_factor=1.1,
                  velocity=(0.0, 30.0), seed=2):
    """A hex lattice, live particles first, tombstones up to ``capacity``:
    the JAX state and the port's state of the same arrays, and the record."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((n_side, n_side), distance_factor=distance_factor, velocity=velocity)
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(seed))
    if cursor:
        meta.cursor_pos = (0.5, 0.5)
        meta.cursor_size = 0.3
    rec = meta.copy()
    jstate = j_state_from_numpy(frame.particles, capacity)
    state, params = from_reference([np.asarray(a) for a in jstate], rec)
    return jstate, JSimParams.from_record(rec), state, params


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


SCENES = {
    "cap128": dict(n_side=10, capacity=128),
    "cap256_multi_tile": dict(n_side=12, capacity=256),
    "cap128_cursor": dict(n_side=10, capacity=128, cursor=True),
    "cap100_ragged": dict(n_side=10, capacity=100),
}


# the Pallas kernel takes capacities that are multiples of 128 only
CASES = [(scene, ref) for scene in sorted(SCENES) for ref in ("jnp", "pallas_interpret")
         if ref == "jnp" or SCENES[scene]["capacity"] % 128 == 0]


@pytest.mark.parametrize("scene, reference", CASES)
def test_allpairs_step_matches_jax(scene, reference):
    jstate, jp, state, params = compact_scene(**SCENES[scene])
    if reference == "jnp":
        ref = j_allpairs_step(jstate, jp)
    else:
        ref = allpairs_step_pallas(jstate, jp, interpret=True)
    got, _ = to_reference(step.allpairs_step(state, params.vector()), params)
    assert_envelope(got, jax.device_get(ref))


SEGMENTED = [(scene, ref) for scene, ref in CASES if "cursor" not in scene]


@pytest.mark.parametrize("scene, reference", SEGMENTED)
def test_segmented_step_matches_jax(monkeypatch, scene, reference):
    """Segments of 32 sources (4, 8 and a ragged 3 + 4/32 of them on these
    scenes) keep the plain step inside the envelope of both JAX forms."""
    monkeypatch.setattr(step, "SEGMENT", 32)
    jstate, jp, state, params = compact_scene(**SCENES[scene])
    if reference == "jnp":
        ref = j_allpairs_step(jstate, jp)
    else:
        ref = allpairs_step_pallas(jstate, jp, interpret=True)
    got, _ = to_reference(step.allpairs_step(state, params.vector()), params)
    assert_envelope(got, jax.device_get(ref))


def pair_term_matrices(state, pv):
    """The (N, N) pair terms [j, i] of source j on receiver i, as
    ``allpairs_forces`` computes them."""
    n = state.x.shape[0]
    scale_x, scale_y = mie.pair_scales(pv)
    dx = (state.x[:, None] - state.x[None, :]).to(torch.float32) * scale_x
    dy = (state.y[:, None] - state.y[None, :]).to(torch.float32) * scale_y
    valid = (state.ty[:, None] >= 0) & ~torch.eye(n, dtype=torch.bool)
    return mie.pair_terms(dx, dy, valid, mie.mie_log_coeffs(pv))


def numpy_segmented_sum(terms, start, seg):
    """The sum's definition, in numpy float32: accumulator 0 from ``start``,
    the others from +0, ascending j within a segment, then ascending k."""
    terms, start = terms.numpy(), start.numpy()
    assert terms.dtype == np.float32 and start.dtype == np.float32
    partials = []
    for k0 in range(0, len(terms), seg):
        acc = start.copy() if k0 == 0 else np.zeros_like(start)
        for j in range(k0, min(len(terms), k0 + seg)):
            acc = acc + terms[j]
        partials.append(acc)
    total = partials[0]
    for acc in partials[1:]:
        total = total + acc
    return total


@pytest.mark.parametrize("seg", [32, 48])
@pytest.mark.parametrize("scene", ["cap128_cursor", "cap256_multi_tile", "cap100_ragged"])
def test_segmented_sum_equals_numpy_recomputation(monkeypatch, scene, seg):
    monkeypatch.setattr(step, "SEGMENT", seg)
    _, _, state, params = compact_scene(**SCENES[scene])
    pv = params.vector()
    assert state.capacity > seg and (seg == 32 or state.capacity % seg)  # 48: ragged
    ext = step.external_forces(state, pv)
    for got, terms, start in zip(step.allpairs_forces(state, pv),
                                 pair_term_matrices(state, pv), ext):
        want = numpy_segmented_sum(terms, start, seg)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("scene", ["cap128_cursor", "cap100_ragged"])
def test_one_segment_is_the_one_at_a_time_sum(scene):
    """With N <= SEGMENT the sum adds j = 0, 1, ..., N-1 one at a time onto
    the cursor + wall force: the sum the step had before it was segmented."""
    _, _, state, params = compact_scene(**SCENES[scene])
    pv = params.vector()
    assert state.capacity <= step.SEGMENT
    ext = step.external_forces(state, pv)
    for got, terms, start in zip(step.allpairs_forces(state, pv),
                                 pair_term_matrices(state, pv), ext):
        acc = start.clone()
        for j in range(state.capacity):
            acc = acc + terms[j]
        assert torch.equal(got, acc)


def test_segment_length_matches_the_cuda_source():
    """One definition of the sum: ``step.SEGMENT`` is the kernel's
    ``AP_SEGMENT``, a plain constant of the source."""
    source = Path(allpairs_cuda.__file__).parent / "csrc" / "allpairs_step.cu"
    found = re.findall(r"constexpr int AP_SEGMENT = (\d+);", source.read_text())
    assert found == [str(step.SEGMENT)]
    assert 128 <= step.SEGMENT <= 512


def test_tombstones_are_inert():
    """Tombstoned slots pass through unchanged, and padding a scene with
    tombstones changes no live particle's result (bit for bit)."""
    _, _, small, params = compact_scene(n_side=10, capacity=100)
    _, _, padded, _ = compact_scene(n_side=10, capacity=256)
    pv = params.vector()
    out_small = step.allpairs_step(small, pv)
    out_padded = step.allpairs_step(padded, pv)
    for a, b, orig in zip(out_small, out_padded, padded):
        assert torch.equal(a, b[:100])
        assert torch.equal(b[100:], orig[100:])
    assert (padded.ty[100:] < 0).all()


def test_row_passes_do_not_change_the_result(monkeypatch):
    """The receivers in several (N, rows) passes, as on the card at large N,
    give the one-pass result bit for bit."""
    _, _, state, params = compact_scene(n_side=12, capacity=256, cursor=True)
    pv = params.vector()
    whole = step.allpairs_step(state, pv)
    monkeypatch.setattr(step, "PASS_ELEMENTS", 256 * 64)  # 4 passes of 64 receivers
    for a, b in zip(step.allpairs_step(state, pv), whole):
        assert torch.equal(a, b)


def test_run_frame_runs_exactly_steps_steps():
    _, _, state, params = compact_scene(n_side=6, capacity=64)
    pv = params.vector()
    calls = []

    def counting(s, p):
        calls.append(1)
        return step.allpairs_step(s, p)

    for steps in (0, 1, 3):
        calls.clear()
        out = step.run_frame(state, pv, steps, counting)
        assert len(calls) == steps
        manual = state
        for _ in range(steps):
            manual = step.allpairs_step(manual, pv)
        for a, b in zip(out, manual):
            assert torch.equal(a, b)
    for a, b in zip(step.run_frame(state, pv, 2), step.run_frame(state, pv, 2, step.allpairs_step)):
        assert torch.equal(a, b)  # allpairs_step is the default step


def test_leapfrog_energy_stability_10k_steps():
    """tests/test_physics.py:test_leapfrog_energy_stability_10k_steps through
    the port: 36 particles, dt = 10 fs, 100 frames of 100 steps; the total
    energy (the JAX package's numpy oracle) drifts less than 5%."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((6, 6), distance_factor=1.12, velocity=(0.0, 10.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(0))
    parts = frame.particles.copy()
    rec = frame.metadata.copy()
    rec["step_dt"] = 10e-15
    rec["steps_per_frame"] = 100
    rec["cursor_pos"] = (-1.0, -1.0)

    state = state_from_numpy(parts, len(parts))
    pv = SimParams.from_record(rec).vector()
    e0 = oracle.total_energy(parts, rec)
    energies = []
    for _ in range(100):
        state = step.run_frame(state, pv, 100)
        energies.append(oracle.total_energy(state_to_numpy(state), rec))
    e = np.array(energies)
    assert np.all(np.isfinite(e)), "energy blew up (NaN/inf)"
    drift = np.abs(e - e0) / max(abs(e0), 1e-21)
    assert drift.max() < 0.05, f"energy drift {drift.max():.3%} exceeds 5%"


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    _, _, state, params = compact_scene(n_side=8, capacity=128, cursor=True)
    pv = params.vector()
    before = dict(allpairs_cuda.LAUNCHES)
    for a, b in zip(allpairs_cuda.allpairs_step_cuda(state, pv), step.allpairs_step(state, pv)):
        assert torch.equal(a, b)
    out = allpairs_cuda.run_frame_allpairs_cuda(state, pv, 3)
    for a, b in zip(out, step.run_frame(state, pv, 3)):
        assert torch.equal(a, b)
    assert allpairs_cuda.LAUNCHES == before  # no kernel launched for CPU tensors


def test_wrapper_validates_inputs():
    _, _, state, params = compact_scene(n_side=4, capacity=32)
    pv = params.vector()
    with pytest.raises(TypeError):
        allpairs_cuda.allpairs_step_cuda(state._replace(vx=state.vx.double()), pv)
    with pytest.raises(ValueError):
        allpairs_cuda.allpairs_step_cuda(state.reshape((2, 16)), pv)
    with pytest.raises(ValueError):
        allpairs_cuda.allpairs_step_cuda(state, pv[:5])
    with pytest.raises(ValueError):
        allpairs_cuda.allpairs_step_cuda(state._replace(x=state.x.repeat(2)[::2]), pv)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        allpairs_cuda.allpairs_step_cuda(state.to("meta"), pv.to("meta"))
