"""The port's dense-pack readback against the JAX package's: packed fields
and the ``[max_occupancy, total]`` header identical, bit for bit, on the
densities of tests/test_readback.py; and the widen-and-retry path of the
port's ``Simulator.read_frame`` reading back exactly the live particles."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.ops.readback import dense_readback as jax_dense_readback
from particle_simulator_tpu.scenes.library import _scene
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import from_reference, state_to_numpy
from particle_simulator_tpu_torch.ops.readback import (
    dense_readback,
    dense_to_particles,
    pow2_at_least,
)
from particle_simulator_tpu_torch.physics.bucket import GridConfig

torch.set_num_threads(2)


def random_fields(rng, shape, density):
    """Random grid state honouring the slot-prefix invariant."""
    by, bx, cap = shape
    cnt = rng.binomial(cap, density, (by, bx))
    occ = np.arange(cap)[None, None, :] < cnt[..., None]
    return (
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
        np.where(occ, rng.integers(0, 5, shape), -1).astype(np.int32),
    )


def check_against_jax(fields, kcap=None, ncap=None):
    counts = (fields[4] >= 0).sum(-1)
    kcap = pow2_at_least(int(counts.max(initial=0))) if kcap is None else kcap
    ncap = pow2_at_least(int(counts.sum())) if ncap is None else ncap
    rs, rp = jax_dense_readback(JState(*(jnp.asarray(a) for a in fields)), kcap, ncap)
    state, _ = from_reference(fields, _scene(2, 2, 1.1, 0.0).metadata.copy())
    gs, gp = dense_readback(state, kcap, ncap)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    for name, r, g in zip(JState._fields, rp, gp):
        g = g.numpy()
        if name in ("x", "y"):
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    return state, gs, gp


@pytest.mark.parametrize("density", [0.0, 0.07, 0.5, 0.93, 1.0])
def test_dense_pack_identical_to_jax(density):
    rng = np.random.default_rng(int(density * 100))
    fields = random_fields(rng, (8, 16, 8), density)
    state, scalars, packed = check_against_jax(fields)
    # and it is the live particles in wire order
    ref = state_to_numpy(state)
    ref = ref[ref["ty"] >= 0]
    total = int(scalars[1])
    assert total == len(ref)
    assert dense_to_particles(total, packed).tobytes() == ref.tobytes()
    assert (packed.ty[total:] == -1).all()


def test_dense_pack_empty_runs_and_padding_identical_to_jax():
    rng = np.random.default_rng(3)
    fields = list(random_fields(rng, (4, 8, 8), 0.6))
    ty = fields[4]
    ty[0] = -1  # leading empty row
    ty[-1] = -1  # trailing empty row
    ty[2, 1:5] = -1  # interior empty run
    check_against_jax(tuple(fields))
    total = int((ty >= 0).sum())
    check_against_jax(tuple(fields), ncap=pow2_at_least(total) * 4)


def test_header_exact_when_kcap_overflows():
    """kcap below the fullest bucket: the pack is discarded by the caller,
    but the header stays exact (and the whole output still matches JAX)."""
    rng = np.random.default_rng(7)
    fields = random_fields(rng, (4, 8, 8), 0.9)
    counts = (fields[4] >= 0).sum(-1)
    _, scalars, _ = check_against_jax(fields, kcap=2)
    assert int(scalars[0]) == int(counts.max()) > 2
    assert int(scalars[1]) == int(counts.sum())


def _sim(frame):
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(frame)
    ref = state_to_numpy(sim.state)
    return sim, ref[ref["ty"] >= 0]


def test_read_frame_widens_kcap_and_retries():
    sim, ref = _sim(_scene(16, 16, distance_factor=1.1, speed=5.0, box_fill=0.4))
    seeded = sim._readback_k
    assert seeded >= 2
    sim._readback_k = 1  # force an overflow against the real occupancy
    out = sim.read_frame()
    assert out.particle_count == len(ref)
    assert out.particles.tobytes() == ref.tobytes()
    assert sim._readback_k == seeded  # grew back to the true pow2 width


def test_read_frame_widens_ncap_and_retries():
    sim, ref = _sim(_scene(12, 12, distance_factor=1.1, speed=5.0, box_fill=0.4))
    sim._readback_ncap = 4  # pack shorter than the live count
    ticket = sim.start_readback()
    out = sim.read_frame(ticket)
    assert out.particles.tobytes() == ref.tobytes()
    assert sim._readback_ncap == pow2_at_least(len(ref))
