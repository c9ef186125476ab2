"""The PyTorch port's state and force law against the JAX package.

Inputs come from a numpy seed and reach both packages as the same arrays
(``engine/state.py:from_reference`` on the torch side). Tolerances: the u32
helpers and the state round trip are exact; the force terms are f32
formulas evaluated in the same order on both sides, so they agree to a few
ulps (rtol 1e-6), except the wall force, which the JAX jnp version computes
with ``power`` and the port (like the JAX kernel) with ``exp``/``log``
(rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.io.frame import default_metadata
from particle_simulator_tpu.physics import mie as jmie
from particle_simulator_tpu_torch.engine.state import (
    ParticleState,
    SimParams,
    from_reference,
    state_from_numpy,
    state_to_numpy,
    to_reference,
)
from particle_simulator_tpu_torch.physics import mie
from particle_simulator_tpu_torch.physics.step import external_forces

torch.set_num_threads(2)

EDGE_U32 = np.array(
    [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001,
     0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFFFE, 0xFFFFFFFF, 0x00FFFFFF, 0x01000001],
    dtype=np.uint32,
)


def _u32(rng, n):
    return np.concatenate([EDGE_U32, rng.integers(0, 2**32, n, dtype=np.uint32)])


def _t(a_u32):
    return torch.from_numpy(a_u32.view(np.int32).copy())


def _meta(cursor=(0.5, 0.5), cursor_size=0.3):
    meta = default_metadata()
    meta["cursor_pos"] = cursor
    meta["cursor_size"] = cursor_size
    meta["step_dt"] = 1e-14
    return meta


def test_state_round_trip_through_reference():
    rng = np.random.default_rng(0)
    shape = (4, 8, 8)
    fields = (
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
        rng.integers(-1, 2, shape).astype(np.int32),
    )
    meta = _meta()
    meta["particles"][1] = (1.5e-10, 2e-21, 11.0, 5.0)
    meta["steps_per_frame"] = 37
    state, params = from_reference(fields, meta)
    assert state.x.dtype == torch.int32 and state.x.shape == shape
    back, rec = to_reference(state, params)
    for a, b in zip(fields, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # every SimParams field survives the record round trip bit for bit
    assert SimParams.from_record(rec) == params
    jp = JSimParams.from_record(meta)
    for name in SimParams._fields:
        assert np.float64(getattr(params, name)) == np.float64(getattr(jp, name)), name

    parts = state_to_numpy(state)
    flat = state_from_numpy(parts, parts.size)
    for a, b in zip(state, flat):
        assert torch.equal(a.reshape(-1), b)


def test_u32_helpers_exact_against_numpy_u32():
    rng = np.random.default_rng(1)
    a, b = _u32(rng, 4096), _u32(rng, 4096)[::-1].copy()
    ta, tb = _t(a), _t(b)
    # correctly rounded u32 -> f32 (numpy's conversion rounds once)
    np.testing.assert_array_equal(mie.u32_to_f32(ta).numpy(), a.astype(np.float32))
    for k in (1, 4, 9, 16, 31):
        np.testing.assert_array_equal(
            mie.bucket_of(ta, k).numpy(), (a >> np.uint32(32 - k)).astype(np.int32)
        )
    np.testing.assert_array_equal(mie.u32_below_half(ta).numpy(), a < np.uint32(2147483647))
    # int32 wrap-difference == the u32 wrap-difference bitcast to i32
    np.testing.assert_array_equal((tb - ta).numpy(), (b - a).view(np.int32))
    np.testing.assert_array_equal((ta + tb).numpy().view(np.uint32), a + b)
    scale = np.float32(3.0e-18)
    np.testing.assert_array_equal(
        mie.wrap_dist(ta, tb, scale).numpy(),
        (b - a).view(np.int32).astype(np.float32) * scale,
    )


@pytest.mark.parametrize(
    "sigma, eps, n, m",
    [
        (3.609e-10, 1.46e-21, 14.08, 6.0),  # nitrogen
        (3.404e-10, 1.63e-21, 12.085, 6.0),  # argon
        (0.0, 1.46e-21, 14.08, 6.0),  # degenerate sigma slider
        (3.609e-10, 1.46e-21, 6.0, 14.08),  # m > n
        (3.609e-10, -1.46e-21, 14.08, 6.0),  # negative eps
        (1e-30, 1e30, 14.08, 6.0),  # |t| beyond f32
    ],
)
def test_mie_log_coeffs_scalars_match_jax(sigma, eps, n, m):
    vals = [np.float32(v) for v in (sigma, eps, n, m)]
    ref = jmie.mie_log_coeffs_scalars(*(jnp.float32(v) for v in vals))
    got = mie.mie_log_coeffs_scalars(*(torch.tensor(v) for v in vals))
    for name, r, g in zip(("A1", "B1", "A2", "B2", "inv_s2", "s1", "s2"), ref, got):
        r, g = np.float32(r), g.numpy()
        if np.isinf(r):
            assert r == g, name
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)


def _positions(rng, n=512):
    x, y = _u32(rng, n), _u32(rng, n)[::-1].copy()
    # a cluster right around the cursor so the radius test is exercised
    x[-64:] = np.uint32(2**31) + rng.integers(-2**28, 2**28, 64).astype(np.uint32)
    y[-64:] = np.uint32(2**31) + rng.integers(-2**28, 2**28, 64).astype(np.uint32)
    return x, y


@pytest.mark.parametrize("cursor", [(0.5, 0.5), (-1.0, -1.0)])
def test_cursor_force_matches_jax(cursor):
    x, y = _positions(np.random.default_rng(2))
    meta = _meta(cursor=cursor)
    jp = JSimParams.from_record(meta)
    ref = [np.asarray(v) for v in jmie.cursor_force(jnp.asarray(x), jnp.asarray(y), jp)]
    pv = SimParams.from_record(meta).vector()
    got = [v.numpy() for v in mie.cursor_force(_t(x), _t(y), pv)]
    if cursor[0] > 0:
        assert (ref[0] != 0).any()
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=0)


def test_wall_force_matches_jax():
    x, y = _positions(np.random.default_rng(3))
    meta = _meta()
    jp = JSimParams.from_record(meta)
    ref = [np.asarray(v) for v in jmie.wall_force(jnp.asarray(x), jnp.asarray(y), jp)]
    pv = SimParams.from_record(meta).vector()
    got = [v.numpy() for v in mie.wall_force(_t(x), _t(y), pv)]
    for r, g in zip(ref, got):
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        np.testing.assert_allclose(g[finite], r[finite], rtol=1e-5, atol=0)


def test_external_forces_sum_cursor_and_wall():
    x, y = _positions(np.random.default_rng(4))
    pv = SimParams.from_record(_meta()).vector()
    st = ParticleState(_t(x), _t(y), *(torch.zeros(x.size) for _ in range(2)),
                       torch.zeros(x.size, dtype=torch.int32))
    fx, fy = external_forces(st, pv)
    (cx, cy), (wx, wy) = mie.cursor_force(st.x, st.y, pv), mie.wall_force(st.x, st.y, pv)
    assert torch.equal(fx, cx + wx) and torch.equal(fy, cy + wy)


def test_leapfrog_apply_matches_jax():
    rng = np.random.default_rng(5)
    n = 2048
    x, y = _u32(rng, n), _u32(rng, n)
    m = x.size
    vx = rng.normal(0, 300, m).astype(np.float32)
    vy = rng.normal(0, 300, m).astype(np.float32)
    ty = np.where(rng.random(m) < 0.8, 0, -1).astype(np.int32)
    fx = rng.normal(0, 1e-11, m).astype(np.float32)
    fy = rng.normal(0, 1e-11, m).astype(np.float32)
    meta = _meta()
    jp = JSimParams.from_record(meta)
    ref = jmie.leapfrog_apply(*(jnp.asarray(a) for a in (x, y, vx, vy, ty, fx, fy)), jp)
    ref = [np.asarray(a) for a in ref]
    got = mie.leapfrog_apply(_t(x), _t(y), *(torch.from_numpy(a) for a in (vx, vy, ty, fx, fy)),
                             SimParams.from_record(meta).vector())
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[0].view(np.uint32), ref[0])
    np.testing.assert_array_equal(got[1].view(np.uint32), ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-6, atol=0)


def test_leapfrog_saturates_like_xla():
    """An absurd velocity drives the fixed-point delta past int32: the
    convert saturates (XLA's f32->s32 semantics, which the CUDA kernel's
    __float2int_rn shares) instead of wrapping or going undefined."""
    meta = _meta()
    jp = JSimParams.from_record(meta)
    vx = np.array([1e13, -1e13, np.nan, 10.0], np.float32)
    x = np.full(4, 1000, np.uint32)
    zeros = np.zeros(4, np.float32)
    ty = np.zeros(4, np.int32)
    ref = np.asarray(jmie.leapfrog_apply(jnp.asarray(x), jnp.asarray(x), jnp.asarray(vx),
                                         jnp.asarray(zeros), jnp.asarray(ty),
                                         jnp.asarray(zeros), jnp.asarray(zeros), jp)[0])
    got = mie.leapfrog_apply(_t(x), _t(x), torch.from_numpy(vx), torch.from_numpy(zeros),
                             torch.from_numpy(ty), torch.from_numpy(zeros),
                             torch.from_numpy(zeros), SimParams.from_record(meta).vector())[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
