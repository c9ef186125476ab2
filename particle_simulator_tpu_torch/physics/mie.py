"""Mie-potential physics in f32 on tensors: the plain PyTorch versions.

Counterpart of ``particle_simulator_tpu/physics/mie.py``, written in the form
the JAX package's step kernel evaluates (``ops/bucket_pallas.py:_step_block``):
wall force as ``Ce*m*exp(m*log(sigma/d))/d``, pair force in the log domain,
displacements as the int32 view of the u32 wrap-difference. The CUDA step
kernel (``ops/csrc/bucket_step.cu``) evaluates the same formulas in the same
f32 types; tests hold both against the JAX package.

Every function takes ``params``, the (10,) f32 tensor of
``engine/state.py:SimParams.vector`` (index names ``SIGMA`` ... ``BH``).

Positions arrive as int32 tensors holding u32 bit patterns, so the u32
operations the JAX code uses are rewritten here:

- u32 -> f32 is the correctly rounded hi/lo split (``u32_to_f32``);
- the bucket id is a logical shift, an arithmetic ``>>`` then a mask;
- ``x < 2147483647`` (unsigned) is ``x >= 0 and x != 0x7FFFFFFF``;
- ``b - a`` in int32 is the u32 wrap-difference already reinterpreted as
  signed, i.e. the JAX kernel's ``_wrap_dist`` bitcast.
"""

from __future__ import annotations

import torch

from particle_simulator_tpu_torch.engine.state import (
    BH,
    BW,
    CURSZ,
    CURX,
    CURY,
    DT,
    EPS,
    HALF_U32,
    M,
    N,
    PARTICLE_MASS,
    SIGMA,
    U32_MAX_F,
)

F32 = torch.float32
_F32_TINY = torch.finfo(F32).tiny  # smallest normal f32
_F32_HUGE = torch.finfo(F32).max  # largest finite f32
_I32_MAX = 2147483647


# ---------------------------------------------------------------------------
# u32 bit-pattern helpers
# ---------------------------------------------------------------------------

def u32_to_f32(v: torch.Tensor) -> torch.Tensor:
    """u32 (held in int32) -> f32, correctly rounded: both 16-bit halves
    convert exactly, the high half scales by an exact power of two, and the
    sum rounds once. A convert-then-fix-up version double-rounds by 1 ulp,
    which is enough to flip the cursor-radius test."""
    hi = ((v >> 16) & 0xFFFF).to(F32)
    lo = (v & 0xFFFF).to(F32)
    return hi * 65536.0 + lo


def bucket_of(v: torch.Tensor, log2: int) -> torch.Tensor:
    """Top ``log2`` bits of the u32 ``v``: the logical shift, masked after the
    arithmetic ``>>``."""
    return (v >> (32 - log2)) & ((1 << log2) - 1)


def u32_below_half(v: torch.Tensor) -> torch.Tensor:
    """u32 ``v < 2147483647`` on the int32 bit pattern."""
    return (v >= 0) & (v != HALF_U32)


def wrap_dist(a: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """Signed displacement b - a in meters: the int32 difference is the u32
    wrap-subtraction reinterpreted as signed, exact while |b - a| < 2^31
    (always, for 3x3-bucket neighbours)."""
    return (b - a).to(F32) * scale


# ---------------------------------------------------------------------------
# force law
# ---------------------------------------------------------------------------

def mie_constant(n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """C = (n/(n-m)) * (n/m)^(m/(n-m)), in the exp/log form."""
    return (n / (n - m)) * torch.exp((m / (n - m)) * torch.log(n / m))


def mie_log_coeffs_scalars(sigma, eps, n, m):
    """Log-domain pair-force constants from f32 0-d tensors:
    F(r)/r = s1*exp(A1 - B1*lu) - s2*exp(A2 - B2*lu), lu = log(r^2/sigma^2),
    A1 = log|C*eps*m/sigma^2|, B1 = (m+2)/2 (A2/B2 with n).

    The degenerate-slider clamps of the JAX version: sigma == 0 clamps s2 to
    the smallest normal f32 and pins A to -inf (the direct form's exact zero
    force); |t| clamps to the largest finite f32; the signs s1/s2 keep
    negative eps or m > n finite instead of log-of-negative NaNs."""
    C = mie_constant(n, m)
    s2_raw = sigma * sigma
    degenerate = s2_raw < _F32_TINY
    s2 = torch.clamp(s2_raw, min=_F32_TINY)
    ce_s2 = C * eps / s2
    t1 = ce_s2 * m
    t2 = ce_s2 * n
    neg_inf = torch.full_like(t1, float("-inf"))
    A1 = torch.where(degenerate, neg_inf, torch.log(torch.clamp(t1.abs(), max=_F32_HUGE)))
    A2 = torch.where(degenerate, neg_inf, torch.log(torch.clamp(t2.abs(), max=_F32_HUGE)))
    B1 = (m + 2.0) * 0.5
    B2 = (n + 2.0) * 0.5
    one = torch.ones_like(t1)
    s1 = torch.where(t1 < 0.0, -one, one)
    s2_sign = torch.where(t2 < 0.0, -one, one)
    return A1, B1, A2, B2, torch.reciprocal(s2), s1, s2_sign


def mie_log_coeffs(params: torch.Tensor):
    return mie_log_coeffs_scalars(params[SIGMA], params[EPS], params[N], params[M])


def _const(params: torch.Tensor, v) -> torch.Tensor:
    """An f32 0-d tensor on the params' device. Dividing by it (or into it)
    is one IEEE division; a Python-scalar divisor would let CUDA torch
    multiply by its reciprocal instead, and ``scalar / t`` is
    ``reciprocal(t) * scalar`` everywhere, and either rounds differently
    from the kernel."""
    return params.new_full((), v)


def cursor_force(x: torch.Tensor, y: torch.Tensor, params: torch.Tensor):
    """Editor cursor repulsion: 8e-12/(d^2+1) with componentwise sign, in
    normalized [0,1] coordinates, inside radius cursor_size/2. A cursor at
    (-1, -1) lies outside every radius."""
    u32_max = _const(params, U32_MAX_F)
    dx = params[CURX] - u32_to_f32(x) / u32_max
    dy = params[CURY] - u32_to_f32(y) / u32_max
    sq = dx * dx + dy * dy
    inside = sq < params[CURSZ] * params[CURSZ] * 0.25
    mag = _const(params, 8e-12) / (sq + 1.0)
    fx = torch.where(dx > 0.0, -mag, mag)
    fy = torch.where(dy > 0.0, -mag, mag)
    zero = torch.zeros_like(fx)
    return torch.where(inside, fx, zero), torch.where(inside, fy, zero)


def wall_force(x: torch.Tensor, y: torch.Tensor, params: torch.Tensor):
    """Repulsive-only Mie force from the four box walls, pushing inward from
    whichever half of the box the particle is in."""
    sigma, m = params[SIGMA], params[M]
    ce = mie_constant(params[N], params[M]) * params[EPS]
    u32_max = _const(params, U32_MAX_F)

    def rep(dist):
        return ce * m * torch.exp(m * torch.log(sigma / dist)) / dist

    def axis(v, box):
        vf = u32_to_f32(v)
        low = u32_below_half(v)
        dist = torch.where(low, vf, U32_MAX_F - vf) / u32_max * box
        sign = torch.where(low, 1.0, -1.0)
        return sign * rep(dist)

    return axis(x, params[BW]), axis(y, params[BH])


def _f32_to_i32_saturating(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> s32 convert: saturating, NaN -> 0 (the CUDA kernel's
    ``__float2int_rn`` does the same). Out-of-range ``.to(int32)`` is
    undefined on the CPU, so only in-range values are converted."""
    big = v >= 2147483648.0
    small = v < -2147483648.0
    safe = torch.where(big | small | v.isnan(), 0.0, v).to(torch.int32)
    safe = torch.where(big, _I32_MAX, safe)
    return torch.where(small, -_I32_MAX - 1, safe)


def leapfrog_apply(x, y, vx, vy, ty, fx, fy, params: torch.Tensor):
    """Kick-drift leapfrog in u32 fixed point:
    v += F/m*dt; x += round(v*dt/box * u32_max) as a wrapping add.
    Dead slots pass through unchanged."""
    dt = params[DT]
    mass = _const(params, PARTICLE_MASS)
    nvx = vx + (fx / mass) * dt
    nvy = vy + (fy / mass) * dt
    ddx = torch.round((nvx * dt / params[BW]) * U32_MAX_F)
    ddy = torch.round((nvy * dt / params[BH]) * U32_MAX_F)
    nx = x + _f32_to_i32_saturating(ddx)
    ny = y + _f32_to_i32_saturating(ddy)
    live = ty >= 0
    return (
        torch.where(live, nx, x),
        torch.where(live, ny, y),
        torch.where(live, nvx, vx),
        torch.where(live, nvy, vy),
    )


def pair_force_accum(xi, yi, xj, yj, tyj, params: torch.Tensor, exclude=None,
                     fx=None, fy=None):
    """Mie pair forces on each i from the j set, added onto ``fx``/``fy``
    (default zero): xi/yi shaped (..., Ni), xj/yj/tyj shaped (..., Nj).
    Tombstoned j's and the pairs in ``exclude`` ((Ni, Nj) bool, e.g.
    i == j) add nothing; masked pairs take a safe distance so no NaN leaks.

    The j's are added one at a time in their order, each term rounded as
    its own f32 operation: the step kernel's per-thread sum, so the two
    agree to the bit wherever the math library does (the sum of a relaxed
    lattice cancels to nearly zero, so another summation order moves the
    result by more than the terms' own rounding)."""
    scale_x, scale_y = pair_scales(params)
    coeffs = mie_log_coeffs(params)
    if fx is None:
        fx = torch.zeros(xi.shape, dtype=F32, device=xi.device)
    if fy is None:
        fy = torch.zeros(yi.shape, dtype=F32, device=yi.device)
    for k in range(xj.shape[-1]):
        dx = wrap_dist(xi, xj[..., k:k + 1], scale_x)
        dy = wrap_dist(yi, yj[..., k:k + 1], scale_y)
        valid = tyj[..., k:k + 1] >= 0
        if exclude is not None:
            valid = valid & ~exclude[..., k]
        tx, ty = pair_terms(dx, dy, valid, coeffs)
        fx = fx + tx
        fy = fy + ty
    return fx, fy


def pair_scales(params: torch.Tensor):
    """Meters per u32 unit along x and y."""
    u32_max = _const(params, U32_MAX_F)
    return params[BW] / u32_max, params[BH] / u32_max


def pair_terms(dx, dy, valid, coeffs):
    """The force terms ``(F/r*dx, F/r*dy)`` of the pairs with displacement
    ``dx``/``dy`` (meters); ``coeffs`` is ``mie_log_coeffs(params)``. An
    invalid pair takes a safe distance, so no NaN leaks, and adds
    ``+0 * dx``: the same signed zero the kernels add."""
    A1, B1, A2, B2, inv_s2, s1, s2 = coeffs
    d2 = torch.where(valid, dx * dx + dy * dy, 1.0)
    lu = torch.log(d2 * inv_s2)
    f_over_r = s1 * torch.exp(A1 - B1 * lu) - s2 * torch.exp(A2 - B2 * lu)
    f_over_r = torch.where(valid, f_over_r, 0.0)
    return f_over_r * dx, f_over_r * dy
