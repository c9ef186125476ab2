"""The plain reference of the MatrixBuckets frame, on live particles.

What the port computes, written again from the semantics and frozen here:
the box is a 2^by_log2 x 2^bx_log2 grid of ``cap``-slot buckets; a
particle's forces are the cursor's, the four walls' and the Mie pairs of
every live particle in the 3x3 buckets around the bucket it is stored in,
added one candidate at a time in that neighbourhood's scan order (the
bucket rows dy = -1, 0, 1, in each the columns dx = -1, 0, 1, in each the
slots ascending), then a kick-drift leapfrog in u32 fixed point. A frame is
one step, then (rebucket, up to ``move_every`` steps) until ``steps`` are
done. The rebucket keeps, for each target bucket, the first ``cap``
particles of its pull order (source buckets in the same scan order, slots
ascending) among those that lie within one bucket of their target, and
drops the rest.

Every float operation is the f32 operation the port's kernels round alike
(``particle_simulator_tpu_torch/physics/mie.py``, copied here), so the
reference agrees with the port bit for bit when both follow the semantics:
the comparison that decides ``correct`` is exact. The state is a ``Layout``
of the live particles only, kept sorted by (bucket, slot), which is the
wire's order; each particle's candidates are listed once per move chunk, so
a step costs the live pairs, not the grid's slots.

``precision="bf16"`` is the control: the pair terms, their sum and the kick
in bfloat16, the nearest precision below the f32 the configuration states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psbench import wire
from psbench.scenes import Grid

F32 = torch.float32
U32_MAX_F = np.float32(4294967295.0)
HALF_U32 = 2147483647
PARTICLE_MASS = np.float32(6.63352599e-26)  # Argon's, for every particle
SIGMA, EPS, N, M, CURX, CURY, CURSZ, DT, BW, BH = range(10)
_F32_TINY = torch.finfo(F32).tiny
_F32_HUGE = torch.finfo(F32).max
_I32_MAX = 2147483647
# elements of one (receivers, candidates) pass of the pair terms
PASS_ELEMENTS = 1 << 26


def params_vector(meta: np.ndarray, device) -> torch.Tensor:
    """The ten f32 scalars a step reads, from a metadata record: species
    0's sigma, epsilon, n, m; the cursor's x, y and size; dt; the box."""
    p0 = meta["particles"][0]
    vals = [p0["sigma"], p0["epsilon"], p0["n"], p0["m"], meta["cursor_pos"][0],
            meta["cursor_pos"][1], meta["cursor_size"], meta["step_dt"], meta["box_width"],
            meta["box_height"]]
    return torch.tensor([np.float32(v) for v in vals], dtype=F32).to(device)


# ---------------------------------------------------------------------------
# the force law and the integrator (f32, in the kernels' rounding)
# ---------------------------------------------------------------------------

def _const(params, v) -> torch.Tensor:
    return params.new_full((), v)


def u32_to_f32(v):
    hi = ((v >> 16) & 0xFFFF).to(F32)
    lo = (v & 0xFFFF).to(F32)
    return hi * 65536.0 + lo


def bucket_of(v, log2: int):
    return (v >> (32 - log2)) & ((1 << log2) - 1)


def mie_constant(n, m):
    return (n / (n - m)) * torch.exp((m / (n - m)) * torch.log(n / m))


def log_coeffs(params):
    sigma, eps, n, m = params[SIGMA], params[EPS], params[N], params[M]
    c = mie_constant(n, m)
    s2_raw = sigma * sigma
    degenerate = s2_raw < _F32_TINY
    s2 = torch.clamp(s2_raw, min=_F32_TINY)
    ce_s2 = c * eps / s2
    t1, t2 = ce_s2 * m, ce_s2 * n
    neg_inf = torch.full_like(t1, float("-inf"))
    a1 = torch.where(degenerate, neg_inf, torch.log(torch.clamp(t1.abs(), max=_F32_HUGE)))
    a2 = torch.where(degenerate, neg_inf, torch.log(torch.clamp(t2.abs(), max=_F32_HUGE)))
    one = torch.ones_like(t1)
    return (a1, (m + 2.0) * 0.5, a2, (n + 2.0) * 0.5, torch.reciprocal(s2),
            torch.where(t1 < 0.0, -one, one), torch.where(t2 < 0.0, -one, one))


def pair_terms(dx, dy, valid, coeffs):
    a1, b1, a2, b2, inv_s2, s1, s2 = coeffs
    d2 = torch.where(valid, dx * dx + dy * dy, 1.0)
    lu = torch.log(d2 * inv_s2)
    f_over_r = s1 * torch.exp(a1 - b1 * lu) - s2 * torch.exp(a2 - b2 * lu)
    f_over_r = torch.where(valid, f_over_r, 0.0)
    return f_over_r * dx, f_over_r * dy


def cursor_force(x, y, params):
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


def wall_force(x, y, params):
    sigma, m = params[SIGMA], params[M]
    ce = mie_constant(params[N], params[M]) * params[EPS]
    u32_max = _const(params, U32_MAX_F)

    def axis(v, box):
        vf = u32_to_f32(v)
        low = (v >= 0) & (v != HALF_U32)
        dist = torch.where(low, vf, U32_MAX_F - vf) / u32_max * box
        return torch.where(low, 1.0, -1.0) * (ce * m * torch.exp(m * torch.log(sigma / dist))
                                              / dist)

    return axis(x, params[BW]), axis(y, params[BH])


def _f32_to_i32_saturating(v):
    big = v >= 2147483648.0
    small = v < -2147483648.0
    safe = torch.where(big | small | v.isnan(), 0.0, v).to(torch.int32)
    safe = torch.where(big, _I32_MAX, safe)
    return torch.where(small, -_I32_MAX - 1, safe)


def leapfrog(x, y, vx, vy, fx, fy, params, low: bool):
    """v += F/m*dt; x += round(v*dt/box * u32_max) as a wrapping add."""
    dt = params[DT]
    mass = _const(params, PARTICLE_MASS)
    if low:
        bf = torch.bfloat16
        nvx = (vx.to(bf) + (fx.to(bf) / mass.to(bf)) * dt.to(bf)).to(F32)
        nvy = (vy.to(bf) + (fy.to(bf) / mass.to(bf)) * dt.to(bf)).to(F32)
    else:
        nvx = vx + (fx / mass) * dt
        nvy = vy + (fy / mass) * dt
    ddx = torch.round((nvx * dt / params[BW]) * U32_MAX_F)
    ddy = torch.round((nvy * dt / params[BH]) * U32_MAX_F)
    return x + _f32_to_i32_saturating(ddx), y + _f32_to_i32_saturating(ddy), nvx, nvy


# ---------------------------------------------------------------------------
# the layout of the live particles
# ---------------------------------------------------------------------------

class Layout(NamedTuple):
    """Live particles sorted by (bucket, slot): x, y the int32 bits of the
    u32 positions, vx, vy f32, ty int32, bucket (row-major id) and slot
    int64; ``grid`` the bucket grid."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    ty: torch.Tensor
    bucket: torch.Tensor
    slot: torch.Tensor
    grid: Grid

    def take(self, idx) -> "Layout":
        return Layout(*(a[idx] for a in self[:7]), self.grid)


def from_particles(parts: np.ndarray, bucket, slot, g: Grid, device) -> Layout:
    """A layout from wire-dtype particles and their (bucket, slot)."""
    def t(name, dtype):
        a = np.ascontiguousarray(parts[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(dtype, copy=True)).to(device)

    bucket = torch.as_tensor(np.asarray(bucket, np.int64), device=device)
    slot = torch.as_tensor(np.asarray(slot, np.int64), device=device)
    order = torch.argsort(bucket * g.cap + slot, stable=True)
    lay = Layout(t("x", np.int32), t("y", np.int32), t("vx", np.float32),
                 t("vy", np.float32), t("ty", np.int32), bucket, slot, g)
    return lay.take(order)


def from_grid(fields, g: Grid) -> Layout:
    """A layout from the (BY, BX, CAP) tensors x, y, vx, vy, ty of a grid
    state (live slots only)."""
    x, y, vx, vy, ty = fields
    flat = torch.nonzero(ty.reshape(-1) >= 0).reshape(-1)
    return Layout(*(a.reshape(-1)[flat] for a in (x, y, vx, vy, ty)),
                  torch.div(flat, g.cap, rounding_mode="floor"), flat % g.cap, g)


def restrict(lay: Layout, rows: tuple[int, int], cols: tuple[int, int]) -> Layout:
    """The particles stored in bucket rows [rows) and columns [cols)."""
    by = torch.div(lay.bucket, lay.grid.bx, rounding_mode="floor")
    bx = lay.bucket % lay.grid.bx
    keep = (by >= rows[0]) & (by < rows[1]) & (bx >= cols[0]) & (bx < cols[1])
    return lay.take(torch.nonzero(keep).reshape(-1))


def pack(lay: Layout) -> np.ndarray:
    """The particles in wire order, as the wire's dtype."""
    out = np.empty(len(lay.x), dtype=wire.PARTICLE_DTYPE)
    for name, a in zip(wire.PARTICLE_DTYPE.names, lay[:5]):
        out[name] = a.cpu().numpy().view(wire.PARTICLE_DTYPE[name])
    return out


def mismatches(a: np.ndarray, b: np.ndarray) -> int:
    """Particles whose 20 bytes differ between two wire-dtype arrays, plus
    the difference of their lengths."""
    n = min(len(a), len(b))
    va = np.ascontiguousarray(a[:n]).view(np.uint32).reshape(n, 5)
    vb = np.ascontiguousarray(b[:n]).view(np.uint32).reshape(n, 5)
    return int((va != vb).any(axis=1).sum()) + abs(len(a) - len(b))


def layout_mismatches(a: Layout, b: Layout) -> int:
    """Particles that differ in their fields or their (bucket, slot)."""
    n = min(len(a.x), len(b.x))
    diff = torch.zeros(n, dtype=torch.bool, device=a.x.device)
    for u, v in zip(a[:7], b[:7]):
        u, v = u[:n], v[:n].to(u.device)
        if u.dtype == F32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        diff |= u != v
    return int(diff.sum()) + abs(len(a.x) - len(b.x))


# ---------------------------------------------------------------------------
# candidates, step, rebucket, frame
# ---------------------------------------------------------------------------

def candidates(lay: Layout) -> torch.Tensor:
    """(live, K) int64: each particle's live candidates in scan order (self
    left out), as indices into the layout, -1 past the last."""
    g = lay.grid
    n = len(lay.x)
    dev = lay.x.device
    if n == 0:
        return torch.zeros((0, 0), dtype=torch.int64, device=dev)
    counts = torch.bincount(lay.bucket, minlength=g.buckets)
    starts = torch.cumsum(counts, 0) - counts
    cmax = int(counts.max())
    by = torch.div(lay.bucket, g.bx, rounding_mode="floor")
    bx = lay.bucket % g.bx
    s = torch.arange(cmax, device=dev)[None, :]
    me = torch.arange(n, device=dev)[:, None]
    blocks = []
    for k in range(9):
        ny, nx = by + (k // 3 - 1), bx + (k % 3 - 1)
        ok = (ny >= 0) & (ny < g.by) & (nx >= 0) & (nx < g.bx)
        nb = torch.where(ok, ny * g.bx + nx, 0)
        cnt = torch.where(ok, counts[nb], 0)
        idx = starts[nb][:, None] + s
        valid = s < cnt[:, None]
        if k == 4:
            valid &= idx != me
        blocks.append(torch.where(valid, idx, -1))
    cand = torch.cat(blocks, dim=1)
    order = torch.sort((cand < 0).to(torch.int8), dim=1, stable=True).indices
    cand = torch.gather(cand, 1, order)
    width = int((cand >= 0).sum(1).max())
    return cand[:, :width].contiguous()


def step(lay: Layout, cand: torch.Tensor, params: torch.Tensor, low: bool = False) -> Layout:
    """One step: cursor and walls, then each candidate's pair term added in
    order, then the leapfrog."""
    fcx, fcy = cursor_force(lay.x, lay.y, params)
    fwx, fwy = wall_force(lay.x, lay.y, params)
    fx, fy = fcx + fwx, fcy + fwy
    u32_max = _const(params, U32_MAX_F)
    sx, sy = params[BW] / u32_max, params[BH] / u32_max
    coeffs = log_coeffs(params)
    n, width = cand.shape
    rows = max(1, PASS_ELEMENTS // max(width, 1))
    out_x, out_y = [], []
    for i0 in range(0, n, rows):
        c = cand[i0:i0 + rows]
        valid = c >= 0
        j = c.clamp(min=0)
        dx = (lay.x[j] - lay.x[i0:i0 + rows, None]).to(F32) * sx
        dy = (lay.y[j] - lay.y[i0:i0 + rows, None]).to(F32) * sy
        tx, ty = pair_terms(dx, dy, valid, coeffs)
        ax, ay = fx[i0:i0 + rows], fy[i0:i0 + rows]
        if low:
            tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
            ax, ay = ax.to(torch.bfloat16), ay.to(torch.bfloat16)
        for k in range(width):
            ax = ax + tx[:, k]
            ay = ay + ty[:, k]
        out_x.append(ax.to(F32))
        out_y.append(ay.to(F32))
    if n:
        fx, fy = torch.cat(out_x), torch.cat(out_y)
    nx, ny, nvx, nvy = leapfrog(lay.x, lay.y, lay.vx, lay.vy, fx, fy, params, low)
    return lay._replace(x=nx, y=ny, vx=nvx, vy=nvy)


def rebucket(lay: Layout) -> Layout:
    """The rebucket pass: each kept particle to its target bucket at its
    rank in the pull order; the rest dropped."""
    g = lay.grid
    tby = bucket_of(lay.y, g.by_log2).to(torch.int64)
    tbx = bucket_of(lay.x, g.bx_log2).to(torch.int64)
    dy = torch.div(lay.bucket, g.bx, rounding_mode="floor") - tby
    dx = lay.bucket % g.bx - tbx
    pull = (lay.ty >= 0) & (dy.abs() <= 1) & (dx.abs() <= 1)
    target = tby * g.bx + tbx
    key = (target * 9 + (dy + 1) * 3 + (dx + 1)) * g.cap + lay.slot
    idx = torch.nonzero(pull).reshape(-1)
    idx = idx[torch.argsort(key[idx])]
    tgt = target[idx]
    rank = torch.arange(len(idx), device=idx.device) - torch.searchsorted(tgt, tgt)
    keep = rank < g.cap
    moved = lay.take(idx[keep])
    return moved._replace(bucket=tgt[keep], slot=rank[keep])


def frame(lay: Layout, params: torch.Tensor, steps: int, low: bool = False) -> Layout:
    """One frame of ``steps`` steps: a step, then (rebucket, up to
    ``move_every`` steps) until done."""
    if steps < 1:
        return lay
    lay = step(lay, candidates(lay), params, low)
    done = 1
    while done < steps:
        lay = rebucket(lay)
        cand = candidates(lay)
        run = min(lay.grid.move_every, steps - done)
        for _ in range(run):
            lay = step(lay, cand, params, low)
        done += run
    return lay


def light_cone(steps: int, move_every: int) -> int:
    """Buckets that information crosses in a frame: one a step (the 3x3
    neighbourhood) and one a rebucket (a move of at most one bucket), and
    one of room."""
    return steps + -(-(steps - 1) // move_every) + 1
