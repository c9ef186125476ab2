"""Step functions: the forces every path shares, the all-pairs
(CompactArray) step and its frame runner.

Counterpart of ``particle_simulator_tpu/physics/step.py``. The reference's
CompactArray kernel is an exact O(N^2) force loop, one thread per particle;
``allpairs_step`` here is the plain PyTorch version of the port's kernel (a
segmented sum over the sources, ``segmented_sum``) on a flat ``(N,)``
state, and what ``ops/allpairs_cuda.py`` runs for CPU tensors and what
``chip_smoke.py`` holds the CUDA kernel (``ops/csrc/allpairs_step.cu``)
against on the card. ``allpairs_step_euler`` is not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import torch

from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.physics.mie import (
    cursor_force,
    leapfrog_apply,
    mie_log_coeffs,
    pair_scales,
    pair_terms,
    wall_force,
)

# elements of one (N, rows) pass of the vectorized pair terms: bounds the
# plain step's memory at large N (16,384 particles -> 4,096 receivers a pass)
PASS_ELEMENTS = 1 << 26

# length L of one segment of the all-pairs sum's j range: a fixed constant of
# the sum's definition (not of N, the card or the launch), mirrored by
# AP_SEGMENT in ops/csrc/allpairs_step.cu
SEGMENT = 128


def external_forces(state: ParticleState, params: torch.Tensor):
    """Cursor repulsion + wall forces on every slot."""
    fcx, fcy = cursor_force(state.x, state.y, params)
    fwx, fwy = wall_force(state.x, state.y, params)
    return fcx + fwx, fcy + fwy


def segmented_sum(terms: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The all-pairs sum of a block of receivers: ``terms`` is (N, rows),
    the term of source j on each receiver, ``start`` (rows,) what segment
    0's accumulator starts from; returns the (rows,) sums.

    The j range is cut into segments of ``SEGMENT``: segment k is
    ``[k*SEGMENT, min(N, (k+1)*SEGMENT))``. Accumulator 0 starts at
    ``start``, every other at +0.0; each adds its segment's terms one j at a
    time in ascending j. The sum is accumulator 0, plus partial 1, plus
    partial 2, ..., one rounded add each in ascending k. All full segments
    advance together, as one (segments, rows) accumulator walked ``SEGMENT``
    times; the ragged last one follows. With ``N <= SEGMENT`` this is the
    one-at-a-time sum."""
    n, rows = terms.shape
    n_full, tail = divmod(n, SEGMENT)
    acc = terms.new_zeros((n_full + 1, rows))
    acc[0] = start
    if n_full:
        full = terms[:n_full * SEGMENT].view(n_full, SEGMENT, rows)
        for k in range(SEGMENT):
            acc[:n_full].add_(full[:, k])
    for k in range(n_full * SEGMENT, n):
        acc[n_full].add_(terms[k])
    total = acc[0].clone()
    for k in range(1, n_full + bool(tail)):
        total.add_(acc[k])
    return total


def allpairs_forces(state: ParticleState, params: torch.Tensor):
    """Cursor, wall and all-pairs Mie forces on every slot of a flat state.

    Each receiver's sum is the segmented sum of ``segmented_sum``, the
    kernel's: segment 0 starts from the receiver's cursor + wall force, each
    segment of ``SEGMENT`` sources adds its pair terms one j at a time, and
    the segments' partials are added in ascending order, every add rounded
    as its own f32 op, so the two agree to the bit wherever the math library
    does. A fixed segment length keeps a scene padded with tombstones
    bit-identical on its live slots. The self pair and tombstoned j add
    ``+0 * dx``. The terms of a block of receivers are computed in one
    vectorized pass as an (N, rows) tensor (elementwise ops round the same
    whatever the shape); only the adds go row by row."""
    n = state.x.shape[0]
    fx, fy = external_forces(state, params)
    scale_x, scale_y = pair_scales(params)
    coeffs = mie_log_coeffs(params)
    xj, yj = state.x[:, None], state.y[:, None]
    live_j = state.ty[:, None] >= 0
    j = torch.arange(n, device=state.x.device)[:, None]
    rows = max(1, PASS_ELEMENTS // max(n, 1))
    out_x, out_y = [], []
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        i = torch.arange(i0, i1, device=state.x.device)[None, :]
        dx = (xj - state.x[None, i0:i1]).to(torch.float32) * scale_x  # [j, i] = x_j - x_i
        dy = (yj - state.y[None, i0:i1]).to(torch.float32) * scale_y
        tx, ty = pair_terms(dx, dy, live_j & (j != i), coeffs)
        out_x.append(segmented_sum(tx, fx[i0:i1]))
        out_y.append(segmented_sum(ty, fy[i0:i1]))
    return torch.cat(out_x), torch.cat(out_y)


def allpairs_step(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step with all-pairs forces (CompactArray semantics):
    cursor + wall + Mie pairs, then leapfrog. ``ty`` passes through and
    tombstones are unchanged."""
    fx, fy = allpairs_forces(state, params)
    nx, ny, nvx, nvy = leapfrog_apply(
        state.x, state.y, state.vx, state.vy, state.ty, fx, fy, params
    )
    return ParticleState(nx, ny, nvx, nvy, state.ty)


def run_frame(
    state: ParticleState,
    params: torch.Tensor,
    steps: int,
    step_fn: Callable[[ParticleState, torch.Tensor], ParticleState] = allpairs_step,
) -> ParticleState:
    """One frame of ``steps`` physics steps. ``steps`` is a plain int, so a
    live steps-per-frame edit changes nothing but the loop count."""
    for _ in range(steps):
        state = step_fn(state, params)
    return state
