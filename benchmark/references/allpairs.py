"""The reference of a served CompactArray scene: what the serve harness
sends, and what the program's frames of it must hold, bit for bit.

It gives the interface ``references/buckets.py`` documents. Here the scene
is the editor's hex lattice (``scenes.hex_lattice``) sent with
``data_structure`` CompactArray; the program holds it as one flat array of
slots, the live particles first in the order sent, and ships the live slots
in slot order. A ``Flat`` layout is that array: each live particle at its
slot, tombstones (``ty`` -1) in the slots between them.

A step is the CompactArray semantics (upstream
``cuda_simulator/src/kernel_compact.cuh``: every particle feels the cursor,
the four walls and the Mie pair force of every other live particle, then a
kick-drift leapfrog), with the force law, the walls, the cursor and the
leapfrog of ``refsim`` (plain PyTorch in float32, every operation rounded
as the port's kernels round it). Two departures from upstream, both the
port's all-pairs step's own definition (the header of its
``allpairs_step.cu``), which the comparison holds it to:

- the sum over the sources is segmented, not one running sum: the slots
  are cut into segments of ``SEGMENT`` sources, ``[k*L, (k+1)*L)``. Segment
  0's accumulator starts from the receiver's cursor force plus its wall
  force, every other from +0.0; each adds its pair terms one source at a
  time in ascending slot order, the self pair and a tombstone adding
  ``+0 * dx``; the receiver's force is accumulator 0, plus partial 1, plus
  partial 2, ..., one rounded add each in ascending order;
- positions are u32 fixed point and the drift is a wrapping u32 add
  (upstream keeps f32 positions).

A tombstone's term is a signed zero, which leaves every accumulator as it
was (an accumulator that starts from +0.0 never holds -0.0), so slots past
the last live one change nothing: a layout ends at its last live slot, and a
segment's tail is padded with +0.0 terms. The terms of a block of receivers
are computed at once and summed as a (rows, segments, L) view: L vector adds
within the segments, then one add a segment across them; no block holds
more than ``BLOCK_ELEMENTS`` terms.

``low=True`` is the control: the pair terms, their sums and the kick in
bfloat16, the nearest precision below the f32 the configuration states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psbench import refsim, roofline, scenes, wire

# The comparison is exact; no float32 product may run in TF32 (none is a
# matrix multiply here, but the reference must not depend on that).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
# L, the length of a segment of the all-pairs sum: a constant of the
# CompactArray step's definition (AP_SEGMENT in the port's
# ops/csrc/allpairs_step.cu), written here, not imported
SEGMENT = 128
# terms of one (receivers, sources) block of a step
BLOCK_ELEMENTS = 1 << 26


class Flat(NamedTuple):
    """A CompactArray state as flat (slots,) tensors: x, y the int32 bits of
    the u32 positions, vx, vy f32, ty int32 (-1 for a tombstone)."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    ty: torch.Tensor


def _flat(parts: np.ndarray, index, device) -> Flat:
    """The live wire-dtype particles ``parts`` at slots ``index``, tombstones
    in every other slot up to the last live one."""
    index = np.asarray(index, np.int64)
    slots = int(index.max()) + 1 if len(index) else 0
    full = np.zeros(slots, dtype=wire.PARTICLE_DTYPE)
    full["ty"] = -1
    full[index] = parts

    def t(name, dtype):
        a = np.ascontiguousarray(full[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(dtype, copy=True)).to(device)

    return Flat(t("x", np.int32), t("y", np.int32), t("vx", np.float32), t("vy", np.float32),
                t("ty", np.int32))


def draw(cfg: dict, seed: int, k: int, drop: int):
    parts, meta = scenes.hex_lattice(cfg, [seed, k], drop=drop)
    meta["data_structure"] = wire.COMPACT_ARRAY
    return parts, meta


def loaded(parts, meta, device) -> Flat:
    live = parts[parts["ty"] >= 0]
    return _flat(live, np.arange(len(live)), device)


def _segmented(terms: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The (rows,) sums of a (rows, slots) block of terms, segment 0 from
    ``start``."""
    rows, slots = terms.shape
    n_seg = max(1, -(-slots // SEGMENT))
    padded = torch.nn.functional.pad(terms, (0, n_seg * SEGMENT - slots))
    # (L, rows, segments): each of the L adds reads one contiguous slice
    by_pos = padded.view(rows, n_seg, SEGMENT).permute(2, 0, 1).contiguous()
    acc = torch.zeros((rows, n_seg), dtype=terms.dtype, device=terms.device)
    acc[:, 0] = start
    for q in range(SEGMENT):
        acc += by_pos[q]
    total = acc[:, 0].clone()
    for s in range(1, n_seg):
        total += acc[:, s]
    return total


def step(lay: Flat, params: torch.Tensor, low: bool = False) -> Flat:
    """One all-pairs step of every slot; tombstones pass through."""
    slots = len(lay.x)
    fcx, fcy = refsim.cursor_force(lay.x, lay.y, params)
    fwx, fwy = refsim.wall_force(lay.x, lay.y, params)
    fx, fy = fcx + fwx, fcy + fwy
    u32_max = params.new_full((), refsim.U32_MAX_F)
    sx, sy = params[refsim.BW] / u32_max, params[refsim.BH] / u32_max
    coeffs = refsim.log_coeffs(params)
    live = lay.ty >= 0
    j = torch.arange(slots, device=lay.x.device)
    rows = max(1, BLOCK_ELEMENTS // max(slots, 1))
    out_x, out_y = [], []
    for i0 in range(0, slots, rows):
        i = j[i0:i0 + rows, None]
        dx = (lay.x[None, :] - lay.x[i0:i0 + rows, None]).to(F32) * sx
        dy = (lay.y[None, :] - lay.y[i0:i0 + rows, None]).to(F32) * sy
        tx, ty = refsim.pair_terms(dx, dy, live[None, :] & (j[None, :] != i), coeffs)
        ax, ay = fx[i0:i0 + rows], fy[i0:i0 + rows]
        if low:
            tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
            ax, ay = ax.to(torch.bfloat16), ay.to(torch.bfloat16)
        del dx, dy
        out_x.append(_segmented(tx, ax).to(F32))
        out_y.append(_segmented(ty, ay).to(F32))
    if slots:
        fx, fy = torch.cat(out_x), torch.cat(out_y)
    nx, ny, nvx, nvy = refsim.leapfrog(lay.x, lay.y, lay.vx, lay.vy, fx, fy, params, low)
    keep = [torch.where(live, new, old)
            for new, old in zip((nx, ny, nvx, nvy), (lay.x, lay.y, lay.vx, lay.vy))]
    return Flat(*keep, lay.ty)


def frame(lay: Flat, meta, steps: int, device, low: bool = False) -> Flat:
    params = refsim.params_vector(meta, device)
    for _ in range(steps):
        lay = step(lay, params, low)
    return lay


def pack(lay: Flat) -> np.ndarray:
    """The live slots in slot order, as the wire's dtype."""
    live = torch.nonzero(lay.ty >= 0).reshape(-1)
    return refsim.pack(Flat(*(a[live] for a in lay)))


def from_snapshot(snap: dict, parts, meta, device) -> Flat | None:
    if int(snap["data_structure"]) != wire.COMPACT_ARRAY:
        return None
    return _flat(wire.from_fields(snap), snap["index"], device)


def least(lay: Flat) -> dict:
    n = int((lay.ty >= 0).sum())
    return roofline.step_least_ms(n * (n - 1), n)
