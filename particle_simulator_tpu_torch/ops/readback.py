"""Dense-pack readback of the bucket grid.

Counterpart of ``particle_simulator_tpu/ops/readback.py``. The wire carries
only live particles, in the global row-major bucket order with slots
ascending, while the grid is mostly tombstones at editor densities. Every
bucket keeps its live particles in a slot prefix (bucketize and the rebucket
pass both fill slots ascending), so bucket b's particles take pack positions
[offset_b, offset_b + count_b), offset = exclusive cumsum of the counts, and
each output position finds its source by inverting that map:

    marks[offset_b] += 1 for every bucket      (one scatter-add)
    bucket_of[j] = cumsum(marks)[j] - 1
    slot_of[j]   = j - offset[bucket_of[j]]
    out[j]       = state[bucket_of[j], slot_of[j]]   (five gathers)

Plain PyTorch ops (the JAX package has no Pallas kernel here). The device
then ships exactly ``ncap`` slots per field plus a ``[max_occupancy, total]``
header; ``kcap`` bounds the source slot prefix. The pack is valid only when
``max_occupancy <= kcap`` and ``total <= ncap``; ``engine/simulator.py``
widens both and retries otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu_torch.engine.state import ParticleState


def dense_readback(state: ParticleState, kcap: int, ncap: int):
    """Pack every live particle of a (BY, BX, CAP) state into ``(ncap,)``
    fields in wire order. Returns ``(scalars, packed)``, ``scalars`` =
    int32 ``[max_occupancy, total]`` (exact whatever ``kcap``/``ncap``).
    Pad positions past ``total`` are tombstoned (``ty = -1``). Runs on the
    state's device without a host sync."""
    by, bx, cap = state.ty.shape
    dev = state.ty.device
    b = by * bx
    kcap = min(int(kcap), cap)
    counts = (state.ty >= 0).sum(-1, dtype=torch.int32).reshape(-1)
    total = counts.sum(dtype=torch.int32)
    mx = counts.max()
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts

    # one mark at each bucket's start; a start at or past ncap falls in the
    # spare last cell and is dropped
    marks = torch.zeros(ncap + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, offsets.clamp(max=ncap).long(),
                     torch.ones(b, dtype=torch.int32, device=dev))
    bucket_of = torch.cumsum(marks[:ncap], 0, dtype=torch.int32) - 1
    j = torch.arange(ncap, dtype=torch.int32, device=dev)
    slot_of = j - offsets[bucket_of.long()]
    valid = j < total
    # out-of-range sources (only when a bucket outgrew kcap: the pack is
    # then discarded) clamp like the reference's gather
    src_idx = torch.where(valid, bucket_of * kcap + slot_of, 0).clamp(0, b * kcap - 1).long()

    packed = []
    for name, a in zip(ParticleState._fields, state):
        g = a.reshape(b, cap)[:, :kcap].reshape(-1)[src_idx]
        if name == "ty":
            g = torch.where(valid, g, -1)
        packed.append(g)
    return torch.stack([mx, total]), ParticleState(*packed)


def dense_to_particles(total: int, packed) -> np.ndarray:
    """The first ``total`` entries of a pack (tensors or numpy arrays, x/y
    as int32 bit patterns) as one live ``PARTICLE_DTYPE`` array."""
    out = np.empty(int(total), dtype=PARTICLE_DTYPE)
    for name, a in zip(PARTICLE_DTYPE.names, packed):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[name] = a[: int(total)].view(PARTICLE_DTYPE[name])
    return out


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor): the sticky kcap/ncap sizes."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()
