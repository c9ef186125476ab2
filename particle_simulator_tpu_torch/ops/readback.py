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

``dense_readback`` is that map in plain PyTorch ops, the counterpart of
the JAX package's readback (which has no Pallas kernel here): ``ncap``
slots per field plus a ``[max_occupancy, total]`` header, ``kcap``
bounding the source slot prefix; the pack is valid only when
``max_occupancy <= kcap`` and ``total <= ncap``. ``dense_to_particles``
interleaves its fields into wire records on the host.

The engine reads a grid back through ``pack_records``: on the card one
hand-written kernel (``csrc/readback_pack.cu``) writes ``ncap`` wire
records of 20 bytes and the header in one buffer, which the host copies
once and ships as a ``PARTICLE_DTYPE`` view (``record_view``), with no
interleave on the host. The kernel reads each bucket's whole live prefix,
so it needs no ``kcap``; its plain version ``records_plain``, which a CPU
grid runs, is ``dense_readback`` at ``kcap = CAP`` with the fields
interleaved into records. ``engine/simulator.py`` widens ``ncap`` and packs
again when the live count outgrew it. ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.ops.bucket_cuda import check_fields, launch

LAUNCHES = {"readback_pack": 0}

RECORD_WORDS = 5  # int32 words of a wire record (x, y, vx, vy, ty)
HEADER_WORDS = 2  # [max_occupancy, total], after the ncap records


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
    """Smallest power of two >= max(n, floor): the sticky ``ncap`` and the
    CompactArray capacity."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()


def record_words(ncap: int) -> int:
    """int32 words of a record pack of ``ncap`` records."""
    return int(ncap) * RECORD_WORDS + HEADER_WORDS


def records_plain(state: ParticleState, ncap: int) -> torch.Tensor:
    """The plain version of ``pack_records``: ``dense_readback`` with the
    whole bucket as the slot prefix, its five fields interleaved into
    ``ncap`` records (x/y as the u32 bit patterns, vx/vy as the f32 bits),
    pad records past ``total`` the tombstone (0, 0, 0.0, 0.0, -1), then the
    header. On the state's device, without a host sync."""
    ncap = int(ncap)
    scalars, packed = dense_readback(state, state.ty.shape[-1], ncap)
    words = torch.stack([a.view(torch.int32) for a in packed], 1)
    pad = torch.arange(ncap, device=words.device) >= scalars[1]
    words[:, :4].masked_fill_(pad[:, None], 0)
    return torch.cat([words.reshape(-1), scalars])


def pack_records(state: ParticleState, ncap: int) -> torch.Tensor:
    """Every live particle of a (BY, BX, CAP) state as ``ncap`` 20-byte wire
    records in wire order, then the header ``[max_occupancy, total]``
    (exact whatever ``ncap``): int32 words, ``record_words(ncap)`` of them
    (read them with ``record_view``). A state on the card launches
    ``csrc/readback_pack.cu`` on the current stream, without a host sync;
    one on the CPU runs ``records_plain``."""
    if state.x.dim() != 3:
        raise ValueError(f"expected a (BY, BX, CAP) grid, got shape {tuple(state.x.shape)}")
    ncap = int(ncap)
    if ncap < 1 or record_words(ncap) >= 2**31:
        raise ValueError(f"ncap {ncap} outside [1, 2**31 / {RECORD_WORDS})")
    if not check_fields(state):
        return records_plain(state, ncap)
    from particle_simulator_tpu_torch.ops.build import library

    by, bx, cap = state.x.shape
    n_buckets = by * bx
    if state.capacity >= 2**31:
        raise ValueError(f"{state.capacity} slots exceed the int32 slot ids")
    with torch.cuda.device(state.x.device):
        tile = library().ps_readback_tile_buckets()
        n_tiles = -(-n_buckets // tile)
        out = torch.empty(record_words(ncap), dtype=torch.int32, device=state.x.device)
        scratch = torch.empty(n_buckets + 3 * n_tiles, dtype=torch.int32,
                              device=state.x.device)
        vec4 = cap % 4 == 0 and state.ty.data_ptr() % 16 == 0
        launch("ps_readback_pack", *(a.data_ptr() for a in state), scratch.data_ptr(),
               out.data_ptr(), n_buckets, cap, ncap, int(vec4))
    LAUNCHES["readback_pack"] += 1
    return out


def record_view(words: np.ndarray, ncap: int) -> tuple[int, int, np.ndarray]:
    """``(max_occupancy, total, records)`` of a record pack of ``ncap``
    records on the host (int32 words); ``records`` is a ``PARTICLE_DTYPE``
    view of the first ``min(total, ncap)`` records, sharing the words'
    memory."""
    ncap = int(ncap)
    mx, total = (int(v) for v in words[ncap * RECORD_WORDS: ncap * RECORD_WORDS + 2])
    records = words[: ncap * RECORD_WORDS].view(PARTICLE_DTYPE)
    return mx, total, records[: min(total, ncap)]
