"""Faults planted in the port, for the tests that show ``correct`` fails.

A process of a run (the harness, the daemon's launcher, a rank) calls
``apply`` with the name in ``PSBENCH_FAULT`` when that is set; the
benchmark's own runs never set it. Each fault breaks the timed path
underneath the harness:

- ``step_identity``: every step returns its state unchanged;
- ``half_batch``: every step leaves the upper half of the bucket rows (of a
  flat CompactArray state: of its live slots) unstepped;
- ``no_exchange``: the ring exchange between shards moves nothing;
- ``altered_answer``: one particle's velocity is altered where the frame
  is produced (the daemon's readback, the frame runners' output).

The step faults reach every step the served and the frames paths take: the
classic step (``bucket_step_cuda``), the live-tile and every-tile step of
the ext-layout frame (``_launch_ext``, under ``bucket_step_ext_cuda`` and
the frame's own loop), the halo step and the all-pairs step
(``allpairs_step_cuda``).
"""

from __future__ import annotations

import os

import torch

ENV = "PSBENCH_FAULT"
NAMES = ("step_identity", "half_batch", "no_exchange", "altered_answer")


def _alter(state):
    """The state with the velocity of its first live slot changed."""
    vx = state.vx.clone()
    first = torch.nonzero(state.ty.reshape(-1) >= 0)[0]
    vx.view(-1)[first] += 1.0
    return state._replace(vx=vx)


def _half(new, old):
    """``new`` with the upper half of its bucket rows, or of a flat state's
    live slots, put back to ``old``'s."""
    fields = []
    if new.x.dim() == 1:
        live = torch.nonzero(old.ty >= 0).reshape(-1)
        upper = live[len(live) // 2:]
    for a, b in zip(new, old):
        a = a.clone()
        if a.dim() == 1:
            a[upper] = b[upper]
        else:
            half = a.shape[-3] // 2
            a[..., half:, :, :] = b[..., half:, :, :]
        fields.append(a)
    return type(new)(*fields)


def apply(name: str | None = None) -> list:
    """Plant the fault ``name`` (default: ``PSBENCH_FAULT``'s); returns what
    ``undo`` puts back."""
    name = os.environ.get(ENV) if name is None else name
    if not name:
        return []
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    from particle_simulator_tpu_torch.engine import simulator
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda
    from particle_simulator_tpu_torch.parallel import domain

    saved = [(m, a, getattr(m, a)) for m, a in (
        (bucket_cuda, "bucket_step_cuda"), (bucket_cuda, "_launch_ext"),
        (allpairs_cuda, "allpairs_step_cuda"), (bucket_cuda, "run_frame_bucket_cuda"),
        (domain, "bucket_step_halo_cuda"), (domain, "refresh_ring"),
        (domain, "make_sharded_frame_fn"), (simulator.Simulator, "read_frame"))]
    if name in ("step_identity", "half_batch"):
        def broken(fn):
            def run(state, params):
                return state if name == "step_identity" else _half(fn(state, params), state)
            return run

        def broken_ext(fn):
            def run(pair, aux, compact):
                if name == "step_identity":
                    return pair
                out = fn(pair, aux, compact)
                return out._replace(cur=_half(out.cur, pair.cur))
            return run

        bucket_cuda.bucket_step_cuda = broken(bucket_cuda.bucket_step_cuda)
        bucket_cuda._launch_ext = broken_ext(bucket_cuda._launch_ext)
        allpairs_cuda.allpairs_step_cuda = broken(allpairs_cuda.allpairs_step_cuda)
        domain.bucket_step_halo_cuda = broken(domain.bucket_step_halo_cuda)
    elif name == "no_exchange":
        domain.refresh_ring = lambda padded, plan, fields=None: None
    else:
        read, frame = simulator.Simulator.read_frame, bucket_cuda.run_frame_bucket_cuda
        make = domain.make_sharded_frame_fn

        def read_frame(self, *args, **kwargs):
            out = read(self, *args, **kwargs)
            if out.particle_count:
                out.particles["vx"][0] += 1.0
            return out

        def make_sharded(*args, **kwargs):
            fn = make(*args, **kwargs)
            return lambda blocks, params, steps: tuple(
                _alter(b) if i == 0 else b for i, b in enumerate(fn(blocks, params, steps)))

        simulator.Simulator.read_frame = read_frame
        bucket_cuda.run_frame_bucket_cuda = lambda *a, **k: _alter(frame(*a, **k))
        domain.make_sharded_frame_fn = make_sharded
    return saved


def undo(saved: list) -> None:
    for module, attr, old in saved:
        setattr(module, attr, old)
