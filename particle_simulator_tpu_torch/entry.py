"""Entry points of the port: the one-device frame check and the sharded dry run.

Counterpart of the repository's ``__graft_entry__.py``:

- ``entry(device)`` returns one frame of the flagship path (the
  MatrixBuckets frame runner ``run_frame_bucket_cuda``: 4 leapfrog steps
  with 3x3 neighbourhood Mie forces and the rebucket) plus its arguments;
  the kernels on a card, the plain versions on CPU tensors;
- ``dryrun_multichip(n, device)`` runs one full sharded frame (the halo
  kernels, the ring exchange and the migration of ``parallel/domain.py``)
  over an n-shard mesh of one device and holds it bit for bit against the
  one-device frame (the classic kernels). Rows are padded to the mesh, so
  any n works. On CPU tensors both frames take the plain versions.

Both run on the card unless the caller asks for the CPU, raise without a
card, and run in the calling process: no subprocess and no platform pinning
(those exist for JAX's TPU plugin).

    make torch-dryrun   # the CPU mesh
    python -c "from particle_simulator_tpu_torch.entry import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import numpy as np
import torch

STEPS = 4  # steps a frame of the tiny scene
GRID = (4, 4, 8)  # entry()'s GridConfig: 16 x 16 buckets, 8 slots: small but real


def tiny_scene(cfg, device="cpu"):
    """A 12 x 12 hex lattice at 1.1 r0 moving at (0, 30) m/s in the default
    box (rng seed 0), bucketized into ``cfg`` on ``device``: (state, params
    vector)."""
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.io.frame import Frame
    from particle_simulator_tpu_torch.io.presets import ParticleLattice
    from particle_simulator_tpu_torch.physics.bucket import bucketize_numpy

    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((12, 12), distance_factor=1.1, velocity=(0.0, 30.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(0))
    layout = bucketize_numpy(frame.particles, cfg)
    state = state_from_numpy(layout, cfg.capacity, device).reshape(cfg.grid_shape)
    return state, SimParams.from_record(meta.copy()).vector(device)


def entry(device="cuda"):
    """(fn, (state, params)): ``fn(state, params)`` runs one 4-step frame of
    the tiny scene on a 16 x 16 x 8 grid. Raises on ``cuda`` without a card."""
    from particle_simulator_tpu_torch.bench import torch_device
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    cfg = GridConfig(*GRID)
    state, params = tiny_scene(cfg, torch_device(device))

    def fn(state, params):
        return run_frame_bucket_cuda(state, params, STEPS, cfg.move_every)

    return fn, (state, params)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One full sharded frame of the tiny scene over an ``n_devices``-shard
    mesh whose shards all live on ``device`` (stacked into one block, the
    analog of XLA's virtual devices), on the smallest power-of-two grid with
    two bucket rows and columns a shard (at least 4 x 4), 4 slots a bucket,
    a rebucket every 2 steps; the gathered grid must equal the one-device
    frame's on every field and slot. Raises on a difference, and on
    ``cuda`` without a card."""
    from particle_simulator_tpu_torch.bench import torch_device
    from particle_simulator_tpu_torch.engine.state import ParticleState
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
    from particle_simulator_tpu_torch.parallel.domain import (
        gather_state,
        make_mesh,
        make_sharded_frame_fn,
        pad_rows_for_mesh,
        shard_state,
    )
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    dev = torch_device(device)
    mesh = make_mesh(devices=[dev] * n_devices)
    ny, nx = mesh.shape
    by_log2 = max(2, int(np.ceil(np.log2(ny))) + 1)
    bx_log2 = max(2, int(np.ceil(np.log2(nx))) + 1)
    cfg = GridConfig(bx_log2, by_log2, 4, move_every=2)

    state, params = tiny_scene(cfg, dev)
    padded, rows = pad_rows_for_mesh(state, mesh)
    blocks = shard_state(padded, mesh)
    pv = tuple(params for _ in mesh.blocks)
    out = make_sharded_frame_fn(cfg, mesh)(blocks, pv, STEPS)
    got = ParticleState(*(a[:rows] for a in gather_state(out, mesh)))
    ref = run_frame_bucket_cuda(state, params, STEPS, cfg.move_every)
    for name, a, b in zip(ParticleState._fields, got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"dryrun_multichip({n_devices}): field {name} differs from "
                                 f"the one-device frame at {int((a != b).sum())} slots")
