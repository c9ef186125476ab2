"""The port's sharded MatrixBuckets path on CPU meshes against its own
single-device path and against the JAX package's ``parallel/domain.py``
(on the 8 virtual CPU devices of ``tests/conftest.py``).

Contract:
- ``factor_mesh``, the halo exchange, the halo dest ids and the halo move:
  bit-identical to JAX;
- the sharded frame: bit-identical to the port's single-device
  ``run_frame_bucket`` (every receiver sees the same candidates in the same
  order); against JAX ``make_sharded_frame_fn``, ``tests/test_parallel.py``'s
  envelope (``ty`` equal, x/y within 8 fixed-point units, v within rtol
  1e-3, atol 0.05: XLA sums the pair terms in another order).

Meshes of ``"cpu"`` entries stack every shard into one block; meshes of
``torch.device("cpu", i)`` entries put each shard in a block of its own,
which drives the exchange between blocks that four cards use.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from particle_simulator_tpu.engine.simulator import Simulator as JSimulator
from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.ops.bucket_pallas import move_dest_pallas_halo
from particle_simulator_tpu.parallel import domain as jdomain
from particle_simulator_tpu.physics import bucket as jbucket
from particle_simulator_tpu_torch.engine import daemon
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import ParticleState, from_reference
from particle_simulator_tpu_torch.io.frame import (
    PARTICLE_DTYPE,
    DataStructure,
    Device,
    Frame,
    MieParams,
)
from particle_simulator_tpu_torch.io.presets import ParticleLattice
from particle_simulator_tpu_torch.ops import bucket_cuda
from particle_simulator_tpu_torch.parallel import domain
from particle_simulator_tpu_torch.physics import bucket

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = bucket.GridConfig(4, 4, 4, move_every=4)  # 16 x 16 buckets x 4 slots


def cpu_mesh(n: int, blocks: bool = False) -> domain.DeviceMesh:
    """``n`` shards on the CPU: one block, or one block per shard."""
    devices = [torch.device("cpu", i) for i in range(n)] if blocks else ["cpu"] * n
    return domain.make_mesh(devices=devices)


def scene_grid(cfg=CFG, n=14, vel=(0.0, 80.0), seed=3):
    """``tests/test_parallel.py:scene_grid`` through the port's codec: an
    n x n hex lattice at 1.1 r0 in the middle of the default box, bucketized
    onto ``cfg``. Returns the five numpy fields in grid shape and the
    metadata record."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((n, n), distance_factor=1.1, velocity=vel)
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(seed))
    layout = bucket.bucketize_numpy(frame.particles, cfg)
    assert layout.tobytes() == jbucket.bucketize_numpy(
        frame.particles, jbucket.GridConfig(*cfg)).tobytes()
    return tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names), meta.copy()


def box_lattice(cfg=CFG, n=24, seed=4):
    """A hex lattice at 1.1 r0 filling 80% of a box sized to it (2-3
    particles a bucket on ``CFG``), thermal velocities of ~150 m/s per
    axis, dt = 10 fs: particles cross bucket and shard edges everywhere."""
    rng = np.random.default_rng(seed)
    frame = Frame.new()
    meta = frame.metadata
    box = n * MieParams.nitrogen().force0_r() * 1.1 / 0.8
    meta.box_width = box
    meta.box_height = box
    meta.step_dt = 1e-14
    lat = ParticleLattice((n, n), distance_factor=1.1, velocity=(0.0, 0.0))
    lat.hex_square(frame, (box / 2, box / 2), rng=rng)
    parts = frame.particles.copy()
    parts["vx"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    parts["vy"] = rng.normal(0, 150, len(parts)).astype(np.float32)
    layout = bucket.bucketize_numpy(parts, cfg)
    return tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names), meta.copy()


def drift_scene(cfg, density, drift, seed):
    """Buckets filled to a random slot prefix, each particle up to ``drift``
    bucket widths from its bucket: crossers, far drifters (dropped) and,
    when dense, overflow (dropped)."""
    rng = np.random.default_rng(seed)
    by, bx, cap = cfg.grid_shape
    occ = np.arange(cap) < rng.binomial(cap, density, (by, bx))[..., None]

    def coord(n_log2, index):
        pos = (index + rng.uniform(-drift, 1 + drift, cfg.grid_shape)) * 2.0 ** (32 - n_log2)
        return (np.floor(pos).astype(np.int64) % 2**32).astype(np.uint32)

    x = coord(cfg.bx_log2, np.arange(bx)[None, :, None])
    y = coord(cfg.by_log2, np.arange(by)[:, None, None])
    return (
        np.where(occ, x, 0).astype(np.uint32),
        np.where(occ, y, 0).astype(np.uint32),
        np.where(occ, rng.normal(size=cfg.grid_shape), 0).astype(np.float32),
        np.where(occ, rng.normal(size=cfg.grid_shape), 0).astype(np.float32),
        np.where(occ, rng.integers(0, 2, cfg.grid_shape), -1).astype(np.int32),
    )


def _jstate(fields):
    return JState(*(jnp.asarray(a) for a in fields))


def _np(state):
    return [np.asarray(a) for a in state]


def from_reference_inverse(state):
    """Port state -> numpy fields with uint32 positions."""
    x, y, vx, vy, ty = (a.numpy() for a in state)
    return x.view(np.uint32), y.view(np.uint32), vx, vy, ty


def join_blocks(padded, mesh):
    """Padded blocks -> the (ny*(LY+2), nx*(LX+2), CAP) layout of a JAX
    ``shard_map`` over the padded shards."""
    ny, nx = mesh.shape
    py, px, cap = padded[0].x.shape[-3:]
    order = np.argsort([s for _, ids in mesh.blocks for s in ids])
    out = []
    for f in range(5):
        shards = torch.cat([b[f] for b in padded])[torch.as_tensor(order)]
        out.append(shards.reshape(ny, nx, py, px, cap).transpose(1, 2)
                   .reshape(ny * py, nx * px, cap))
    return from_reference_inverse(ParticleState(*out))


def test_factor_mesh_matches_jax():
    for n in range(1, 20):
        assert domain.factor_mesh(n) == jdomain.factor_mesh(n), n
    assert cpu_mesh(8).shape == (4, 2) and cpu_mesh(3).shape == (3, 1)
    assert len(cpu_mesh(8).blocks) == 1 and len(cpu_mesh(8, blocks=True).blocks) == 8


@pytest.mark.parametrize("blocks", [False, True], ids=["one-block", "eight-blocks"])
def test_exchange_halo_bit_identical_to_jax(blocks):
    """The (4, 2) mesh's padded shards equal JAX ``exchange_halo`` under
    ``shard_map``, bit for bit: interiors, edges, the corners that JAX's
    two-phase exchange carries from the diagonal shard, and the tombstone
    ring where the mesh ends."""
    fields, _ = scene_grid(n=12, vel=(0.0, 80.0))
    mesh = cpu_mesh(8, blocks)
    state, _ = from_reference(fields, scene_grid()[1])
    got = join_blocks(domain.exchange_halo(domain.shard_state(state, mesh), mesh), mesh)

    jmesh = jdomain.make_mesh(n_devices=8)
    ny, nx = jmesh.devices.shape
    spec = JState(*([P("dy", "dx", None)] * 5))
    f = shard_map(lambda s: jdomain.exchange_halo(s, ny, nx), mesh=jmesh,
                  in_specs=(spec,), out_specs=spec)
    ref = _np(f(jdomain.shard_state(_jstate(fields), jmesh)))
    for name, a, b in zip(PARTICLE_DTYPE.names, ref, got):
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (got[4][0] == -1).all() and (got[4][:, -1] == -1).all()  # mesh edge: tombstones
    assert (got[4] >= 0).sum() > (fields[4] >= 0).sum()  # the rings hold live neighbours


DEST_CASES = {
    "drift": lambda: drift_scene(CFG, 0.6, 1.4, seed=10),
    "overflow": lambda: drift_scene(CFG, 0.95, 0.8, seed=11),
    "lattice": lambda: scene_grid(n=14)[0],
}


@pytest.mark.parametrize("case", sorted(DEST_CASES))
def test_halo_dest_and_move_bit_identical_to_jax(case):
    """On every shard of a (3, 2) mesh (tombstone pad rows): the halo dest ids equal JAX
    ``move_ranks_direct_halo`` composed in the interior numbering, and the
    Pallas ``move_dest_pallas_halo`` (interpret mode) after its padded lane
    numbering is mapped to the interior; the halo move equals JAX
    ``bucket_move_direct_halo``. The wrappers route CPU tensors to the plain
    versions."""
    fields = DEST_CASES[case]()
    state, _ = from_reference(fields, scene_grid()[1])
    mesh = cpu_mesh(6)  # 3 x 2: rows padded from 16 to 18
    (padded,) = domain.exchange_halo(
        domain.shard_state(domain.pad_rows_for_mesh(state, mesh)[0], mesh), mesh)
    (offsets,) = domain.ring_plan(mesh, padded.x.shape[1] - 2, padded.x.shape[2] - 2).offsets
    before = dict(bucket_cuda.LAUNCHES)
    destid = bucket_cuda.move_dest_halo_cuda(padded, CFG.bx_log2, CFG.by_log2, offsets)
    moved = bucket_cuda.bucket_move_halo_cuda(padded, CFG.bx_log2, CFG.by_log2, offsets)
    assert bucket_cuda.LAUNCHES == before
    _, py, px, cap = padded.x.shape
    ly, lx = py - 2, px - 2
    dropped = 0
    for s in range(6):
        shard = from_reference_inverse(ParticleState(*(a[s] for a in padded)))
        js = _jstate(shard)
        row_off, col_off = (int(v) for v in offsets[s])
        tgt_by, tgt_bx, rank, keep = jbucket.move_ranks_direct_halo(
            js, CFG.bx_log2, CFG.by_log2, row_off, col_off)
        ref = np.where(np.asarray(keep), np.asarray((tgt_by * lx + tgt_bx) * cap + rank), -1)
        np.testing.assert_array_equal(destid[s].numpy(), ref, err_msg=f"shard {s}")
        if s in (0, 3):  # a corner shard and a middle-row shard
            pid = np.asarray(move_dest_pallas_halo(
                js, CFG.bx_log2, CFG.by_log2, row_off, col_off, interpret=True)).reshape(py, px, cap)
            b, r = pid // cap, pid % cap
            mapped = np.where(pid >= 0, ((b // px) * lx + b % px - 1) * cap + r, -1)
            np.testing.assert_array_equal(destid[s].numpy(), mapped, err_msg=f"pallas {s}")
        jmoved = _np(jbucket.bucket_move_direct_halo(js, CFG.bx_log2, CFG.by_log2,
                                                     row_off, col_off))
        got = from_reference_inverse(ParticleState(*(a[s] for a in moved)))
        for name, a, b in zip(PARTICLE_DTYPE.names, jmoved, got):
            np.testing.assert_array_equal(b, a, err_msg=f"shard {s} field {name}")
        interior_live = (shard[4][1:-1, 1:-1] >= 0).sum()
        dropped += interior_live - (destid[s].numpy()[1:-1, 1:-1] >= 0).sum()
    if case != "lattice":  # a freshly bucketized lattice has no crossers
        ring = destid.clone()
        ring[:, 1:-1, 1:-1] = -1
        assert (ring >= 0).any()  # ring particles migrate in
        assert dropped > 0  # the stress scenes really drop particles


def _single_frames(state, pv, frames, steps=10):
    for _ in range(frames):
        state = bucket.run_frame_bucket(state, pv, steps, CFG.move_every)
    return state


def _sharded_frames(state, pv, mesh, frames, steps=10):
    padded, rows = domain.pad_rows_for_mesh(state, mesh)
    blocks = domain.shard_state(padded, mesh)
    fn = domain.make_sharded_frame_fn(CFG, mesh)
    for _ in range(frames):
        blocks = fn(blocks, [pv] * len(mesh.blocks), steps)
    out = domain.gather_state(blocks, mesh)
    return ParticleState(*(a[:rows] for a in out))


def _jax_sharded_frames(fields, meta, n, frames, kernel, steps=10):
    jp = JSimParams.from_record(meta)._replace(steps_per_frame=np.int32(steps))
    jmesh = jdomain.make_mesh(n_devices=n)
    js, rows = jdomain.pad_rows_for_mesh(_jstate(fields), jmesh)
    fn = jdomain.make_sharded_frame_fn(jbucket.GridConfig(*CFG), jmesh, donate=False,
                                       kernel=kernel)
    js = jdomain.shard_state(js, jmesh)
    for _ in range(frames):
        js = fn(js, jp)
    return [a[:rows] for a in _np(js)]


def assert_parallel_envelope(ref, got):
    """tests/test_parallel.py's sharded-frame envelope."""
    np.testing.assert_array_equal(got[4], ref[4])
    for i in (0, 1):
        np.testing.assert_allclose(got[i].astype(np.int64), ref[i].astype(np.int64),
                                   rtol=0, atol=8)
    for i in (2, 3):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-3, atol=0.05)


SCENES = {"test_parallel": lambda: scene_grid(n=14, vel=(0.0, 80.0)), "box": box_lattice}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("n, blocks", [(2, False), (3, False), (4, False), (4, True)],
                         ids=["2", "3-padded-rows", "4", "4-blocks"])
def test_sharded_frame_matches_single_device_and_jax(n, blocks, scene):
    """Three 10-step frames (rebucket every 4 steps) on an n-shard CPU mesh:
    bit-identical to the port's single-device frames on every slot, and
    inside the envelope of JAX ``make_sharded_frame_fn(kernel="jnp")``."""
    fields, meta = SCENES[scene]()
    state, params = from_reference(fields, meta)
    pv = params.vector()
    single = _single_frames(state, pv, 3)
    got = _sharded_frames(state, pv, cpu_mesh(n, blocks), 3)
    for name, a, b in zip(ParticleState._fields, single, got):
        assert torch.equal(a, b), name
    # particles changed buckets across the frames: the moves did work
    assert not torch.equal((single.ty >= 0).sum(-1), (state.ty >= 0).sum(-1))
    assert_parallel_envelope(_jax_sharded_frames(fields, meta, n, 3, "jnp"),
                             from_reference_inverse(got))


def test_sharded_frame_matches_jax_pallas():
    """One 10-step frame on a (2, 2) mesh against the JAX sharded runner with
    the Pallas step and halo move (interpret mode, default ``refs``
    halo-column refresh)."""
    fields, meta = scene_grid(n=14, vel=(0.0, 80.0))
    state, params = from_reference(fields, meta)
    got = _sharded_frames(state, params.vector(), cpu_mesh(4), 1)
    assert_parallel_envelope(_jax_sharded_frames(fields, meta, 4, 1, "pallas"),
                             from_reference_inverse(got))


@pytest.mark.parametrize("blocks", [False, True], ids=["one-block", "eight-blocks"])
def test_sharded_migration_across_boundary(blocks):
    """``tests/test_parallel.py:test_sharded_migration_across_boundary``: one
    particle crossing the x shard edge of a (4, 2) mesh, with a vy the ring's
    velocity refresh must carry to the new owner. Bit-identical to the
    single-device frame; within test_parallel's envelope of JAX."""
    cfg = bucket.GridConfig(4, 4, 4, move_every=2)
    frame = Frame.new()
    meta = frame.metadata
    bw = meta.box_width
    v = 0.125 * bw / (np.float32(meta.step_dt) * 8)  # 2 buckets over 8 steps
    frame.push(meta.new_particle((bw * 0.49, bw * 0.5), (float(v), float(v) / 3)))
    layout = bucket.bucketize_numpy(frame.particles, cfg)
    fields = tuple(layout[f].reshape(cfg.grid_shape) for f in PARTICLE_DTYPE.names)
    state, params = from_reference(fields, meta.copy())
    pv = params.vector()
    single = bucket.run_frame_bucket(state, pv, 8, cfg.move_every)
    mesh = cpu_mesh(8, blocks)
    fn = domain.make_sharded_frame_fn(cfg, mesh)
    blocks_ = fn(domain.shard_state(state, mesh), [pv] * len(mesh.blocks), 8)
    got = domain.gather_state(blocks_, mesh)
    for name, a, b in zip(ParticleState._fields, single, got):
        assert torch.equal(a, b), name
    live = got.ty.reshape(-1) >= 0
    assert int(live.sum()) == 1
    assert got.x.reshape(-1)[live].view(torch.int32).numpy().view(np.uint32)[0] > 0.55 * 2**32

    jp = JSimParams.from_record(meta.copy())._replace(steps_per_frame=np.int32(8))
    jmesh = jdomain.make_mesh(n_devices=8)
    jfn = jdomain.make_sharded_frame_fn(jbucket.GridConfig(*cfg), jmesh, donate=False)
    ref = _np(jfn(jdomain.shard_state(_jstate(fields), jmesh), jp))
    got = from_reference_inverse(got)
    np.testing.assert_array_equal(got[4], ref[4])
    m = ref[4] >= 0
    for i in (0, 1):
        np.testing.assert_allclose(got[i][m].astype(np.int64), ref[i][m].astype(np.int64),
                                   rtol=0, atol=16)
    for i in (2, 3):
        np.testing.assert_allclose(got[i][m], ref[i][m], rtol=1e-4, atol=0)


def _lattice_frame(n=8, steps=5, **meta):
    """``tests/test_daemon.py:scene_frame``: a sparse lattice (spacing 4 r0)."""
    frame = Frame.new()
    m = frame.metadata
    lat = ParticleLattice((n, n), distance_factor=4.0, velocity=(0.0, 10.0))
    lat.hex_square(frame, (m.box_width / 2, m.box_height / 2), rng=np.random.default_rng(0))
    m.steps_per_frame = steps
    for name, value in meta.items():
        setattr(m, name, value)
    return frame


@pytest.mark.parametrize("dev", list(Device), ids=lambda d: d.name)
def test_simulator_mesh_matches_jax_and_single_device(dev):
    """``Simulator(device="cpu", mesh=...)`` on an odd mesh (3 shards, pad
    rows) for every device request: the echo (scene and device field) is
    the JAX mesh Simulator's, byte for byte; the scene runs sharded
    whatever the request; frames are the unsharded Simulator's, byte for
    byte, and within the frame envelope of the JAX mesh Simulator's."""
    scene = _lattice_frame(n=10, steps=6, device=dev)
    sims = [Simulator(bucket.GridConfig(4, 4, 8), device="cpu", mesh=cpu_mesh(3)),
            Simulator(bucket.GridConfig(4, 4, 8), device="cpu")]
    jsim = JSimulator(jbucket.GridConfig(4, 4, 8), mesh=jdomain.make_mesh(n_devices=3))
    for sim in (*sims, jsim):
        sim.load_frame(scene)
    sharded, single = sims
    assert sharded.sharded and sharded.active_device == jsim.active_device
    assert sharded.read_frame().bytes == jsim.read_frame().bytes == single.read_frame().bytes
    for _ in range(2):
        for sim in (*sims, jsim):
            sim.frame_async()
        got, ref = sharded.read_frame(), jsim.read_frame()
        assert got.bytes == single.read_frame().bytes
        assert got.bytes[:96] == ref.bytes[:96]
        g, r = got.particles, ref.particles
        np.testing.assert_array_equal(g["ty"], r["ty"])
        for name in ("x", "y"):
            np.testing.assert_allclose(g[name].astype(np.int64), r[name].astype(np.int64),
                                       rtol=0, atol=16)
        for name in ("vx", "vy"):
            np.testing.assert_allclose(g[name], r[name], rtol=1e-3, atol=0.05)
    assert sharded.active_kernel == "sharded-torch-cpu"
    assert sharded.live_count == scene.particle_count


def test_simulator_mesh_compact_array_runs_unsharded():
    scene = _lattice_frame(n=6, steps=2, data_structure=DataStructure.COMPACT_ARRAY)
    sim = Simulator(bucket.GridConfig(4, 4, 8), device="cpu", mesh=cpu_mesh(4))
    sim.load_frame(scene)
    sim.frame_async()
    assert not sim.sharded and sim.active_kernel == "allpairs-torch-cpu"
    # a live switch to MatrixBuckets shards it
    edit = Frame.new()
    edit.header["metadata"] = scene.metadata.copy()
    edit.metadata.data_structure = DataStructure.MATRIX_BUCKETS
    sim.update_metadata(edit)
    sim.frame_async()
    assert sim.sharded and sim.active_kernel == "sharded-torch-cpu"
    assert sim.live_count == scene.particle_count


@pytest.mark.parametrize("n", [8, 3])
def test_daemon_mesh_serves_headless_editor(n):
    """``serve`` with a sharded CPU Simulator against the unchanged headless
    editor (``tests/test_daemon.py:198`` and ``:294``): every frame arrives
    with every particle, finite, and the particles move."""
    shipped = []
    connect = daemon.Frontend.connect_tcp

    class Capture(daemon.Frontend):
        def write(self, frame):
            shipped.append(frame.bytes)
            super().write(frame)

    def connect_capture(addr, retry_s=0.0, native=False):
        inner = connect(addr, retry_s=retry_s, native=native)
        return Capture(inner.reader, inner.writer, verbose=False)

    port = _free_port()
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--lattice", "10x10", "--frames", "5",
         "--steps-per-frame", "5", "--timeout", "120"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(daemon.Frontend, "connect_tcp", staticmethod(connect_capture))
            sim = Simulator(bucket.GridConfig(4, 4, 8), device="cpu", mesh=cpu_mesh(n))
            served = daemon.serve(("127.0.0.1", port), sim, max_frames=5, retry_s=60.0)
        out, err = editor.communicate(timeout=120)
    finally:
        if editor.poll() is None:
            editor.kill()
            editor.wait()
    assert editor.returncode == 0, err[-2000:]
    assert served == 5 and sim.active_kernel == "sharded-torch-cpu"
    frames = [Frame.from_bytes(b) for b in shipped]
    assert all(f.particle_count == 100 for f in frames)
    assert all(np.isfinite(f.particles["vx"]).all() for f in frames)
    assert not np.array_equal(frames[0].particles["y"], frames[-1].particles["y"])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_never_shrinks_and_validates():
    with pytest.raises(RuntimeError, match="a mesh of 4 devices"):
        domain.make_mesh(devices=["cpu"] * 2, n_devices=4)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            daemon.make_simulator("2")
    assert domain.make_mesh(devices=["cpu"] * 6, n_devices=4).shape == (2, 2)
    with pytest.raises(ValueError):  # 18 rows over a 4 x 2 mesh
        domain.shard_state(bucket.pad_tombstone_halo(from_reference(
            drift_scene(CFG, 0.5, 0.5, 1), scene_grid()[1])[0]), cpu_mesh(8))
    with pytest.raises(ValueError):  # a CPU Simulator cannot run on a CUDA mesh
        Simulator(device="cpu", mesh=domain.DeviceMesh([["cuda:0", "cuda:0"]]))
    padded = bucket.pad_tombstone_halo(from_reference(
        drift_scene(CFG, 0.5, 0.5, 2), scene_grid()[1])[0])
    with pytest.raises(ValueError):  # offsets must match the stack of shards
        bucket_cuda.move_dest_halo_cuda(padded, 4, 4, torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        bucket_cuda.bucket_step_halo_cuda(padded.to("meta"), torch.zeros(10, device="meta"))
