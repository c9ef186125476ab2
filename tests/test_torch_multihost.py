"""The port's multi-process path (``parallel/multihost.py``, the cross-process
ring of ``parallel/domain.py``, the daemon's ``DistributedFrontend``) on the
CPU, over gloo.

Contract:
- the single-process helpers behave as the JAX package's do without the
  ``PS_TPU_*`` variables; the backend follows from the cards every rank
  names (on one host or several), and NCCL that is needed and missing
  raises;
- the cross-process ring, delivered message by message in one process,
  fills every ring exactly as the single-process exchange does, bits of
  f32 fields included;
- 2 (and 4) processes over ``torch.device("cpu", rank)`` blocks, three
  frames of a scene with crossers on both axes, on the (2, 1), (2, 2) and
  4-process (2, 2) global meshes: rank 0's gathered grid is bit-identical
  to the port's one-device ``run_frame_bucket`` and inside
  ``tests/multihost_child.py``'s envelope of JAX ``run_frame_bucket`` (``ty``
  equal, x/y within 8 fixed-point units, v within rtol 1e-3, atol 0.05);
- two daemon processes serve the unchanged headless editor end to end
  (``tests/test_parallel.py:test_multihost_daemon_editor_end_to_end``'s
  analog), coerce a CompactArray scene to MatrixBuckets and echo it, and
  both stop when process 0 cannot reach the editor.

The file is its own child: ``python tests/test_torch_multihost.py frame
<rank> <workdir> <shards>`` runs one process of the sharded frame (the
``PS_TPU_*`` variables name the group). Children import neither jax nor
the JAX package (each checks); the parent computes the JAX reference.
Every child runs under a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.parallel import domain, multihost
from particle_simulator_tpu_torch.physics import bucket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ParticleState._fields
FRAMES, STEPS = 3, 10
CHILD_TIMEOUT_S = 90


# ---------------------------------------------------------------------------
# the child: one process of the sharded frame
# ---------------------------------------------------------------------------

def child_frame(rank: int, workdir: str, n_shards: int) -> int:
    """Three frames of the parent's scene on the global mesh of
    ``n_shards`` shards; rank 0 writes the gathered grid to
    ``workdir/got.npz``. Prints one JSON line."""
    from particle_simulator_tpu_torch.ops import bucket_cuda

    assert multihost.init_distributed("cpu")
    scene = np.load(os.path.join(workdir, "scene.npz"))
    cfg = bucket.GridConfig(*(int(v) for v in scene["cfg"]))
    state = ParticleState(*(torch.from_numpy(scene[f]) for f in FIELDS))
    pv = torch.from_numpy(scene["params"])
    mesh = multihost.global_mesh(n_shards, "cpu")
    padded, rows = domain.pad_rows_for_mesh(state, mesh)
    blocks = multihost.shard_state_global(padded, mesh)
    fn = domain.make_sharded_frame_fn(cfg, mesh)
    for _ in range(FRAMES):
        blocks = fn(blocks, [pv] * len(mesh.blocks), STEPS)
    live = multihost.all_sum(sum(int((b.ty >= 0).sum()) for b in blocks), torch.device("cpu"))
    got = multihost.gather_global(blocks, mesh)
    if rank == 0:
        np.savez(os.path.join(workdir, "got.npz"),
                 **{f: a[:rows].numpy() for f, a in zip(FIELDS, got)})
    else:
        assert got is None
    foreign = multihost.foreign_modules()
    print(json.dumps({"rank": rank, "mesh": list(mesh.shape), "blocks": len(mesh.blocks),
                      "backend": torch.distributed.get_backend(), "live": live,
                      "exchange": domain.EXCHANGE, "launches": bucket_cuda.LAUNCHES,
                      "foreign_modules": foreign}), flush=True)
    torch.distributed.destroy_process_group()
    return 1 if foreign else 0


# ---------------------------------------------------------------------------
# helpers of the parent
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_env(tmp_path, world: int, rank: int) -> dict:
    """A child's environment: the coordinator is a file store in
    ``tmp_path`` (no port to race for under xdist), two threads a process."""
    env = dict(os.environ)
    env.update(PS_TPU_COORDINATOR=f"file://{tmp_path}/store", PS_TPU_NUM_PROCESSES=str(world),
               PS_TPU_PROCESS_ID=str(rank), OMP_NUM_THREADS="2", PYTHONPATH=REPO,
               PYTHON=sys.executable)
    return env


def finish(procs, timeout=CHILD_TIMEOUT_S):
    """(rc, stdout, stderr) of every process; kills all and fails when one
    outlives ``timeout``."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a multi-process child timed out")
        outs.append((p.returncode, out, err))
    return outs


def rank_stats(err: str) -> dict:
    """The daemon's ``engine: rank stats`` line."""
    lines = [ln for ln in err.splitlines() if ln.startswith("engine: rank stats ")]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0][len("engine: rank stats "):])


def daemons(tmp_path, addr: str, *extra: str, world: int = 2):
    return [subprocess.Popen(
        ["bash", os.path.join(REPO, "scripts", "torch_launch_multihost.sh"),
         f"file://{tmp_path}/store", str(world), str(i), "--torch-device", "cpu",
         "--addr", addr, *extra],
        env=dist_env(tmp_path, world, i), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(world)]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_multihost_helpers_single_process(monkeypatch):
    """``tests/test_parallel.py:test_multihost_helpers_single_process``: no
    ``PS_TPU_*`` variables -> no group, this process owns the editor link,
    and the global mesh is ``make_mesh``'s."""
    for var in ("PS_TPU_COORDINATOR", "PS_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_frame_owner() and multihost.process_count() == 1
    cpu0 = torch.device("cpu", 0)
    assert multihost.global_mesh(device_type="cpu") == domain.make_mesh(devices=[cpu0])
    mesh = multihost.global_mesh(4, "cpu")
    assert mesh == domain.make_mesh(devices=[cpu0] * 4) and mesh.shape == (2, 2)
    assert not mesh.multi_process and len(mesh.blocks) == 1
    assert multihost.process_device("cpu") == cpu0
    assert multihost.foreign_modules()  # this process imported jax (conftest)


@pytest.mark.parametrize("case, want", [
    (("cpu", ["", ""], False), ("gloo", False)),
    (("cuda", ["GPU-a", "GPU-a"], False), ("gloo", True)),  # two processes share one card
    (("cuda", ["GPU-a", "GPU-b", "GPU-a", "GPU-b"], True), ("gloo", True)),
    (("cuda", ["GPU-a", "GPU-b"], True), ("nccl", False)),  # a card each on one host
    (("cuda", ["GPU-host0-card0", "GPU-host1-card0"], True), ("nccl", False)),  # a host each
    (("cuda", ["GPU-a", "GPU-b"], False), RuntimeError),  # NCCL needed and missing
    (("cuda", ["GPU-a"] * 3 + ["GPU-b"], True), ("gloo", True)),  # one card shared of two
    (("mps", ["x"], True), ValueError),
], ids=["cpu", "shared-card", "shared-cards", "card-each", "host-each", "no-nccl",
        "partly-shared", "other-device"])
def test_pick_backend(case, want):
    if isinstance(want, type):
        with pytest.raises(want):
            multihost.pick_backend(*case)
    else:
        assert multihost.pick_backend(*case) == want


@pytest.mark.parametrize("cards, want", [
    (["GPU-host0-card0", "GPU-host1-card0"], ("nccl", 0)),
    (["GPU-one", "GPU-one"], ("gloo", 0)),
], ids=["two-hosts-a-card-each", "two-processes-one-card"])
def test_init_distributed_picks_the_backend_from_every_rank_card(tmp_path, monkeypatch,
                                                                 cards, want):
    """Rank 0 of two on the CUDA path, without ``LOCAL_RANK`` or
    ``LOCAL_WORLD_SIZE``: each host sees one card (index 0), and the backend
    follows from the cards both ranks name through the rendezvous store
    (rank 1's name is put there beforehand), not from the process count."""
    store = tmp_path / "store"
    monkeypatch.setenv("PS_TPU_COORDINATOR", f"file://{store}")
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PS_TPU_PROCESS_ID", "0")
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    seen = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen.setdefault("card", i))
    monkeypatch.setattr(multihost, "card_identity", lambda i: cards[0])
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(multihost, "barrier", lambda dev: None)
    torch.distributed.FileStore(str(store), 2).set("ps_tpu_card/1", cards[1])
    assert multihost.init_distributed("cuda")
    assert (seen["backend"], seen["card"]) == want
    assert (seen["rank"], seen["world_size"]) == (0, 2)


def test_init_distributed_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setenv("PS_TPU_COORDINATOR", "127.0.0.1:9")
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PS_TPU_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device_count"):
        multihost.init_distributed("cuda")


def test_mesh_owners_validate_and_keep_the_single_process_mesh():
    devs = [["cpu", "cpu"], ["cpu", "cpu"]]
    one = domain.DeviceMesh(devs)
    assert one == domain.make_mesh(devices=["cpu"] * 4) and one.owners == ((0, 0), (0, 0))
    assert one.blocks == ((torch.device("cpu"), (0, 1, 2, 3)),) and not one.multi_process
    two = domain.DeviceMesh(devs, [[0, 0], [1, 1]], rank=1)
    assert two.multi_process and two.blocks == ((torch.device("cpu"), (2, 3)),)
    assert [o for o, _, _ in two.all_blocks] == [0, 1]
    assert two != domain.DeviceMesh(devs, [[0, 0], [1, 1]], rank=0)
    with pytest.raises(ValueError):
        domain.DeviceMesh(devs, [[0, 1]])
    with pytest.raises(ValueError):
        domain.DeviceMesh(devs, [[0, 0], [1, 1]], rank=2)


def as_state(fields) -> ParticleState:
    """Numpy fields (x, y as uint32) -> a port state on the CPU."""
    return ParticleState(*(torch.from_numpy(np.ascontiguousarray(a)).view(torch.int32)
                           if a.dtype == np.uint32 else torch.from_numpy(np.ascontiguousarray(a))
                           for a in fields))


def drift_state(cfg, seed=10):
    """``tests/test_torch_parallel.py:drift_scene``: crossers, far drifters
    and overflow on both axes of every shard edge."""
    from test_torch_parallel import drift_scene

    return as_state(drift_scene(cfg, 0.6, 1.4, seed))


def box_state(cfg):
    """``tests/test_torch_parallel.py:box_lattice``: a hex lattice at 1.1 r0
    with thermal velocities filling its box, dt = 10 fs. Returns the state
    and the metadata record."""
    from test_torch_parallel import box_lattice

    fields, meta = box_lattice(cfg)
    return as_state(fields), meta


OWNERS = {
    "2x1-two": ([0, 1], 2),
    "2x2-two": ([0, 0, 1, 1], 4),
    "2x2-four": ([0, 1, 2, 3], 4),
    "4x2-three-uneven": ([0, 0, 0, 1, 1, 2, 2, 2], 8),
}


@pytest.mark.parametrize("name", sorted(OWNERS))
def test_cross_process_ring_matches_single_process_exchange(name):
    """Each rank's ``RingPlan`` for a multi-process mesh; the messages
    ``pack_ring`` builds from one rank's blocks are unpacked into the
    receiving rank's, as the exchange would deliver them. Every rank's
    padded blocks then equal the single-process exchange's for the same
    shards, bit for bit, NaN payloads and -0.0 in the velocities included;
    every message has the size its receiver expects."""
    owners, n = OWNERS[name]
    cfg = bucket.GridConfig(4, 4, 4)
    state = drift_state(cfg)
    vx = state.vx.clone()
    vx.view(-1)[:3] = torch.tensor([-0.0, float("nan"), 0.0])
    vx.view(torch.int32).view(-1)[1] |= 0x1234  # a NaN with a payload
    state = state._replace(vx=vx)
    ny, nx = domain.factor_mesh(n)
    devs = [torch.device("cpu", o) for o in owners]
    grid = lambda flat: [flat[i * nx:(i + 1) * nx] for i in range(ny)]  # noqa: E731
    world = max(owners) + 1
    meshes = [domain.DeviceMesh(grid(devs), grid(owners), rank=r) for r in range(world)]
    single = domain.DeviceMesh(grid(devs))
    state, _ = domain.pad_rows_for_mesh(state, single)
    ref = domain.exchange_halo(domain.shard_state(state, single), single)
    ref_by_shard = {s: ParticleState(*(a[pos] for a in blk))
                    for blk, (_, ids) in zip(ref, single.blocks) for pos, s in enumerate(ids)}
    ly, lx = state.x.shape[0] // ny, state.x.shape[1] // nx
    padded = {r: [bucket.pad_tombstone_halo(b) for b in domain.shard_state(state, m)]
              for r, m in enumerate(meshes)}
    plans = {r: domain.ring_plan(m, ly, lx) for r, m in enumerate(meshes)}
    for r in range(world):
        domain.refresh_ring(padded[r], plans[r]._replace(sends=(), recvs=()))
    sent = 0
    for r in range(world):
        for peer, segs in plans[r].sends:
            msg = domain.pack_ring(padded[r], segs, domain.ALL_FIELDS)
            (n_cells, into), = [(k, sg) for p, k, sg in plans[peer].recvs if p == r]
            assert msg.shape == (5, n_cells, cfg.cap) and msg.dtype == torch.int32
            domain.unpack_ring(padded[peer], into, domain.ALL_FIELDS, msg)
            sent += 1
    assert sent == sum(len(p.recvs) for p in plans.values()) > 0
    for r, m in enumerate(meshes):
        for blk, (_, ids) in zip(padded[r], m.blocks):
            for pos, s in enumerate(ids):
                for f, a, b in zip(FIELDS, blk, ref_by_shard[s]):
                    assert torch.equal(a[pos].view(torch.int32) if a.is_floating_point()
                                       else a[pos],
                                       b.view(torch.int32) if b.is_floating_point() else b), \
                        f"rank {r} shard {s} field {f}"


# ---------------------------------------------------------------------------
# several processes
# ---------------------------------------------------------------------------

def run_children(tmp_path, state, pv, cfg, n_shards: int, world: int) -> list[dict]:
    """Run ``world`` frame children on the scene; their JSON lines."""
    np.savez(tmp_path / "scene.npz", cfg=np.array(cfg), params=pv.numpy(),
             **{f: a.numpy() for f, a in zip(FIELDS, state)})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "frame", str(r), str(tmp_path),
         str(n_shards)], env=dist_env(tmp_path, world, r), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    lines = []
    for r, (rc, out, err) in enumerate(finish(procs)):
        assert rc == 0, f"child {r} rc={rc}\n{out[-1500:]}\n{err[-3000:]}"
        lines.append(json.loads(out.strip().splitlines()[-1]))
    return lines


def check_children(tmp_path, lines, state, pv, cfg, n_shards) -> dict:
    """Rank 0's gathered grid bit-identical to the port's one-device frames
    on every slot; every child's line consistent. Returns the grid."""
    single = state
    for _ in range(FRAMES):
        single = bucket.run_frame_bucket(single, pv, STEPS, cfg.move_every)
    got = np.load(tmp_path / "got.npz")
    for f, a in zip(FIELDS, single):
        assert np.array_equal(got[f], a.numpy()), f
    live = int((single.ty >= 0).sum())
    for r, line in enumerate(lines):
        assert line["rank"] == r and line["backend"] == "gloo" and line["live"] == live
        assert line["mesh"] == list(domain.factor_mesh(n_shards)) and not line["foreign_modules"]
        assert line["exchange"]["steps"] == FRAMES * STEPS and line["exchange"]["bytes"] > 0
        assert not any(line["launches"].values())  # CPU tensors: the plain versions
    # particles crossed bucket edges on both axes: column and row counts moved
    before, after = (s.ty >= 0 for s in (state, single))
    assert not torch.equal(before.sum((0, 2)), after.sum((0, 2)))
    assert not torch.equal(before.sum((1, 2)), after.sum((1, 2)))
    return got


MESHES = pytest.mark.parametrize(
    "n_shards, world", [(2, 2), (4, 2), (4, 4)],
    ids=["2x1-two-processes", "2x2-two-processes", "2x2-four-processes"])


def jax_frames(state, meta, cfg) -> list[np.ndarray]:
    """JAX ``run_frame_bucket``: ``FRAMES`` frames of ``STEPS`` steps of the
    same state and metadata record; the five fields as numpy."""
    import jax

    from particle_simulator_tpu.engine.state import ParticleState as JState
    from particle_simulator_tpu.engine.state import SimParams as JSimParams
    from particle_simulator_tpu.physics import bucket as jbucket

    jp = JSimParams.from_record(meta)._replace(steps_per_frame=np.int32(STEPS))
    js = JState(*(jax.numpy.asarray(a.numpy().view(np.uint32) if f in ("x", "y") else a.numpy())
                  for f, a in zip(FIELDS, state)))
    for _ in range(FRAMES):
        js = jbucket.run_frame_bucket(js, jp, move_every=cfg.move_every)
    return [np.asarray(a) for a in js]


def envelope_misses(got, ref) -> dict:
    """The slots outside ``tests/multihost_child.py``'s envelope of JAX's
    frames (x/y within 8 fixed-point units, v within rtol 1e-3 / atol 0.05):
    field -> flat slot indices, and the worst position distance in units."""
    misses, worst = {}, 0
    for i, f in ((0, "x"), (1, "y")):
        d = np.abs(np.asarray(got[f]).view(np.uint32).astype(np.int64) - ref[i].astype(np.int64))
        misses[f] = np.flatnonzero(d > 8).tolist()
        worst = max(worst, int(d.max()))
    for i, f in ((2, "vx"), (3, "vy")):
        misses[f] = np.flatnonzero(np.abs(got[f] - ref[i]) > 0.05 + 1e-3 * np.abs(ref[i])).tolist()
    return {**misses, "worst_position_units": worst}


@MESHES
def test_multi_process_sharded_frame(tmp_path, n_shards, world):
    """VERDICT.md "Next round" item 5: ``world`` gloo processes, three
    10-step frames (rebucket every 4) of the thermal box lattice, whose
    particles cross bucket and shard edges on both axes; rank 0's gathered
    grid is bit-identical to the port's one-device frames and inside
    ``tests/multihost_child.py``'s envelope of JAX ``run_frame_bucket``."""
    from particle_simulator_tpu_torch.engine.state import SimParams

    cfg = bucket.GridConfig(4, 4, 4, move_every=4)
    state, meta = box_state(cfg)
    pv = SimParams.from_record(meta).vector()
    lines = run_children(tmp_path, state, pv, cfg, n_shards, world)
    got = check_children(tmp_path, lines, state, pv, cfg, n_shards)

    ref = jax_frames(state, meta, cfg)
    np.testing.assert_array_equal(got["ty"], ref[4])
    for i, f in ((0, "x"), (1, "y")):
        np.testing.assert_allclose(got[f].view(np.uint32).astype(np.int64),
                                   ref[i].astype(np.int64), rtol=0, atol=8)
    for i, f in ((2, "vx"), (3, "vy")):
        np.testing.assert_allclose(got[f], ref[i], rtol=1e-3, atol=0.05)


def drift_frames_against_jax():
    """The drift scene's three frames on one device of the port, and JAX's:
    (cfg, state, pv, meta, the port's grid, JAX's fields)."""
    from particle_simulator_tpu_torch.engine.state import SimParams
    from particle_simulator_tpu_torch.io.frame import Frame

    cfg = bucket.GridConfig(4, 4, 4, move_every=4)
    state = drift_state(cfg)
    meta = Frame.new().metadata.copy()
    pv = SimParams.from_record(meta).vector()
    single = state
    for _ in range(FRAMES):
        single = bucket.run_frame_bucket(single, pv, STEPS, cfg.move_every)
    return cfg, state, pv, meta, single, jax_frames(state, meta, cfg)


def test_drift_scene_one_device_leaves_the_jax_envelope():
    """The witness for ``ROADMAP.md`` queue 3's drift-scene deviation, with no
    second process: the port's one-device frames of the drift scene against
    JAX ``run_frame_bucket``. ``ty`` is equal; 16 of 1,024 slots leave the
    8-unit position envelope (worst 1,397 units), one of them the velocity
    envelope too. Random positions put pairs a few fixed-point units apart,
    where the force's rounding against XLA's is amplified."""
    _, _, _, _, single, ref = drift_frames_against_jax()
    got = {f: a.numpy() for f, a in zip(FIELDS, single)}
    np.testing.assert_array_equal(got["ty"], ref[4])
    misses = envelope_misses(got, ref)
    slots = set(misses["x"]) | set(misses["y"])
    assert len(slots) == 16 and misses["worst_position_units"] == 1397, misses
    assert misses["vx"] + misses["vy"] == [373] and 373 in slots, misses


def test_multi_process_sharded_frame_drift_scene(tmp_path):
    """The drift scene (far drifters and overflow dropped at every shard
    edge) through two processes on the (2, 2) mesh: bit-identical to the
    port's one-device frames, and outside JAX's envelope at exactly the
    slots where the one-device frames are
    (``test_drift_scene_one_device_leaves_the_jax_envelope``), so the
    deviation lies in the step, not in the multi-process path; JAX's
    envelope is held on the lattice above."""
    cfg, state, pv, _, single, ref = drift_frames_against_jax()
    lines = run_children(tmp_path, state, pv, cfg, 4, 2)
    got = check_children(tmp_path, lines, state, pv, cfg, 4)
    np.testing.assert_array_equal(got["ty"], ref[4])
    one = envelope_misses({f: a.numpy() for f, a in zip(FIELDS, single)}, ref)
    assert envelope_misses(got, ref) == one and one["x"] + one["y"]


def test_multi_process_daemon_serves_headless_editor(tmp_path):
    """``test_multihost_daemon_editor_end_to_end``'s analog: the unchanged
    headless editor and two daemon processes started through
    ``scripts/torch_launch_multihost.sh``; process 0 holds the editor link
    and broadcasts its input, both run the same sharded frames. Each holds
    the halo kernels' CPU side on its own blocks through ``--inspect``
    (``chip_smoke.hold_served``, a collective), as loaded and after its
    frames, as phase 20 of ``chip_smoke.py`` does on the card."""
    port = free_port()
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--frames", "3", "--lattice", "12x12",
         "--steps-per-frame", "10", "--timeout", "80"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [editor, *daemons(tmp_path, f"127.0.0.1:{port}", "--max-frames", "5",
                              "--retry-s", "60", "--inspect", "chip_smoke:hold_served")]
    (e_rc, e_out, e_err), *outs = finish(procs)
    assert e_rc == 0, f"editor rc={e_rc}\n{e_out[-1500:]}\n{e_err[-3000:]}"
    stats = json.loads(e_out.strip().splitlines()[-1])
    assert stats["frame_count"] >= 3 and stats["particle_count"] == 144
    ranks = []
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"daemon {i} rc={rc}\n{out[-1500:]}\n{err[-3000:]}"
        assert "disconnected after" in err
        assert f"engine: distributed process {i}/2, gloo, cpu:{i}" in err
        ranks.append(rank_stats(err))
    assert "sharding over a (2, 1) device mesh" in outs[0][2]
    assert "connected to editor" in outs[0][2] and "connected to editor" not in outs[1][2]
    assert ranks[0]["shipped"] == ranks[1]["shipped"] >= 3
    for r in ranks:
        assert not r["foreign_modules"] and r["exchange"]["bytes_per_step"] > 0
        assert not any(r["launches"].values())  # CPU tensors: the plain versions
    import chip_smoke

    held = chip_smoke.inspect_lines(outs, "daemons")
    assert [h["at"] for h in held] == ["as loaded", f"after {ranks[0]['shipped']} frames"] * 2
    assert chip_smoke.held_errors(held) == dict.fromkeys(chip_smoke.HALO_KERNELS, 0.0)
    assert all(h["blocks"] == [[1, 34, 66, 8]] for h in held), held  # one shard + ring
    assert ranks[0]["frame_period_ms"] is not None and ranks[1]["frame_period_ms"] is None


def test_multi_process_daemon_coerces_compact_array(tmp_path):
    """A CompactArray scene asked for on the CPU main thread, sent to two
    daemon processes, is served as sharded MatrixBuckets on every process;
    the echo and every frame carry the coerced data structure, and a live
    switch back to CompactArray is ignored. This test plays the editor on
    the port's own TCP server."""
    from particle_simulator_tpu_torch.io.frame import DataStructure, Device, Frame
    from particle_simulator_tpu_torch.io.presets import ParticleLattice
    from particle_simulator_tpu_torch.io.transport import new_tcp_server

    scene = Frame.new()
    meta = scene.metadata
    ParticleLattice((10, 10), distance_factor=4.0, velocity=(0.0, 10.0)).hex_square(
        scene, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(0))
    meta.steps_per_frame = 5
    meta.data_structure = DataStructure.COMPACT_ARRAY
    meta.device = Device.CPU_MAIN_THREAD
    server = new_tcp_server(("127.0.0.1", 0))
    spans = tmp_path / "spans.json"
    procs = daemons(tmp_path, f"127.0.0.1:{server.addr[1]}", "--retry-s", "60",
                    "--spans", str(spans))
    frames = []
    try:
        conn = None
        for _ in range(6000):
            conn = server.try_accept()
            if conn or any(p.poll() is not None for p in procs):
                break
            time.sleep(0.01)
        assert conn, "the engine never connected"
        reader, writer = conn
        assert writer.write(scene)
        frames.append(reader.read_blocking(timeout=60))
        switch = Frame.new()
        switch.header["metadata"] = meta.copy()
        assert writer.write(switch)  # CompactArray again: ignored
        for _ in range(4):
            frames.append(reader.read_blocking(timeout=60))
        reader.close()
        writer.close()
    finally:
        server.close()
        outs = finish(procs)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"daemon {i} rc={rc}\n{out[-1500:]}\n{err[-3000:]}"
        assert ("engine: multi-process run forces MatrixBuckets/accelerator "
                "(requested COMPACT_ARRAY/CPU_MAIN_THREAD)") in err
        assert "sharded over DeviceMesh(2x1" in err
        # --spans: a file a process, each with that process's frames
        with open(f"{spans}.rank{i}") as f:
            names = [s[0] for s in json.load(f)["spans"]]
        assert names.count("sim.load_frame") == 1 and "sim.frame_async" in names
    assert not spans.exists()
    # the echo holds the scene's particles, in bucket order
    rows = lambda parts: sorted(parts[i].tobytes() for i in range(len(parts)))  # noqa: E731
    assert rows(frames[0].particles) == rows(scene.particles)
    for f in frames:
        assert f.metadata.data_structure == DataStructure.MATRIX_BUCKETS
        assert f.metadata.device == Device.CPU_THREAD_POOL  # a GPU request on the CPU
        assert f.particle_count == 100 and np.isfinite(f.particles["vx"]).all()
    assert not np.array_equal(frames[0].particles["y"], frames[-1].particles["y"])


def test_multi_process_daemon_abort_when_editor_unreachable(tmp_path):
    """Process 0 cannot reach the editor (``--retry-s 0``): it releases
    process 1, waiting for the first scene, with a CLOSED broadcast and
    raises; process 1 stops cleanly. Neither hangs."""
    procs = daemons(tmp_path, f"127.0.0.1:{free_port()}", "--retry-s", "0")
    (rc0, _, err0), (rc1, _, err1) = finish(procs)
    assert rc0 != 0 and "ConnectionRefusedError" in err0, err0[-3000:]
    assert rc1 == 0 and "editor disconnected before first scene" in err1, err1[-3000:]
    assert rank_stats(err1)["shipped"] == 0


def test_make_simulator_on_the_cpu():
    """``--torch-device cpu`` in one process: a CPU ``Simulator``, sharded
    over one CPU block when ``--devices`` asks for several shards."""
    from particle_simulator_tpu_torch.engine import daemon

    sim = daemon.make_simulator(None, "cpu")
    assert sim.device == torch.device("cpu") and sim.mesh is None
    sim = daemon.make_simulator("3", "cpu")
    assert sim.mesh.shape == (3, 1) and len(sim.mesh.blocks) == 1 and not sim.multi_process
    assert daemon.make_simulator("all", "cpu").mesh is None


if __name__ == "__main__":
    assert sys.argv[1] == "frame", sys.argv
    sys.exit(child_frame(int(sys.argv[2]), sys.argv[3], int(sys.argv[4])))
