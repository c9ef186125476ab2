"""The port's dense-pack readback against the JAX package's: packed fields
and the ``[max_occupancy, total]`` header identical, bit for bit, on the
densities of tests/test_readback.py; and the widen-and-retry path of the
port's ``Simulator.read_frame`` reading back exactly the live particles.

Then the record pack (``ops/readback.py:pack_records``), the one readback
of a bucket grid: its plain version against the fields' pack and host
interleave (``dense_readback`` + ``dense_to_particles``), a CPU
Simulator's frames through it, its redo path and two tickets, and a Python
model of the CUDA kernel's three launches against the plain version
(tests/test_torch_readback_card.py holds the kernel itself on the card)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_simulator_tpu.engine.state import ParticleState as JState
from particle_simulator_tpu.ops.readback import dense_readback as jax_dense_readback
from particle_simulator_tpu.scenes.library import _scene
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import from_reference, state_to_numpy
from particle_simulator_tpu_torch.io.frame import Frame
from particle_simulator_tpu_torch.ops.readback import (
    RECORD_WORDS,
    dense_readback,
    dense_to_particles,
    pack_records,
    pow2_at_least,
    record_view,
    record_words,
    records_plain,
)
from particle_simulator_tpu_torch.physics.bucket import GridConfig
from particle_simulator_tpu_torch.utils import profiling

torch.set_num_threads(2)


def random_fields(rng, shape, density):
    """Random grid state honouring the slot-prefix invariant."""
    by, bx, cap = shape
    cnt = rng.binomial(cap, density, (by, bx))
    occ = np.arange(cap)[None, None, :] < cnt[..., None]
    return (
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.integers(0, 2**32, shape, dtype=np.uint32),
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
        np.where(occ, rng.integers(0, 5, shape), -1).astype(np.int32),
    )


def check_against_jax(fields, kcap=None, ncap=None):
    counts = (fields[4] >= 0).sum(-1)
    kcap = pow2_at_least(int(counts.max(initial=0))) if kcap is None else kcap
    ncap = pow2_at_least(int(counts.sum())) if ncap is None else ncap
    rs, rp = jax_dense_readback(JState(*(jnp.asarray(a) for a in fields)), kcap, ncap)
    state, _ = from_reference(fields, _scene(2, 2, 1.1, 0.0).metadata.copy())
    gs, gp = dense_readback(state, kcap, ncap)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    for name, r, g in zip(JState._fields, rp, gp):
        g = g.numpy()
        if name in ("x", "y"):
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    return state, gs, gp


@pytest.mark.parametrize("density", [0.0, 0.07, 0.5, 0.93, 1.0])
def test_dense_pack_identical_to_jax(density):
    rng = np.random.default_rng(int(density * 100))
    fields = random_fields(rng, (8, 16, 8), density)
    state, scalars, packed = check_against_jax(fields)
    # and it is the live particles in wire order
    ref = state_to_numpy(state)
    ref = ref[ref["ty"] >= 0]
    total = int(scalars[1])
    assert total == len(ref)
    assert dense_to_particles(total, packed).tobytes() == ref.tobytes()
    assert (packed.ty[total:] == -1).all()


def test_dense_pack_empty_runs_and_padding_identical_to_jax():
    rng = np.random.default_rng(3)
    fields = list(random_fields(rng, (4, 8, 8), 0.6))
    ty = fields[4]
    ty[0] = -1  # leading empty row
    ty[-1] = -1  # trailing empty row
    ty[2, 1:5] = -1  # interior empty run
    check_against_jax(tuple(fields))
    total = int((ty >= 0).sum())
    check_against_jax(tuple(fields), ncap=pow2_at_least(total) * 4)


def test_header_exact_when_kcap_overflows():
    """kcap below the fullest bucket: the pack is discarded by the caller,
    but the header stays exact (and the whole output still matches JAX)."""
    rng = np.random.default_rng(7)
    fields = random_fields(rng, (4, 8, 8), 0.9)
    counts = (fields[4] >= 0).sum(-1)
    _, scalars, _ = check_against_jax(fields, kcap=2)
    assert int(scalars[0]) == int(counts.max()) > 2
    assert int(scalars[1]) == int(counts.sum())


def _sim(frame):
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(frame)
    ref = state_to_numpy(sim.state)
    return sim, ref[ref["ty"] >= 0]


def test_read_frame_widens_ncap_and_retries():
    sim, ref = _sim(_scene(12, 12, distance_factor=1.1, speed=5.0, box_fill=0.4))
    sim._readback_ncap = 4  # pack shorter than the live count
    ticket = sim.start_readback()
    out = sim.read_frame(ticket)
    assert out.particles.tobytes() == ref.tobytes()
    assert sim._readback_ncap == pow2_at_least(len(ref))


# -- the record pack (ops/readback.py:pack_records, csrc/readback_pack.cu) ----

def frame_of_fields(state, ncap, meta=None):
    """The frame of a grid through the fields' pack at ``kcap = CAP``, then
    the host interleave (``dense_readback`` + ``dense_to_particles``)."""
    scalars, packed = dense_readback(state, state.x.shape[-1], ncap)
    live = dense_to_particles(int(scalars[1]), packed)
    return Frame.from_particles(META if meta is None else meta, live, owned=True)


def check_records(fields, ncap=None):
    """The plain record pack of ``fields`` against the fields' frame: the same
    wire bytes, the exact header, tombstoned pads; returns the words."""
    state, _ = from_reference(fields, META)
    counts = (fields[4] >= 0).sum(-1)
    total = int(counts.sum())
    ncap = pow2_at_least(total) if ncap is None else ncap
    words = records_plain(state, ncap)
    assert torch.equal(pack_records(state, ncap), words)  # a CPU state runs the plain version
    assert words.shape == (record_words(ncap),)
    mx, got_total, live = record_view(words.numpy(), ncap)
    assert (mx, got_total) == (int(counts.max(initial=0)), total)
    frame = Frame.from_particles(META, live, owned=True)
    assert frame.bytes == frame_of_fields(state, ncap).bytes
    rec = words[: ncap * RECORD_WORDS].reshape(ncap, RECORD_WORDS)
    assert (rec[total:, :4] == 0).all() and (rec[total:, 4] == -1).all()
    return words


META = _scene(2, 2, 1.1, 0.0).metadata.copy()


@pytest.mark.parametrize("density", [0.0, 0.07, 0.5, 0.93, 1.0])
def test_record_pack_gives_the_frame_bytes(density):
    rng = np.random.default_rng(int(density * 100) + 11)
    check_records(random_fields(rng, (8, 16, 8), density))


def test_record_pack_empty_rows_and_pads():
    rng = np.random.default_rng(5)
    fields = list(random_fields(rng, (4, 8, 8), 0.6))
    ty = fields[4]
    ty[0] = -1  # leading empty row
    ty[-1] = -1  # trailing empty row
    ty[2, 1:5] = -1  # interior empty run
    check_records(tuple(fields))
    total = int((ty >= 0).sum())
    check_records(tuple(fields), ncap=pow2_at_least(total) * 4)  # ncap far past total


def record_sim(frame):
    """A CPU Simulator on ``frame`` and the frame of its state through the
    fields' pack."""
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(frame)
    want = frame_of_fields(sim.state, pow2_at_least(sim.live_count), sim.meta_record)
    return sim, want


@pytest.mark.parametrize("overflow", ["ncap"])
def test_record_path_on_both_redo_paths(overflow, monkeypatch):
    """The record path's frame equals the fields' path's when its pack
    length (``ncap``, the one sticky size it has) is widened and redone."""
    sim, want = record_sim(_scene(16, 16, distance_factor=1.1, speed=5.0, box_fill=0.4))
    # a recorder of its own: the process's would keep these spans for a
    # later test that exports it (tests/test_torch_tracing.py)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    with profiling.recording():
        before = dict(profiling.RECORDER.counters)
        sim._readback_ncap = 4
        records = sim.read_frame(sim._start_records(sim.state))
        after = profiling.RECORDER.counters
    assert records.bytes == want.bytes
    redo = after.get("readback.redo", 0) - before.get("readback.redo", 0)
    assert redo == 1
    assert after["readback.records"] - before.get("readback.records", 0) == 1
    assert sim._readback_ncap == pow2_at_least(want.particle_count)


@pytest.mark.parametrize("case", ["sparse lattice", "full buckets", "all dead"])
def test_cpu_grids_read_back_through_the_record_pack(case, monkeypatch):
    """A CPU Simulator's ``read_frame`` of a bucket grid gives the bytes of
    ``dense_readback`` + ``dense_to_particles`` at ``kcap = CAP``, and
    ``readback.records`` counts each frame: the record pack is a CPU grid's
    readback too."""
    sim, _ = record_sim(_scene(12, 12, distance_factor=1.1, speed=50.0, box_fill=0.4))
    if case != "sparse lattice":
        rng = np.random.default_rng(3)
        fields = random_fields(rng, tuple(sim.grid.grid_shape), 1.0 if case == "full buckets"
                               else 0.0)
        sim.state, _ = from_reference(fields, sim.meta_record)
    got, want = [], []
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    with profiling.recording():
        before = dict(profiling.RECORDER.counters)
        for _ in range(2):
            if case == "sparse lattice":
                sim.frame_async()
            want.append(frame_of_fields(sim.state, sim.grid.capacity, sim.meta_record).bytes)
            got.append(sim.read_frame().bytes)
        after = profiling.RECORDER.counters
    assert got == want
    assert after["readback.records"] - before.get("readback.records", 0) == 2


def test_record_frames_of_two_tickets_stay_apart_and_writable():
    sim, _ = record_sim(_scene(12, 12, distance_factor=1.1, speed=50.0, box_fill=0.4))
    first = sim.read_frame(sim._start_records(sim.state))
    kept = first.bytes
    sim.frame_async()
    second = sim.read_frame(sim._start_records(sim.state))
    assert second.bytes != kept  # the scene moved
    assert first.bytes == kept  # the later readback left the earlier frame whole
    second_bytes = second.bytes
    first.particles["vx"][0] += 1.0
    assert first.bytes != kept and second.bytes == second_bytes


def kernel_model(fields, ncap, tile=16, chunk=8):
    """The three launches of csrc/readback_pack.cu, block by block with its
    index arithmetic (``tile`` buckets a block, ``chunk`` records staged at
    a time; the kernel's are 1024 and 1024): the count (16-byte loads where
    the cap allows), the scan of the tiles, the chunked write through the
    staging words with 4-byte stores at the ragged ends and 16-byte ones
    between, the pads. Returns the words and how often each was stored."""
    x, y, vx, vy, ty = (np.ascontiguousarray(a).reshape(-1).view(np.int32) for a in fields)
    cap = fields[0].shape[-1]
    n_buckets = fields[0].size // cap
    vec4 = cap % 4 == 0
    n_tiles = -(-n_buckets // tile)
    out_words = ncap * RECORD_WORDS
    out = np.full(record_words(ncap), 12345, np.int32)
    stores = np.zeros(record_words(ncap), np.int64)

    def store(w, v):
        out[w] = v
        stores[w] += 1

    def live_prefix(b):
        t = ty[b * cap:(b + 1) * cap]
        step = 4 if vec4 else 1
        for n in range(0, cap, step):
            for k in range(step):
                if t[n + k] < 0:
                    return n + k
        return cap

    counts = np.array([live_prefix(b) for b in range(n_buckets)], np.int64)
    sums = [int(counts[t * tile:(t + 1) * tile].sum()) for t in range(n_tiles)]
    maxes = [int(counts[t * tile:(t + 1) * tile].max(initial=0)) for t in range(n_tiles)]
    tile_off = np.concatenate([[0], np.cumsum(sums)[:-1]]).astype(np.int64)
    total = int(sum(sums))
    store(out_words, max(maxes))
    store(out_words + 1, total)
    for blk in range(n_tiles):
        base = blk * tile
        c = np.zeros(tile, np.int64)
        n_here = min(tile, n_buckets - base)
        c[:n_here] = counts[base:base + n_here]
        s_off = np.concatenate([[0], np.cumsum(c)[:-1]])
        tile_total = int(c.sum())
        first = int(tile_off[blk])
        for c0 in range(0, tile_total, chunk):
            n = min(chunk, tile_total - c0)
            w0 = (first + c0) * RECORD_WORDS
            aligned = w0 & ~3
            lead = w0 - aligned
            s_rec = np.zeros(chunk * RECORD_WORDS + 4, np.int32)
            for p in range(n):
                lp = c0 + p
                lo, hi = 0, tile - 1
                while lo < hi:
                    mid = (lo + hi + 1) >> 1
                    if s_off[mid] <= lp:
                        lo = mid
                    else:
                        hi = mid - 1
                src = (base + lo) * cap + (lp - s_off[lo])
                r = lead + p * RECORD_WORDS
                s_rec[r:r + 5] = (x[src], y[src], vx[src], vy[src], ty[src])
            end = min(w0 + n * RECORD_WORDS, out_words)
            if w0 < end:
                qa = min((w0 + 3) & ~3, end)
                qb = max(qa, end & ~3)
                for w in range(w0, qa):
                    store(w, s_rec[w - aligned])
                for q in range(qa, qb, 4):
                    assert q % 4 == 0 and (q - aligned) % 4 == 0
                    for k in range(4):
                        store(q + k, s_rec[q - aligned + k])
                for w in range(qb, end):
                    store(w, s_rec[w - aligned])
    p0 = total * RECORD_WORDS
    if p0 < out_words:
        pad = lambda w: -1 if w % RECORD_WORDS == RECORD_WORDS - 1 else 0  # noqa: E731
        qa = min((p0 + 3) & ~3, out_words)
        qb = max(qa, out_words & ~3)
        for w in list(range(p0, qa)) + list(range(qb, out_words)):
            store(w, pad(w))
        for q in range(qa, qb, 4):
            for k in range(4):
                store(q + k, pad(q + k))
    return out, stores


@pytest.mark.parametrize("shape,density,ncap_scale", [
    ((8, 16, 8), 0.5, 1),       # vector count, several tiles and chunks
    ((4, 12, 6), 0.6, 1),       # cap 6: the scalar count; a ragged last tile
    ((5, 7, 12), 0.93, 2),      # cap 12, pads past total
    ((4, 8, 8), 0.0, 1),        # all dead: pads only
    ((4, 8, 8), 1.0, 1),        # all full
    ((8, 16, 8), 0.5, 0.25),    # ncap below total: records clipped, header exact
])
def test_kernel_model_matches_the_plain_record_pack(shape, density, ncap_scale):
    rng = np.random.default_rng(sum(shape) + int(density * 10))
    fields = list(random_fields(rng, shape, density))
    fields[4][1, :3] = -1  # an interior empty run
    total = int((fields[4] >= 0).sum())
    ncap = max(1, int(pow2_at_least(total) * ncap_scale))
    got, stores = kernel_model(fields, ncap)
    state, _ = from_reference(fields, META)
    want = records_plain(state, ncap).numpy()
    assert (stores == 1).all(), "a word stored other than once"
    np.testing.assert_array_equal(got, want)
