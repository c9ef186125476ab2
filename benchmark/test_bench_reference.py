"""The reference against the port's plain versions, its square of buckets,
the control that must fail, and the bytes the serve harness sends and
checks against, frozen."""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from psbench import cells, frames, refsim, scenes, serve, wire

import control

# sha256 of what the serve harness sent and checked against before each
# data layout got a reference module of its own (references/buckets.py):
# the scene packets of editor-lattice-1m from seed FROZEN_SEED (k = 0..3),
# the tiny lattice's echo and its 20-step frames (the cursor off, then on),
# and the arrays of the daemon's snapshot of the tiny lattice as loaded
FROZEN_SEED = 2147483801
SCENE_PACKETS = [
    "a8a27480716860ad3056c8b84b77a353adf33acbd10d4d04bc218c6794d47b94",
    "b499ff9a1ea4209bd9676c8de56fbfe6c6b1bb0b268d260a15c44f1c5ed9e952",
    "21761543110b8919011cf52ee8a1386bcea096ffc226607b7b18582fb7403d5f",
    "8807d913b7bd9ad6c8a57f7c55d24f8394b43cb1b465e5a8e5c16acfcd01fbc6",
]
TINY_ECHO = "561eb73f6f7e141affbf74f5a84d3dc056aee33718347dcd2470fc5dda67fca4"
TINY_FRAME = "308e5220264234161e431b17171bcac3293811993c8b2c278854ca78da6d7569"
TINY_FRAME_CURSOR = "62aca9a02d33f50f6122dfddf88050d6a027f0b38e934ba430bd69277b730df2"
SNAPSHOT = {
    "grid": "69086f09e078f4be1792f9eb68360a1027ae067452a8640c2521360d6d744f37",
    "cursor": "7c8e9e654585093fe245e490010889af419e1023882a4110ddfc3d53ce48721e",
    "x": "34c8784a7752e54ec8a3e143c54c49981746dc36150844a74fb6f62616997c01",
    "y": "f03d446e2f18b24a25be252beb0dcccd867408633d8d7b3b197093af06cdc5d4",
    "vx": "ba78a1348f3f185a09529ceec342fea494705970a52c5218bf9897ba3c14e280",
    "vy": "b603bfbeda0fa645266decc794eeb57b3a8caccf07014e0b86b48a745596106b",
    "ty": "cfc335996cfae29fdf14fd2db7ea853366d350a5d387aa3c322616e81dacd56b",
    "bucket": "09acc68f73f3fe129624dbc6e5146b62313465398ab2ecfafbaf7182b85aa381",
    "slot": "606f558e014930f9c1669f03c71c28945c4631568e39cd308c6c7f4077c7bfb9",
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _config(root: str, name: str) -> dict:
    with open(os.path.join(root, cells.NAME, "configs", name + ".json")) as f:
        return json.load(f)


def _port_frame(state, params, steps, g, device):
    from particle_simulator_tpu_torch.engine.state import ParticleState
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda

    return run_frame_bucket_cuda(ParticleState(*(a.to(device) for a in state)),
                                 params.to(device), steps, g.move_every)


@pytest.mark.parametrize("cursor", [(-1.0, -1.0), (0.4, 0.55)])
def test_reference_agrees_with_the_ports_frame_bit_for_bit(cursor):
    g = scenes.Grid(4, 4, 8)
    st, meta, _ = scenes.dense_crystal(g, 2**31 + 99, 1e-14, "cpu")
    meta["cursor_pos"], meta["cursor_size"] = cursor, 0.3
    params = refsim.params_vector(meta, "cpu")
    got = _port_frame(st, params, 37, g, "cpu")
    ref = refsim.frame(refsim.from_grid(st, g), params, 37)
    assert refsim.layout_mismatches(refsim.from_grid(tuple(got), g), ref) == 0


def test_reference_follows_a_sent_lattice_through_crossings_and_drops():
    from particle_simulator_tpu_torch.engine.state import state_from_numpy
    from particle_simulator_tpu_torch.physics.bucket import GridConfig, bucketize_numpy

    cfg = {"n_side": 30, "distance_factor": 0.95, "box_sides_r0": 40.0,
           "velocity": [200, 900], "step_dt": 1e-14, "steps_per_frame": 100}
    parts, meta = scenes.hex_lattice(cfg, 5)
    meta["cursor_pos"], meta["cursor_size"] = (0.5, 0.5), 0.4
    g = scenes.scene_grid(parts, meta)
    layout = bucketize_numpy(parts, GridConfig(*g))
    state = state_from_numpy(layout, g.capacity).reshape((g.by, g.bx, g.cap))
    lay = refsim.from_particles(*scenes.bucketize(parts, g), g, "cpu")
    assert refsim.mismatches(refsim.pack(lay), layout[layout["ty"] >= 0]) == 0
    params = refsim.params_vector(meta, "cpu")
    for _ in range(3):
        state = _port_frame(state, params, 100, g, "cpu")
        lay = refsim.frame(lay, params, 100)
        assert refsim.layout_mismatches(refsim.from_grid(tuple(state), g), lay) == 0


def test_square_of_buckets_equals_the_whole_grid_inside_the_light_cone(monkeypatch):
    g = scenes.Grid(6, 6, 8)
    st, meta, live = scenes.dense_crystal(g, 17, 1e-14, "cpu")
    params = refsim.params_vector(meta, "cpu")
    steps = 6
    monkeypatch.setattr(frames, "REGION_LIVE", 1000)
    inner, outer = frames.region(g, live, 17, {"region_half_buckets": 8}, steps)
    assert inner[0][1] - inner[0][0] == 16
    assert outer[0][1] - outer[0][0] == 16 + 2 * refsim.light_cone(steps, g.move_every)
    whole = refsim.frame(refsim.from_grid(st, g), params, steps)
    square = refsim.frame(frames.crop(refsim.from_grid(st, g), outer), params, steps)
    assert refsim.layout_mismatches(frames.crop(whole, inner), frames.crop(square, inner)) == 0
    too_small = frames.crop(refsim.from_grid(st, g), ((inner[0][0] - 1, inner[0][1] + 1),
                                                       (inner[1][0] - 1, inner[1][1] + 1)))
    cut = refsim.frame(too_small, params, steps)
    assert refsim.layout_mismatches(frames.crop(whole, inner), frames.crop(cut, inner)) > 0


@pytest.mark.parametrize("workload", ["user1m-serve-drag", "dense1m-frames",
                                      "dense16m-4card-frames"])
def test_the_control_fails_the_comparison(tiny_root, workload):
    reading = control.control_reading(workload, 2**31 + 7, "cpu", root=tiny_root)
    assert reading["compared"] > 0
    assert reading["control_mismatch"] > reading["limit"] == 0


@pytest.mark.card
def test_reference_agrees_with_the_kernels_on_the_card(card):
    g = scenes.Grid(6, 7, 8)
    st, meta, _ = scenes.dense_crystal(g, 21, 1e-14, card)
    meta["cursor_pos"], meta["cursor_size"] = (0.5, 0.5), 0.2
    params = refsim.params_vector(meta, card)
    got = _port_frame(st, params, 100, g, card)
    ref = refsim.frame(refsim.from_grid(st, g), params, 100)
    assert refsim.layout_mismatches(refsim.from_grid(tuple(got), g), ref) == 0
    assert torch.cuda.is_available() and np.isfinite(ref.vx.cpu().numpy()).all()


def test_the_served_scenes_keep_their_bytes():
    cfg = _config(cells.ROOT, "editor-lattice-1m")
    ref = cells.reference(cfg)
    got = [_sha(serve.scene_packet(ref, cfg, FROZEN_SEED, k)[0]) for k in range(4)]
    assert got == SCENE_PACKETS


def test_the_bucket_reference_keeps_its_frames(tiny_root):
    cfg = _config(tiny_root, "editor-lattice-1m")
    ref = cells.reference(cfg, tiny_root)
    parts, meta = ref.draw(cfg, FROZEN_SEED, 0, 0)
    lay = ref.loaded(parts, meta, "cpu")
    assert _sha(ref.pack(lay).tobytes()) == TINY_ECHO
    assert _sha(ref.pack(ref.frame(lay, meta, 20, "cpu")).tobytes()) == TINY_FRAME
    meta["cursor_pos"], meta["cursor_size"] = (0.45, 0.55), 0.05
    assert _sha(ref.pack(ref.frame(lay, meta, 20, "cpu")).tobytes()) == TINY_FRAME_CURSOR


def test_the_daemon_keeps_its_snapshot_arrays(tiny_root, tmp_path):
    """The snapshot of the tiny lattice as loaded (``snap`` asked before the
    scene is sent, so the first frame's state is copied)."""
    cfg = _config(tiny_root, "editor-lattice-1m")
    parts, meta = cells.reference(cfg, tiny_root).draw(cfg, FROZEN_SEED, 0, 0)
    link = serve.Link()
    child = serve.Child(link, {"traffic": {}, "workdir": str(tmp_path), "device": "cpu",
                               "trace": 0})
    try:
        child.tell("snap")
        link.accept(120.0, child.proc)
        time.sleep(0.3)
        link.send(wire.encode(meta, parts))
        assert link.wait(serve._first_stepped(len(parts), 0.0), 120.0)
    finally:
        link.close()
        child.stop()
    assert child.proc.returncode == 0
    with np.load(tmp_path / "snap0.npz") as z:
        snap = {n: z[n] for n in z.files}
    assert {n: _sha(snap[n].tobytes()) for n in SNAPSHOT} == SNAPSHOT
    assert int(snap["data_structure"]) == wire.MATRIX_BUCKETS
    cap = int(snap["grid"][2])
    assert np.array_equal(snap["index"], snap["bucket"] * cap + snap["slot"])
    assert set(snap) == set(SNAPSHOT) | {"data_structure", "index"}
