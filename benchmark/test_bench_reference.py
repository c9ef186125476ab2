"""The reference against the port's plain versions, its square of buckets,
and the control that must fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from psbench import frames, refsim, scenes

import control


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
