"""The harness's arithmetic, its lookup by name and its frozen copies."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from psbench import cells, nojax, roofline, scenes, stats, trace, wire

import run


def test_finds_a_cell_config_mix_and_metric_it_was_not_edited_for(tiny_root):
    bench_dir = os.path.join(tiny_root, cells.NAME)
    with open(os.path.join(bench_dir, "configs", "dense-crystal-1m.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "dense-crystal-small"
    with open(os.path.join(bench_dir, "configs", "dense-crystal-small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "frames-short.json"), "w") as f:
        json.dump({"mode": "frames", "trace_s": 0.5}, f)
    with open(os.path.join(bench_dir, "metrics", "frames_done.py"), "w") as f:
        f.write('"""Frames in the window."""\n\n\ndef read(run):\n    return run["frames"]\n')
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dense-crystal-small", "source": "https://example.org",
                             "file": f"{cells.NAME}/configs/dense-crystal-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small-frames", "config": "dense-crystal-small",
                               "traffic": "frames-short", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "particle_steps_per_s")["workloads"].append("small-frames")
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["small-frames"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    out = run.run_cell("small-frames", 5, 1.0, False, "cpu", root=tiny_root)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"particle_steps_per_s", "setup_s", "frames_done"}
    assert out["metrics"]["frames_done"]["value"] == out["attempted"] > 0
    assert list(out)[-1] == "checks"


def test_metric_lists_follow_benchmark_json():
    bench = cells.load()
    assert [m["name"] for m in cells.metrics(bench, "user1m-serve-drag", False)] == [
        "served_fps", "setup_s"]
    traced = [m["name"] for m in cells.metrics(bench, "dense1m-frames", True)]
    assert traced == ["step_roofline_pct.bench", "mfu.bench", "device_idle_pct.bench"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for name in ("scene_switch_ms", "scene_load_ms.resend", "exchange_host_ms.4card"):
        assert callable(cells.reader(name))  # readers of the cells left out


def test_every_cell_reads_its_metrics_from_a_record():
    record = {"window_s": 30.0, "frame_times": [0.1 * i for i in range(300)], "steps": 100,
              "edit_lag_ms": [300.0] * 10, "edit_lag_frames": [7] * 10, "setup_s": 20.0,
              "step_least": {"bound_ms": 0.068}, "frames": 1000, "particle_steps": 1e11,
              "trace": {"idle_pct": 1.0,
                        "kernels": {"bucket_step_kernel_tiles<true>": [10, 3e5]}},
              "ranks": [{"step_least": {"bound_ms": 0.11}, "step_ms": 0.25,
                         "exchange": {"seconds": 1.0, "steps": 1000}}]}
    read = {m: cells.reader(m)(record) for m in (
        "served_fps", "edit_lag_p95_ms.serve", "setup_s", "particle_steps_per_s", "mfu.serve",
        "mfu.bench", "step_roofline_pct.serve", "step_roofline_pct.bench",
        "exchange_host_ms.4card", "edit_lag_frames.serve", "device_idle_pct.bench")}
    assert read["served_fps"] == 10.0 and read["edit_lag_p95_ms.serve"] == 300.0
    assert read["mfu.serve"] == pytest.approx(100 * 0.068e-3 * 100 * 300 / 30)
    assert read["mfu.bench"] == pytest.approx(100 * 0.11e-3 * 100 * 1000 / 30)
    assert read["step_roofline_pct.serve"] == pytest.approx(100 * 0.068 / 0.3)
    assert read["step_roofline_pct.bench"] == pytest.approx(44.0)
    assert read["exchange_host_ms.4card"] == 1.0 and read["edit_lag_frames.serve"] == 7
    assert read["particle_steps_per_s"] == pytest.approx(1e11 / 30)


def test_each_step_reader_reads_only_its_own_kernel():
    import rank_child
    from psbench import frames

    ms = {"bucket_step_kernel<false>": 0.25, "bucket_step_kernel<true>": 0.5,
          "bucket_step_kernel_tiles<true>": 0.125, "bucket_step_kernel_tiles<false>": 1.0,
          "allpairs_step_kernel": 2.0, "bucket_dest_kernel<false>": 4.0}
    red = {"kernels": {n: [10, m * 1e6] for n, m in ms.items()}}
    assert trace.kernel_mean_ms(red, frames.STEP_KERNELS) == 0.25
    assert trace.kernel_mean_ms(red, rank_child.STEP_KERNELS) == 0.5
    served = cells.reader("step_roofline_pct.serve")({"trace": red,
                                                      "step_least": {"bound_ms": 0.1}})
    assert served == pytest.approx(80.0)  # 0.1 ms of 0.125


def test_every_configuration_carries_its_cpu_cut(tiny_root):
    configs = os.path.join(cells.BENCH_DIR, "configs")
    for name in sorted(os.listdir(configs)):
        with open(os.path.join(configs, name)) as f:
            full = json.load(f)
        with open(os.path.join(tiny_root, cells.NAME, "configs", name)) as f:
            tiny = json.load(f)
        cut = full.pop("cpu_cut")
        assert cut and tiny == {**full, **cut}
        assert tiny["steps_per_frame"] == 20


def test_percentiles_cover_every_sample_with_a_stall():
    times = [i * 0.033 for i in range(100)]
    times = times[:50] + [t + 0.5 for t in times[50:]]  # one 533 ms stall
    gaps = stats.gaps_ms(times)
    assert len(gaps) == 99
    assert stats.percentile(gaps, 95) == pytest.approx(np.percentile(gaps, 95))
    assert stats.percentile(gaps, 100) == pytest.approx(533.0)
    assert stats.percentile([], 95) is None
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0
    assert stats.in_window(times, 0.1, 0.2) == [t for t in times if 0.1 <= t <= 0.2]


def test_edits_match_the_frames_computed_under_them():
    edits = [(0.00, (0.5, 0.5)), (0.01, (0.6, 0.5)), (0.02, (0.7, 0.5)), (0.03, (0.5, 0.5))]
    # frames: two under the scene's cursor, edit 1 (edit 0 dropped: newest
    # wins), edit 1 again, edit 3 (a cursor that repeats edit 0's)
    cursors = [(-1.0, -1.0), (-1.0, -1.0), (0.6, 0.5), (0.6, 0.5), (0.5, 0.5)]
    times = [0.005, 0.015, 0.025, 0.045, 0.06]
    idx = stats.edit_indices(cursors, [c for _, c in edits])
    assert idx == [-1, -1, 1, 1, 3]
    lags = stats.edit_lags([t for t, _ in edits], times, idx)
    assert [round(lag[0], 3) for lag in lags] == [25.0, 15.0, 40.0, 30.0]
    assert [lag[1] for lag in lags] == [2, 1, 2, 1]
    assert stats.edit_lags([0.0, 0.01, 0.02, 0.03, 0.07], times, idx)[4] is None
    assert stats.edit_indices([(0.5, 0.5), (0.1, 0.1)], [(0.5, 0.5)]) == [0, None]


def test_scenes_match_their_echo_and_first_stepped_frame():
    frames_t = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
    counts = [10, 10, 10, 9, 9, 9]
    assert stats.scene_frames([0.0, 0.35], [10, 9], frames_t, counts) == [(0, 1), (3, 4)]
    assert stats.scene_frames([0.55], [9], frames_t, counts) == [None]


def test_wire_decoder_reads_the_ports_encoder():
    from particle_simulator_tpu_torch.io import frame as pframe

    parts, meta = scenes.hex_lattice({"n_side": 7, "distance_factor": 1.1, "box_sides_r0": 20,
                                      "velocity": [0, 100], "step_dt": 1e-14,
                                      "steps_per_frame": 100}, 3)
    ported = pframe.Frame.from_particles(meta, parts.astype(pframe.PARTICLE_DTYPE)).bytes
    assert wire.encode(meta, parts) == ported
    count, got = wire.decode_header(ported[:wire.HEADER_SIZE])
    assert count == len(parts) and got.tobytes() == meta.tobytes()
    assert wire.particles(ported).tobytes() == parts.tobytes()
    edit = pframe.Frame.from_metadata(meta).bytes
    assert wire.encode(meta) == edit and wire.decode_header(edit)[0] == 0
    assert wire.default_metadata().tobytes() == pframe.default_metadata().tobytes()
    with pytest.raises(ValueError):
        wire.decode_header(b"\0" * wire.HEADER_SIZE)


def test_frozen_scenes_match_the_port():
    from particle_simulator_tpu_torch.bench import dense_grid_config
    from particle_simulator_tpu_torch.editor.core import Editor
    from particle_simulator_tpu_torch.engine.simulator import _grid_for
    from particle_simulator_tpu_torch.io.frame import MieParams
    from particle_simulator_tpu_torch.io.presets import ParticleLattice
    from particle_simulator_tpu_torch.io.frame import Frame
    from particle_simulator_tpu_torch.physics.bucket import REFERENCE_GRID, bucketize_numpy

    for n in (1_000_000, 16_000_000, 3000):
        assert tuple(scenes.dense_grid_config(n))[:3] == tuple(dense_grid_config(n))[:3]
    cfg = {"n_side": 40, "distance_factor": 1.1, "box_sides_r0": 88.0, "velocity": [0, 80],
           "step_dt": 1e-14, "steps_per_frame": 100}
    parts, meta = scenes.hex_lattice(cfg, 9)
    frame = Frame.from_metadata(meta.copy())
    ParticleLattice((40, 40), 1.1, (0, 80)).hex_square(
        frame, (frame.metadata.box_width / 2, frame.metadata.box_height / 2),
        rng=np.random.default_rng(9))
    assert frame.particles.tobytes() == parts.tobytes()
    assert Editor is not None
    r0 = MieParams(*(float(v) for v in meta["particles"][0].tolist())).force0_r()
    g = scenes.scene_grid(parts, meta)
    pg = _grid_for(parts, REFERENCE_GRID, float(meta["box_width"]), r0, float(meta["box_height"]))
    assert tuple(g) == tuple(pg)
    kept, b, s = scenes.bucketize(parts, g)
    laid = bucketize_numpy(parts, pg)
    assert laid[b * g.cap + s].tobytes() == kept.tobytes()
    assert int((laid["ty"] >= 0).sum()) == len(kept)


def test_frozen_pair_count_and_bound_match_chip_smoke():
    sys.path.insert(0, os.path.dirname(cells.BENCH_DIR))
    import chip_smoke

    g = scenes.Grid(4, 4, 8)
    st, _, _ = scenes.dense_crystal(g, 4, 1e-14, "cpu")
    ty = st[4].clone()
    ty[3:6, 2:9, 5:] = -1  # a ragged occupancy
    from particle_simulator_tpu_torch.engine.state import ParticleState

    state = ParticleState(*st[:4], ty)
    counts = (ty >= 0).sum(-1)
    pairs = roofline.pairs_from_counts(counts)
    assert pairs == chip_smoke.bucket_pairs(state) > 0
    assert roofline.ops_bound_ms(pairs) == chip_smoke.ops_bound_ms(pairs)
    assert roofline.bound(12345678, 0.01) == chip_smoke.bound(12345678, 0.01)
    assert roofline.FORCE_LAW_COUNTS == chip_smoke.FORCE_LAW_COUNTS
    bucket = torch.nonzero(ty.reshape(-1) >= 0).reshape(-1) // g.cap
    assert torch.equal(roofline.counts_of(bucket, g.by, g.bx), counts)


def test_trace_reduction_counts_idle_edges_and_names_the_host():
    ms = 1_000_000
    ops = [(2 * ms, 5 * ms, "bucket_step_kernel<false>"), (4 * ms, 6 * ms, "copy"),
           (8 * ms, 9 * ms, "bucket_step_kernel<false>"), (9 * ms, 12 * ms, "late")]
    spans = [("read_frame", 6 * ms, 7 * ms)]
    red = trace.reduce(ops, 1 * ms, 10 * ms, spans)
    assert red["busy_s"] == pytest.approx(6e-3)  # [2, 6] and [8, 10]
    assert red["window_s"] == pytest.approx(9e-3)
    assert red["idle_pct"] == pytest.approx(100 / 3)
    gaps = dict(red["idle_gaps"])
    assert gaps["host in read_frame, device after copy"] == pytest.approx(2e-3)
    assert gaps["host in no harness span, device after window start"] == pytest.approx(1e-3)
    assert trace.kernel_mean_ms(red, ("bucket_step_kernel<false>",)) == pytest.approx(2.0)
    assert trace.kernel_mean_ms(red, ("absent",)) is None
    with pytest.raises(TypeError):
        trace.kernel_mean_ms(red, "bucket_step_kernel<false>")
    assert trace.short_name("void bucket_step_kernel<true>(int const*, int)") == \
        "bucket_step_kernel<true>"


def test_nojax_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "particle_simulator_tpu_torch_fake", sys)
    assert "particle_simulator_tpu_torch_fake" not in nojax.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in nojax.foreign_modules()


def test_run_refuses_without_enough_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "dense1m-frames", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
