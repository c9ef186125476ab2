"""Whole runs of every cell at a tiny size on the CPU: sound, each is
``correct``; with a fault planted in the timed path underneath, none is.

Beside the benchmark's own cells, two join the tiny copy as files and
entries only (``conftest.py``): ``gas-compact-drag``, a served CompactArray
gas lattice on a stub reference (the all-pairs step, and the Simulator's
compact load and readback), and ``lattice-ext-drag``, the editor lattice on
a grid of two lane chunks (the ext-layout frame on the live tiles, the
served default on the card)."""

from __future__ import annotations

import hashlib
import os

import pytest
import torch

from psbench import cells, faults, refsim, scenes

import conftest
import run

EXTRA = {"gas-compact-drag": conftest.add_compact_cell,
         "lattice-ext-drag": conftest.add_ext_lattice_cell}
# what the daemon's load message says of the path each extra cell takes
PATH = {"gas-compact-drag": "compact capacity", "lattice-ext-drag": "lane_chunks 2"}
CELLS = ["user1m-serve-drag", "dense1m-frames", "user1m-resend", "dense16m-4card-frames",
         "lattice-ext-drag"]
FAULTS = [
    ("user1m-serve-drag", "step_identity"), ("user1m-serve-drag", "half_batch"),
    ("user1m-serve-drag", "altered_answer"),
    ("dense1m-frames", "step_identity"), ("dense1m-frames", "half_batch"),
    ("dense1m-frames", "altered_answer"),
    ("user1m-resend", "step_identity"), ("user1m-resend", "half_batch"),
    ("user1m-resend", "altered_answer"),
    ("dense16m-4card-frames", "step_identity"), ("dense16m-4card-frames", "half_batch"),
    ("dense16m-4card-frames", "no_exchange"), ("dense16m-4card-frames", "altered_answer"),
    ("gas-compact-drag", "step_identity"), ("gas-compact-drag", "half_batch"),
    ("gas-compact-drag", "altered_answer"),
    ("lattice-ext-drag", "step_identity"), ("lattice-ext-drag", "half_batch"),
]
SECONDS = {"user1m-serve-drag": 3.0, "user1m-resend": 5.0, "gas-compact-drag": 3.0,
           "lattice-ext-drag": 3.0}


def _root(tiny_root: str, workload: str) -> str:
    if workload in EXTRA:
        EXTRA[workload](tiny_root)
    return tiny_root


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny_root, workload):
    out = run.run_cell(workload, 2**31 + 3, SECONDS.get(workload, 1.0), False, "cpu",
                       root=_root(tiny_root, workload))
    assert out["correct"] is True, {k: c for k, c in out["checks"].items() if c["value"]}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


def _harness_files(root: str) -> dict:
    bench_dir = os.path.join(root, cells.NAME)
    paths = [os.path.join(bench_dir, name) for name in ("run.py", "daemon_child.py")]
    paths += [os.path.join(bench_dir, "psbench", n)
              for n in sorted(os.listdir(os.path.join(bench_dir, "psbench")))
              if n.endswith(".py")]
    out = {}
    for path in paths:
        with open(path, "rb") as f:
            out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_compact_array_scene_joins_as_files_and_entries(tiny_root):
    before = _harness_files(tiny_root)
    workload = conftest.add_compact_cell(tiny_root)
    assert _harness_files(tiny_root) == before
    out = run.run_cell(workload, 2**31 + 3, SECONDS[workload], False, "cpu", root=tiny_root)
    assert out["correct"] is True, {k: c for k, c in out["checks"].items() if c["value"]}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["snapshot_missing"]["value"] == 0
    with open(os.path.join(tiny_root, cells.NAME, "references", "snapshots.txt")) as f:
        assert f.read().split() == ["256", "256"]  # both snapshots decoded, every particle
    assert set(out["metrics"]) == {"served_fps", "setup_s"}


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(tiny_root, monkeypatch, workload,
                                                           fault):
    monkeypatch.setenv(faults.ENV, fault)
    out = run.run_cell(workload, 2**31 + 4, SECONDS.get(workload, 1.0), False, "cpu",
                       root=_root(tiny_root, workload))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    if workload in PATH:
        assert any(PATH[workload] in line for line in out["log_tail"]), out["log_tail"]


@pytest.mark.parametrize("fault", ["step_identity", "half_batch"])
@pytest.mark.parametrize("path", ["classic", "ext", "allpairs"])
def test_the_step_faults_reach_every_step_the_program_takes(path, fault):
    from particle_simulator_tpu_torch.engine.state import ParticleState
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda

    g = scenes.Grid(4, 4, 8)
    fields, meta, _ = scenes.dense_crystal(g, 11, 1e-14, "cpu")
    params = refsim.params_vector(meta, "cpu")
    if path == "allpairs":
        fields = tuple(a.reshape(-1) for a in fields)
    state = ParticleState(*fields)
    frame = {"classic": lambda s: bucket_cuda.run_frame_bucket_cuda(s, params, 1),
             "ext": lambda s: bucket_cuda.run_frame_bucket_cuda(s, params, 1, lane_chunks=2,
                                                                ext_io=True),
             "allpairs": lambda s: allpairs_cuda.run_frame_allpairs_cuda(s, params, 1)}[path]
    sound = frame(state)
    saved = faults.apply(fault)
    try:
        broken = frame(state)
    finally:
        faults.undo(saved)
    if path == "allpairs":
        live = torch.nonzero(state.ty >= 0).reshape(-1)
        lower, upper = live[:len(live) // 2], live[len(live) // 2:]
    else:
        lower, upper = slice(0, g.by // 2), slice(g.by // 2, None)
    for got, want, old in zip(broken[:4], sound[:4], state[:4]):
        assert not torch.equal(want[upper], old[upper])  # a step moves both halves
        assert torch.equal(got[upper], old[upper])
        assert torch.equal(got[lower], old[lower] if fault == "step_identity" else want[lower])
