"""Whole runs of every cell at a tiny size on the CPU: sound, each is
``correct``; with a fault planted in the timed path underneath, none is."""

from __future__ import annotations

import pytest

from psbench import faults

import run

CELLS = ["user1m-serve-drag", "dense1m-frames", "user1m-resend", "dense16m-4card-frames"]
FAULTS = [
    ("user1m-serve-drag", "step_identity"), ("user1m-serve-drag", "half_batch"),
    ("user1m-serve-drag", "altered_answer"),
    ("dense1m-frames", "step_identity"), ("dense1m-frames", "half_batch"),
    ("dense1m-frames", "altered_answer"),
    ("user1m-resend", "step_identity"), ("user1m-resend", "half_batch"),
    ("user1m-resend", "altered_answer"),
    ("dense16m-4card-frames", "step_identity"), ("dense16m-4card-frames", "half_batch"),
    ("dense16m-4card-frames", "no_exchange"), ("dense16m-4card-frames", "altered_answer"),
]
SECONDS = {"user1m-serve-drag": 3.0, "user1m-resend": 5.0}


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny_root, workload):
    out = run.run_cell(workload, 2**31 + 3, SECONDS.get(workload, 1.0), False, "cpu",
                       root=tiny_root)
    assert out["correct"] is True, {k: c for k, c in out["checks"].items() if c["value"]}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(tiny_root, monkeypatch, workload,
                                                           fault):
    monkeypatch.setenv(faults.ENV, fault)
    out = run.run_cell(workload, 2**31 + 4, SECONDS.get(workload, 1.0), False, "cpu",
                       root=tiny_root)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
