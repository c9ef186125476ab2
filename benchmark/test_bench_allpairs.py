"""The ``gas16k-serve`` cell at its configuration's CPU cut: a served
CompactArray gas lattice checked by ``references/allpairs.py``. A sound run
is ``correct`` with both snapshots decoded by that reference; each fault in
the all-pairs path makes it incorrect; the bfloat16 control fails its
comparison; its roofline reader reads the all-pairs kernel alone."""

from __future__ import annotations

import pytest

from psbench import cells, faults

import control
import run

WORKLOAD = "gas16k-serve"
SECONDS = 3.0


def test_a_sound_run_is_correct_with_both_snapshots_decoded(tiny_root, monkeypatch):
    decoded = []
    load = cells.reference

    def counting(config, root=cells.ROOT):
        ref = load(config, root)
        assert ref.__file__.endswith("allpairs.py")
        from_snapshot = ref.from_snapshot

        def spy(snap, *args):
            lay = from_snapshot(snap, *args)
            decoded.append(None if lay is None else int((lay.ty >= 0).sum()))
            return lay

        ref.from_snapshot = spy
        return ref

    monkeypatch.setattr(cells, "reference", counting)
    out = run.run_cell(WORKLOAD, 2**31 + 3, SECONDS, False, "cpu", root=tiny_root)
    assert out["correct"] is True, {k: c for k, c in out["checks"].items() if c["value"]}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert decoded == [256, 256]  # both snapshots, every particle of the 16 x 16 lattice
    assert set(out["metrics"]) == {"served_fps", "setup_s"}


@pytest.mark.parametrize("fault", ["step_identity", "half_batch", "altered_answer"])
def test_a_fault_in_the_all_pairs_path_makes_the_run_incorrect(tiny_root, monkeypatch, fault):
    monkeypatch.setenv(faults.ENV, fault)
    out = run.run_cell(WORKLOAD, 2**31 + 4, SECONDS, False, "cpu", root=tiny_root)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    assert any("compact capacity 1024" in line for line in out["log_tail"]), out["log_tail"]


def test_the_control_fails_the_comparison(tiny_root):
    reading = control.control_reading(WORKLOAD, 2**31 + 7, "cpu", root=tiny_root)
    assert reading["compared"] == 256
    assert reading["control_mismatch"] > reading["limit"] == 0


def test_the_roofline_reader_reads_the_all_pairs_kernel_alone():
    read = cells.reader("step_roofline_pct.allpairs")
    least = {"bound_ms": 0.4086}
    kernels = {"allpairs_step_kernel": [100, 0.7e6], "bucket_step_kernel<false>": [10, 0.2e6],
               "bucket_step_kernel_tiles<true>": [10, 0.1e6]}
    assert read({"trace": {"kernels": kernels}, "step_least": least}) == \
        pytest.approx(100 * 0.4086 / 0.7)
    del kernels["allpairs_step_kernel"]
    assert read({"trace": {"kernels": kernels}, "step_least": least}) is None
    assert read({"trace": None, "step_least": least}) is None
    served = cells.reader("step_roofline_pct.serve")
    assert served({"trace": {"kernels": {"allpairs_step_kernel": [100, 0.7e6]}},
                   "step_least": least}) is None
