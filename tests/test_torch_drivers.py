"""The port's config scripts (``scripts/torch_*.py``) on the CPU at tiny sizes.

Each script's record function runs with ``torch_device="cpu"`` (the plain
PyTorch versions) and its JSON keys are held against the JAX script's, read
from the JAX script's source (the JAX scripts run full-size scenes only, so
they are not run here). At these sizes the numbers mean nothing physically:
a 16x16 lattice lies on buckets narrower than the force range. The physics
is checked at full size on the card (``chip_smoke.py`` phases 15-17). Config
5's script starts the port's web editor and daemon as processes of their
own, the daemon on the CPU (``chip_smoke.py`` phase 21 runs it on the card).
"""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))

import torch_bench_configs  # noqa: E402
import torch_interactive_1m_chip  # noqa: E402
import torch_phase_sweep_chip  # noqa: E402
import torch_soak_leapfrog_1e6  # noqa: E402

from particle_simulator_tpu.scenes.order import OrderParams as JOrderParams  # noqa: E402
from particle_simulator_tpu_torch.scenes.order import OrderParams  # noqa: E402

torch.set_num_threads(2)


def json_keys(script: str, marker: str) -> set:
    """The keys of the record a JAX script prints: the string keys of the
    dict literal in ``script`` that holds ``marker`` as a key or a value
    (the largest such), plus the keys assigned to ``rec[...]`` afterwards. A
    ``**op.as_dict()`` entry stands for the OrderParams fields."""
    tree = ast.parse((SCRIPTS / script).read_text())
    best = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
        values = {v.value for v in node.values if isinstance(v, ast.Constant)}
        if marker in keys | values and len(keys) > len(best):
            best = set(keys)
            if any(k is None for k in node.keys):
                best |= {f.name for f in dataclasses.fields(JOrderParams)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "rec"):
            best.add(node.targets[0].slice.value)
    return best


BENCH_KEYS = json_keys("bench_configs.py", "particle-steps/sec/chip")


@pytest.mark.parametrize("num, scene, kernel, structure", [
    (1, "liquid-droplet-2k", "allpairs-torch-cpu", "COMPACT_ARRAY"),
    (2, "gas-diffusion-16k", "allpairs-torch-cpu", "COMPACT_ARRAY"),
    (3, "solid-crystal-64k", "bucket-torch-cpu", "MATRIX_BUCKETS"),
])
def test_bench_config_record(num, scene, kernel, structure):
    import chip_smoke

    hold = chip_smoke.KernelHold()
    rec = torch_bench_configs.bench_config(num, frames=2, steps=3, torch_device="cpu", n_side=12,
                                           inspect=hold)
    # the state as loaded and after the warm-up and the two timed frames
    assert [h["at"] for h in hold.held] == [f"config {num} as loaded",
                                            f"config {num} after 3 frames"]
    assert all(h["live"] == 144 and len(h["shape"]) == (3 if num == 3 else 1)
               for h in hold.held)
    bucket_only = {"grid", "lane_chunks"}
    assert set(rec) == (BENCH_KEYS if num == 3 else BENCH_KEYS - bucket_only)
    assert bucket_only <= BENCH_KEYS
    assert (rec["config"], rec["scene"], rec["kernel"], rec["data_structure"]) == (
        num, scene, kernel, structure)
    assert rec["device"] == "cpu" and rec["particles"] == rec["live_after"] == 144
    assert rec["frames"] == 2 and rec["steps_per_frame"] == 3
    assert rec["value"] == pytest.approx(144 * rec["sim_steps_per_sec"], rel=0.05)
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 60e6, abs=1e-4)
    json.dumps(rec)


def test_bench_main_prints_one_line_per_config(capsys):
    rc = torch_bench_configs.main(["--configs", "1", "3", "--frames", "1", "--steps", "2",
                                   "--n-side", "8", "--torch-device", "cpu"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [rec["config"] for rec in lines] == [1, 3]  # no card line on the CPU


def test_bench_config_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_bench_configs.bench_config(1, frames=1, steps=1, n_side=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_soak_leapfrog_1e6.soak(steps=10, check_every=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_phase_sweep_chip.phase_sweep(n_side=4, steps_scale=0.0001)


SWEEP_EXTRA = {"particles", "grid", "elapsed_s", "kernel", "device"}


def test_phase_sweep_records_and_verdict(tmp_path, monkeypatch):
    """Three records and the verdict's six checks at n_side 16 and a step
    budget of 5 / 15 / 100 steps in 5-step frames; the GIF holds the
    snapshots (one of the solid's single frame, three and four of the
    others)."""
    emitted, seen = [], []
    gif = tmp_path / "sweep.gif"
    monkeypatch.setattr(torch_phase_sweep_chip, "STEPS_PER_FRAME", 5)
    records, verdict = torch_phase_sweep_chip.phase_sweep(
        n_side=16, steps_scale=0.0005, device=1, torch_device="cpu", gif=str(gif), size=32,
        emit=emitted.append,
        inspect=lambda label, state, pv: seen.append((label, tuple(state.x.shape), pv.shape)))
    assert [label for label, _, _ in seen] == [
        "solid as loaded", "solid after 1 frames", "liquid as loaded", "liquid after 3 frames",
        "gas as loaded", "gas after 20 frames"]
    assert all(len(shape) == 3 and pshape == (10,) for _, shape, pshape in seen)
    assert emitted == records and [r["phase"] for r in records] == ["solid", "liquid", "gas"]
    jax_keys = json_keys("phase_sweep_chip.py", "phase")
    assert {f.name for f in dataclasses.fields(OrderParams)} <= jax_keys
    for rec, (label, speed, steps, _, dt) in zip(records, torch_phase_sweep_chip.PHASES):
        assert set(rec) == jax_keys | SWEEP_EXTRA
        assert (rec["initial_speed"], rec["dt"]) == (speed, dt)
        assert rec["steps"] == max(1, int(steps * 0.0005) // 5) * 5
        assert rec["particles"] == 256 and rec["n"] <= 256
        assert rec["kernel"] == "bucket-torch-cpu" and rec["device"] == "cpu"
        assert np.isfinite(rec["mean_speed"])
    assert [r["steps"] for r in records] == [5, 15, 100]
    assert set(verdict) == json_keys("phase_sweep_chip.py", "phase-sweep-256k")
    assert verdict["metric"] == "phase-sweep-256k"
    assert set(verdict["checks"]) == json_keys("phase_sweep_chip.py", "solid_is_hexatic")
    assert len(verdict["checks"]) == 6 and verdict["ok"] == all(verdict["checks"].values())
    import chip_smoke

    assert chip_smoke.gif_shape(gif) == (32, 32, 1 + 3 + 4)


def test_phase_sweep_phases_and_checks_are_the_jax_scripts():
    tree = ast.parse((SCRIPTS / "phase_sweep_chip.py").read_text())
    phases = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                  if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "PHASES")
    assert torch_phase_sweep_chip.PHASES == phases

    def op(psi6, nbrs, occ):
        return OrderParams(1, psi6, nbrs, occ, 0.0)

    good = torch_phase_sweep_chip.phase_checks(op(0.99, 5.98, 0.22), op(0.63, 4.2, 0.84),
                                               op(0.57, 1.37, 1.0))
    assert all(good.values()) and len(good) == 6
    bad = torch_phase_sweep_chip.phase_checks(op(0.5, 7.5, 0.6), op(0.45, 2.0, 0.84),
                                              op(0.57, 1.6, 1.0))
    assert not any(bad.values())


def test_phase_sweep_main_exit_code_follows_the_verdict(capsys, monkeypatch):
    seen = {}

    def fake(*args, emit=None, **kwargs):
        seen["args"] = args
        emit({"phase": "solid"})
        return [{"phase": "solid"}], {"metric": "phase-sweep-256k", "ok": seen["ok"], "checks": {}}

    monkeypatch.setattr(torch_phase_sweep_chip, "phase_sweep", fake)
    for ok, rc in ((True, 0), (False, 1)):
        seen["ok"] = ok
        assert torch_phase_sweep_chip.main(["--torch-device", "cpu", "--n-side", "16",
                                            "--steps-scale", "0.01"]) == rc
        out = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert out[0] == {"phase": "solid"} and out[1]["ok"] is ok
    assert seen["args"][:4] == (16, 0.01, None, "cpu")


def test_soak_record():
    seen = []
    rec = torch_soak_leapfrog_1e6.soak(
        steps=300, check_every=100, torch_device="cpu", progress=False,
        inspect=lambda label, state, pv: seen.append((label, tuple(state.x.shape))))
    assert seen == [("soak at the start", (8, 8, 16)), ("soak after 300 steps", (8, 8, 16))]
    assert set(rec) == json_keys("soak_leapfrog_1e6.py", "sim_time_ns")
    assert rec["ok"] and rec["metric"] == "leapfrog-1e6-soak" and rec["device"] == "cpu"
    assert rec["steps"] == 300 and rec["live_start"] == rec["live_end"] == 64
    assert rec["sim_time_ns"] == pytest.approx(0.003) and rec["dt_fs"] == pytest.approx(10.0)
    assert 0 <= rec["final_energy_drift"] <= rec["worst_energy_drift"] < 0.05


def test_soak_reports_an_explosion(monkeypatch):
    """A non-finite energy ends the soak with the JAX script's failure
    record; ``main`` then exits 1."""
    from particle_simulator_tpu_torch.physics import oracle

    calls = []

    def energy(parts, meta):
        calls.append(len(parts))
        return 1e-19 if len(calls) < 3 else float("nan")

    monkeypatch.setattr(oracle, "total_energy", energy)
    rec = torch_soak_leapfrog_1e6.soak(steps=30, check_every=10, torch_device="cpu")
    assert rec == {"metric": "leapfrog-1e6-soak", "ok": False, "exploded_at_step": 20}
    assert set(rec) == json_keys("soak_leapfrog_1e6.py", "exploded_at_step")
    calls.clear()
    assert torch_soak_leapfrog_1e6.main(["--steps", "30", "--check-every", "10",
                                         "--torch-device", "cpu"]) == 1


CONFIG5_KEYS = json_keys("interactive_1m_chip.py", "interactive-editor-1m")


def test_interactive_script_prints_the_jax_keys(tmp_path, capsys, monkeypatch):
    """``--n-side 32 --seconds 2 --torch-device cpu`` (one step a frame, so
    that the plain versions ship frames inside the window): the JAX script's
    result keys and events, both children stopped, neither importing jax or
    the JAX package."""
    from particle_simulator_tpu_torch.utils.log import FOREIGN_MODULES_TAG

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = torch_interactive_1m_chip.main(["--n-side", "32", "--seconds", "2", "--torch-device",
                                         "cpu", "--steps-per-frame", "1",
                                         "--log-dir", str(tmp_path)])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    events, rec = lines[:-1], lines[-1]  # no card line on the CPU
    assert [e["event"] for e in events] == ["memory", "first_frames"]
    assert set(events[1]) == {"event", "wait_s", "stats"}
    assert set(rec) == CONFIG5_KEYS and len(CONFIG5_KEYS) == 15
    assert rec["metric"] == "interactive-editor-1m" and rec["particles"] == 32 * 32
    assert rec["engine_frames"] > 0 and rec["fetch_errors"] == 0 and rec["steps_per_frame"] == 1
    assert rec["device"] == "CPU Thread Pool" and rec["limiter"] in ("engine", "frame.bin-fetch")
    for log, who in (("daemon.log", "engine"), ("webview.log", "editor UI")):
        text = (tmp_path / log).read_text()
        assert f"{who}: {FOREIGN_MODULES_TAG}[]" in text.splitlines(), text[-2000:]


def test_interactive_script_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_interactive_1m_chip.record(seconds=1, n_side=4, log_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())  # raised before starting anything
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_interactive_1m_chip.main(["--n-side", "4", "--seconds", "1"])


def test_cpu_seconds_reads_a_process_and_refuses_a_missing_one():
    import os

    spent = torch_interactive_1m_chip.cpu_seconds(os.getpid())
    assert spent is not None and spent > 0
    assert torch_interactive_1m_chip.cpu_seconds(2**22 + 12345) is None
