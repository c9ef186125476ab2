"""Fixtures of the benchmark's own tests (``python -m pytest benchmark -q``).

``tiny_root`` is a copy of the benchmark in a temporary directory, beside a
``BENCHMARK.json`` of the same cells, with every configuration cut to a size
the CPU runs in seconds, so a test drives a whole run there with
``run.run_cell(..., device="cpu", root=tiny_root)``. Tests that need an
NVIDIA card take the ``card`` fixture, which decides while the test runs,
never at import.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

TINY = {
    "editor-lattice-1m": {"n_side": 24, "box_sides_r0": 24 * 1.1 / 0.5, "steps_per_frame": 20},
    "dense-crystal-1m": {"bx_log2": 3, "by_log2": 4, "steps_per_frame": 20},
    "dense-crystal-16m": {"bx_log2": 4, "by_log2": 4, "steps_per_frame": 20},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (run these on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the card tests run on the chip")
    return "cuda"


def build_tiny(root: str) -> str:
    dst = os.path.join(root, os.path.basename(HERE))
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("__pycache__", "test_*", "conftest.py"))
    for name, changes in TINY.items():
        path = os.path.join(dst, "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(changes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    path = os.path.join(dst, "traffic", "drag.json")
    with open(path) as f:
        drag = json.load(f)
    drag.update(edits_hz=20, warmup_s=1.0, trace_s=1.0)
    with open(path, "w") as f:
        json.dump(drag, f)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    # the resend and four-card cells, left out of BENCHMARK.json (their
    # host-bound runs spread past any bound), keep their runners and
    # readers under test
    bench["configs"].append({"name": "dense-crystal-16m", "source": "https://example.org",
                             "file": "benchmark/configs/dense-crystal-16m.json", "reduced": [],
                             "why": "test"})
    bench["workloads"] += [
        {"name": "user1m-resend", "config": "editor-lattice-1m", "traffic": "resend", "chips": 1,
         "why": "test"},
        {"name": "dense16m-4card-frames", "config": "dense-crystal-16m", "traffic": "frames",
         "chips": 4, "why": "test"}]
    next(m for m in bench["end_to_end"]
         if m["name"] == "particle_steps_per_s")["workloads"].append("dense16m-4card-frames")
    bench["end_to_end"].insert(-1, {"name": "scene_switch_ms", "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["user1m-resend"]})
    bench["per_layer"] += [
        {"name": "scene_load_ms.resend", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "simulator", "moves": "scene_switch_ms",
         "workloads": ["user1m-resend"]},
        {"name": "exchange_host_ms.4card", "unit": "ms", "better": "lower",
         "source": "program_counter", "layer": "frame schedule",
         "moves": "particle_steps_per_s", "workloads": ["dense16m-4card-frames"]}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return build_tiny(str(tmp_path))
