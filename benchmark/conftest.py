"""Fixtures of the benchmark's own tests (``python -m pytest benchmark -q``).

``tiny_root`` is a copy of the benchmark in a temporary directory, beside a
``BENCHMARK.json`` of the same cells, with every configuration cut to a size
the CPU runs in seconds (the changes its file lists under ``cpu_cut``, which
the harness never reads), so a test drives a whole run there with
``run.run_cell(..., device="cpu", root=tiny_root)``. Tests that need an
NVIDIA card take the ``card`` fixture, which decides while the test runs,
never at import.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


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
    shutil.copytree(HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*", "conftest.py"))
    for path in glob.glob(os.path.join(dst, "configs", "*.json")):
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(cfg.pop("cpu_cut", {}))
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


def _add_cell(root: str, config: dict, workload: str, stub: str | None = None) -> str:
    """Write ``config`` into the copy at ``root`` (and ``stub`` as the
    reference it names), and a ``drag`` cell ``workload`` of it with the
    served cell's metrics, into its ``BENCHMARK.json`` alone."""
    bench_dir = os.path.join(root, os.path.basename(HERE))
    with open(os.path.join(bench_dir, "configs", config["name"] + ".json"), "w") as f:
        json.dump(config, f)
    if stub is not None:
        with open(os.path.join(bench_dir, "references", config["reference"] + ".py"), "w") as f:
            f.write(stub)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config["name"], "source": "https://example.org",
                             "file": f"{os.path.basename(HERE)}/configs/{config['name']}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": workload, "config": config["name"], "traffic": "drag",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "user1m-serve-drag" in m.get("workloads", ()):
            m["workloads"].append(workload)
    with open(path, "w") as f:
        json.dump(bench, f)
    return workload


# A stand-in reference of the CompactArray layout, for the harness's own
# tests: the port's plain all-pairs frame, which a benchmark's reference
# may not import. It proves only that a layout joins as files; it appends
# a line to ``snapshots.txt`` beside itself for each snapshot it decodes.
COMPACT_STUB = '''"""CompactArray: the live particles in slot order, stepped all pairs."""

import os

from psbench import roofline, scenes, wire
from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
from particle_simulator_tpu_torch.physics import step


def draw(cfg, seed, k, drop):
    parts, meta = scenes.hex_lattice(cfg, [seed, k], drop=drop)
    meta["data_structure"] = wire.COMPACT_ARRAY
    return parts, meta


def loaded(parts, meta, device):
    live = parts[parts["ty"] >= 0]
    return state_from_numpy(live, len(live), device)


def frame(state, meta, steps, device, low=False):
    if low:
        raise NotImplementedError("the stub has no control")
    return step.run_frame(state, SimParams.from_record(meta).vector(device), steps)


def pack(state):
    return wire.from_fields({n: a.cpu().numpy() for n, a in zip(wire.PARTICLE_DTYPE.names,
                                                                 state)})


def from_snapshot(snap, parts, meta, device):
    if int(snap["data_structure"]) != wire.COMPACT_ARRAY:
        return None
    with open(os.path.join(os.path.dirname(__file__), "snapshots.txt"), "a") as f:
        f.write(f"{len(snap['x'])}\\n")
    return loaded(wire.from_fields(snap), meta, device)


def least(state):
    n = int((state.ty >= 0).sum())
    return roofline.step_least_ms(n * (n - 1), n)
'''


def add_compact_cell(root: str, n_side: int = 16, steps_per_frame: int = 20) -> str:
    """A served CompactArray gas lattice (``scenes/library.py:gas_diffusion``
    of the port: 2.5 r0 apart, 0-400 m/s, the lattice 70% of the box side)
    as a cell ``gas-compact-drag`` of the copy at ``root``, on the stub
    reference ``compact_stub``."""
    config = {"name": "gas-compact", "reference": "compact_stub", "n_side": n_side,
              "distance_factor": 2.5, "box_sides_r0": n_side * 2.5 / 0.7,
              "velocity": [0.0, 400.0], "step_dt": 1e-14, "steps_per_frame": steps_per_frame,
              "data_structure": "CompactArray"}
    return _add_cell(root, config, "gas-compact-drag", COMPACT_STUB)


def add_ext_lattice_cell(root: str) -> str:
    """The tiny editor lattice in a box wide enough that the engine's grid
    (128x128x16) splits into two lane chunks, so that the served frame is the
    ext-layout frame on the live tiles, as at 1M on the card: a cell
    ``lattice-ext-drag`` of the copy at ``root``. The plain versions take
    ~1.5 s a step of that grid, so a frame is two steps: a step, the
    rebucket and a step."""
    with open(os.path.join(root, os.path.basename(HERE), "configs",
                           "editor-lattice-1m.json")) as f:
        config = json.load(f)
    config.update(name="editor-lattice-ext", box_sides_r0=300.0, steps_per_frame=2)
    return _add_cell(root, config, "lattice-ext-drag")


@pytest.fixture
def tiny_root(tmp_path):
    return build_tiny(str(tmp_path))
