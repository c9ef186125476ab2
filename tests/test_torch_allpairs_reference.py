"""The port's served CompactArray frames against the benchmark's plain
all-pairs reference (``benchmark/references/allpairs.py``), bit for bit, and
the Simulator's all-pairs counters.

The reference is plain PyTorch written from the CompactArray semantics and
imports nothing of the port; it decides the ``gas16k-serve`` cell's
``correct`` on the card. Here, on the CPU, the port's ``Simulator``
(CompactArray, ``device="cpu"``: the plain all-pairs step) and the
reference step the same seeded scenes in 20-step frames, and every live
particle's 20 bytes must agree: the reference rounds each f32 operation as
the port does and adds the pair terms in the same segmented order, so the
comparison is exact, as on the card. The bfloat16 control must fail it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.engine.state import state_from_numpy
from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, DataStructure, Frame
from particle_simulator_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
REFERENCE = os.path.join(BENCH, "references", "allpairs.py")
CONFIG = os.path.join(BENCH, "configs", "gas-diffusion-16k.json")
SEED = 2**31 + 181
STEPS = 20


def _reference():
    sys.path.insert(0, BENCH)  # the reference imports ``psbench``
    try:
        spec = importlib.util.spec_from_file_location("allpairs_reference", REFERENCE)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(BENCH)
    return module


def _config(n_side: int = 16) -> dict:
    """The gas configuration at its CPU cut, its lattice ``n_side`` a side
    and 70% of the box."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(cfg.pop("cpu_cut"))
    cfg.update(n_side=n_side, box_sides_r0=n_side * 2.5 / 0.7)
    return cfg


def _loaded_sim(parts, meta) -> Simulator:
    sim = Simulator(device="cpu")
    sim.load_frame(Frame.from_particles(meta, parts.astype(PARTICLE_DTYPE)))
    return sim


def _served(sim: Simulator) -> np.ndarray:
    sim.frame_async()
    return sim.read_frame().particles


def _differing(a: np.ndarray, b: np.ndarray) -> int:
    """Particles whose 20 bytes differ, plus the difference of the counts."""
    n = min(len(a), len(b))
    va = np.ascontiguousarray(a[:n]).view(np.uint32).reshape(n, 5)
    vb = np.ascontiguousarray(b[:n]).view(np.uint32).reshape(n, 5)
    return int((va != vb).any(axis=1).sum()) + abs(len(a) - len(b))


@pytest.mark.parametrize("case", ["gas lattice", "tombstones between segments", "cursor on"])
def test_served_compact_frames_equal_the_reference_bit_for_bit(case):
    ref = _reference()
    n_side = 18 if case == "tombstones between segments" else 16
    cfg = _config(n_side)
    parts, meta = ref.draw(cfg, SEED, 0, 24 if case == "tombstones between segments" else 0)
    sim = _loaded_sim(parts, meta)
    lay = ref.loaded(parts, meta, "cpu")
    assert ref.pack(lay).tobytes() == sim.read_frame().particles.tobytes()
    if case == "tombstones between segments":
        # 300 live particles at seeded slots of a 512-slot state: four
        # segments of 128 sources, each holding tombstones between live slots
        index = np.sort(np.random.default_rng(SEED).choice(512, size=len(parts), replace=False))
        full = np.zeros(512, dtype=PARTICLE_DTYPE)
        full["ty"] = -1
        full[index] = parts
        sim.state = state_from_numpy(full, 512)
        snap = {n: parts[n] for n in PARTICLE_DTYPE.names}
        snap.update(index=index, data_structure=np.array(int(sim.data_structure)))
        lay = ref.from_snapshot(snap, parts, meta, "cpu")
        assert len(parts) == 300 and index.max() > 3 * 128
    if case == "cursor on":
        meta = meta.copy()
        meta["cursor_pos"], meta["cursor_size"] = (0.47, 0.52), 0.3
        sim.update_metadata(Frame.from_metadata(meta))
    for _ in range(2):
        got = _served(sim)
        lay = ref.frame(lay, meta, STEPS, "cpu")
        assert _differing(ref.pack(lay), got) == 0
        assert len(got) == len(parts)
    if case == "cursor on":
        # the cursor pushed particles: the frame differs from one without it
        meta["cursor_pos"] = (-1.0, -1.0)
        far = ref.frame(ref.loaded(parts, meta, "cpu"), meta, 2 * STEPS, "cpu")
        assert _differing(ref.pack(far), got) > 0


def test_the_bfloat16_control_differs_from_the_port_on_most_particles():
    ref = _reference()
    parts, meta = ref.draw(_config(), SEED + 1, 0, 0)
    got = _served(_loaded_sim(parts, meta))
    control = ref.pack(ref.frame(ref.loaded(parts, meta, "cpu"), meta, STEPS, "cpu", low=True))
    assert _differing(control, got) > 0.9 * len(parts)


def test_the_reference_loads_nothing_of_jax_or_of_the_port():
    code = f"""
import importlib.util, json, sys
sys.path.insert(0, {BENCH!r})
spec = importlib.util.spec_from_file_location("allpairs_reference", {REFERENCE!r})
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
cfg = {{"n_side": 4, "distance_factor": 2.5, "box_sides_r0": 14.3, "velocity": [0, 400],
        "step_dt": 1e-14, "steps_per_frame": 2}}
parts, meta = ref.draw(cfg, 3, 0, 0)
ref.pack(ref.frame(ref.loaded(parts, meta, "cpu"), meta, 2, "cpu"))
from psbench import nojax
tops = set(nojax.FORBIDDEN) | {{"particle_simulator_tpu_torch"}}
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in tops)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=BENCH, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_allpairs_counters_count_compact_frames_only(monkeypatch):
    """Each CompactArray frame counts ``frame.allpairs`` once and
    ``allpairs.swept_pairs`` slots^2 x steps (1024 slots: 256 live padded by
    ``compact_capacity``); a MatrixBuckets frame counts neither; with
    recording off nothing is kept."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    ref = _reference()
    parts, meta = ref.draw(_config(), SEED, 0, 0)
    meta["steps_per_frame"] = 3
    sim = _loaded_sim(parts, meta)
    assert sim.state.x.shape == (1024,)
    sim.frame_async()
    assert profiling.export()["counters"] == {}
    with profiling.recording():
        for _ in range(2):
            sim.frame_async()
        buckets = meta.copy()
        buckets["data_structure"] = int(DataStructure.MATRIX_BUCKETS)
        bsim = _loaded_sim(parts, buckets)
        bsim.frame_async()
    assert bsim.active_kernel == "bucket-torch-cpu" and sim.active_kernel == "allpairs-torch-cpu"
    counters = profiling.export()["counters"]
    assert counters == {"frame.allpairs": 2, "allpairs.swept_pairs": 2 * 1024 * 1024 * 3}
