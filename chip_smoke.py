#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (particle_simulator_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one result line; any failure raises and the script
exits non-zero without printing a result):

1. card: the device name and ``nvidia-smi`` name/power limit;
2. build: the three CUDA kernels compiled from ``ops/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs on the card (step: ``ty`` equal, x/y within 8 fixed-point units,
   live vx/vy within rtol 1e-4, atol 1e-6; dest and place: equal), on the
   dense 512x256x8 scene (1,036,320 particles) and a 16x16x16 scene with
   the cursor, bucket crossers, far drifters and overflow; kernel and plain
   times at the dense scene;
4. slice: the unchanged headless editor (a subprocess) sends a 1024x1024
   lattice (1,048,576 particles) over TCP and the port's ``serve`` ships 6
   frames back through the kernels; every frame must be finite and every
   kernel launched;
5. throughput: 100-step frames of ``run_frame_bucket_cuda`` on the dense
   scene, in sim-steps/s and particle-steps/s.

The last two lines are the kernels JSON line and the result line.
It exits non-zero when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

STEP_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:123"  # _step_kernel
DEST_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1228"  # _dest_kernel
PLACE_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1573"  # _place_kernel
CSRC = "particle_simulator_tpu_torch/ops/csrc"


def dense_grid_scene(cfg, fill: int = 8):
    """The bench scene, in numpy: every interior bucket holds ``fill``
    particles on a bucket-aligned hexagonal lattice at spacing r0 (1%
    jitter), cold (sigma 1 m/s), the outer bucket ring empty as a wall
    margin, dt = 10 fs. Returns (grid-ordered PARTICLE_DTYPE array, metadata
    record, live count)."""
    from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, MieParams, default_metadata

    meta = default_metadata()
    n = cfg.buckets * fill
    r0 = MieParams.nitrogen().force0_r()
    rows = 2 if fill <= 8 else 4
    cols = fill // rows
    d = r0
    box_w = float(cfg.bx * cols * d)
    box_h = float(cfg.by * rows * (np.sqrt(3.0) / 2.0) * d)
    meta["box_width"] = box_w
    meta["box_height"] = box_h
    meta["step_dt"] = 10e-15

    rng = np.random.default_rng(0)
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    gx, gy, gs = np.meshgrid(np.arange(cfg.bx), np.arange(cfg.by), np.arange(fill),
                             indexing="xy")
    gx, gy, gs = gx.ravel(), gy.ravel(), gs.ravel()
    ixg = gx * cols + gs % cols
    iyg = gy * rows + gs // cols
    px = (ixg + 0.5 * (iyg % 2) + 0.25) * d + rng.uniform(-0.01, 0.01, n) * d
    py = (iyg + 0.5) * (np.sqrt(3.0) / 2.0) * d + rng.uniform(-0.01, 0.01, n) * d
    parts["x"] = np.clip(px / box_w * 2**32, 0, 2**32 - 1).astype(np.uint64).astype(np.uint32)
    parts["y"] = np.clip(py / box_h * 2**32, 0, 2**32 - 1).astype(np.uint64).astype(np.uint32)
    parts["vx"] = rng.normal(0, 1.0, n).astype(np.float32)
    parts["vy"] = rng.normal(0, 1.0, n).astype(np.float32)
    parts["ty"] = 0
    interior = (gx > 0) & (gx < cfg.bx - 1) & (gy > 0) & (gy < cfg.by - 1)
    parts["ty"][~interior] = -1
    return parts, meta, int(np.count_nonzero(interior))


def stress_scene(cfg, seed: int = 1):
    """Every bucket of a CAP-16 grid holds 12 residents on 20 jittered
    lattice sites (5 x 4 sites at spacing r0, so no two particles come
    closer than ~0.9 r0); 70% of the other 8 sites receive a particle stored
    in another bucket: mostly a neighbour (a bucket crosser, and where more
    than 4 arrive, overflow), sometimes 2-3 buckets away (a far drifter,
    dropped by the move). The cursor covers the middle of the box.
    Returns (grid-ordered particles, metadata)."""
    from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, MieParams, default_metadata

    rng = np.random.default_rng(seed)
    by, bx, cap = cfg.grid_shape
    sx, sy, residents = 5, 4, 12
    r0 = MieParams.nitrogen().force0_r()
    meta = default_metadata()
    meta["box_width"] = bx * sx * r0
    meta["box_height"] = by * sy * r0
    meta["step_dt"] = 10e-15
    meta["cursor_pos"] = (0.5, 0.5)
    meta["cursor_size"] = 0.3

    def site(gy, gx, s):  # site s of bucket (gy, gx), in box fractions
        u = (gx * sx + s % sx + 0.5 + rng.uniform(-0.05, 0.05)) / (bx * sx)
        v = (gy * sy + s // sx + 0.5 + rng.uniform(-0.05, 0.05)) / (by * sy)
        return u, v

    u = np.zeros((by, bx, cap))
    v = np.zeros((by, bx, cap))
    ty = np.full((by, bx, cap), -1)
    holes = {}
    for gy in range(by):
        for gx in range(bx):
            perm = rng.permutation(sx * sy)
            for slot, s in enumerate(perm[:residents]):
                u[gy, gx, slot], v[gy, gx, slot] = site(gy, gx, s)
                ty[gy, gx, slot] = 0
            holes[gy, gx] = perm[residents:]
    near = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    far = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4) if max(abs(dy), abs(dx)) >= 2]
    for (gy, gx), hs in holes.items():
        for s in hs:
            if rng.random() > 0.7:
                continue
            pool = near if rng.random() < 0.85 else far
            dy, dx = pool[rng.integers(len(pool))]
            sy_, sx_ = gy + dy, gx + dx  # the bucket that stores it
            if not (0 <= sy_ < by and 0 <= sx_ < bx):
                continue
            free = np.flatnonzero(ty[sy_, sx_] < 0)
            if free.size == 0:
                continue
            slot = free[0]  # slots stay a prefix
            u[sy_, sx_, slot], v[sy_, sx_, slot] = site(gy, gx, s)
            ty[sy_, sx_, slot] = 0
    parts = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    parts["x"] = np.floor(u.ravel() * 2**32).astype(np.uint32)
    parts["y"] = np.floor(v.ravel() * 2**32).astype(np.uint32)
    parts["vx"] = rng.normal(0, 150, cfg.capacity).astype(np.float32)
    parts["vy"] = rng.normal(0, 150, cfg.capacity).astype(np.float32)
    parts["ty"] = ty.ravel()
    return parts, meta


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` in ms from CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_step(got, ref, label: str) -> float:
    """The step envelope; returns the largest live-velocity error."""
    import torch

    if not torch.equal(got.ty, ref.ty):
        raise AssertionError(f"{label}: step ty differs")
    live = ref.ty >= 0
    for name in ("x", "y"):
        d = (getattr(got, name) - getattr(ref, name)).abs().max().item()
        if d > 8:
            raise AssertionError(f"{label}: step {name} off by {d} fixed-point units")
    err = 0.0
    for name in ("vx", "vy"):
        g, r = getattr(got, name)[live], getattr(ref, name)[live]
        bad = (g - r).abs() > 1e-6 + 1e-4 * r.abs()
        if bad.any() or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: step {name} outside rtol 1e-4 atol 1e-6 "
                                 f"at {int(bad.sum())} slots")
        err = max(err, (g - r).abs().max().item())
    for name in ("x", "y", "vx", "vy"):
        if not torch.equal(getattr(got, name)[~live], getattr(ref, name)[~live]):
            raise AssertionError(f"{label}: step changed a tombstone's {name}")
    return err


def phase_kernels(device, dense_cfg, stress_cfg, reps: int):
    """Phase 3: each kernel against its plain version on the same inputs."""
    import torch

    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    results = {}
    scenes = {"dense": dense_grid_scene(dense_cfg)[:2], "stress": stress_scene(stress_cfg)}
    cfgs = {"dense": dense_cfg, "stress": stress_cfg}
    for label, (parts, meta) in scenes.items():
        cfg = cfgs[label]
        state = state_from_numpy(parts, cfg.capacity, device).reshape(cfg.grid_shape)
        pv = SimParams.from_record(meta).vector(device)

        step_err = check_step(bc.bucket_step_cuda(state, pv),
                              bucket.bucket_step(state, pv), label)
        dest = bc.move_dest_cuda(state)
        dest_ref = bucket.move_dest_direct(state)
        if not torch.equal(dest, dest_ref):
            raise AssertionError(f"{label}: dest ids differ at "
                                 f"{int((dest != dest_ref).sum())} slots")
        placed = bc.bucket_place_cuda(state, dest_ref)
        placed_ref = bucket.bucket_place(state, dest_ref)
        for name, a, b in zip(placed._fields, placed, placed_ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: place field {name} differs")
        kept = int((dest_ref >= 0).sum())
        live = int((state.ty >= 0).sum())
        line = {"scene": label, "grid": list(cfg.grid_shape), "live": live,
                "kept_by_move": kept, "step_max_abs_err_v": step_err}
        if label == "stress" and not (kept < live):
            raise AssertionError("stress scene: the move dropped nothing")
        if label == "dense":
            line["ms"] = {
                "step": cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps),
                "step_plain": cuda_ms(lambda: bucket.bucket_step(state, pv), reps),
                "dest": cuda_ms(lambda: bc.move_dest_cuda(state), reps),
                "dest_plain": cuda_ms(lambda: bucket.move_dest_direct(state), reps),
                "place": cuda_ms(lambda: bc.bucket_place_cuda(state, dest_ref), reps),
                "place_plain": cuda_ms(lambda: bucket.bucket_place(state, dest_ref), reps),
            }
        results[label] = line
        print("kernels: " + json.dumps(line), flush=True)
    return results


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_slice(device, lattice: str, frames: int, workdir: str):
    """Phase 4: the unchanged headless editor against the port's daemon."""
    from particle_simulator_tpu.io.transport import Disconnected, Reader
    from particle_simulator_tpu_torch.engine import daemon
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc

    port = _free_port()
    record = os.path.join(workdir, "slice_frames.bin")
    editor_log = os.path.join(workdir, "editor.log")
    cmd = [sys.executable, "-m", "particle_simulator_tpu.editor.headless",
           "--addr", f"127.0.0.1:{port}", "--lattice", lattice,
           "--distance-factor", "1.1", "--step-dt", "1e-14",
           "--frames", str(frames), "--timeout", "600"]
    sim = Simulator(device=device)
    with open(editor_log, "w") as log:
        editor = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            for k in bc.LAUNCHES:
                bc.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            shipped = daemon.serve(("127.0.0.1", port), sim, max_frames=frames,
                                   retry_s=120.0, record=record)
            serve_s = time.perf_counter() - t0
            launches = dict(bc.LAUNCHES)
            rc = editor.wait(timeout=300)
        finally:
            if editor.poll() is None:
                editor.kill()
                editor.wait()
    if rc != 0:
        with open(editor_log) as f:
            raise AssertionError(f"editor exited {rc}:\n{f.read()[-4000:]}")
    if shipped != frames:
        raise AssertionError(f"daemon shipped {shipped} of {frames} frames")
    if sim.active_kernel != ("bucket-cuda" if device.startswith("cuda") else "bucket-torch-cpu"):
        raise AssertionError(f"frames ran through {sim.active_kernel}")
    counts = []
    reader = Reader.open_file(record)
    try:
        for _ in range(frames):
            p = reader.read_blocking(timeout=120).particles
            for name in ("vx", "vy"):
                if not np.isfinite(p[name]).all():
                    raise AssertionError(f"shipped frame {len(counts)} has non-finite {name}")
            counts.append(len(p))
    except (Disconnected, TimeoutError):
        pass
    finally:
        reader.close()
    os.unlink(record)
    if len(counts) != frames:
        raise AssertionError(f"recorded {len(counts)} frames, expected {frames}")
    nx, ny = (int(v) for v in lattice.split("x"))
    if counts[0] != nx * ny:  # the echo of the scene the editor sent
        raise AssertionError(f"echoed {counts[0]} particles of {nx * ny}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    line = {"frames": frames, "particles": counts, "grid": list(sim.grid.grid_shape),
            "active_kernel": sim.active_kernel, "launches": launches,
            "serve_s": serve_s}
    print("slice: " + json.dumps(line), flush=True)
    return line


def phase_throughput(device, cfg, frames: int, steps: int):
    """Phase 5: frame rate of the kernel runner on the dense scene."""
    import torch

    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda

    parts, meta, live = dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity, device).reshape(cfg.grid_shape)
    pv = SimParams.from_record(meta).vector(device)
    state = run_frame_bucket_cuda(state, pv, steps, cfg.move_every)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state = run_frame_bucket_cuda(state, pv, steps, cfg.move_every)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    survivors = int((state.ty >= 0).sum())
    if not bool(torch.isfinite(state.vx[state.ty >= 0]).all()):
        raise AssertionError("throughput run produced non-finite velocities")
    rate = frames * steps / dt
    line = {"grid": list(cfg.grid_shape), "particles": live, "survivors": survivors,
            "frames": frames, "steps_per_frame": steps, "seconds": dt,
            "sim_steps_per_s": rate, "particle_steps_per_s": rate * live}
    print("throughput: " + json.dumps(line), flush=True)
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print("build: " + json.dumps({"seconds": time.perf_counter() - t0,
                                  "library": str(build.BUILD_DIR / build.LIB_NAME)}),
          flush=True)

    device = "cuda"
    dense_cfg = GridConfig(8, 9, 8)  # 512 rows x 256 columns x 8 slots, as bench.py
    kern = phase_kernels(device, dense_cfg, GridConfig(4, 4, 16), reps=20)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        sl = phase_slice(device, "1024x1024", 6, workdir)
    phase_throughput(device, dense_cfg, frames=5, steps=100)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    ms = kern["dense"]["ms"]
    err = max(kern["dense"]["step_max_abs_err_v"], kern["stress"]["step_max_abs_err_v"])
    kernels = [
        {"name": "bucket_step", "route": "cuda", "source": f"{CSRC}/bucket_step.cu",
         "replaces": STEP_KERNEL, "launches": sl["launches"]["step"],
         "max_abs_err": err, "ms": ms["step"], "plain_ms": ms["step_plain"]},
        {"name": "bucket_dest", "route": "cuda", "source": f"{CSRC}/bucket_dest.cu",
         "replaces": DEST_KERNEL, "launches": sl["launches"]["dest"],
         "max_abs_err": 0.0, "ms": ms["dest"], "plain_ms": ms["dest_plain"]},
        {"name": "bucket_place", "route": "cuda", "source": f"{CSRC}/bucket_place.cu",
         "replaces": PLACE_KERNEL, "launches": sl["launches"]["place"],
         "max_abs_err": 0.0, "ms": ms["place"], "plain_ms": ms["place_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
