#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (particle_simulator_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one result line; any failure raises and the script
exits non-zero without printing a result):

1. card: the device name and ``nvidia-smi`` name/power limit;
2. build: the four CUDA kernels compiled from ``ops/csrc`` with nvcc, one
   process per source; the all-pairs kernel's main loop counted in its SASS
   (``cuobjdump -sass``), which sets the arithmetic bounds;
3. kernels: each bucket kernel against its plain PyTorch version on the
   same inputs on the card (step: ``ty`` equal, x/y within 8 fixed-point
   units, live vx/vy within rtol 1e-4, atol 1e-6; dest and place: equal), on
   the dense 512x256x8 scene (1,036,320 particles) and a 16x16x16 scene with
   the cursor, bucket crossers, far drifters and overflow; kernel, plain and
   library-call times at the dense scene;
4. slice: the unchanged headless editor (a subprocess) sends a 1024x1024
   lattice (1,048,576 particles) over TCP and the port's ``serve`` ships 6
   frames back through the bucket kernels; every frame must be finite and
   every kernel launched;
5. throughput: 100-step frames of ``run_frame_bucket_cuda`` on the dense
   scene, in sim-steps/s and particle-steps/s;
6. all-pairs kernel against its plain version (the step envelope) on the
   gas-diffusion scene (16,384 live, 16,384 slots) and on the liquid droplet
   with the cursor on (2,025 live, 2,048 slots: tombstones and a ragged
   last tile); kernel and plain times at 16,384;
7. CompactArray slice: this script plays the editor with the port's own
   TCP server; ``serve`` runs the gas-diffusion scene as CompactArray for at
   least 6 frames of 100 steps through the all-pairs kernel, then a
   metadata-only frame switches it live to MatrixBuckets and at least 3
   more frames come back through the bucket kernels; every frame finite,
   the echoed data structure right on each side, every kernel launched;
8. all-pairs throughput: 100-step frames of ``run_frame_allpairs_cuda`` at
   16,384, in sim-steps/s and pair evaluations/s.

The last three lines are the card's ``nvidia-smi`` line, the kernels JSON
line and the result line. It exits non-zero when
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

STEP_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:123"  # _step_kernel
DEST_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1228"  # _dest_kernel
PLACE_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1573"  # _place_kernel
ALLPAIRS_KERNEL = "particle_simulator_tpu/ops/allpairs_pallas.py:44"  # _allpairs_kernel
CSRC = "particle_simulator_tpu_torch/ops/csrc"

# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): 3.35 TB/s
# of device memory and 67 TFLOP/s of f32 outside the tensor cores. An SM
# issues 128 f32 lanes a clock (an FFMA counts two FLOPs), and 16 lanes a
# clock of the multi-function unit (MUFU: ex2, lg2, rcp) and of the slow
# conversions (I2F, F2I, F2F).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
MUFU_INSTR_PER_S = FP32_INSTR_PER_S / 8
_FP32_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSET", "FSETP", "FRND", "FCHK",
             "I2FP", "F2FP"}
_MUFU_OPS = {"MUFU", "I2F", "F2I", "F2F"}


def dense_grid_scene(cfg, fill: int = 8):
    """The bench scene, in numpy: every interior bucket holds ``fill``
    particles on a bucket-aligned hexagonal lattice at spacing r0 (1%
    jitter), cold (sigma 1 m/s), the outer bucket ring empty as a wall
    margin, dt = 10 fs. Returns (grid-ordered PARTICLE_DTYPE array, metadata
    record, live count)."""
    from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, MieParams, default_metadata

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
    from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, MieParams, default_metadata

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
    """Mean device time of ``fn`` in ms from CUDA events, after one warm-up
    call. A spin kernel (``torch.cuda._sleep``) ahead of the start event
    keeps the card busy while the host enqueues the ``reps`` calls, so the
    window holds the device's work back to back and no host launch gaps: a
    small kernel runs in about the time its Python wrapper takes to
    enqueue it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    torch.cuda._sleep(int(min(4e9, (1.5 * reps * one_s + 1e-3) * 2e9)))  # ~2e9 cycles/s
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


def sass_pair_counts(lib_path, kernel: str, pairs_per_iter: int) -> dict:
    """Instructions per pair of ``kernel``'s main loop in the built library:
    the innermost loop of its SASS (``cuobjdump -sass``) with the most
    ``MUFU.EX2``, its f32-pipe and MUFU-pipe instructions counted and
    divided by the pairs one iteration evaluates."""
    from particle_simulator_tpu_torch.ops.build import find_nvcc

    cuobjdump = str(Path(find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    loop = main_loop_sass(sass, kernel)
    fp32 = sum(op.split(".")[0] in _FP32_OPS for op in loop)
    mufu = sum(op.split(".")[0] in _MUFU_OPS for op in loop)
    return {"loop_instructions": len(loop), "pairs_per_iter": pairs_per_iter,
            "fp32_per_pair": fp32 / pairs_per_iter, "mufu_per_pair": mufu / pairs_per_iter}


def main_loop_sass(sass: str, kernel: str) -> list[str]:
    """The opcodes (with modifiers) of the innermost loop with the most
    ``MUFU.EX2`` in the SASS of the function whose name contains
    ``kernel``. A loop is a backward branch and the instructions from its
    target to it; branch targets are addresses or ``.L_x_N`` labels."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        raise AssertionError(f"no function named like {kernel} in the SASS")
    insts, labels, pending = [], {}, []
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        text = re.sub(r"^@!?U?P(?:T|\d+)\s+", "", m.group(2).strip())
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, text.split()[0], text))
    loops = []
    for addr, op, text in insts:
        if op.split(".")[0] != "BRA":
            continue
        t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", text)
        if not t:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is not None and target <= addr:
            loops.append((target, addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    bodies = [[op for addr, op, _ in insts if a <= addr <= b] for a, b in inner]
    bodies = [b for b in bodies if "MUFU.EX2" in b]
    if not bodies:
        raise AssertionError(f"no loop with MUFU.EX2 in the SASS of {kernel}")
    return max(bodies, key=lambda b: b.count("MUFU.EX2"))


def ops_bound_ms(pairs: int, sass: dict) -> float:
    """The least time of ``pairs`` pair evaluations: the busier of the f32
    and MUFU pipes at the card's published rate."""
    return 1e3 * pairs * max(sass["fp32_per_pair"] / FP32_INSTR_PER_S,
                             sass["mufu_per_pair"] / MUFU_INSTR_PER_S)


def bound(nbytes: int, ops_ms: float = 0.0) -> dict:
    """``bound_ms`` (the larger of the byte time and the operation time)
    and ``bound_by``."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def bucket_pairs(state) -> int:
    """Pair evaluations of one bucket step on this state: live receivers
    times their live 3x3-neighbourhood candidates, self excluded."""
    import torch

    from particle_simulator_tpu_torch.physics import bucket

    nbr = bucket.gather_neighborhood(state)
    live_j = (nbr.ty >= 0).sum(-1, dtype=torch.int64)  # (BY, BX): the same for a bucket's slots
    live_i = (state.ty >= 0).to(torch.int64)
    return int((live_i * (live_j[..., None] - 1)).sum())


def phase_kernels(device, dense_cfg, stress_cfg, reps: int, sass: dict):
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
            lib_place, lib_place_ms = place_library_call(state, dest_ref, reps)
            if not torch.equal(lib_place, torch.stack(
                    [a.reshape(-1).view(torch.int32) for a in placed_ref], 1)):
                raise AssertionError("index_copy disagrees with the place kernel")
            slots = state.capacity
            pairs = bucket_pairs(state)
            line["pairs_per_step"] = pairs
            line["ms"] = {
                "step": cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps),
                "step_plain": cuda_ms(lambda: bucket.bucket_step(state, pv), reps),
                "dest": cuda_ms(lambda: bc.move_dest_cuda(state), reps),
                "dest_plain": cuda_ms(lambda: bucket.move_dest_direct(state), reps),
                "place": cuda_ms(lambda: bc.bucket_place_cuda(state, dest_ref), reps),
                "place_plain": cuda_ms(lambda: bucket.bucket_place(state, dest_ref), reps),
                "place_library": lib_place_ms,
            }
            # each input read once, each output written once: step reads 20
            # B a slot and writes 16 (x, y, vx, vy); dest reads x, y, ty and
            # writes an id; place reads 24 B and writes 20. The step's pair
            # math is the all-pairs kernel's, so its SASS counts per pair
            # bound the step too.
            line["bounds"] = {
                "step": bound(36 * slots, ops_bound_ms(pairs, sass)),
                "dest": bound(16 * slots),
                "place": bound(44 * slots),
            }
        results[label] = line
        print("kernels: " + json.dumps(line), flush=True)
    return results


def place_library_call(state, destid, reps: int, timer=cuda_ms):
    """The place function as one PyTorch call: ``torch.index_copy`` of the
    kept particles' five fields (bit patterns, one int32 row each) into a
    tombstone-filled table. Packing the rows is not timed. Returns the
    (slots, 5) table and its time in ms."""
    import torch

    src = destid.reshape(-1) >= 0
    idx = destid.reshape(-1)[src].long()
    rows = torch.stack([a.reshape(-1).view(torch.int32) for a in state], 1)[src]
    fill = torch.tensor([0, 0, 0, 0, -1], dtype=torch.int32, device=rows.device)
    tombs = fill.expand(state.capacity, 5).contiguous()
    return (torch.index_copy(tombs, 0, idx, rows),
            timer(lambda: torch.index_copy(tombs, 0, idx, rows), reps))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_slice(device, lattice: str, frames: int, workdir: str):
    """Phase 4: the unchanged headless editor against the port's daemon."""
    from particle_simulator_tpu_torch.io.transport import Disconnected, Reader
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


def compact_state(frame, device):
    """A scene laid out as the Simulator's CompactArray: live particles
    first, then tombstones up to ``max(1024, pow2 >= live)`` slots."""
    from particle_simulator_tpu_torch.engine.simulator import compact_capacity
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy

    parts = frame.particles
    live = parts[parts["ty"] >= 0]
    state = state_from_numpy(live, compact_capacity(len(live)), device)
    return state, SimParams.from_record(frame.metadata.copy()).vector(device), len(live)


def phase_allpairs_kernel(device, reps: int, sass: dict):
    """Phase 6: the all-pairs kernel against its plain version."""
    import torch

    from particle_simulator_tpu_torch.ops.allpairs_cuda import allpairs_step_cuda
    from particle_simulator_tpu_torch.physics.step import allpairs_step
    from particle_simulator_tpu_torch.scenes.library import gas_diffusion, liquid_droplet

    droplet = liquid_droplet()
    droplet.metadata.cursor_pos = (0.5, 0.5)
    droplet.metadata.cursor_size = 0.3
    results = {}
    for label, frame in (("gas_diffusion", gas_diffusion()), ("liquid_droplet_cursor", droplet)):
        state, pv, live = compact_state(frame, device)
        got = allpairs_step_cuda(state, pv)
        ref = allpairs_step(state, pv)
        err = check_step(got, ref, label)
        line = {"scene": label, "live": live, "slots": state.capacity,
                "max_abs_err_v": err,
                "bit_identical": all(torch.equal(a, b) for a, b in zip(got, ref))}
        if label == "gas_diffusion":
            pairs = live * (live - 1)
            line["pairs_per_step"] = pairs
            line["ms"] = {
                "kernel": cuda_ms(lambda: allpairs_step_cuda(state, pv), reps),
                "plain": cuda_ms(lambda: allpairs_step(state, pv), 1),
            }
            line["bound"] = bound(36 * state.capacity, ops_bound_ms(pairs, sass))
            line["library_ms"] = None
            line["library"] = ("none: no single PyTorch call computes Mie pair forces "
                               "(torch.cdist gives only the distances)")
        results[label] = line
        print("allpairs: " + json.dumps(line), flush=True)
    return results


def _accept(server, timeout: float):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        conn = server.try_accept()
        if conn:
            return conn
        time.sleep(0.005)
    raise AssertionError("the engine never connected")


def phase_compact_slice(device, compact_frames: int, bucket_frames: int):
    """Phase 7: the gas-diffusion scene served as CompactArray through the
    all-pairs kernel, then switched live to MatrixBuckets. This script is
    the editor, on the port's own TCP server."""
    from particle_simulator_tpu_torch.engine import daemon
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.io.frame import DataStructure, Frame
    from particle_simulator_tpu_torch.io.transport import new_tcp_server
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda
    from particle_simulator_tpu_torch.scenes.library import gas_diffusion

    scene = gas_diffusion()
    scene.metadata.data_structure = DataStructure.COMPACT_ARRAY
    n = scene.particle_count
    sim = Simulator(device=device)
    server = new_tcp_server(("127.0.0.1", 0))
    served = {}

    def engine():
        served["frames"] = daemon.serve(("127.0.0.1", server.addr[1]), sim, retry_s=60.0)

    counters = (allpairs_cuda.LAUNCHES, bucket_cuda.LAUNCHES)
    for launches in counters:
        for k in launches:
            launches[k] = 0
    t0 = time.perf_counter()
    thread = threading.Thread(target=engine, daemon=True)
    thread.start()
    reader, writer = _accept(server, 120.0)
    frames, kernels, arrivals = [], [], []
    try:
        if not writer.write(scene):
            raise AssertionError("the scene did not reach the engine")

        def take(ds, count):
            """Read until ``count`` frames of ``ds`` arrived."""
            got = 0
            while got < count:
                f = reader.read_blocking(timeout=300)
                arrivals.append(time.perf_counter())
                p = f.particles
                for name in ("vx", "vy"):
                    if not np.isfinite(p[name]).all():
                        raise AssertionError(f"frame {len(frames)} has non-finite {name}")
                frames.append((f.metadata.data_structure.name, f.particle_count))
                if f.metadata.data_structure == ds:
                    got += 1
            return f

        echo = take(DataStructure.COMPACT_ARRAY, 1)
        if echo.particles.tobytes() != scene.particles.tobytes():
            raise AssertionError("the CompactArray echo is not the scene, slot for slot")
        take(DataStructure.COMPACT_ARRAY, compact_frames)
        kernels.append(sim.active_kernel)
        switch = Frame.new()
        switch.header["metadata"] = scene.metadata.copy()
        switch.metadata.data_structure = DataStructure.MATRIX_BUCKETS
        if not writer.write(switch):
            raise AssertionError("the switch did not reach the engine")
        switch_t = time.perf_counter()
        take(DataStructure.MATRIX_BUCKETS, bucket_frames)
        kernels.append(sim.active_kernel)
    finally:
        reader.close()
        writer.close()
        server.close()
        thread.join(timeout=300)
    serve_s = time.perf_counter() - t0
    if thread.is_alive():
        raise AssertionError("the engine did not stop after the editor closed")
    launches = {**counters[0], **counters[1]}
    compact = [c for ds, c in frames if ds == "COMPACT_ARRAY"]
    if any(c != n for c in compact):
        raise AssertionError(f"CompactArray frames lost particles: {compact}")
    if [ds for ds, _ in frames[len(compact):]].count("COMPACT_ARRAY"):
        raise AssertionError("a CompactArray frame came after the switch")
    if kernels != ["allpairs-cuda", "bucket-cuda"]:
        raise AssertionError(f"frames ran through {kernels}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on this path: {launches}")
    # the editor's view: the period between stepped CompactArray frames, and
    # the time from sending the switch to the first MatrixBuckets frame
    # (frames already in flight come first)
    periods = np.diff(arrivals[1:len(compact)]) * 1e3
    line = {"scene": "gas_diffusion", "particles": n, "frames": frames,
            "compact_frames_stepped": len(compact) - 1, "active_kernels": kernels,
            "launches": launches, "serve_s": serve_s,
            "compact_frame_period_ms": {"median": float(np.median(periods)),
                                        "max": float(periods.max()),
                                        "all": [round(float(v), 3) for v in periods]},
            "switch_to_first_bucket_frame_s": arrivals[len(compact)] - switch_t}
    print("compact slice: " + json.dumps(line), flush=True)
    return line


def phase_allpairs_throughput(device, frames: int, steps: int):
    """Phase 8: frame rate of the all-pairs kernel runner at 16,384."""
    import torch

    from particle_simulator_tpu_torch.ops.allpairs_cuda import run_frame_allpairs_cuda
    from particle_simulator_tpu_torch.scenes.library import gas_diffusion

    state, pv, live = compact_state(gas_diffusion(), device)
    state = run_frame_allpairs_cuda(state, pv, steps)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state = run_frame_allpairs_cuda(state, pv, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(state.vx[state.ty >= 0]).all()):
        raise AssertionError("all-pairs throughput run produced non-finite velocities")
    rate = frames * steps / dt
    line = {"scene": "gas_diffusion", "particles": live, "frames": frames,
            "steps_per_frame": steps, "seconds": dt, "sim_steps_per_s": rate,
            "pair_evaluations_per_s": rate * live * (live - 1)}
    print("allpairs throughput: " + json.dumps(line), flush=True)
    return line


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bnd,
                 library_ms):
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms}


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

    # 2. build, and the all-pairs kernel's SASS
    t0 = time.perf_counter()
    lib = build.library()
    build_s = time.perf_counter() - t0
    lib_path = build.BUILD_DIR / build.LIB_NAME
    sass = sass_pair_counts(lib_path, "allpairs_step_kernel", lib.ps_allpairs_pairs_per_iter())
    ptxas = [ln.strip() for ln in (build.BUILD_DIR / build.BUILD_LOG).read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print("build: " + json.dumps({"seconds": build_s, "library": str(lib_path),
                                  "sass_allpairs_main_loop": sass, "ptxas": ptxas}),
          flush=True)

    device = "cuda"
    dense_cfg = GridConfig(8, 9, 8)  # 512 rows x 256 columns x 8 slots, as bench.py
    kern = phase_kernels(device, dense_cfg, GridConfig(4, 4, 16), reps=20, sass=sass)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        sl = phase_slice(device, "1024x1024", 6, workdir)
    phase_throughput(device, dense_cfg, frames=5, steps=100)
    ap = phase_allpairs_kernel(device, reps=20, sass=sass)
    cs = phase_compact_slice(device, compact_frames=6, bucket_frames=3)
    phase_allpairs_throughput(device, frames=5, steps=100)

    if "jax" in sys.modules or any(m.split(".")[0] == "particle_simulator_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    ms, bnd = kern["dense"]["ms"], kern["dense"]["bounds"]
    err = max(kern["dense"]["step_max_abs_err_v"], kern["stress"]["step_max_abs_err_v"])
    gas = ap["gas_diffusion"]
    ap_err = max(line["max_abs_err_v"] for line in ap.values())
    kernels = [
        kernel_entry("bucket_step", "bucket_step.cu", STEP_KERNEL, sl["launches"]["step"],
                     err, ms["step"], ms["step_plain"], bnd["step"], None),
        kernel_entry("bucket_dest", "bucket_dest.cu", DEST_KERNEL, sl["launches"]["dest"],
                     0.0, ms["dest"], ms["dest_plain"], bnd["dest"], None),
        kernel_entry("bucket_place", "bucket_place.cu", PLACE_KERNEL, sl["launches"]["place"],
                     0.0, ms["place"], ms["place_plain"], bnd["place"], ms["place_library"]),
        kernel_entry("allpairs_step", "allpairs_step.cu", ALLPAIRS_KERNEL,
                     cs["launches"]["allpairs"], ap_err, gas["ms"]["kernel"],
                     gas["ms"]["plain"], gas["bound"], gas["library_ms"]),
    ]
    print("library calls: bucket_step, bucket_dest, allpairs_step none (no single PyTorch "
          "call computes the Mie step, the pull-order rank or the all-pairs forces); "
          "bucket_place torch.index_copy into a tombstone table", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
