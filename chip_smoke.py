#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (particle_simulator_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one result line; any failure raises and the script
exits non-zero without printing a result):

1. card: the device name and ``nvidia-smi`` name/power limit;
2. build: the CUDA kernels compiled from ``ops/csrc`` with nvcc, one
   process per source; the pair loops of the all-pairs, the tile-scheduled
   and the classic step kernels counted in their SASS (``cuobjdump -sass``)
   and every kernel's ``ptxas`` figures (registers, spills, static shared
   memory), as information: the arithmetic bounds use the frozen per-pair
   counts of the force law (``FORCE_LAW_COUNTS``), so they do not move with
   a kernel's code;
3. kernels: each bucket kernel against its plain PyTorch version on the
   same inputs on the card (step, dest and place: every field and slot
   equal), on the dense 512x256x8 scene (1,036,320 particles) and a 16x16x16
   scene with the cursor, bucket crossers, far drifters and overflow; kernel,
   plain and library-call times at the dense scene; then the classic and
   halo step and dest on small random grids of other shapes
   (``STEP_DEST_GEOMETRIES``: caps 6, 8, 12, 64, sides no sub-tile divides,
   stacks of 1 to 4 shards, moves that drop particles) against their plain
   versions, bit for bit;
4. slice: the unchanged headless editor (a subprocess) sends a 1024x1024
   lattice (1,048,576 particles) over TCP and the port's ``serve`` ships 6
   frames back through the bucket kernels; every frame must be finite and
   every kernel launched;
5. throughput: 100-step frames of ``run_frame_bucket_cuda`` on the dense
   scene, in sim-steps/s and particle-steps/s;
6. all-pairs kernel against its plain version (the step envelope) on the
   gas-diffusion scene (16,384 live, 16,384 slots) and on the liquid droplet
   with the cursor on (2,025 live, 2,048 slots: tombstones), and on the
   first 5,000 particles of the gas scene (not a multiple of the sum's
   segment length: a ragged last segment with live sources) and on 37
   slots (30 live); kernel and plain times at 16,384, the kernel's at 2,048;
7. CompactArray slice: this script plays the editor with the port's own
   TCP server; ``serve`` runs the gas-diffusion scene as CompactArray for at
   least 6 frames of 100 steps through the all-pairs kernel, then a
   metadata-only frame switches it live to MatrixBuckets and at least 3
   more frames come back through the bucket kernels; every frame finite,
   the echoed data structure right on each side, every kernel launched;
8. all-pairs throughput: 100-step frames of ``run_frame_allpairs_cuda`` at
   16,384, in sim-steps/s and pair evaluations/s;
9. halo kernels: the step, dest and place in their halo modes against their
   plain versions (bit-identical), on the block of four halo-padded shards
   of a (2, 2) split of the dense scene (4 x 258 x 130 x 8) and of the
   stress scene (crossers migrate in from the ring); kernel, plain and
   library-call times on the dense block;
10. sharded frame: three 100-step frames of the dense scene on a (2, 2)
    mesh of four shards on the one card, bit-identical to
    ``run_frame_bucket_cuda`` (ty everywhere, x/y/vx/vy on live slots);
    frame times of both runners, in turns, the host's time to enqueue one
    frame of each, and the device's busy share over two frames of each
    (``torch.profiler``);
11. mesh slice: the 1024x1024 editor lattice served through
    ``Simulator(mesh=make_mesh(devices=[cuda:0] * 4))`` to the unchanged
    headless editor: frame period median and p90 at the daemon's wire
    writes, every halo kernel launched and no single-device bucket kernel;
    the same serve on one device for comparison; then the device's busy
    share over a steady window (from the third frame on) of a profiled
    serve of each;
12. ext kernels: the tile-scheduled step (``bucket_step_ext_cuda``, every
    tile and live tiles only) against its plain versions and the classic
    CUDA step, bit for bit on every field over two steps on one buffer
    pair, on the 1M user scene of ``bench.py --user-scene`` (1024x1024x16,
    8 lane chunks, 8-row tiles) and the stress scene (2 chunks); on the
    user scene the classic, every-tile and live-tiles step times, the plain
    versions', the per-chunk aux and buffer-pair times, the rebucket's
    time, the bound, the time of moving every slot's bytes once, and the
    live-tile share; the step times again on the state four classic frames
    later (omax 8); then both modes on small random grids of other shapes
    (``EXT_GEOMETRIES``: caps 6, 8, 12, 64, 16-row and 4-row tiles,
    one-bucket tiles) against the classic CUDA step; the classic step and
    the dest against their plain versions on both scenes, the dest's time
    on the user scene, and the classic step's, the dest's and both tile
    modes' times on the editor's 1024x1024 lattice (a 512x512x16 grid);
13. ext frame: three 100-step frames of the user scene through
    ``run_frame_bucket_cuda(ext_io=True)`` in both modes, bit-identical to
    the classic frame on every slot; the frame time of each runner (5 in
    turns, with omax and the live-tile share after each compact one), the
    host's time to enqueue one frame of each and the device's busy share
    over two frames of each; the readback check: a ticket started on frame k of a
    Simulator serving with PS_EXT_IO=compact reads the bytes of a copy
    taken before frame k+1, whose run left the held state unchanged;
14. ext slice: the 1024x1024 editor lattice served as in phase 4 with
    PS_EXT_IO=compact, nocompact and off: frames finite, the runner and
    its kernels launched, the frame period; then a profiled serve of each
    for the busy share.

On a machine with more than one card, phases 10 and 11 run once more on a
mesh of every card, one shard a card.

The last three lines are the card's ``nvidia-smi`` line, the kernels JSON
line and the result line. It exits non-zero when
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import contextlib
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
# the halo modes, by their pl.pallas_call sites
STEP_HALO_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:750"  # edge_rows/halo_cols
DEST_HALO_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1536"  # _dest_kernel(halo=True)
PLACE_HALO_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:2143"  # _place_edge_kernel
HALO_KERNELS = ("step_halo", "dest_halo", "place_halo")
# the ext-layout step: _step_kernel with out_off=0 at its pallas_call (compact=False),
# and _step_kernel_compact (compact=True, its pallas_call at :1079)
EXT_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:1103"
COMPACT_KERNEL = "particle_simulator_tpu/ops/bucket_pallas.py:936"
CSRC = "particle_simulator_tpu_torch/ops/csrc"

# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): 3.35 TB/s
# of device memory and 67 TFLOP/s of f32 outside the tensor cores. An SM
# issues 128 f32 lanes a clock (an FFMA counts two FLOPs), and 16 lanes a
# clock of the multi-function unit (MUFU: ex2, lg2, rcp) and of the slow
# conversions (I2F, F2I, F2F).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
MUFU_INSTR_PER_S = FP32_INSTR_PER_S / 8
# The force law's instructions per pair on the two pipes, frozen: counted in
# the SASS of allpairs_step_kernel's main loop (4 pairs an iteration) as
# built from commit ef05cf4 for sm_90a and read on an NVIDIA H100 80GB HBM3
# (309 instructions an iteration, 204 of them on the f32 pipe, 8 MUFU.EX2).
# Every step kernel's operation bound is pairs times these over the card's
# rates, whatever loop implements the pairs.
FORCE_LAW_COUNTS = {"fp32_per_pair": 51.0, "mufu_per_pair": 2.0}
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


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, spill_stores,
    spill_loads, smem}}, a template instance named like ``kernel<1>``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            found = re.findall(r"\d+([a-z_]+_kernel)(?:ILb([01])E)?", entry.group(1))
            name = (found[-1][0] + (f"<{found[-1][1]}>" if found[-1][1] else "")
                    if found else entry.group(1))
            out[name] = {}
        elif name is not None:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            used = re.search(r"Used (\d+) registers", line)
            if spills:
                out[name].update(spill_stores=int(spills.group(1)),
                                 spill_loads=int(spills.group(2)))
            if used:
                smem = re.search(r"(\d+) bytes smem", line)
                out[name].update(registers=int(used.group(1)),
                                 smem=int(smem.group(1)) if smem else 0)
                name = None
    return out


def ops_bound_ms(pairs: int, sass: dict = FORCE_LAW_COUNTS) -> float:
    """The least time of ``pairs`` pair evaluations: the busier of the f32
    and MUFU pipes at the card's published rate, from the per-pair counts
    ``sass`` (the frozen ``FORCE_LAW_COUNTS``)."""
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
    times their live 3x3-neighbourhood candidates, self excluded, from the
    per-bucket live counts."""
    import torch

    live = (state.ty >= 0).sum(-1, dtype=torch.int64)  # (BY, BX)
    by, bx = live.shape
    padded = torch.zeros((by + 2, bx + 2), dtype=torch.int64, device=live.device)
    padded[1:-1, 1:-1] = live
    nbr = sum(padded[dy:dy + by, dx:dx + bx] for dy in range(3) for dx in range(3))
    return int((live * (nbr - 1)).sum())


def live_tile_share(aux) -> float:
    """The share of an ``ExtStepAux``'s tiles that hold a live slot."""
    return float(aux.flags.float().mean())


def ext_bound(state, sass: dict) -> dict:
    """The bound of one step of a sparse grid, the same for the classic and
    the tile-scheduled step: the live slots' 20 bytes read and 16 written,
    and the live pairs' operations. Dead slots are work the data does not
    need."""
    import torch

    live = int((state.ty >= 0).sum(dtype=torch.int64))
    return bound(36 * live, ops_bound_ms(bucket_pairs(state), sass))


def halo_pairs(padded) -> int:
    """Pair evaluations of one halo step on this stack of padded shards:
    live interior receivers times their live 3x3-neighbourhood candidates,
    ring included, self excluded."""
    import torch

    from particle_simulator_tpu_torch.physics import bucket

    live_j = (bucket.stack9(padded).ty >= 0).sum(-1, dtype=torch.int64)
    live_i = (bucket.interior(padded).ty >= 0).to(torch.int64)
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

        stepped, stepped_ref = bc.bucket_step_cuda(state, pv), bucket.bucket_step(state, pv)
        step_err = check_step(stepped, stepped_ref, label)
        same_state(stepped, stepped_ref, f"{label}: the step against its plain version")
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
                "kept_by_move": kept, "step_max_abs_err_v": step_err,
                "step_bit_identical": True}
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
    print("step and dest geometries: " + json.dumps(step_dest_geometry_sweep(device)),
          flush=True)
    return results


# Grids of other shapes than the scenes': a 3-tuple is one (gy, gx, cap) grid
# for the classic step and dest (sides powers of two: a bucket is the top
# bits of a coordinate), a 4-tuple a stack of halo-padded shards (n, LY+2,
# LX+2, cap) for their halo modes, whose sides are free.
STEP_DEST_GEOMETRIES = (
    (4, 4, 6),        # smaller than a sub-tile; cap no multiple of 4: scalar copies
    (2, 32, 8),       # two sub-tiles across, two rows
    (32, 4, 12),      # four sub-tiles down; cap a multiple of 4, no power of two
    (16, 16, 64),     # cap 64 narrows the sub-tile to fit shared memory: a cut last column
    (16, 64, 16),     # 2 x 4 whole sub-tiles
    (1, 5, 7, 6),     # one shard, 3 x 5 interior buckets
    (3, 19, 33, 8),   # 17 x 31 interior: 3 x 2 sub-tiles, the last row and column cut
    (2, 3, 3, 12),    # one interior bucket: the ring strips are all but it
    (4, 10, 18, 64),  # four shards; the narrowed sub-tile
    (2, 11, 35, 16),  # 9 x 33 interior: a last row of 1 and a last column of 1
)


def drift_grid(shape, seed: int, density: float = 0.8, drift: float = 1.3):
    """A random (gy, gx, cap) grid or (n, LY+2, LX+2, cap) stack of padded
    shards on the CPU for the sweep: every bucket filled to a random slot
    prefix (binomial, ``density`` of cap, so some buckets are full and
    targets overflow), a fifth of the filled slots tombstoned again, one
    corner of every grid dead, each particle placed up to ``drift`` bucket
    widths from its bucket (crossers, and far drifters the move drops),
    thermal velocities. The shards lie at random offsets of a 64 x 64 global
    grid, the first at (0, 0), so its ring is outside the box. Returns
    (ParticleState, bx_log2, by_log2, offsets or None)."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState

    rng = np.random.default_rng(seed)
    *lead, gy, gx, cap = shape
    if lead:
        bx_log2 = by_log2 = 6
        n = lead[0]
        offsets = np.stack([rng.integers(0, 64 - (gy - 2) + 1, n),
                            rng.integers(0, 64 - (gx - 2) + 1, n)], 1).astype(np.int32)
        offsets[0] = 0
        rows = offsets[:, 0, None, None, None] + np.arange(-1, gy - 1)[None, :, None, None]
        cols = offsets[:, 1, None, None, None] + np.arange(-1, gx - 1)[None, None, :, None]
    else:
        by_log2, bx_log2 = gy.bit_length() - 1, gx.bit_length() - 1
        offsets = None
        rows, cols = np.arange(gy)[:, None, None], np.arange(gx)[None, :, None]
    occ = np.arange(cap) < rng.binomial(cap, density, shape[:-1])[..., None]
    occ &= rng.random(shape) > 0.2
    occ[..., : gy // 2, : gx // 2, :] = False

    def coord(index, log2):
        pos = (index + rng.uniform(-drift, 1 + drift, shape)) * 2.0 ** (32 - log2)
        return (np.floor(pos).astype(np.int64) % 2**32).astype(np.uint32).view(np.int32)

    fields = (coord(cols, bx_log2), coord(rows, by_log2),
              rng.normal(0, 50, shape).astype(np.float32),
              rng.normal(0, 50, shape).astype(np.float32),
              np.where(occ, 0, -1).astype(np.int32))
    state = ParticleState(*(torch.from_numpy(np.ascontiguousarray(a)) for a in fields))
    return state, bx_log2, by_log2, None if offsets is None else torch.from_numpy(offsets)


def step_dest_geometry_sweep(device) -> list:
    """The classic and halo step and dest on ``STEP_DEST_GEOMETRIES``: two
    steps and the dest of each, bit for bit against their plain versions;
    over the sweep the move must drop live particles and pull ring
    particles in."""
    import torch

    from particle_simulator_tpu_torch.engine.state import SimParams
    from particle_simulator_tpu_torch.io.frame import default_metadata
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    meta = default_metadata()
    meta["step_dt"] = 10e-15
    pv = SimParams.from_record(meta).vector(device)
    lines = []
    for seed, shape in enumerate(STEP_DEST_GEOMETRIES):
        state, bx_log2, by_log2, offsets = drift_grid(shape, seed)
        state = state.to(device)
        halo = offsets is not None
        if halo:
            offsets = offsets.to(device)
            step, step_ref = bc.bucket_step_halo_cuda, bucket.bucket_step_halo
            dest = bc.move_dest_halo_cuda(state, bx_log2, by_log2, offsets)
            dest_ref = bucket.move_dest_direct_halo(state, bx_log2, by_log2, offsets)
            receivers = bucket.interior(state).ty >= 0
            kept = dest_ref[..., 1:-1, 1:-1, :] >= 0
        else:
            step, step_ref = bc.bucket_step_cuda, bucket.bucket_step
            dest, dest_ref = bc.move_dest_cuda(state), bucket.move_dest_direct(state)
            receivers, kept = state.ty >= 0, dest_ref >= 0
        got, ref = state, state
        for k in range(2):
            got, ref = step(got, pv), step_ref(ref, pv)
            same_state(got, ref, f"{shape} step {k} against its plain version")
        if not torch.equal(dest, dest_ref):
            raise AssertionError(f"{shape}: dest ids differ at "
                                 f"{int((dest != dest_ref).sum())} slots")
        ring_kept = int((dest_ref >= 0).sum()) - int(kept.sum())
        lines.append({"shape": list(shape), "halo": halo, "receivers": int(receivers.sum()),
                      "dropped_by_move": int((receivers & ~kept).sum()),
                      "pulled_in_from_ring": ring_kept})
    if not all(any(ln["dropped_by_move"] for ln in lines if ln["halo"] == h) for h in (0, 1)):
        raise AssertionError(f"the sweep's moves dropped nothing: {lines}")
    if not any(ln["pulled_in_from_ring"] for ln in lines):
        raise AssertionError(f"the sweep pulled no ring particle in: {lines}")
    return lines


def place_library_call(state, destid, reps: int, timer=cuda_ms, out_grid=None):
    """The place function as one PyTorch call: ``torch.index_copy`` of the
    kept particles' five fields (bit patterns, one int32 row each) into a
    tombstone-filled table. For a stack of halo-padded shards, ``out_grid``
    is each shard's interior shape and a shard's ids are offset by its
    place in the stack. Packing the rows is not timed. Returns the
    (output slots, 5) table and its time in ms."""
    import torch

    out_grid = tuple(state.x.shape[-3:]) if out_grid is None else tuple(out_grid)
    n_out = int(np.prod(out_grid))
    n_src = int(np.prod(state.x.shape[-3:]))
    n_grids = state.capacity // n_src
    d = destid.reshape(n_grids, n_src)
    src = d >= 0
    base = torch.arange(n_grids, device=d.device)[:, None] * n_out
    idx = (d.long() + base)[src]
    rows = torch.stack([a.reshape(n_grids, n_src).view(torch.int32) for a in state], -1)[src]
    fill = torch.tensor([0, 0, 0, 0, -1], dtype=torch.int32, device=rows.device)
    tombs = fill.expand(n_grids * n_out, 5).contiguous()
    return (torch.index_copy(tombs, 0, idx, rows),
            timer(lambda: torch.index_copy(tombs, 0, idx, rows), reps))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def ship_times():
    """The host time of every frame the port's daemon writes to the wire,
    appended to the yielded list while the context is open."""
    from particle_simulator_tpu_torch.engine import daemon

    times = []
    original = daemon.Frontend.__dict__["connect_tcp"]

    class Timed(daemon.Frontend):
        def write(self, frame):
            super().write(frame)
            times.append(time.perf_counter())

    def connect_timed(addr, retry_s=0.0, native=False):
        inner = original.__func__(addr, retry_s=retry_s, native=native)
        return Timed(inner.reader, inner.writer, verbose=inner.verbose)

    daemon.Frontend.connect_tcp = staticmethod(connect_timed)
    try:
        yield times
    finally:
        daemon.Frontend.connect_tcp = original


def enqueue_ms(runner) -> float:
    """Host time to enqueue one frame on an idle card (least of 3)."""
    import torch

    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return best


def device_busy(fn, window_kernel: str | None = None, skip: int = 0):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only); return (its
    result, ``busy_summary`` of the device operations it recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    ops = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    return result, busy_summary(ops, window_kernel, skip)


def busy_summary(ops, window_kernel: str | None = None, skip: int = 0):
    """Device operations (start us, end us, name) -> a dict: the device's
    busy share of the window (a kernel, copy or fill running), its idle ms
    after the operations that most often precede a gap, and its busy ms by
    operation name; None without operations. The window is the span from
    the first to the last operation, or, with ``window_kernel``, from the
    start of the ``skip``-th launch of the kernel whose name holds it to the
    end of its last launch (a steady window past the scene load)."""
    ops = sorted(ops)
    if not ops:
        return None
    lo, hi = ops[0][0], max(end for _, end, _ in ops)
    if window_kernel is not None:
        marks = [(start, end) for start, end, name in ops if window_kernel in name]
        if len(marks) > skip:
            lo, hi = marks[skip][0], marks[-1][1]
    busy, idle_after, by_name = 0.0, {}, {}
    cur_start = cur_end = last = None
    for start, end, name in ops:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
                idle_after[last] = idle_after.get(last, 0.0) + (start - cur_end) / 1e3
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        if end >= cur_end:
            last = name
    busy += cur_end - cur_start
    top = sorted(idle_after.items(), key=lambda kv: -kv[1])[:4]
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_share": busy / max(hi - lo, 1e-9), "window_ms": (hi - lo) / 1e3,
            "idle_ms_after": {k[:60]: round(v, 4) for k, v in top},
            "busy_ms_by_op": {k[:60]: round(v, 4) for k, v in names}}


# PS_EXT_IO -> the one-device slice's runner and the kernels of its path
SLICE_PATHS = {"off": ("bucket", ("step", "dest", "place")),
               "nocompact": ("bucket-ext", ("step_ext", "dest", "place")),
               "compact": ("bucket-compact", ("step_compact", "dest", "place"))}


def phase_slice(device, lattice: str, frames: int, workdir: str, mesh=None,
                profile: bool = False, ext_io: str = "off"):
    """Phases 4, 11 and 14: the unchanged headless editor against the port's
    daemon, on one device or sharded over ``mesh``, with ``PS_EXT_IO`` set
    to ``ext_io``; with ``profile``, the device's busy share over the
    serve."""
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
    sim = Simulator(device=device, mesh=mesh)

    def serve():
        return daemon.serve(("127.0.0.1", port), sim, max_frames=frames, retry_s=120.0,
                            record=record)

    with open(editor_log, "w") as log:
        editor = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            for k in bc.LAUNCHES:
                bc.LAUNCHES[k] = 0
            with ship_times() as times, ext_io_env(ext_io):
                t0 = time.perf_counter()
                # the steady window starts with the third frame's first step
                steady = dict(window_kernel="bucket_step", skip=200)
                shipped, busy = device_busy(serve, **steady) if profile else (serve(), None)
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
    runner, path = ("sharded", HALO_KERNELS) if mesh is not None else SLICE_PATHS[ext_io]
    if sim.active_kernel != f"{runner}-{'cuda' if device.startswith('cuda') else 'torch-cpu'}":
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
    if any(launches[k] == 0 for k in path):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if any(launches[k] for k in bc.LAUNCHES if k not in path):
        raise AssertionError(f"a kernel of another path launched: {launches}")
    periods = np.diff(times[2:]) * 1e3  # after the echo and the first frame
    line = {"frames": frames, "particles": counts, "grid": list(sim.grid.grid_shape),
            "mesh": None if mesh is None else list(mesh.shape), "ext_io": ext_io,
            "lane_chunks": sim._lane_chunks, "active_kernel": sim.active_kernel, "launches": launches, "serve_s": serve_s,
            "frame_period_ms": {"median": float(np.median(periods)),
                                "p90": float(np.percentile(periods, 90)),
                                "all": [round(float(v), 3) for v in periods]},
            "profiled": profile, "device": busy}
    label = "mesh slice" if mesh is not None else "slice" if ext_io == "off" else "ext slice"
    print(f"{label}: " + json.dumps(line), flush=True)
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

    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.ops.allpairs_cuda import allpairs_step_cuda
    from particle_simulator_tpu_torch.physics import step
    from particle_simulator_tpu_torch.scenes.library import gas_diffusion, liquid_droplet

    seg = step.SEGMENT
    if build.library().ps_allpairs_segment() != seg:
        raise AssertionError("the kernel's AP_SEGMENT differs from physics/step.py:SEGMENT")
    droplet = liquid_droplet()
    droplet.metadata.cursor_pos = (0.5, 0.5)
    droplet.metadata.cursor_size = 0.3
    gas = gas_diffusion()
    # every slot live and no multiple of the segment length: the last
    # segment is ragged and holds live sources
    ragged_n = 5000
    gas_live = gas.particles[gas.particles["ty"] >= 0]
    ragged = (state_from_numpy(gas_live[:ragged_n], ragged_n, device),
              SimParams.from_record(gas.metadata.copy()).vector(device), ragged_n)
    if ragged_n % seg == 0:
        raise AssertionError(f"{ragged_n} slots leave no ragged segment of {seg}")
    # fewer slots than one segment, or than two blocks' receivers: 30 live, 7 tombstones
    tiny = (state_from_numpy(gas_live[:30], 37, device), ragged[1], 30)
    results = {}
    for label, case in (("gas_diffusion", compact_state(gas, device)),
                        ("liquid_droplet_cursor", compact_state(droplet, device)),
                        ("gas_ragged_segment", ragged), ("gas_37_slots", tiny)):
        state, pv, live = case
        got = allpairs_step_cuda(state, pv)
        ref = step.allpairs_step(state, pv)
        err = check_step(got, ref, label)
        line = {"scene": label, "live": live, "slots": state.capacity, "L": seg,
                "segments": -(-state.capacity // seg), "max_abs_err_v": err,
                "bit_identical": all(torch.equal(a, b) for a, b in zip(got, ref))}
        if not line["bit_identical"]:
            raise AssertionError(f"{label}: the all-pairs kernel and its plain version differ")
        if label in ("gas_diffusion", "liquid_droplet_cursor"):  # the main path's shapes
            pairs = live * (live - 1)
            line["pairs_per_step"] = pairs
            line["ms"] = {"kernel": cuda_ms(lambda: allpairs_step_cuda(state, pv), reps)}
            line["bound"] = bound(36 * state.capacity, ops_bound_ms(pairs, sass))
        if label == "gas_diffusion":
            line["ms"]["plain"] = cuda_ms(lambda: step.allpairs_step(state, pv), 1)
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
    launches = {k: v for k, v in {**counters[0], **counters[1]}.items()
                if k in ("allpairs", "step", "dest", "place")}
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


def one_card_mesh(device: str):
    """A (2, 2) mesh of four shards on one card."""
    import torch

    from particle_simulator_tpu_torch.parallel.domain import make_mesh

    return make_mesh(devices=[torch.device(device)] * 4)


def phase_halo_kernels(device, dense_cfg, stress_cfg, reps: int, sass: dict):
    """Phase 9: the three halo kernels against their plain versions on the
    block of four halo-padded shards of a (2, 2) split."""
    import torch

    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.parallel import domain
    from particle_simulator_tpu_torch.physics import bucket

    mesh = one_card_mesh(device)
    results = {}
    scenes = {"dense": dense_grid_scene(dense_cfg)[:2], "stress": stress_scene(stress_cfg)}
    cfgs = {"dense": dense_cfg, "stress": stress_cfg}
    for label, (parts, meta) in scenes.items():
        cfg = cfgs[label]
        state = state_from_numpy(parts, cfg.capacity, device).reshape(cfg.grid_shape)
        pv = SimParams.from_record(meta).vector(device)
        (padded,) = domain.exchange_halo(domain.shard_state(state, mesh), mesh)
        (offsets,) = domain.ring_plan(mesh, padded.x.shape[1] - 2, padded.x.shape[2] - 2).offsets
        log2 = (cfg.bx_log2, cfg.by_log2)

        got, ref = bc.bucket_step_halo_cuda(padded, pv), bucket.bucket_step_halo(padded, pv)
        for name, a, b in zip(got._fields, got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: halo step field {name} differs")
        live = bucket.interior(ref).ty >= 0
        step_err = max((bucket.interior(got)[i][live] - bucket.interior(ref)[i][live])
                       .abs().max().item() for i in (2, 3))
        dest = bc.move_dest_halo_cuda(padded, *log2, offsets)
        dest_ref = bucket.move_dest_direct_halo(padded, *log2, offsets)
        if not torch.equal(dest, dest_ref):
            raise AssertionError(f"{label}: halo dest ids differ at "
                                 f"{int((dest != dest_ref).sum())} slots")
        placed = bc.bucket_place_halo_cuda(padded, dest_ref)
        placed_ref = bucket.bucket_place_halo(padded, dest_ref)
        for name, a, b in zip(placed._fields, placed, placed_ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: halo place field {name} differs")
        ring = dest_ref.clone()
        ring[:, 1:-1, 1:-1] = -1
        line = {"scene": label, "block": list(padded.x.shape), "mesh": list(mesh.shape),
                "live_in_block": int((padded.ty >= 0).sum()),
                "kept_by_move": int((dest_ref >= 0).sum()),
                "migrating_in_from_ring": int((ring >= 0).sum()),
                "step_max_abs_err_v": step_err}
        if label == "stress" and not line["migrating_in_from_ring"]:
            raise AssertionError("stress scene: no particle migrated in from a ring")
        if label == "dense":
            out_grid = placed.x.shape[-3:]
            lib_place, lib_ms = place_library_call(padded, dest_ref, reps, out_grid=out_grid)
            if not torch.equal(lib_place, torch.stack(
                    [a.reshape(-1).view(torch.int32) for a in placed_ref], 1)):
                raise AssertionError("index_copy disagrees with the halo place kernel")
            src_slots, out_slots = padded.capacity, placed.x.numel()
            pairs = halo_pairs(padded)
            line["pairs_per_step"] = pairs
            line["ms"] = {
                "step": cuda_ms(lambda: bc.bucket_step_halo_cuda(padded, pv), reps),
                "step_plain": cuda_ms(lambda: bucket.bucket_step_halo(padded, pv), reps),
                "dest": cuda_ms(lambda: bc.move_dest_halo_cuda(padded, *log2, offsets), reps),
                "dest_plain": cuda_ms(
                    lambda: bucket.move_dest_direct_halo(padded, *log2, offsets), reps),
                "place": cuda_ms(lambda: bc.bucket_place_halo_cuda(padded, dest_ref), reps),
                "place_plain": cuda_ms(lambda: bucket.bucket_place_halo(padded, dest_ref), reps),
                "place_library": lib_ms,
            }
            # each input read once, each output written once: the step reads
            # 20 B and writes 16 B a padded slot (the ring passes through);
            # dest reads x, y, ty and writes an id a padded slot, plus the
            # offsets; place reads 24 B a padded slot and writes 20 B an
            # interior slot
            line["bounds"] = {
                "step": bound(36 * src_slots, ops_bound_ms(pairs, sass)),
                "dest": bound(16 * src_slots + offsets.numel() * 4),
                "place": bound(24 * src_slots + 20 * out_slots),
            }
        results[label] = line
        print("halo kernels: " + json.dumps(line), flush=True)
    return results


def phase_sharded_frame(device, cfg, frames: int, steps: int, timed: int, mesh=None):
    """Phase 10: the sharded frame (by default on a (2, 2) one-card mesh)
    against ``run_frame_bucket_cuda`` on the dense scene."""
    import torch

    from particle_simulator_tpu_torch.engine.state import (
        ParticleState,
        SimParams,
        state_from_numpy,
    )
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
    from particle_simulator_tpu_torch.parallel import domain

    parts, meta, live = dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity, device).reshape(cfg.grid_shape)
    pv = SimParams.from_record(meta).vector(device)
    mesh = one_card_mesh(device) if mesh is None else mesh
    fn = domain.make_sharded_frame_fn(cfg, mesh)
    pvs = [pv.to(dev) for dev, _ in mesh.blocks]
    single = state
    blocks = domain.shard_state(domain.pad_rows_for_mesh(state, mesh)[0], mesh)
    for k in bc.LAUNCHES:
        bc.LAUNCHES[k] = 0
    for i in range(frames):
        single = run_frame_bucket_cuda(single, pv, steps, cfg.move_every)
        blocks = fn(blocks, pvs, steps)
        if i == 0:
            per_frame = {k: v for k, v in bc.LAUNCHES.items() if k in HALO_KERNELS}
    got = ParticleState(*(a[:cfg.by] for a in domain.gather_state(blocks, mesh)))
    if not torch.equal(got.ty, single.ty):
        raise AssertionError(f"sharded frame: ty differs at {int((got.ty != single.ty).sum())}")
    alive = single.ty >= 0
    for name, a, b in zip(got._fields[:4], got, single):
        if not torch.equal(a[alive], b[alive]):
            raise AssertionError(f"sharded frame: live {name} differs")
    if not bool(torch.isfinite(single.vx[alive]).all()):
        raise AssertionError("sharded frame: non-finite velocities")
    all_slots = all(torch.equal(a, b) for a, b in zip(got, single))

    def run(runner, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            runner()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def one():
        nonlocal single
        single = run_frame_bucket_cuda(single, pv, steps, cfg.move_every)

    def sharded():
        nonlocal blocks
        blocks = fn(blocks, pvs, steps)

    # in turns: one device, mesh, mesh, one device
    ms = [run(one, timed), run(sharded, timed), run(sharded, timed), run(one, timed)]
    host = {"single_device": enqueue_ms(one), "sharded": enqueue_ms(sharded)}
    busy = {"single_device": device_busy(lambda: run(one, 2))[1],
            "sharded": device_busy(lambda: run(sharded, 2))[1]}
    line = {"grid": list(cfg.grid_shape), "mesh": list(mesh.shape),
            "devices": [str(d) for d in mesh.flat], "particles": live,
            "survivors": int(alive.sum()), "frames_compared": frames,
            "steps_per_frame": steps, "bit_identical_live": True,
            "bit_identical_all_slots": all_slots,
            "launches_per_sharded_frame": per_frame,
            "frame_ms": {"single_device": [ms[0], ms[3]], "sharded": [ms[1], ms[2]]},
            "sharded_over_single": (ms[1] + ms[2]) / (ms[0] + ms[3]),
            "host_enqueue_ms_per_frame": host, "device": busy}
    print("sharded frame: " + json.dumps(line), flush=True)
    return line


def user_scene():
    """``bench.py --user-scene`` at 1M: a 1000 x 1000 hex lattice at 1.1 r0
    filling half of its box's side, 100 steps a frame; ``_grid_for`` puts it
    on a 1024 x 1024 x 16 grid, 27% of whose 8-row tiles are live at 8 lane
    chunks."""
    from particle_simulator_tpu_torch.scenes.library import _scene

    return _scene(1000, 1000, distance_factor=1.1, speed=1.0, box_fill=0.5)


def same_state(got, ref, label: str) -> float:
    """Raise unless every field is equal; return the largest live-velocity
    difference (0.0)."""
    import torch

    for name, a, b in zip(got._fields, got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: field {name} differs at "
                                 f"{int((a != b).sum())} slots")
    live = ref.ty >= 0
    diffs = [(got[i][live] - ref[i][live]).abs() for i in (2, 3)]
    return max((float(d.max()) for d in diffs if d.numel()), default=0.0)


def phase_ext_kernels(device, scene, stress_cfg, reps: int, sass: dict):
    """Phase 12: the tile-scheduled step (both modes) against its plain
    versions and the classic CUDA step, two steps on one buffer pair, on the
    1M user scene and the stress scene; times and bound on the user scene."""
    import torch

    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    sim = Simulator(device=device)
    sim.load_frame(scene)
    parts, meta = stress_scene(stress_cfg)
    stress = state_from_numpy(parts, stress_cfg.capacity, device).reshape(stress_cfg.grid_shape)
    cases = {"user": (sim.state, sim._pvec, sim._lane_chunks),
             "stress": (stress, SimParams.from_record(meta).vector(device), 2)}
    results = {}
    for label, (state, pv, chunks) in cases.items():
        aux = bucket.ext_step_aux(state, pv, chunks, 8)
        classic = [bc.bucket_step_cuda(state, pv)]
        classic.append(bc.bucket_step_cuda(classic[0], pv))
        err = same_state(classic[0], bucket.bucket_step(state, pv),
                         f"{label}: the classic step against its plain version")
        for compact in (False, True):
            name = "compact" if compact else "ext"
            first = bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, compact)
            second = bc.bucket_step_ext_cuda(first, aux, compact)  # writes first's spare
            plain = bucket.bucket_step_ext(state, aux, compact)
            for k, (got, ref) in enumerate(((first.cur, plain),
                                            (second.cur, bucket.bucket_step_ext(plain, aux, compact)))):
                err = max(err, same_state(got, ref, f"{label} {name} step {k} vs plain"))
                same_state(got, classic[k], f"{label} {name} step {k} vs the classic step")
        line = {"scene": label, "grid": list(state.x.shape), "lane_chunks": chunks,
                "ty_rows": aux.ty_rows, "live": int((state.ty >= 0).sum()),
                "omax": int(aux.params[-1]), "live_tile_share": live_tile_share(aux),
                "max_abs_err_v": err}
        if label == "user":
            pair = bc.ext_pair(state)
            line["pairs_per_step"] = bucket_pairs(state)
            line["ms"] = {
                "classic": cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps),
                "ext": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, False), reps),
                "compact": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps),
                "ext_plain": cuda_ms(lambda: bucket.bucket_step_ext(state, aux, False), 1),
                "compact_plain": cuda_ms(lambda: bucket.bucket_step_ext(state, aux, True), 1),
                # the once-a-chunk prologue of the ext frame, and the rebucket
                "aux": cuda_ms(lambda: bucket.ext_step_aux(state, pv, chunks, 8), reps),
                "pair": cuda_ms(lambda: bc.ext_pair(state), reps),
                "move": cuda_ms(lambda: bc.bucket_move_cuda(state), reps),
                "dest": cuda_ms(lambda: bc.move_dest_cuda(state), reps),
            }
            if not torch.equal(bc.move_dest_cuda(state), bucket.move_dest_direct(state)):
                raise AssertionError("user scene: dest ids differ from the plain version's")
            line["bound"] = ext_bound(state, sass)
            line["dest_bound"] = bound(16 * state.capacity)
            # what the every-tile step must move whatever is live: 16 B read
            # and 16 B written a slot (the bound above counts live slots only)
            line["every_slot_bytes_ms"] = 1e3 * 32 * state.capacity / HBM_BYTES_PER_S
            line["later"] = ext_times_later(state, pv, chunks, sim.grid.move_every,
                                            sim.params.steps_per_frame, reps, sass)
        results[label] = line
        print("ext kernels: " + json.dumps(line), flush=True)
    print("ext geometries: " + json.dumps(ext_geometry_sweep(device)), flush=True)
    print("editor lattice kernels: " + json.dumps(lattice_kernel_times(device, reps, sass)),
          flush=True)
    return results


def editor_lattice():
    """The lattice the headless editor sends for ``--lattice 1024x1024
    --distance-factor 1.1 --step-dt 1e-14``: 1,048,576 particles spanning
    0.6 of the box's side; ``_grid_for`` puts it on a 512 x 512 x 16 grid."""
    from particle_simulator_tpu_torch.scenes.library import _scene

    return _scene(1024, 1024, distance_factor=1.1, speed=0.0, box_fill=0.6, dt=1e-14)


def lattice_kernel_times(device, reps: int, sass: dict) -> dict:
    """The classic step and the dest on the editor lattice's grid, each
    against its plain version bit for bit, then timed, with the two
    tile-scheduled modes' times beside them (the serving slices of phases
    4, 11 and 14 run this state)."""
    import torch

    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    sim = Simulator(device=device)
    sim.load_frame(editor_lattice())
    state, pv, chunks = sim.state, sim._pvec, sim._lane_chunks
    same_state(bc.bucket_step_cuda(state, pv), bucket.bucket_step(state, pv),
               "editor lattice: the classic step against its plain version")
    if not torch.equal(bc.move_dest_cuda(state), bucket.move_dest_direct(state)):
        raise AssertionError("editor lattice: dest ids differ from the plain version's")
    aux = bucket.ext_step_aux(state, pv, chunks, 8)
    pair = bc.ext_pair(state)
    return {"grid": list(state.x.shape), "live": int((state.ty >= 0).sum()),
            "lane_chunks": chunks, "omax": int(aux.params[-1]),
            "live_tile_share": live_tile_share(aux), "pairs_per_step": bucket_pairs(state),
            "ms": {"classic": cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps),
                   "ext": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, False), reps),
                   "compact": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps),
                   "dest": cuda_ms(lambda: bc.move_dest_cuda(state), reps)},
            "bound": ext_bound(state, sass), "dest_bound": bound(16 * state.capacity)}


# (grid shape, lane chunks, rows a tile asked for): what each exercises in
# the tile-scheduled kernel beyond the two scenes above
EXT_GEOMETRIES = (
    ((16, 32, 8), 2, 8),    # cap 8, four tiles, one sub-tile a tile
    ((16, 32, 6), 1, 8),    # cap no multiple of 4: the pass-through's scalar path
    ((8, 64, 12), 4, 8),    # cap a multiple of 4 and no power of two
    ((32, 16, 64), 1, 16),  # 16-row tiles (two sub-tiles down); cap 64 narrows the
                            # sub-tile to fit shared memory, its last column ragged
    ((4, 4, 16), 4, 8),     # tiles of one bucket column and the grid's 4 rows
)


def ext_geometry_sweep(device) -> list:
    """The tile-scheduled step in both modes on small random half-live grids
    of other shapes than the scenes': bit-identical, two steps on one buffer
    pair, to the classic CUDA step, itself held against the plain step."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams
    from particle_simulator_tpu_torch.io.frame import default_metadata
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    meta = default_metadata()
    meta["step_dt"] = 10e-15
    pv = SimParams.from_record(meta).vector(device)
    lines = []
    for seed, (shape, chunks, rows) in enumerate(EXT_GEOMETRIES):
        rng = np.random.default_rng(seed)
        n = int(np.prod(shape))
        fields = (rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
                  rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
                  rng.normal(0, 50, n).astype(np.float32),
                  rng.normal(0, 50, n).astype(np.float32),
                  np.where(rng.random(n) < 0.5, 0, -1).astype(np.int32))
        state = ParticleState(*(torch.from_numpy(a).to(device).reshape(shape) for a in fields))
        state.ty[: shape[0] // 2, : shape[1] // 2] = -1  # a dead corner: dead tiles and buckets
        aux = bucket.ext_step_aux(state, pv, chunks, rows)
        classic = [bc.bucket_step_cuda(state, pv)]
        classic.append(bc.bucket_step_cuda(classic[0], pv))
        same_state(classic[0], bucket.bucket_step(state, pv), f"{shape} classic vs plain")
        for compact in (False, True):
            pair = bc.ext_pair(state)
            for k in range(2):
                pair = bc.bucket_step_ext_cuda(pair, aux, compact)
                same_state(pair.cur, classic[k],
                           f"{shape} chunks {chunks} compact={compact} step {k} vs classic")
        lines.append({"grid": list(shape), "lane_chunks": chunks, "ty_rows": aux.ty_rows,
                      "omax": int(aux.params[-1]), "live_tile_share": live_tile_share(aux),
                      "live": int((state.ty >= 0).sum())})
    return lines


def ext_times_later(state, pv, chunks: int, move_every: int, steps: int, reps: int,
                    sass: dict, frames: int = 4) -> dict:
    """The three step modes on the state ``frames`` classic frames later
    (the user scene's stretched lattice contracts, so omax grows): each ext
    mode bit-identical to the classic CUDA step there, and their times."""
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    for _ in range(frames):
        state = bc.run_frame_bucket_cuda(state, pv, steps, move_every)
    aux = bucket.ext_step_aux(state, pv, chunks, 8)
    classic = bc.bucket_step_cuda(state, pv)
    for compact in (False, True):
        same_state(bc.bucket_step_ext_cuda(state, aux, compact), classic,
                   f"user scene {frames} frames later, compact={compact}, vs the classic step")
    pair = bc.ext_pair(state)
    return {"frames_later": frames, "omax": int(aux.params[-1]),
            "live_tile_share": live_tile_share(aux), "pairs_per_step": bucket_pairs(state),
            "ms": {"classic": cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps),
                   "ext": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, False), reps),
                   "compact": cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps)},
            "bound": ext_bound(state, sass)}


def compare_readback(got_bytes: bytes, want_bytes: bytes, held, copy) -> None:
    """The readback check: a ticket's frame must be the frame of a copy
    taken before the next frame ran, and the state the ticket holds must
    still hold the copy's bytes."""
    import torch

    if got_bytes != want_bytes:
        raise AssertionError("the ReadbackTicket read other bytes than its frame's copy")
    for name, a, b in zip(held._fields, held, copy):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"the next frame wrote the held state's {name}")


def readback_check(sim) -> dict:
    """Frame k on a loaded Simulator, a synchronous host copy of its state,
    a ReadbackTicket started on it, frame k+1; then ``compare_readback``."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState

    sim.frame_async()
    copy = ParticleState(*(a.to("cpu", copy=True) for a in sim.state))
    ticket = sim.start_readback()
    kernel = sim.active_kernel
    sim.frame_async()
    got = sim.read_frame(ticket)
    if sim.state.x.is_cuda:
        torch.cuda.synchronize()
    want = sim.read_frame(copy.to(sim.state.x.device))
    compare_readback(got.bytes, want.bytes, ticket.state, copy)
    return {"active_kernel": kernel, "particles": got.particle_count}


@contextlib.contextmanager
def ext_io_env(mode: str):
    """``PS_EXT_IO`` set to ``mode`` while the context is open."""
    old = os.environ.get("PS_EXT_IO")
    os.environ["PS_EXT_IO"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["PS_EXT_IO"]
        else:
            os.environ["PS_EXT_IO"] = old


def phase_ext_frame(device, scene, frames: int, timed: int):
    """Phase 13: the ext frame in both modes against the classic frame on
    the 1M user scene, bit for bit on every slot; frame times; then the
    readback check through a Simulator serving the scene with
    PS_EXT_IO=compact."""
    import torch

    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
    from particle_simulator_tpu_torch.physics import bucket

    sim = Simulator(device=device)
    sim.load_frame(scene)
    pv, steps, every = sim._pvec, sim.params.steps_per_frame, sim.grid.move_every
    chunks, particles = sim._lane_chunks, sim.live_count

    def runner(**ext):
        return lambda s: run_frame_bucket_cuda(s, pv, steps, every, **ext)

    runners = {"classic": runner(),
               "ext": runner(lane_chunks=chunks, ext_io=True, compact_tiles=False, block_rows=8),
               "compact": runner(lane_chunks=chunks, ext_io=True, compact_tiles=True, block_rows=8)}
    states = dict.fromkeys(runners, sim.state)
    for i in range(frames):
        for name, run in runners.items():
            states[name] = run(states[name])
        for name in ("ext", "compact"):
            same_state(states[name], states["classic"], f"{name} frame {i}")
    alive = states["classic"].ty >= 0
    if not bool(torch.isfinite(states["classic"].vx[alive]).all()):
        raise AssertionError("ext frame: non-finite velocities")
    def advance(name, frames=1):
        for _ in range(frames):
            states[name] = runners[name](states[name])

    ms = {name: [] for name in runners}
    tiles = []  # (omax, live-tile share) after each timed compact frame
    for _ in range(timed):  # in turns
        for name in runners:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            advance(name)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
        aux = bucket.ext_step_aux(states["compact"], pv, chunks, 8)
        tiles.append((int(aux.params[-1]), live_tile_share(aux)))
    host = {name: enqueue_ms(lambda name=name: advance(name)) for name in runners}
    busy = {name: device_busy(lambda name=name: advance(name, 2))[1] for name in runners}
    with ext_io_env("compact"):
        readback = readback_check(sim)
    if readback["active_kernel"] != "bucket-compact-cuda":
        raise AssertionError(f"the readback check ran through {readback['active_kernel']}")
    line = {"scene": "user", "grid": list(sim.grid.grid_shape), "lane_chunks": chunks,
            "particles": particles,
            "survivors": int(alive.sum()), "frames_compared": frames,
            "steps_per_frame": steps, "bit_identical_all_slots": True,
            "frame_ms_median": {k: float(np.median(v)) for k, v in ms.items()},
            "frame_ms": {k: [round(t, 3) for t in v] for k, v in ms.items()},
            "omax_and_live_tiles_after_compact_frames": tiles,
            "host_enqueue_ms_per_frame": host, "device": busy, "readback_check": readback}
    print("ext frame: " + json.dumps(line), flush=True)
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

    # 2. build; the pair loops' SASS counts are information, the bounds use
    # the frozen FORCE_LAW_COUNTS
    t0 = time.perf_counter()
    lib = build.library()
    build_s = time.perf_counter() - t0
    lib_path = build.BUILD_DIR / build.LIB_NAME
    sass = FORCE_LAW_COUNTS
    loops = {"allpairs_step_kernel": sass_pair_counts(
                 lib_path, "allpairs_step_kernel", lib.ps_allpairs_pairs_per_iter()),
             "bucket_step_tiles_kernel": sass_pair_counts(
                 lib_path, "bucket_step_tiles_kernel", lib.ps_bucket_tiles_pairs_per_iter()),
             # the classic and halo step run the same staged candidate loop
             "bucket_step_kernel": sass_pair_counts(
                 lib_path, "bucket_step_kernel", lib.ps_bucket_tiles_pairs_per_iter())}
    ptxas = ptxas_summary((build.BUILD_DIR / build.BUILD_LOG).read_text())
    print("build: " + json.dumps({"seconds": build_s, "library": str(lib_path),
                                  "force_law_counts": sass, "sass_pair_loops": loops,
                                  "ptxas": ptxas}),
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
    halo = phase_halo_kernels(device, dense_cfg, GridConfig(4, 4, 16), reps=20, sass=sass)
    phase_sharded_frame(device, dense_cfg, frames=3, steps=100, timed=5)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        msl = phase_slice(device, "1024x1024", 16, workdir, mesh=one_card_mesh(device))
        # the same serve on one device (8 frames: phase 14 serves it again
        # with 16), then both profiled
        phase_slice(device, "1024x1024", 8, workdir)
        for mesh in (None, one_card_mesh(device)):
            phase_slice(device, "1024x1024", 8, workdir, mesh=mesh, profile=True)
    scene = user_scene()
    ext = phase_ext_kernels(device, scene, GridConfig(4, 4, 16), reps=20, sass=sass)
    phase_ext_frame(device, scene, frames=3, timed=5)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        esl = {mode: phase_slice(device, "1024x1024", 16, workdir, ext_io=mode)
               for mode in ("compact", "nocompact", "off")}
        for mode in esl:
            phase_slice(device, "1024x1024", 8, workdir, profile=True, ext_io=mode)
    if torch.cuda.device_count() > 1:
        from particle_simulator_tpu_torch.parallel.domain import make_mesh

        cards = make_mesh()
        phase_sharded_frame(device, dense_cfg, frames=3, steps=100, timed=3, mesh=cards)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
            phase_slice(device, "1024x1024", 12, workdir, mesh=cards)

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
    hms, hbnd = halo["dense"]["ms"], halo["dense"]["bounds"]
    herr = max(line["step_max_abs_err_v"] for line in halo.values())
    kernels += [
        kernel_entry("bucket_step_halo", "bucket_step.cu", STEP_HALO_KERNEL,
                     msl["launches"]["step_halo"], herr, hms["step"], hms["step_plain"],
                     hbnd["step"], None),
        kernel_entry("bucket_dest_halo", "bucket_dest.cu", DEST_HALO_KERNEL,
                     msl["launches"]["dest_halo"], 0.0, hms["dest"], hms["dest_plain"],
                     hbnd["dest"], None),
        kernel_entry("bucket_place_halo", "bucket_place.cu", PLACE_HALO_KERNEL,
                     msl["launches"]["place_halo"], 0.0, hms["place"], hms["place_plain"],
                     hbnd["place"], hms["place_library"]),
    ]
    ems, ebnd = ext["user"]["ms"], ext["user"]["bound"]
    eerr = max(line["max_abs_err_v"] for line in ext.values())
    kernels += [
        kernel_entry("bucket_step_ext", "bucket_step.cu", EXT_KERNEL,
                     esl["nocompact"]["launches"]["step_ext"], eerr, ems["ext"],
                     ems["ext_plain"], ebnd, None),
        kernel_entry("bucket_step_compact", "bucket_step.cu", COMPACT_KERNEL,
                     esl["compact"]["launches"]["step_compact"], eerr, ems["compact"],
                     ems["compact_plain"], ebnd, None),
    ]
    print("library calls: bucket_step(_halo, _ext, _compact), bucket_dest(_halo), "
          "allpairs_step none (no single PyTorch call computes the Mie step, the pull-order "
          "rank or the all-pairs forces); bucket_place(_halo) torch.index_copy into a "
          "tombstone table", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
