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
4. slice: the port's headless editor (a subprocess,
   ``particle_simulator_tpu_torch.editor.headless``) sends a 1024x1024
   lattice (1,048,576 particles) over TCP and the port's ``serve`` ships 6
   frames back through the runner the scene picks (the live-tile step where
   it loads with more than one lane chunk, else the classic step); every
   frame must be finite, every kernel of that runner launched and no other;
5. throughput (printed after phase 22): phase 22's dense bench line, 10
   timed 100-step frames of ``run_frame_bucket_cuda`` on the dense scene
   (particle-steps/s, sim-steps/s);
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
    ``Simulator(mesh=make_mesh(devices=[cuda:0] * 4))`` to the port's
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
    Simulator serving the scene (the live-tile frame) reads the bytes of a
    copy taken before frame k+1, whose run left the held state unchanged;
14. (folded into phases 4 and 11: the one-device serve of the 1024x1024
    editor lattice runs the runner its scene picks, and phase 11 profiles
    it);
15. configs 1-3: ``scripts/torch_bench_configs.py``'s ``bench_config`` on the
    card: liquid-droplet-2k and gas-diffusion-16k as CompactArray,
    solid-crystal-64k as MatrixBuckets, 20 timed frames of 100 steps behind
    ``Simulator.sync()``; finite, no particle lost, ``allpairs-cuda`` /
    ``bucket-cuda``, the kernel launched (frames + 1) x steps times;
    particle-steps/s and sim-steps/s;
16. config 4: ``scripts/torch_phase_sweep_chip.py``'s states-of-matter sweep
    at full size (a 512x512 lattice, 262,144 particles; 5,000 / 30,000 /
    200,000 steps): all six order-parameter checks must hold; the live count
    after each phase;
17. the leapfrog soak of ``scripts/torch_soak_leapfrog_1e6.py`` through
    ``run_frame_bucket_cuda`` for 100,000 steps (the full 1e6 is one run of
    the script): energy finite, live count kept, worst drift under 5%;
18. explicit Euler against leapfrog on the integrator scene (a 6x6 hex
    lattice at 1.05 r0, 400 m/s, dt = 1 fs), both read every 250 steps:
    leapfrog through the all-pairs kernel for 100,000 steps, drift under 5%;
    Euler through ``allpairs_step_euler`` on CUDA tensors for 2,000 steps:
    its drift grows from quarter point to quarter point, lies above
    leapfrog's at every common read and ends above
    ``EULER_OVER_LEAPFROG_MIN`` times leapfrog's worst over the same 2,000
    steps. (Euler above 0.5 and above 100x after 100,000 steps is not shown
    here: that horizon takes minutes on CUDA tensors; the CPU suite's test
    marked ``slow`` holds it);
19. the scene runner's command line (``scenes/library.py:main``): three
    frames of the liquid droplet rendered to PNGs and a GIF that decode to
    ``--size``, the stats line; one frame under ``utils/profiling.py:trace``
    with an ``annotate("dispatch")`` range: the trace file names the range
    and the step kernel;
20. (run right after phase 13) several processes
    (``parallel/multihost.py``): two processes share the card over gloo,
    the ring staged through host memory, on the (2, 2) global mesh of two
    shards each. First the dense scene's three 100-step
    frames through the sharded frame in each process (``python
    chip_smoke.py --child-frame ...``), rank 0's gathered grid bit-identical
    to ``run_frame_bucket_cuda`` computed here, then frames on the clock and
    under the profiler in each process; then the 1024x1024 editor lattice
    served for 12 frames to the port's headless editor by two daemon
    processes started through ``scripts/torch_launch_multihost.sh ...
    --devices 4``: every frame finite, the echo 1,048,576 particles, the
    frame period at process 0's wire writes beside phase 11's. Every
    process reports its launches (the halo kernels and no other), its
    backend and device, its ring bytes and host time a step (and of it the
    staging and the sends' waits), and the jax modules it imported (none);
21. config 5 (``scripts/torch_interactive_1m_chip.py``'s ``record``): the
    port's web editor and daemon as processes of their own, a 1024x1024
    lattice drawn through the HTTP surface (1,048,576 particles, dt = 10 fs,
    100 steps a frame, the 1024x1024x16 user-scene grid), served to the web
    editor for ``CONFIG5_SECONDS`` under a sustained ``/frame.bin`` fetch:
    at least 0.9 x 1,048,576 particles, engine fps above 0, no fetch error;
    the daemon tees every frame into a FIFO that this script reads, and
    every frame must be finite; through the daemon's ``--inspect``, the
    step, dest and place held bit for bit against their plain versions on
    the served grid as loaded and after the last frame (``hold_grid``),
    whose line also carries the daemon's launches: each of the three
    launched, no other kernel;
22. the bench (``particle_simulator_tpu_torch/bench.py``, the counterpart
    of ``bench.py``) in this process at bench.py's default sizes: the dense
    grid (1,036,320 live on 512x256x8, 10 timed frames of 100 steps),
    ``--per-frame``, ``--sharded`` on a (1, 1) mesh of the first card, and
    the 1M user scene (the 1000 x 1000 lattice of phases 12 and 13) through
    the runner the Simulator picks for it. Each line must carry
    bench.py's keys for its mode (``BENCH_KEYS``), ``"device": "cuda"``,
    the particle count and a finite rate; each kernel of the mode's path
    launched once a step per block and no other kernel; every kernel it
    launched held bit for bit against its plain version on the bench's own
    states as loaded and after the last frame (``BenchHold``, through the
    bench's ``inspect`` hook: rows 1-3 dense, 1h, 7, 8 sharded, 1u, 2, 3
    and 5 on the user scene).
    Then the entry points (``particle_simulator_tpu_torch/entry.py``, the
    counterpart of ``__graft_entry__.py``) on the card: ``entry()``'s frame
    finite and bit for bit the plain frame's (``physics/bucket.py:
    run_frame_bucket``) on the same tensors, and ``dryrun_multichip(n)`` for n in
    ``DRYRUN_SHARDS``: the sharded frame (the halo kernels) bit for bit
    against the one-device frame (the classic kernels);
23. the main path at the sizes of the JAX package's recorded runs
    (``SCALE_RUNS``, bench.py's commands of BASELINE.md's N-scaling record):
    the port's bench with ``--per-frame`` on the dense grid at
    ``--particles 4194304`` (1024x512x8) and ``16000000`` (2048x1024x8,
    16,728,096 live), the 16M grid ``--sharded`` on a (2, 2) mesh of the
    one card, and the user scene at 4M (a 2048 x 2048 lattice on a 2048 x
    2048 x 16 grid, the live-tile step it picks); each row checked and held
    as phase 22's rows (rows 1-3 dense, 1h, 7, 8 sharded, 1u, 2, 3 and 5 on
    the user scene), each kernel of its path timed at the row's state beside
    its bound, the device-memory peaks of the run and of the holds, and the
    seconds of the load, the frames and the holds; then a Simulator serving
    the 4M user scene holds its readback (``readback_check``: the wire bytes
    against the device pack of a copy and its numpy pack).

24. readback pack: the record-pack kernel (``ops/readback.py:pack_records``,
    ``csrc/readback_pack.cu``) against its plain version (``records_plain``),
    every word, on the 1024 x 1024 x 16 grid the served 1M editor lattice
    loads on (as loaded and after three frames), the dense scene, the user
    scene, that grid all dead, and small random grids of other caps and
    ragged tiles (``READBACK_GEOMETRIES``), each at ncap = the power of two
    at or above the live count, four times that, and a quarter (records
    clipped, header exact); kernel and plain times (20 launches behind the
    spin kernel) at the lattice grid beside the byte bound
    (``readback_bound``). ``python3 chip_smoke.py --readback-pack`` runs
    phases 1, 2 and 24 alone;
25. (run right after phase 13) the live-tile step (row 5,
    ``bucket_step_kernel_tiles<true>``) on the 1M lattice of the benchmark's
    ``editor-lattice-1m`` (``user_scene(1024)``: a 1024 x 1024 x 16 grid,
    8 lane chunks) as loaded and after 300 and 900 frames served under the
    ``drag`` traffic's cursor (the lattice spreads over more tiles, the
    state the served cell spends its window in): on each state two steps
    held bit for bit against the classic step, the first against the plain
    ext step, the time beside the bound, omax and the live-tile share; the
    step's registers, spills and blocks a multiprocessor (and the
    every-tile instance's); ``step.live_tile_launches`` over the drag equal
    to the live-tile launches and to its frames' steps; then the small
    grids of ``LIVE_TILE_GEOMETRIES`` (16-byte stage, 4- 8- and 16-row and
    one-bucket tiles, cap 64 with omax 20, the all-dead grid) against the
    classic and plain steps. The frame's tile kernel (row 10,
    ``csrc/bucket_tiles.cu``): on each of those three states ``ps_tile_aux``
    bit for bit against ``ext_step_aux``, alone and with its retire against
    ``tile_retire``, timed beside its byte bounds; the served frames
    of ``LIVE_TILE_HELD_FRAMES`` (the first after the load, the two after it
    and later pairs, each stepping into the buffer the frame before kept)
    bit for bit against the classic frame, their given states unchanged;
    the drag's ``tile_aux`` and ``tile_retire`` launches (an aux at every
    run's entry but a frame's first, which takes the aux kept with the
    buffer, but in the first frame; a retire at every run's entry but the
    first and but the second of the first frame); the kernel on small grids
    (``tile_kernels_sweep``).
    ``python3 chip_smoke.py --live-tile`` runs phases 1, 2 and 25 alone
    (~60 s of command).

Every child process (the headless editors of phases 4, 11 and 20, the
web editor and the daemons of phase 21) prints the modules of jax or of the
JAX package it imported as it exits (``utils/log.py:report_foreign_modules``;
phase 20's processes in their JSON lines): the run fails on any, or on a
child that printed no such line.

Phases 15-19 also hold every kernel they launch against its plain version,
bit for bit, on their own states (``KernelHold``): each config's, each sweep
phase's, the soak's and the integrator scene's state as loaded and after its
run, the droplet's before and after a frame. These comparisons' launches are
not counted, and their errors go into the kernels line's ``max_abs_err``.

On a machine with more than one card, phases 10, 11 and 22's ``--sharded``
run once more on a mesh of every card, one shard a card, and phase 20 with
one process a card over NCCL; then phase 23's dense 16M row on the first
card, its sharded 16M row on the mesh of every card and phase 20's sharded
frame at the 16M grid over NCCL, their three rates on one line
(``multi_card``; ``scripts/torch_multicard_chip.py`` runs only these).

The last three lines are the card's ``nvidia-smi`` line, the kernels JSON
line and the result line. In the kernels line ``launches`` is the count of
the served slice that runs the kernel, ``launches_scripts`` that of
phases 15-19, each counted from 0 around its own run, and
``launches_multiprocess`` that of phase 20's two daemon processes (each
counts from its start), summed, ``launches_config5`` that of phase 21's
daemon, ``launches_bench`` that of phase 22's runs and ``launches_scale``
that of phase 23's rows, each summed. It exits non-zero when
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
# the readback pack replaces no Pallas kernel: the JAX package's pack is XLA ops
READBACK_KERNEL = "none (particle_simulator_tpu/ops/readback.py:dense_readback, XLA ops)"
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
    ``MUFU.EX2`` in the SASS of the first function named ``kernel`` (its
    whole identifier: ``bucket_step_kernel`` is not
    ``bucket_step_kernel_tiles``; either template instance). A loop is a
    backward branch and the instructions from its target to it; branch
    targets are addresses or ``.L_x_N`` labels."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:]
                 if kernel_name(f.split("\n", 1)[0].strip()).split("<")[0] == kernel), None)
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


def kernel_name(symbol: str) -> str:
    """A kernel's name in a mangled symbol, a template instance named like
    ``kernel<1>``: the last length-prefixed identifier that holds
    ``kernel``, read by its own length, so that one name is never taken for
    the start of a longer one; a symbol with none is its own name."""
    found = None
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", symbol):
        n, rest = int(m.group(1)), m.group(2)
        if len(rest) >= n and "kernel" in rest[:n]:
            flag = re.match(r"ILb([01])E", rest[n:])
            found = rest[:n] + (f"<{flag.group(1)}>" if flag else "")
    return found or symbol


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, spill_stores,
    spill_loads, smem}}, a template instance named like ``kernel<1>``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
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

    from particle_simulator_tpu_torch.bench import dense_grid_scene
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


def phase_slice(device, lattice: str, frames: int, workdir: str, mesh=None,
                profile: bool = False):
    """Phases 4 and 11: the port's headless editor against the port's
    daemon, on one device or sharded over ``mesh``; one device runs the
    runner the scene picks (the live-tile step where it loads with more
    than one lane chunk). With ``profile``, the device's busy share over
    the serve."""
    from particle_simulator_tpu_torch.io.transport import Disconnected, Reader
    from particle_simulator_tpu_torch.engine import daemon
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc, readback

    port = _free_port()
    record = os.path.join(workdir, "slice_frames.bin")
    editor_log = os.path.join(workdir, "editor.log")
    cmd = [sys.executable, "-m", "particle_simulator_tpu_torch.editor.headless",
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
            readback.LAUNCHES["readback_pack"] = 0
            with ship_times() as times:
                t0 = time.perf_counter()
                # the steady window starts with the third frame's first step
                steady = dict(window_kernel="bucket_step", skip=200)
                shipped, busy = device_busy(serve, **steady) if profile else (serve(), None)
                serve_s = time.perf_counter() - t0
            launches = dict(bc.LAUNCHES)
            packs = readback.LAUNCHES["readback_pack"]
            rc = editor.wait(timeout=300)
        finally:
            if editor.poll() is None:
                editor.kill()
                editor.wait()
    with open(editor_log) as f:
        log_text = f.read()
    if rc != 0:
        raise AssertionError(f"editor exited {rc}:\n{log_text[-4000:]}")
    child_modules(log_text, "editor", "the headless editor")
    if shipped != frames:
        raise AssertionError(f"daemon shipped {shipped} of {frames} frames")
    if mesh is not None:
        runner, path = "sharded", HALO_KERNELS
    else:
        step = "step_compact" if sim._lane_chunks > 1 else "step"
        runner, path = STEP_RUNNERS[step], (*STEP_PATHS[step], "dest", "place")
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
    if device.startswith("cuda") and packs < frames:  # each frame read back packs once
        raise AssertionError(f"{packs} readback packs for {frames} frames")
    periods = np.diff(times[2:]) * 1e3  # after the echo and the first frame
    line = {"frames": frames, "particles": counts, "grid": list(sim.grid.grid_shape),
            "mesh": None if mesh is None else list(mesh.shape),
            "lane_chunks": sim._lane_chunks, "active_kernel": sim.active_kernel, "launches": launches,
            "readback_pack_launches": packs, "serve_s": serve_s,
            "frame_period_ms": {"median": float(np.median(periods)),
                                "p90": float(np.percentile(periods, 90)),
                                "all": [round(float(v), 3) for v in periods]},
            "profiled": profile, "device": busy}
    label = "mesh slice" if mesh is not None else "slice"
    print(f"{label}: " + json.dumps(line), flush=True)
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
    all-pairs kernel, then switched live to MatrixBuckets (the live-tile
    step where the reloaded grid has lane chunks). This script is the
    editor, on the port's own TCP server."""
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
    # the switched scene's step: the live-tile one where the reload gave it
    # lane chunks
    step = "step_compact" if sim._lane_chunks > 1 else "step"
    launches = {k: v for k, v in {**counters[0], **counters[1]}.items()
                if k in ("allpairs", step, "dest", "place")}
    compact = [c for ds, c in frames if ds == "COMPACT_ARRAY"]
    if any(c != n for c in compact):
        raise AssertionError(f"CompactArray frames lost particles: {compact}")
    if [ds for ds, _ in frames[len(compact):]].count("COMPACT_ARRAY"):
        raise AssertionError("a CompactArray frame came after the switch")
    if kernels != ["allpairs-cuda", f"{STEP_RUNNERS[step]}-cuda"]:
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

    from particle_simulator_tpu_torch.bench import dense_grid_scene
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

    from particle_simulator_tpu_torch.bench import dense_grid_scene
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
    identity = same_grid(got, single, "sharded frame")
    alive = single.ty >= 0
    if not bool(torch.isfinite(single.vx[alive]).all()):
        raise AssertionError("sharded frame: non-finite velocities")

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
            "steps_per_frame": steps, **identity,
            "launches_per_sharded_frame": per_frame,
            "frame_ms": {"single_device": [ms[0], ms[3]], "sharded": [ms[1], ms[2]]},
            "sharded_over_single": (ms[1] + ms[2]) / (ms[0] + ms[3]),
            "host_enqueue_ms_per_frame": host, "device": busy}
    print("sharded frame: " + json.dumps(line), flush=True)
    return line


def user_scene(side: int = 1000):
    """``bench.py --user-scene`` at ``side`` squared particles: a hex lattice
    at 1.1 r0 filling half of its box's side, 100 steps a frame. At 1M (the
    default) ``_grid_for`` puts it on a 1024 x 1024 x 16 grid, 27% of whose
    8-row tiles are live at 8 lane chunks; at 4M (side 2048) on 2048 x 2048
    x 16, also at 8."""
    from particle_simulator_tpu_torch.scenes.library import _scene

    return _scene(side, side, distance_factor=1.1, speed=1.0, box_fill=0.5)


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


def numpy_pack(state) -> np.ndarray:
    """The live particles of a (BY, BX, CAP) grid on the host in wire order
    (buckets row-major, slots ascending), by numpy alone: the reckoning the
    device pack (``ops/readback.py:pack_records``) is held against."""
    from particle_simulator_tpu_torch.engine.state import state_to_numpy

    parts = state_to_numpy(state)
    return parts[parts["ty"] >= 0]


def readback_check(sim) -> dict:
    """Frame k on a loaded Simulator, a synchronous host copy of its state,
    a ReadbackTicket started on it, frame k+1; then ``compare_readback``,
    and the ticket's wire bytes against the copy's ``numpy_pack``."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState
    from particle_simulator_tpu_torch.io.frame import Frame

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
    if got.bytes != Frame.from_particles(sim.meta_record, numpy_pack(copy), owned=True).bytes:
        raise AssertionError("the Simulator's wire bytes differ from the numpy pack")
    return {"active_kernel": kernel, "particles": got.particle_count}


def phase_ext_frame(device, scene, frames: int, timed: int):
    """Phase 13: the ext frame in both modes against the classic frame on
    the 1M user scene, bit for bit on every slot; frame times; then the
    readback check through a Simulator serving the scene, which picks the
    live-tile frame."""
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


def same_aux(got, want, label: str) -> None:
    """Raise unless two ``ExtStepAux`` are the same to the bit."""
    import torch

    for name in ("params", "flags", "order", "sizes", "bucket_max"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: the tile aux's {name} differs")
    if (got.ty_rows, got.lane_chunks) != (want.ty_rows, want.lane_chunks):
        raise AssertionError(f"{label}: the tile aux's tiling differs")


def tile_aux_bound(ty, old=None) -> dict:
    """The least time of one ``ps_tile_aux``: ty read once and each
    bucket's largest live slot + 1 written; with the old aux ``old`` (the
    retire), also its ``bucket_max`` read on the tiles live under it and 16
    bytes written on each slot dead in ty below it."""
    import torch

    nbytes = 4 * ty.numel() + 4 * ty[..., 0].numel()
    if old is not None:
        from particle_simulator_tpu_torch.physics import bucket

        slot = torch.arange(ty.shape[-1], device=ty.device)
        live_tiles = bucket._tile_slots(old.flags != 0, old, ty.shape)
        nbytes += 4 * int(live_tiles.sum()) + 16 * int(
            ((slot < old.bucket_max[..., None]) & (ty < 0)).sum())
    return bound(nbytes)


def tile_kernels_line(state, pv, chunks: int, rows: int, reps: int) -> dict:
    """The live-tile frame's tile kernel on one state: ``ps_tile_aux``
    against ``ext_step_aux`` bit for bit, on the state and on the rebucket's
    output after one more step, there with the retire of the buffer the
    step wrote, against ``tile_retire``; the times of both beside their
    byte bounds, and the PyTorch aux's time."""
    import torch

    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    aux = bc.ext_step_aux_cuda(state, pv, chunks, rows)
    same_aux(aux, bucket.ext_step_aux(state, pv, chunks, rows), "ps_tile_aux")
    written = bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, True).cur
    moved = bc.bucket_move_cuda(written)
    got, want = (type(written)(*(a.clone() for a in written[:4]), moved.ty) for _ in range(2))
    retire = (got, aux)
    same_aux(bc.ext_step_aux_cuda(moved, pv, chunks, rows, retire),
             bucket.ext_step_aux(moved, pv, chunks, rows), "ps_tile_aux with the retire")
    bucket.tile_retire(want, moved.ty, aux)
    same_state(got, want, "ps_tile_aux's retire")
    dead = moved.ty < 0
    if not all(torch.equal(a[dead], b[dead]) for a, b in zip(got[:4], moved[:4])):
        raise AssertionError("the retired buffer differs from the rebucket's output on a "
                             "dead slot")
    return {"aux_ms": cuda_ms(lambda: bc.ext_step_aux_cuda(state, pv, chunks, rows), reps),
            "aux_bound": tile_aux_bound(state.ty),
            "aux_plain_ms": cuda_ms(lambda: bucket.ext_step_aux(state, pv, chunks, rows), reps),
            "aux_retire_ms": cuda_ms(
                lambda: bc.ext_step_aux_cuda(moved, pv, chunks, rows, retire), reps),
            "aux_retire_bound": tile_aux_bound(moved.ty, aux),
            "retired_slots": int(((state.ty >= 0) & (moved.ty < 0)).sum())}


def tile_kernels_sweep(device) -> list:
    """``ps_tile_aux`` and its retire against their plain versions on small
    grids: random half-live ones of several caps (16-byte and scalar loads)
    and tilings, one with 2,048 one-row tiles (the partition in two chunks
    of the block), single live tiles and the all-dead grid; the retire
    against the ty of another random grid."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams
    from particle_simulator_tpu_torch.io.frame import default_metadata
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    pv = SimParams.from_record(default_metadata()).vector(device)
    lines = []
    cases = [(shape, chunks, rows, share) for shape, chunks, rows, share in (
        ((16, 32, 16), 2, 8, 0.5), ((16, 64, 16), 4, 4, 0.2), ((32, 16, 12), 1, 16, 0.5),
        ((16, 32, 6), 8, 8, 0.3), ((1024, 4, 2), 2, 1, 0.3), ((16, 32, 16), 2, 8, 0.0),
        ((16, 32, 16), 4, 8, -1), ((1024, 4, 2), 2, 1, -1))]
    for seed, (shape, chunks, rows, share) in enumerate(cases):
        rng = np.random.default_rng(seed)
        ty = np.where(rng.random(shape) < share, 0, -1).astype(np.int32)
        ty[: shape[0] // 2, : shape[1] // 3] = -1  # dead tiles among the live
        if share < 0:  # one live slot, in the last tile
            ty[-1, -1, 1] = 0
        new_ty = np.where(rng.random(shape) < 0.4, 0, -1).astype(np.int32)
        fields = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32))
                  for _ in range(2)]
        fields += [torch.from_numpy(rng.normal(0, 50, shape).astype(np.float32)) for _ in range(2)]
        old = ParticleState(*(a.to(device) for a in (*fields, torch.from_numpy(ty))))
        aux = bc.ext_step_aux_cuda(old, pv, chunks, rows)
        same_aux(aux, bucket.ext_step_aux(old, pv, chunks, rows), f"{shape} aux")
        new = ParticleState(*old[:4], torch.from_numpy(new_ty).to(device))
        got, want = (ParticleState(*(a.clone() for a in new[:4]), new.ty) for _ in range(2))
        same_aux(bc.ext_step_aux_cuda(new, pv, chunks, rows, (got, aux)),
                 bucket.ext_step_aux(new, pv, chunks, rows), f"{shape} aux with the retire")
        bucket.tile_retire(want, new.ty, aux)
        same_state(got, want, f"{shape} retire")
        lines.append({"grid": list(shape), "lane_chunks": chunks, "ty_rows": aux.ty_rows,
                      "tiles": int(aux.flags.numel()), "live_tiles": int(aux.flags.sum()),
                      "omax": int(aux.params[-1])})
    return lines


# phase 25: the live-tile step (row 5) as it serves the 1M lattice
# (grid, lane chunks, rows a tile asked for, width of the live slots in a
# bucket): the live-tile step's 16-byte stage where omax is small beside
# cap, on 8- 4- and 16-row tiles, one-bucket tiles, cap 64 with omax at most
# 32 on a narrowed sub-tile whose last column is cut, and the all-dead grid
LIVE_TILE_GEOMETRIES = (
    ((16, 32, 16), 2, 8, 5),
    ((16, 64, 16), 4, 4, 8),
    ((32, 16, 12), 1, 16, 6),
    ((8, 8, 16), 8, 8, 3),
    ((16, 32, 64), 1, 8, 20),
    ((16, 32, 16), 2, 8, 0),
)
# the drag of the benchmark's ``drag`` traffic (benchmark/traffic/drag.json):
# the cursor circles the box centre at a quarter of its side, a turn every
# 4 s at ~35 frames a second, size 0.05; the states are read as loaded and
# after these frames (the lattice has spread over ~half of its tiles after
# 300 and over all of them after 900)
LIVE_TILE_DRAG_FRAMES = (300, 900)
# served frames of the drag held bit for bit against the classic frame: the
# first after the load (which copies the given state), the frames after it
# (each steps into the buffer the one before kept), and later ones
LIVE_TILE_HELD_FRAMES = (0, 1, 2, 298, 299, 898, 899)
DRAG_RADIUS, DRAG_TURN_FRAMES, DRAG_SIZE = 0.25, 140, 0.05


def live_tile_sweep(device) -> list:
    """The live-tile step on small random half-live grids whose live slots
    lie below a width in each bucket (``LIVE_TILE_GEOMETRIES``): two steps
    on one buffer pair bit-identical to the classic step, the first to the
    plain ext step."""
    import torch

    from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams
    from particle_simulator_tpu_torch.io.frame import default_metadata
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    meta = default_metadata()
    meta["step_dt"] = 10e-15
    pv = SimParams.from_record(meta).vector(device)
    lines = []
    for seed, (shape, chunks, rows, width) in enumerate(LIVE_TILE_GEOMETRIES):
        rng = np.random.default_rng(seed)
        n = int(np.prod(shape))
        live = (rng.random(shape) < 0.5) & (np.arange(shape[2]) < width)
        fields = (rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
                  rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32),
                  rng.normal(0, 50, n).astype(np.float32),
                  rng.normal(0, 50, n).astype(np.float32),
                  np.where(live.ravel(), 0, -1).astype(np.int32))
        state = ParticleState(*(torch.from_numpy(a).to(device).reshape(shape) for a in fields))
        state.ty[: shape[0] // 2, : shape[1] // 3] = -1  # dead tiles and buckets
        aux = bucket.ext_step_aux(state, pv, chunks, rows)
        classic = [bc.bucket_step_cuda(state, pv)]
        classic.append(bc.bucket_step_cuda(classic[0], pv))
        pair = bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, True)
        same_state(pair.cur, bucket.bucket_step_ext(state, aux, True), f"{shape} vs plain")
        same_state(pair.cur, classic[0], f"{shape} step 0 vs classic")
        pair = bc.bucket_step_ext_cuda(pair, aux, True)
        same_state(pair.cur, classic[1], f"{shape} step 1 vs classic")
        lines.append({"grid": list(shape), "lane_chunks": chunks, "ty_rows": aux.ty_rows,
                      "omax": int(aux.params[-1]), "live_tile_share": live_tile_share(aux),
                      "live": int((state.ty >= 0).sum())})
    return lines


def drag_edit(sim, frame: int):
    """The metadata-only frame of the drag's cursor at served frame
    ``frame`` (``LIVE_TILE_DRAG_FRAMES``' circle)."""
    import math

    from particle_simulator_tpu_torch.io.frame import Frame

    angle = 2.0 * math.pi * frame / DRAG_TURN_FRAMES
    edit = Frame.from_metadata(sim.meta_record.copy())
    edit.metadata.cursor_pos = (0.5 + DRAG_RADIUS * math.cos(angle),
                                0.5 + DRAG_RADIUS * math.sin(angle))
    edit.metadata.cursor_size = DRAG_SIZE
    return edit


def live_tile_state_line(state, pv, chunks: int, rows: int, reps: int, sass: dict) -> dict:
    """The live-tile step on one state: two steps on one buffer pair held
    against the classic CUDA step, the first against the plain ext step, bit
    for bit; its time beside the bound, omax and the live-tile share."""
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket

    aux = bucket.ext_step_aux(state, pv, chunks, rows)
    first = bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, True)
    same_state(first.cur, bucket.bucket_step_ext(state, aux, True), "live-tile step vs plain")
    classic = bc.bucket_step_cuda(state, pv)
    same_state(first.cur, classic, "live-tile step vs the classic step")
    second = bc.bucket_step_ext_cuda(first, aux, True)
    same_state(second.cur, bc.bucket_step_cuda(classic, pv), "live-tile step 1 vs classic")
    pair = bc.ext_pair(state)
    ms = cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps)
    bnd = ext_bound(state, sass)
    return {"omax": int(aux.params[-1]), "live_tile_share": live_tile_share(aux),
            "live": int((state.ty >= 0).sum()), "pairs_per_step": bucket_pairs(state),
            "ms": ms, "bound": bnd, "share_of_bound": bnd["bound_ms"] / ms}


def phase_live_tile(device, reps: int, sass: dict) -> dict:
    """Phase 25: the live-tile step (``bucket_step_kernel_tiles<true>``,
    row 5) on the 1M lattice of the ``editor-lattice-1m`` configuration
    (1024 x 1024 at 1.1 r0 over half of the box's side: a 1024 x 1024 x 16
    grid of 8 lane chunks), as loaded and after the served frames of a
    cursor drag (``LIVE_TILE_DRAG_FRAMES``): on each state held bit for bit
    against its plain version and the classic step and timed beside its
    bound, with omax and the live-tile share; the step's registers and
    blocks a multiprocessor, and the every-tile instance's beside them; the
    drag's ``step.live_tile_launches`` count against the launches; then the
    small grids of ``LIVE_TILE_GEOMETRIES``."""
    import ctypes

    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.physics import bucket
    from particle_simulator_tpu_torch.utils import profiling

    sim = Simulator(device=device)
    sim.load_frame(user_scene(1024))
    gy, gx, cap = sim.state.x.shape
    chunks, pv = sim._lane_chunks, sim._pvec
    rows = max(1, 1 << max(0, int(sim.meta_record["gpu_threads_per_block_log2"]) - 4))
    ptxas = ptxas_summary((build.BUILD_DIR / build.BUILD_LOG).read_text())
    occupancy = {}
    for name, compact in (("bucket_step_kernel_tiles<1>", 1), ("bucket_step_kernel_tiles<0>", 0)):
        out = (ctypes.c_int * 2)()
        rc = build.library().ps_bucket_tiles_occupancy(rows, gx // chunks, cap, compact, out)
        if rc:
            raise AssertionError(f"ps_bucket_tiles_occupancy failed with cudaError_t {rc}")
        occupancy[name] = {**ptxas.get(name, {}), "blocks_per_sm": out[0], "smem_bytes": out[1]}
    def state_line(state, pv):
        return {**live_tile_state_line(state, pv, chunks, rows, reps, sass),
                "tile_kernels": tile_kernels_line(state, pv, chunks, rows, reps)}

    states = {"loaded": state_line(sim.state, pv)}
    real, profiling.RECORDER = profiling.RECORDER, profiling.Recorder()
    served = 0  # the drag's frames' launches, not the holds' and timings'
    launched = dict.fromkeys(("step_compact", "tile_aux", "tile_retire"), 0)
    held = []  # served frames held against the classic frame
    try:
        with profiling.recording():
            for target in LIVE_TILE_DRAG_FRAMES:
                before = dict(bc.LAUNCHES)
                while served < target:
                    sim.update_metadata(drag_edit(sim, served))
                    given = sim.state
                    ref = (type(given)(*(a.clone() for a in given))
                           if served in LIVE_TILE_HELD_FRAMES else None)
                    sim.frame_async()
                    if ref is not None:
                        steps, every = sim.params.steps_per_frame, sim.grid.move_every
                        launches = dict(bc.LAUNCHES)
                        same_state(sim.state, bc.run_frame_bucket_cuda(ref, sim._pvec, steps,
                                                                       every),
                                   f"served frame {served} against the classic frame")
                        same_state(given, ref, f"the state served frame {served} was given")
                        bc.LAUNCHES.update(launches)
                        held.append(served)
                    served += 1
                for k in launched:
                    launched[k] += bc.LAUNCHES[k] - before[k]
                states[f"after {target} frames"] = state_line(sim.state, sim._pvec)
        counted = profiling.RECORDER.counters.get("step.live_tile_launches", 0)
    finally:
        profiling.RECORDER = real
    if sim.active_kernel != "bucket-compact-cuda":
        raise AssertionError(f"the drag ran through {sim.active_kernel}")
    steps = served * sim.params.steps_per_frame
    if not counted == launched["step_compact"] == steps:
        raise AssertionError(f"step.live_tile_launches {counted}, launches {launched}, "
                             f"steps {steps}")
    # an aux at every run's entry but the first of a frame that finds the
    # one before kept (all but the first after the load), a retire at every
    # run's entry but the first and but the second of that first frame
    runs = len(bucket.frame_runs(sim.params.steps_per_frame, sim.grid.move_every))
    if (launched["tile_aux"], launched["tile_retire"]) != ((runs - 1) * served + 1,
                                                          (runs - 1) * served - 1):
        raise AssertionError(f"tile kernel launches {launched} over {served} frames of "
                             f"{runs} runs")
    line = {"grid": [gy, gx, cap], "lane_chunks": chunks, "ty_rows": rows, "frames": served,
            "step_live_tile_launches": counted, "launches": launched,
            "frames_held_against_classic": held, "kernels": occupancy, "states": states}
    print("live-tile step: " + json.dumps(line), flush=True)
    print("live-tile geometries: " + json.dumps(live_tile_sweep(device)), flush=True)
    print("tile kernels: " + json.dumps(tile_kernels_sweep(device)), flush=True)
    return line


# (grid shape, live share): the readback pack beyond the scenes of phase 24:
# a cap that takes the scalar count (6), a grid whose last block of buckets
# is ragged, caps 12 and 64
READBACK_GEOMETRIES = (
    ((8, 16, 8), 0.5),
    ((5, 700, 6), 0.3),     # 3,500 buckets: a ragged last tile; cap 6
    ((32, 64, 12), 0.93),
    ((16, 32, 64), 0.07),
    ((64, 64, 16), 1.0),
)


def readback_bound(state, ncap: int) -> dict:
    """The least time of one record pack: each bucket's ty up to and
    including its first tombstone (a full bucket has none), the live
    records' 20 bytes read once, ``ncap`` records and the 16-byte header
    written once."""
    import torch

    counts = (state.ty >= 0).sum(-1, dtype=torch.int64)
    live = int(counts.sum())
    open_buckets = int((counts < state.ty.shape[-1]).sum())
    return bound(4 * (live + open_buckets) + 20 * live + 20 * int(ncap) + 16)


def hold_readback(state, ncap: int, label: str) -> int:
    """The record pack of ``state`` on its card against its plain version
    on the same card, every word; returns the live count."""
    import torch

    from particle_simulator_tpu_torch.ops.readback import RECORD_WORDS, pack_records, records_plain

    got, want = pack_records(state, ncap), records_plain(state, ncap)
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).reshape(-1)
        raise AssertionError(f"{label}, ncap {ncap}: {int(bad.numel())} record words differ "
                             f"from the plain pack, first at {bad[:8].tolist()}")
    return int(want[ncap * RECORD_WORDS + 1])


def phase_readback_pack(device, reps: int) -> dict:
    """Phase 24: the record pack against its plain version on the served
    lattice's grid, the dense and user scenes, an all-dead grid and
    ``READBACK_GEOMETRIES``; kernel and plain times at the lattice grid."""
    import torch

    from particle_simulator_tpu_torch.bench import dense_grid_scene
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.engine.state import ParticleState, state_from_numpy
    from particle_simulator_tpu_torch.ops.readback import pack_records, pow2_at_least, records_plain
    from particle_simulator_tpu_torch.physics.bucket import GridConfig
    from particle_simulator_tpu_torch.scenes.library import _scene

    def hold_all(state, label):
        live = int((state.ty >= 0).sum())
        ncap = pow2_at_least(live)
        for n in {ncap, 4 * ncap, max(1, ncap // 4)}:
            hold_readback(state, n, label)
        return live

    held = {}
    sim = Simulator(device=device)
    sim.load_frame(_scene(1024, 1024, distance_factor=1.1, speed=50.0, box_fill=0.5, dt=1e-14))
    lattice = sim.state
    held["lattice"] = hold_all(lattice, "lattice grid")
    dead = ParticleState(*lattice[:4], torch.full_like(lattice.ty, -1))
    held["all_dead"] = hold_all(dead, "all-dead grid")
    for _ in range(3):
        sim.frame_async()
    held["lattice_3_frames"] = hold_all(sim.state, "lattice grid after three frames")
    cfg = GridConfig(8, 9, 8)
    parts = dense_grid_scene(cfg)[0]
    held["dense"] = hold_all(state_from_numpy(parts, cfg.capacity, device).reshape(
        cfg.grid_shape), "dense scene")
    user = Simulator(device=device)
    user.load_frame(user_scene())
    held["user"] = hold_all(user.state, "user scene")
    rng = np.random.default_rng(24)
    for shape, share in READBACK_GEOMETRIES:
        by, bx, cap = shape
        cnt = rng.binomial(cap, share, (by, bx))
        ty = np.where(np.arange(cap)[None, None, :] < cnt[..., None],
                      rng.integers(0, 5, shape), -1).astype(np.int32)
        ty[0, : bx // 3] = -1
        state = ParticleState(
            *(torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32))
              for _ in range(2)),
            *(torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(2)),
            torch.from_numpy(ty))
        state = ParticleState(*(a.to(device) for a in state))
        held["x".join(map(str, shape))] = hold_all(state, f"random grid {shape}")
    ncap = pow2_at_least(held["lattice"])
    line = {"grid": list(lattice.x.shape), "live": held["lattice"], "ncap": ncap,
            "held_live": held, "bit_identical_every_word": True,
            "ms": cuda_ms(lambda: pack_records(lattice, ncap), reps),
            "plain_ms": cuda_ms(lambda: records_plain(lattice, ncap), reps),
            **readback_bound(lattice, ncap)}
    line["share_of_bound"] = line["bound_ms"] / line["ms"]
    print("readback pack: " + json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def counted_launches():
    """Every wrapper's launch count set to 0 on entry; the yielded dict holds
    the counts of the enclosed run once the context closes."""
    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda

    counters = (allpairs_cuda.LAUNCHES, bucket_cuda.LAUNCHES)
    for launches in counters:
        for k in launches:
            launches[k] = 0
    seen = {}
    try:
        yield seen
    finally:
        for launches in counters:
            seen.update(launches)


def script_module(name: str):
    """A script of ``scripts/`` as a module (its record function is called
    in this process, not through a subprocess)."""
    import importlib

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


# a one-device frame's step kernel (its LAUNCHES key) -> the Simulator's runner
STEP_RUNNERS = {"step": "bucket", "step_compact": "bucket-compact"}
# ... -> the kernels its frames launch beside the rebucket's (the live-tile
# frame's tile aux and its retires)
STEP_PATHS = {"step": ("step",), "step_compact": ("step_compact", "tile_aux", "tile_retire")}


class KernelHold:
    """Holds every kernel the scripts' path runs against its plain version,
    bit for bit, on the states that path itself hands over (the drivers'
    ``inspect`` hook): a flat state holds the all-pairs step, a (BY, BX, CAP)
    grid the classic step, the dest and the place, and the live-tile step
    where a ``Simulator`` would run it on a scene loaded as that grid (more
    than one lane chunk); the line names the grid's lane chunks and the
    served step's ``LAUNCHES`` key as ``served_step``. The comparison's own
    launches are taken out of the counts again. ``held`` lists what was
    compared; ``err`` is the largest live-velocity difference per kernel
    (0.0, or the comparison raised)."""

    def __init__(self):
        self.held = []
        self.err = {"step": 0.0, "dest": 0.0, "place": 0.0, "allpairs": 0.0}

    def __call__(self, label: str, state, pv) -> None:
        import torch

        from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda as bc
        from particle_simulator_tpu_torch.physics import bucket, step

        counters = (allpairs_cuda.LAUNCHES, bc.LAUNCHES)
        before = [dict(c) for c in counters]
        line = {"at": label, "shape": list(state.x.shape), "live": int((state.ty >= 0).sum())}
        if state.x.dim() == 1:
            err = same_state(allpairs_cuda.allpairs_step_cuda(state, pv),
                             step.allpairs_step(state, pv),
                             f"{label}: the all-pairs step against its plain version")
            self.err["allpairs"] = max(self.err["allpairs"], err)
        else:
            err = same_state(bc.bucket_step_cuda(state, pv), bucket.bucket_step(state, pv),
                             f"{label}: the step against its plain version")
            self.err["step"] = max(self.err["step"], err)
            dest, dest_ref = bc.move_dest_cuda(state), bucket.move_dest_direct(state)
            if not torch.equal(dest, dest_ref):
                raise AssertionError(f"{label}: dest ids differ at "
                                     f"{int((dest != dest_ref).sum())} slots")
            err = same_state(bc.bucket_place_cuda(state, dest_ref),
                             bucket.bucket_place(state, dest_ref),
                             f"{label}: the place against its plain version")
            self.err["place"] = max(self.err["place"], err)
            own = torch.arange(dest_ref.numel(), dtype=dest_ref.dtype,
                               device=dest_ref.device).reshape(dest_ref.shape)
            line["moved_by_dest"] = int(((dest_ref >= 0) & (dest_ref != own)).sum())
            chunks = self.hold_live_tiles(label, state, pv)
            line["lane_chunks"] = chunks
            line["served_step"] = "step_compact" if chunks > 1 else "step"
        for counter, was in zip(counters, before):
            counter.update(was)
        self.held.append(line)

    def hold_live_tiles(self, label: str, state, pv) -> int:
        """The live-tile step against its plain version on the lane chunks
        the Simulator's load rule picks for the grid ``state``
        (``_lane_chunks_for``) and 8-row tiles (the default launch width's);
        returns the chunk count (1: nothing held, since the live-tile frame
        then does not run)."""
        from particle_simulator_tpu_torch.engine.simulator import _lane_chunks_for
        from particle_simulator_tpu_torch.ops import bucket_cuda as bc
        from particle_simulator_tpu_torch.physics import bucket

        grid = bucket.GridConfig(*bucket.grid_log2(state), state.x.shape[-1])
        chunks = _lane_chunks_for((state.ty >= 0).sum(-1).cpu().numpy(), grid)
        if chunks == 1:
            return 1
        launches = dict(bc.LAUNCHES)
        aux = bucket.ext_step_aux(state, pv, chunks, 8)
        same_aux(bc.ext_step_aux_cuda(state, pv, chunks, 8), aux,
                 f"{label}: the tile aux kernel against its plain version")
        err = same_state(bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, True).cur,
                         bucket.bucket_step_ext(state, aux, True),
                         f"{label}: the live-tile step against its plain version")
        bc.LAUNCHES.update(launches)
        self.err["step_compact"] = max(self.err.get("step_compact", 0.0), err)
        return chunks


def phase_configs(device: str, frames: int, steps: int, hold: KernelHold):
    """Phase 15: BASELINE configs 1-3 through ``scripts/torch_bench_configs.py``'s
    ``bench_config``: the Simulator's own dispatch, ``frames`` timed frames
    of ``steps`` steps after one warm-up frame, ``Simulator.sync()`` as the
    barrier; the kernels held on each config's state as loaded and after
    its frames. Config 3's step is the one its scene picks as loaded (the
    hold's ``served_step``)."""
    bench = script_module("torch_bench_configs")
    want = {1: ("allpairs", "allpairs"), 2: ("allpairs", "allpairs"), 3: ("bucket", "step")}
    records, total = {}, {}
    for num, (runner, kernel) in want.items():
        first = len(hold.held)
        with counted_launches() as launches:
            rec = bench.bench_config(num, frames, steps, torch_device=device, inspect=hold)
        if num == 3:
            kernel = hold.held[first]["served_step"]
            runner = STEP_RUNNERS[kernel]
        if rec["kernel"] != f"{runner}-cuda" or rec["device"] != "cuda":
            raise AssertionError(f"config {num} ran through {rec['kernel']} on {rec['device']}")
        if launches[kernel] != (frames + 1) * steps:  # the warm-up frame too
            raise AssertionError(f"config {num}: {launches[kernel]} {kernel} launches, "
                                 f"expected {(frames + 1) * steps}")
        if num == 3 and (launches["dest"] == 0 or launches["place"] == 0):
            raise AssertionError(f"config 3 never rebucketed: {launches}")
        if rec["live_after"] != rec["particles"]:
            raise AssertionError(f"config {num} lost particles: {rec}")
        rec["launches"] = {k: v for k, v in launches.items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        records[num] = rec
        print("config: " + json.dumps(rec), flush=True)
    return records, total


def phase_sweep(device: str, hold: KernelHold):
    """Phase 16: config 4, the states-of-matter sweep of
    ``scripts/torch_phase_sweep_chip.py`` at full size (512 x 512) with the
    script's own step budgets (they fit: ~33 s on the H100); all six
    order-parameter checks must hold, and the kernels are held on each
    phase's state as loaded and after its last frame. Each phase runs the
    step that its scene picks as loaded (the hold's ``served_step``)."""
    sweep = script_module("torch_phase_sweep_chip")
    first = len(hold.held)
    t0 = time.perf_counter()
    with counted_launches() as launches:
        records, verdict = sweep.phase_sweep(
            torch_device=device, inspect=hold,
            emit=lambda rec: print("sweep phase: " + json.dumps(rec), flush=True))
    seconds = time.perf_counter() - t0
    steps = sum(rec["steps"] for rec in records)
    line = {**verdict, "particles": records[0]["particles"], "steps": steps,
            "seconds": seconds, "live_after": {rec["phase"]: rec["n"] for rec in records},
            "launches": {k: v for k, v in launches.items() if v}}
    print("sweep: " + json.dumps(line), flush=True)
    if not verdict["ok"]:
        raise AssertionError(f"the phase sweep failed its checks: {verdict['checks']}")
    loaded = {h["at"]: h["served_step"] for h in hold.held[first:]}
    want = dict.fromkeys(STEP_RUNNERS, 0)
    for rec in records:
        kernel = loaded[f"{rec['phase']} as loaded"]
        want[kernel] += rec["steps"]
        if rec["kernel"] != f"{STEP_RUNNERS[kernel]}-cuda":
            raise AssertionError(f"phase {rec['phase']} ran through {rec['kernel']}")
    if any(launches[k] != n for k, n in want.items()) or launches["dest"] == 0 \
            or launches["place"] == 0:
        raise AssertionError(f"the sweep's {steps} steps launched {launches}, expected {want}")
    return line, launches


def phase_soak(device: str, steps: int, check_every: int, hold: KernelHold):
    """Phase 17: the leapfrog energy soak of
    ``scripts/torch_soak_leapfrog_1e6.py`` through ``run_frame_bucket_cuda``;
    the kernels held on its 8 x 8 x 16 grid at the start and the end."""
    soak = script_module("torch_soak_leapfrog_1e6")
    with counted_launches() as launches:
        rec = soak.soak(steps, check_every, torch_device=device, progress=False, inspect=hold)
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["steps_per_s"] = steps / max(rec.get("elapsed_s", 0.0), 1e-9)
    print("soak: " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise AssertionError(f"the soak exploded: {rec}")
    if rec["live_end"] != rec["live_start"]:
        raise AssertionError(f"the soak lost particles: {rec}")
    if not rec["worst_energy_drift"] < 0.05:
        raise AssertionError(f"the soak drifted {rec['worst_energy_drift']:.2%}")
    if rec["device"] != "cuda" or launches["step"] != steps:
        raise AssertionError(f"the soak's {steps} steps launched {launches} on {rec['device']}")
    return rec, launches


def integrator_scene():
    """The integrator-analysis scene: a 6x6 hex lattice, mildly stretched
    (1.05 r0) and hot (400 m/s), dt = 1 fs, no cursor. Returns (particles,
    metadata record)."""
    from particle_simulator_tpu_torch.io.frame import Frame
    from particle_simulator_tpu_torch.io.presets import ParticleLattice

    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((6, 6), distance_factor=1.05, velocity=(0.0, 400.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(0))
    rec = meta.copy()
    rec["step_dt"] = 1e-15
    rec["cursor_pos"] = (-1.0, -1.0)
    return frame.particles.copy(), rec


def integrator_drifts(step_fn, frames: int, steps_per_frame: int, device="cpu",
                      inspect=None) -> list:
    """The relative energy drift |E - E0| / |E0| of the integrator scene
    after each of ``frames`` frames of ``steps_per_frame`` steps of
    ``step_fn(state, params)`` (the instantaneous drift, not a running
    maximum); ``[inf]`` once the energy is no longer finite.
    ``inspect(label, state, params)`` sees the first and the last state."""
    from particle_simulator_tpu_torch.engine.state import (
        SimParams,
        state_from_numpy,
        state_to_numpy,
    )
    from particle_simulator_tpu_torch.physics import oracle
    from particle_simulator_tpu_torch.physics.step import run_frame

    parts, rec = integrator_scene()
    state = state_from_numpy(parts, len(parts), device)
    pv = SimParams.from_record(rec).vector(device)
    e0 = oracle.total_energy(parts, rec)
    scale = max(abs(e0), 1e-21)
    if inspect is not None:
        inspect("integrator scene as loaded", state, pv)
    drifts = []
    for _ in range(frames):
        state = run_frame(state, pv, steps_per_frame, step_fn)
        e = oracle.total_energy(state_to_numpy(state), rec)
        if not np.isfinite(e):
            return [np.inf]
        drifts.append(abs(e - e0) / scale)
    if inspect is not None:
        inspect(f"integrator scene after {frames * steps_per_frame} steps", state, pv)
    return drifts


def quarter_points(drifts: list) -> list:
    """The drift at each quarter of the horizon."""
    n = len(drifts)
    return [drifts[n // 4 - 1], drifts[n // 2 - 1], drifts[3 * n // 4 - 1], drifts[-1]]


def secular_growth(drifts: list) -> bool:
    """Explosion, asserted the robust way: the drift is no longer finite, or
    it grows strictly from quarter point to quarter point."""
    q = quarter_points(drifts)
    return drifts[-1] == np.inf or q[0] < q[1] < q[2] < q[3]


# The least phase 18 accepts for Euler's drift after its horizon over
# leapfrog's worst drift within the same number of steps, both read at the
# same step counts. With 2,000 steps read every 250 the two read 0.0777
# against 1.29e-3 (60x) on the H100 and on the CPU alike; the bound leaves a
# margin under that. Leapfrog's energy, read with its half-step velocity
# offset, swings most while the stretched lattice relaxes in the first 1,000
# steps (up to 2.9e-3 when read every 50 steps: still 27x under Euler).
EULER_OVER_LEAPFROG_MIN = 20.0


def integrator_contrast(leapfrog: list, euler: list) -> dict:
    """Euler's drifts against leapfrog's, both read every so many steps from
    the same start, ``leapfrog`` over at least Euler's horizon: Euler's drift
    must grow from quarter point to quarter point, lie above leapfrog's at
    every common read, and end at least ``EULER_OVER_LEAPFROG_MIN`` times
    above the worst leapfrog shows within Euler's horizon. Raises otherwise;
    returns the figures."""
    same = leapfrog[:len(euler)]
    if len(same) != len(euler):
        raise AssertionError("leapfrog's horizon is shorter than Euler's")
    line = {"leapfrog_worst_drift_same_horizon": max(same),
            "euler_quarter_points": quarter_points(euler),
            "euler_over_leapfrog_same_horizon": euler[-1] / max(max(same), 1e-300),
            "euler_over_leapfrog_min": EULER_OVER_LEAPFROG_MIN}
    if not secular_growth(euler):
        raise AssertionError(f"Euler's drift is not secular: {quarter_points(euler)}")
    if euler[-1] != np.inf:
        if not all(e > lf for e, lf in zip(euler, same)):
            raise AssertionError(f"Euler {euler} is not above leapfrog {same} at every read")
        if not euler[-1] > EULER_OVER_LEAPFROG_MIN * max(same):
            raise AssertionError(f"no contrast: Euler {euler[-1]:.3g} against leapfrog "
                                 f"{max(same):.3g} over the same steps")
    return line


def phase_integrators(device: str, leapfrog_frames: int, euler_frames: int,
                      steps_per_frame: int, hold: KernelHold):
    """Phase 18: explicit Euler against leapfrog on the integrator scene,
    both read every ``steps_per_frame`` steps. Leapfrog through the
    all-pairs CUDA kernel over the whole horizon, its drift under 5%
    throughout; Euler through ``allpairs_step_euler`` (some 350 small torch
    ops a step on CUDA tensors, ~5 ms) over the horizon that fits, held
    against leapfrog's drift over the same steps (``integrator_contrast``).

    The card does not show the full claim (Euler's drift above 0.5 and above
    100x leapfrog's after 100,000 steps): at 5 ms a step that horizon takes
    minutes. It is the CPU suite's, in the test marked ``slow``."""
    from particle_simulator_tpu_torch.ops.allpairs_cuda import allpairs_step_cuda
    from particle_simulator_tpu_torch.physics.step import allpairs_step_euler

    t0 = time.perf_counter()
    with counted_launches() as launches:
        leapfrog = integrator_drifts(allpairs_step_cuda, leapfrog_frames, steps_per_frame,
                                     device, inspect=hold)
    leapfrog_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    euler = integrator_drifts(allpairs_step_euler, euler_frames, steps_per_frame, device)
    euler_s = time.perf_counter() - t0
    worst = max(leapfrog)
    line = {"steps_per_read": steps_per_frame,
            "leapfrog_steps": leapfrog_frames * steps_per_frame,
            "leapfrog_worst_drift": worst, "leapfrog_s": leapfrog_s,
            "euler_steps": euler_frames * steps_per_frame, "euler_s": euler_s,
            "launches": {k: v for k, v in launches.items() if v}}
    if not worst < 0.05:
        raise AssertionError(f"leapfrog drifted {worst:.2%} on the integrator scene")
    if launches["allpairs"] != leapfrog_frames * steps_per_frame:
        raise AssertionError(f"leapfrog launched {launches}")
    line.update(integrator_contrast(leapfrog, euler))
    print("integrators: " + json.dumps(line), flush=True)
    return line, launches


def png_size(path) -> tuple[int, int]:
    """(width, height) of a PNG file, from its IHDR chunk; raises unless the
    file is a PNG whose image data inflates to ``height`` RGB8 rows."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: image data is not {w}x{h} RGB8")
    return w, h


def gif_shape(path) -> tuple[int, int, int]:
    """(width, height, frames) of a GIF89a file: the logical screen size and
    the number of image descriptors, walking the block structure."""
    import struct

    data = Path(path).read_bytes()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path} is not a GIF89a")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
    frames = 0

    def skip_blocks(pos):
        while data[pos]:
            pos += 1 + data[pos]
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: label, then sub-blocks
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image: descriptor, LZW code size, sub-blocks
            if struct.unpack("<HH", data[pos + 5:pos + 9]) != (w, h):
                raise AssertionError(f"{path}: a frame is not {w}x{h}")
            frames += 1
            pos = skip_blocks(pos + 11)
        else:
            raise AssertionError(f"{path}: unknown block 0x{data[pos]:02x} at {pos}")
    return w, h, frames


def trace_names(path) -> tuple[set, set]:
    """(names of the annotation ranges, names of the device kernels) in a
    Chrome trace written by ``utils/profiling.py:trace``."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") in ("user_annotation", "gpu_user_annotation")}
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    return ranges, kernels


def phase_scene_cli(workdir: str, hold: KernelHold, frames: int = 3, size: int = 256):
    """Phase 19: the scene runner's command line (``scenes/library.py:main``)
    renders the liquid droplet to PNGs and a GIF; then one frame of the same
    scene under ``trace`` with an ``annotate("dispatch")`` range around its
    dispatch, the kernels held on its state before and after that frame."""
    import io

    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.scenes import library
    from particle_simulator_tpu_torch.utils.profiling import annotate, trace

    render = os.path.join(workdir, "render")
    gif = os.path.join(workdir, "droplet.gif")
    argv = ["liquid_droplet", "--frames", str(frames), "--render", render, "--gif", gif,
            "--size", str(size)]
    out = io.StringIO()
    with counted_launches() as launches, contextlib.redirect_stdout(out):
        rc = library.main(argv)
    if rc != 0:
        raise AssertionError(f"the scene runner exited {rc}")
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    pngs = sorted(Path(render).glob("frame_*.png"))
    if len(pngs) != frames or any(png_size(f) != (size, size) for f in pngs):
        raise AssertionError(f"expected {frames} PNGs of {size}x{size}, got {pngs}")
    if gif_shape(gif) != (size, size, frames):
        raise AssertionError(f"the GIF is {gif_shape(gif)}, expected {(size, size, frames)}")
    if stats["particles"] != 2025 or stats["frames"] != frames:
        raise AssertionError(f"scene stats {stats}")
    if not np.isfinite(stats["mean_speed"]):
        raise AssertionError(f"scene stats {stats}")
    if launches["step"] != frames * stats["steps_per_frame"] or not (
            launches["dest"] and launches["place"]):
        raise AssertionError(f"the scene runner's {frames} frames launched {launches}")

    sim = Simulator(device="cuda")
    sim.load_frame(library.liquid_droplet())
    hold("liquid droplet as loaded", sim.state, sim._pvec)
    trace_dir = os.path.join(workdir, "trace")
    with trace(trace_dir):
        with annotate("dispatch"):
            sim.frame_async()
        sim.read_frame()
    hold("liquid droplet after 1 frame", sim.state, sim._pvec)
    files = sorted(Path(trace_dir).glob("*.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace file, got {files}")
    ranges, kernels = trace_names(files[0])
    if "dispatch" not in ranges:
        raise AssertionError(f"the trace names no 'dispatch' range: {sorted(ranges)[:10]}")
    if not any("bucket_step" in k for k in kernels):
        raise AssertionError(f"the trace names no step kernel: {sorted(kernels)[:10]}")
    line = {"stats": stats, "pngs": len(pngs), "gif": list(gif_shape(gif)),
            "launches": {k: v for k, v in launches.items() if v},
            "trace_bytes": files[0].stat().st_size, "trace_ranges": sorted(ranges)[:4],
            "trace_kernels": sorted(k[:40] for k in kernels)[:6]}
    print("scene cli: " + json.dumps(line), flush=True)
    return line, launches


# ---------------------------------------------------------------------------
# phase 20: several processes (parallel/multihost.py)
# ---------------------------------------------------------------------------

def same_grid(got, ref, label: str) -> dict:
    """Raise unless ``ty`` is equal everywhere and x, y, vx, vy on every live
    slot; say whether every slot is equal too."""
    import torch

    if not torch.equal(got.ty, ref.ty):
        raise AssertionError(f"{label}: ty differs at {int((got.ty != ref.ty).sum())} slots")
    alive = ref.ty >= 0
    for name, a, b in zip(got._fields[:4], got, ref):
        if not torch.equal(a[alive], b[alive]):
            raise AssertionError(f"{label}: live {name} differs")
    return {"bit_identical_live": True,
            "bit_identical_all_slots": all(torch.equal(a, b) for a, b in zip(got, ref))}


def child_lines(outs, label: str) -> list:
    """(rc, stdout, stderr) of each child -> the JSON object on the last
    line of each one's standard output; raises on a child that failed, on
    a missing line and on a child that imported jax or the JAX package."""
    lines = []
    for rank, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"{label}: process {rank} exited {rc}:\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
        text = out.strip().splitlines()
        if not text:
            raise AssertionError(f"{label}: process {rank} printed no line:\n{err[-4000:]}")
        lines.append(json.loads(text[-1]))
    return lines


def rank_stats_lines(outs, label: str) -> list:
    """(rc, stdout, stderr) of each daemon process -> its ``engine: rank
    stats`` object; raises on a nonzero exit or a missing line."""
    stats = []
    for rank, (rc, out, err) in enumerate(outs):
        found = [ln for ln in err.splitlines() if ln.startswith("engine: rank stats ")]
        if rc != 0 or len(found) != 1:
            raise AssertionError(f"{label}: daemon {rank} exited {rc} with {len(found)} stats "
                                 f"lines:\n{err[-4000:]}")
        stats.append(json.loads(found[0][len("engine: rank stats "):]))
    return stats


def check_processes(lines, path=HALO_KERNELS, backend: str | None = None) -> dict:
    """Every process's line: each kernel of ``path`` launched, no other
    kernel, nothing of jax imported, the backend the run asked for. Returns
    the launches summed over the processes."""
    total = {}
    for rank, line in enumerate(lines):
        launches = line["launches"]
        if any(launches.get(k, 0) == 0 for k in path):
            raise AssertionError(f"process {rank}: a kernel of the path never launched: "
                                 f"{launches}")
        if any(v for k, v in launches.items() if k not in path):
            raise AssertionError(f"process {rank}: a kernel of another path launched: "
                                 f"{launches}")
        if line["foreign_modules"]:
            raise AssertionError(f"process {rank} imported {line['foreign_modules']}")
        if backend is not None and line["backend"] != backend:
            raise AssertionError(f"process {rank} ran over {line['backend']}, not {backend}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _wait_all(procs, timeout: float, label: str):
    """(rc, stdout, stderr) of every process; kills them all and raises when
    one outlives ``timeout``."""
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: a process outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def multiprocess_env(world: int, rank: int, coordinator: str, own_cards: bool) -> dict:
    """A process's environment: the PS_TPU_* group and, for processes that
    share a card, only the first card this script sees (so that every rank
    lands on it whatever the machine holds)."""
    env = dict(os.environ, PS_TPU_COORDINATOR=coordinator, PS_TPU_NUM_PROCESSES=str(world),
               PS_TPU_PROCESS_ID=str(rank), PYTHON=sys.executable,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    if not own_cards:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return env


def hold_halo(label: str, blocks, mesh, cfg, params) -> dict:
    """The three halo kernels against their plain versions, bit for bit, on
    this process's own blocks of a sharded grid, their rings filled by the
    mesh's exchange (a collective: every process calls this at the same
    point). The comparison's launches and ring traffic are taken out of the
    counts again. Returns a line whose ``max_abs_err`` holds each kernel's
    largest live-velocity difference (0.0, or the comparison raised)."""
    import torch

    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.parallel import domain
    from particle_simulator_tpu_torch.physics import bucket

    launches, exchange = dict(bc.LAUNCHES), dict(domain.EXCHANGE)
    padded = domain.exchange_halo(blocks, mesh)
    offsets = domain.ring_plan(mesh, *blocks[0].x.shape[-3:-1]).offsets
    err = dict.fromkeys(HALO_KERNELS, 0.0)
    line = {"at": label, "blocks": [list(b.x.shape) for b in padded],
            "live": sum(int((b.ty >= 0).sum()) for b in padded), "migrating_in_from_ring": 0}
    for b, pv, off in zip(padded, params, offsets):
        err["step_halo"] = max(err["step_halo"], same_state(
            bc.bucket_step_halo_cuda(b, pv), bucket.bucket_step_halo(b, pv),
            f"{label}: the halo step against its plain version"))
        dest = bc.move_dest_halo_cuda(b, cfg.bx_log2, cfg.by_log2, off)
        dest_ref = bucket.move_dest_direct_halo(b, cfg.bx_log2, cfg.by_log2, off)
        if not torch.equal(dest, dest_ref):
            raise AssertionError(f"{label}: halo dest ids differ at "
                                 f"{int((dest != dest_ref).sum())} slots")
        err["place_halo"] = max(err["place_halo"], same_state(
            bc.bucket_place_halo_cuda(b, dest_ref), bucket.bucket_place_halo(b, dest_ref),
            f"{label}: the halo place against its plain version"))
        ring = dest_ref.clone()
        ring[:, 1:-1, 1:-1] = -1
        line["migrating_in_from_ring"] += int((ring >= 0).sum())
    bc.LAUNCHES.update(launches)
    domain.EXCHANGE.update(exchange)
    line["max_abs_err"] = err
    return line


def hold_served(label: str, sim) -> dict:
    """``hold_halo`` on a daemon's own blocks (its ``--inspect`` hook)."""
    if not sim.sharded:
        raise AssertionError(f"{label}: the served scene is not sharded")
    return hold_halo(label, sim.state, sim.mesh, sim.grid, sim._pvec)


def inspect_lines(outs, label: str) -> list:
    """(rc, stdout, stderr) of each daemon process -> its ``engine: inspect``
    objects (``hold_served``'s lines); raises unless each process held its
    blocks both as loaded and after the frames."""
    held = []
    for rank, (_, _, err) in enumerate(outs):
        found = [json.loads(ln[len("engine: inspect "):]) for ln in err.splitlines()
                 if ln.startswith("engine: inspect ")]
        if len(found) != 2:
            raise AssertionError(f"{label}: daemon {rank} held its blocks {len(found)} times, "
                                 f"not twice:\n{err[-4000:]}")
        held += found
    return held


def held_errors(held) -> dict:
    """The largest ``max_abs_err`` of each halo kernel over ``hold_halo``'s
    lines."""
    if not held:
        raise AssertionError("no halo hold ran")
    return {k: max(line["max_abs_err"][k] for line in held) for k in HALO_KERNELS}


# phase 20 runs the 1024x1024 editor lattice and the dense scene at these
# depths: frames compared, steps a frame, frames timed, frames served
MP_FRAMES, MP_STEPS, MP_TIMED, MP_SERVE_FRAMES = 3, 100, 3, 12


def multiprocess_frame_child(workdir: str, cfg, n_shards: int) -> int:
    """One process of phase 20's sharded frame (``python chip_smoke.py
    --child-frame ...`` with the PS_TPU_* group): the dense scene of grid
    ``cfg`` on the global mesh, its halo kernels held as loaded, then
    ``MP_FRAMES`` frames, the kernels held again and rank 0's gathered grid
    saved for the parent, then ``MP_TIMED`` frames on the clock, twice, and
    two under the profiler. Prints one JSON line."""
    import torch
    import torch.distributed as dist

    from particle_simulator_tpu_torch.bench import dense_grid_scene
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.parallel import domain, multihost

    if not multihost.init_distributed("cuda"):
        raise AssertionError("no PS_TPU_* group in the environment")
    dev = multihost.process_device("cuda")
    parts, meta, _ = dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity).reshape(cfg.grid_shape)
    pv = SimParams.from_record(meta).vector(dev)
    mesh = multihost.global_mesh(n_shards, "cuda")
    padded, rows = domain.pad_rows_for_mesh(state, mesh)
    blocks = multihost.shard_state_global(padded, mesh)
    pvs = [pv] * len(mesh.blocks)
    fn = domain.make_sharded_frame_fn(cfg, mesh)
    held = [hold_halo("dense scene as loaded", blocks, mesh, cfg, pvs)]
    for counts in (bc.LAUNCHES, domain.EXCHANGE):
        for k in counts:
            counts[k] = 0
    for i in range(MP_FRAMES):
        blocks = fn(blocks, pvs, MP_STEPS)
        if i == 0:
            per_frame = {k: v for k, v in bc.LAUNCHES.items() if v}
    torch.cuda.synchronize()
    launches, ex = dict(bc.LAUNCHES), dict(domain.EXCHANGE)
    n = max(1, ex["steps"])
    held.append(hold_halo(f"dense scene after {MP_FRAMES} frames", blocks, mesh, cfg, pvs))
    got = multihost.gather_global(blocks, mesh)
    if got is not None:
        torch.save({f: a[:rows].cpu() for f, a in zip(got._fields, got)},
                   os.path.join(workdir, "rank0_grid.pt"))

    def run(n):
        nonlocal blocks
        multihost.barrier(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            blocks = fn(blocks, pvs, MP_STEPS)
        torch.cuda.synchronize()
        multihost.barrier(dev)
        return (time.perf_counter() - t0) * 1e3 / n

    frame_ms = [run(MP_TIMED), run(MP_TIMED)]
    _, busy = device_busy(lambda: run(2))
    line = {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "host_staged": domain.host_staged(dev),
            "device": str(dev), "mesh": list(mesh.shape),
            "shards": [list(ids) for _, ids in mesh.blocks],
            "frames": MP_FRAMES, "steps_per_frame": MP_STEPS, "launches": launches,
            "launches_per_frame": per_frame,
            "exchange": {"messages": ex["messages"], "bytes": ex["bytes"], "steps": ex["steps"],
                         "bytes_per_step": ex["bytes"] / n,
                         "host_ms_per_step": ex["seconds"] * 1e3 / n,
                         "stage_ms_per_step": ex["stage_s"] * 1e3 / n,
                         "comm_ms_per_step": ex["comm_s"] * 1e3 / n},
            "frame_ms": frame_ms,
            "device_busy": None if busy is None else {
                "busy_share": busy["busy_share"], "window_ms": busy["window_ms"]},
            "held": held,
            "foreign_modules": multihost.foreign_modules()}
    print(json.dumps(line), flush=True)
    dist.destroy_process_group()
    return 1 if line["foreign_modules"] else 0


def multiprocess_frame(cfg, workdir: str, world: int, n_shards: int, own_cards: bool) -> dict:
    """Phase 20's sharded frame: the dense scene of grid ``cfg`` in ``world``
    processes (``python chip_smoke.py --child-frame ...``) over one global
    mesh of ``n_shards`` shards, sharing the first card over gloo or, with
    ``own_cards``, a card each over NCCL; rank 0's gathered grid bit for bit
    against ``run_frame_bucket_cuda`` computed here. Returns the printed
    line and every process's ``hold_halo`` lines."""
    import torch

    from particle_simulator_tpu_torch.bench import dense_grid_scene
    from particle_simulator_tpu_torch.engine.state import (
        ParticleState,
        SimParams,
        state_from_numpy,
    )
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda

    backend = "nccl" if own_cards else "gloo"
    here = os.path.dirname(os.path.abspath(__file__))
    label = f"multi-process ({world} processes, {backend})"
    parts, meta, live = dense_grid_scene(cfg)
    state = state_from_numpy(parts, cfg.capacity, "cuda").reshape(cfg.grid_shape)
    pv = SimParams.from_record(meta).vector("cuda")
    single = state
    for _ in range(MP_FRAMES):
        single = run_frame_bucket_cuda(single, pv, MP_STEPS, cfg.move_every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MP_TIMED):
        state = run_frame_bucket_cuda(state, pv, MP_STEPS, cfg.move_every)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / MP_TIMED
    del state
    coord = f"file://{workdir}/frame_store"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child-frame", workdir,
         ",".join(map(str, cfg)), str(n_shards)],
        env=multiprocess_env(world, r, coord, own_cards), cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    lines = child_lines(_wait_all(procs, 300, label), label)
    frame_s = time.perf_counter() - t0
    check_processes(lines, backend=backend)
    held = [h for line in lines for h in line["held"]]
    got = torch.load(os.path.join(workdir, "rank0_grid.pt"))
    identity = same_grid(ParticleState(*(got[f].to("cuda") for f in ParticleState._fields)),
                         single, f"{label}: sharded frame")
    if not bool(torch.isfinite(single.vx[single.ty >= 0]).all()):
        raise AssertionError(f"{label}: non-finite velocities")
    frame_line = {"grid": list(cfg.grid_shape), "particles": live, "frames_compared": MP_FRAMES,
                  "steps_per_frame": MP_STEPS, **identity, "seconds": frame_s,
                  "single_device_frame_ms": single_ms, "processes": lines}
    print("multi-process frame: " + json.dumps(frame_line), flush=True)
    return {"line": frame_line, "held": held}


def phase_multiprocess(cfg, workdir: str, world: int, n_shards: int, own_cards: bool,
                       beside: dict):
    """Phase 20: ``world`` processes over one global mesh of ``n_shards``
    shards, sharing the first card over gloo (host-staged ring) or, with
    ``own_cards``, a card each over NCCL. The dense scene's sharded frame
    against ``run_frame_bucket_cuda`` computed here (``multiprocess_frame``);
    then the 1024x1024
    editor lattice served for ``MP_SERVE_FRAMES`` frames by ``world`` daemon
    processes started through ``scripts/torch_launch_multihost.sh``, to the
    port's headless editor. Every process holds the halo kernels against
    their plain versions on its own blocks, as loaded and after its frames
    (``hold_halo``; the daemons through ``--inspect``). ``beside`` is the
    single-controller mesh's serve of the same lattice (``phase_slice``'s
    line): its period is printed next to this one's, and its particle count
    per frame must be this serve's."""
    from particle_simulator_tpu_torch.io.transport import Disconnected, Reader

    backend = "nccl" if own_cards else "gloo"
    here = os.path.dirname(os.path.abspath(__file__))
    label = f"multi-process ({world} processes, {backend})"
    frame = multiprocess_frame(cfg, workdir, world, n_shards, own_cards)
    frame_line, held = frame["line"], frame["held"]

    # the serve, through the launcher
    port = _free_port()
    record = os.path.join(workdir, "mp_frames.bin")
    editor_log = os.path.join(workdir, "mp_editor.log")
    coord = f"127.0.0.1:{_free_port()}"
    with open(editor_log, "w") as log:
        editor = subprocess.Popen(
            [sys.executable, "-m", "particle_simulator_tpu_torch.editor.headless",
             "--addr", f"127.0.0.1:{port}", "--lattice", "1024x1024",
             "--distance-factor", "1.1", "--step-dt", "1e-14",
             "--frames", str(MP_SERVE_FRAMES), "--timeout", "600"],
            stdout=log, stderr=subprocess.STDOUT, cwd=here)
        t0 = time.perf_counter()
        daemons = [subprocess.Popen(
            ["bash", os.path.join(here, "scripts", "torch_launch_multihost.sh"), coord,
             str(world), str(r), "--addr", f"127.0.0.1:{port}",
             "--max-frames", str(MP_SERVE_FRAMES), "--retry-s", "120", "--record", record,
             "--inspect", "chip_smoke:hold_served", "--devices", str(n_shards)],
            env=multiprocess_env(world, r, coord, own_cards), cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
        outs = _wait_all(daemons, 600, label)
        stats = rank_stats_lines(outs, label)
        held += inspect_lines(outs, label)
        serve_s = time.perf_counter() - t0
        rc = editor.wait(timeout=120)
    with open(editor_log) as f:
        log_text = f.read()
    if rc != 0:
        raise AssertionError(f"{label}: editor exited {rc}:\n{log_text[-4000:]}")
    child_modules(log_text, "editor", f"{label}: the headless editor")
    launches = check_processes(stats, backend=backend)
    if any(s["shipped"] != MP_SERVE_FRAMES for s in stats):
        raise AssertionError(f"{label}: shipped {[s['shipped'] for s in stats]} frames, "
                             f"not {MP_SERVE_FRAMES} each")
    counts = []
    reader = Reader.open_file(record)
    try:
        for _ in range(MP_SERVE_FRAMES):
            p = reader.read_blocking(timeout=120).particles
            for name in ("vx", "vy"):
                if not np.isfinite(p[name]).all():
                    raise AssertionError(f"{label}: frame {len(counts)} has non-finite {name}")
            counts.append(len(p))
    except (Disconnected, TimeoutError):
        pass
    finally:
        reader.close()
    os.unlink(record)
    if len(counts) != MP_SERVE_FRAMES or counts[0] != 1024 * 1024:
        raise AssertionError(f"{label}: recorded {len(counts)} frames of {counts[:1]} particles")
    if counts != beside["particles"][:MP_SERVE_FRAMES]:
        raise AssertionError(f"{label}: particles a frame {counts}, the single-controller "
                             f"mesh's {beside['particles']}")
    err = held_errors(held)
    serve_line = {"frames": MP_SERVE_FRAMES, "particles": counts, "serve_s": serve_s,
                  "frame_period_ms": stats[0]["frame_period_ms"],
                  "single_controller_mesh_period_ms": beside["frame_period_ms"],
                  "launches": launches, "processes": stats}
    print("multi-process slice: " + json.dumps(serve_line), flush=True)
    print("multi-process held: " + json.dumps({"states": held, "max_abs_err_v": err}),
          flush=True)
    return {"frame": frame_line, "serve": serve_line, "launches": launches, "err": err}


# ---------------------------------------------------------------------------
# phase 21: config 5, the web editor and the daemon as processes of their own
# (scripts/torch_interactive_1m_chip.py)
# ---------------------------------------------------------------------------

# the measurement window (the web editor keeps every frame, ~21 MB at 1M)
CONFIG5_SECONDS = 12.0
CONFIG5_PATH = ("step", "dest", "place")


def child_modules(text: str, who: str, label: str) -> list:
    """The ``<who>: foreign modules [...]`` line a child process printed as
    it exited (``utils/log.py:report_foreign_modules``) -> its list; raises
    unless there is exactly one such line and it names no module."""
    from particle_simulator_tpu_torch.utils.log import FOREIGN_MODULES_TAG

    tag = f"{who}: {FOREIGN_MODULES_TAG}"
    found = [json.loads(ln[len(tag):]) for ln in text.splitlines() if ln.startswith(tag)]
    if len(found) != 1:
        raise AssertionError(f"{label} printed {len(found)} '{tag.strip()}' lines, not "
                             f"one:\n{text[-2000:]}")
    if found[0]:
        raise AssertionError(f"{label} imported {found[0]}")
    return found[0]


class FrameCheck:
    """Reads a wire stream from a FIFO in a thread of its own (phase 21's
    daemon tees every frame it ships into it, ``--record``) and keeps only
    counts: the frames, the fewest and most particles in one, and the
    indices of the frames with a non-finite velocity."""

    def __init__(self, path: str):
        self.path = path
        self.frames = 0
        self.particles = [None, None]
        self.nonfinite = []
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _fill(f, view) -> bool:
        got = 0
        while got < len(view):
            n = f.readinto(view[got:])
            if not n:
                return False
            got += n
        return True

    def _run(self) -> None:
        from particle_simulator_tpu_torch.io.frame import (
            HEADER_DTYPE,
            HEADER_SIZE,
            PARTICLE_DTYPE,
            PARTICLE_SIZE,
            SIGNATURE_START,
        )

        try:
            with open(self.path, "rb", buffering=0) as f:
                header, body = bytearray(HEADER_SIZE), bytearray()
                while self._fill(f, memoryview(header)):
                    hdr = np.frombuffer(header, HEADER_DTYPE, 1)[0]
                    if hdr["signature_start"].tobytes() != SIGNATURE_START:
                        raise ValueError(f"frame {self.frames}: bad signature")
                    n = int(hdr["particle_count"])
                    if len(body) < n * PARTICLE_SIZE:
                        body = bytearray(n * PARTICLE_SIZE)
                    if not self._fill(f, memoryview(body)[:n * PARTICLE_SIZE]):
                        raise ValueError(f"frame {self.frames}: the stream ended mid-frame")
                    parts = np.frombuffer(body, PARTICLE_DTYPE, n)
                    if not (np.isfinite(parts["vx"]).all() and np.isfinite(parts["vy"]).all()):
                        self.nonfinite.append(self.frames)
                    lo, hi = self.particles
                    self.particles = [n if lo is None else min(lo, n),
                                      n if hi is None else max(hi, n)]
                    self.frames += 1
        except Exception as e:  # reported through finish()
            self.error = repr(e)

    def finish(self, timeout: float) -> None:
        """Wait for the end of the stream; a writer that never came is
        stood in for by an empty one, so the reader's open returns."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            try:
                os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
            except OSError:
                pass
            self._thread.join(timeout)
        if self._thread.is_alive():
            self.error = self.error or "the FIFO reader never finished"


def hold_grid(label: str, sim) -> dict:
    """``KernelHold`` on a daemon's own one-device bucket grid (its
    ``--inspect`` hook; phase 21): the step, the dest and the place against
    their plain versions, bit for bit, on the served state, and the
    live-tile step where the scene runs it. The line also
    carries the daemon's launches so far (the hold's own are taken out
    again), whether every live velocity is finite and the largest
    live-velocity difference of each kernel of the state's path."""
    import torch

    from particle_simulator_tpu_torch.ops import allpairs_cuda, bucket_cuda as bc

    if sim.sharded or sim.state.x.dim() != 3:
        raise AssertionError(f"{label}: the served scene is not one bucket grid")
    launches = {**bc.LAUNCHES, **allpairs_cuda.LAUNCHES}
    hold = KernelHold()
    hold(label, sim.state, sim._pvec)
    alive = sim.state.ty >= 0
    finite = bool(torch.isfinite(sim.state.vx[alive]).all()
                  and torch.isfinite(sim.state.vy[alive]).all())
    path = (hold.held[0]["served_step"], *CONFIG5_PATH[1:])
    return {**hold.held[0], "launches": launches, "finite": finite,
            "max_abs_err": {k: hold.err.get(k, 0.0) for k in path}}


def config5_checks(rec: dict, check: FrameCheck, held: list, shipped: int,
                   drawn: int, path=CONFIG5_PATH) -> dict:
    """Phase 21's checks on the script's result line, the FIFO's counts, the two
    ``hold_grid`` lines and the frames the daemon says it shipped, for a
    lattice of ``drawn`` particles served through the kernels of ``path``
    (none on the CPU); returns the daemon's launches and each held
    kernel's largest error."""
    if rec["particles"] < 0.9 * drawn:
        raise AssertionError(f"config 5: {rec['particles']} particles, fewer than 0.9 x "
                             f"{drawn}")
    if not rec["engine_fps"] > 0:
        raise AssertionError(f"config 5: engine fps {rec['engine_fps']}")
    if rec["fetch_errors"]:
        raise AssertionError(f"config 5: {rec['fetch_errors']} /frame.bin fetches failed")
    if check.error is not None:
        raise AssertionError(f"config 5: the frame check failed: {check.error}")
    # every frame on the wire went through the FIFO first; frames the daemon
    # counted after the editor's disconnect never reached either
    if not rec["engine_frames"] <= check.frames <= shipped or check.frames == 0:
        raise AssertionError(f"config 5: the FIFO carried {check.frames} frames, the editor "
                             f"saw {rec['engine_frames']} in its window, the daemon counted "
                             f"{shipped}")
    if check.nonfinite:
        raise AssertionError(f"config 5: frames {check.nonfinite[:10]} are not finite")
    if check.particles[0] < 0.9 * drawn:
        raise AssertionError(f"config 5: a frame held {check.particles[0]} particles")
    if len(held) != 2 or not all(h["finite"] for h in held):
        raise AssertionError(f"config 5: the served grid was held {len(held)} times, finite "
                             f"{[h['finite'] for h in held]}")
    launches = held[-1]["launches"]
    if any(launches.get(k, 0) == 0 for k in path):
        raise AssertionError(f"config 5: a kernel of the path never launched: {launches}")
    if any(v for k, v in launches.items() if k not in path):
        raise AssertionError(f"config 5: a kernel of another path launched: {launches}")
    err = {}
    for h in held:
        for k, v in h["max_abs_err"].items():
            err[k] = max(err.get(k, 0.0), v)
    return {"launches": launches, "err": err}


def phase_config5(workdir: str, seconds: float = CONFIG5_SECONDS, n_side: int = 1024,
                  steps_per_frame: int = 100, torch_device: str = "cuda") -> dict:
    """Phase 21: ``scripts/torch_interactive_1m_chip.py``'s ``record`` for
    ``seconds`` (on the card unless ``torch_device`` says otherwise, as the
    CPU tests do at a small ``n_side``), the daemon holding rows 1-3 on its
    grid (or row 5 where the scene runs it) through
    ``--inspect chip_smoke:hold_grid`` and teeing its frames
    into a FIFO read by ``FrameCheck``; both children's module reports
    checked."""
    drv = script_module("torch_interactive_1m_chip")
    fifo = os.path.join(workdir, "config5_frames.fifo")
    os.mkfifo(fifo)
    check = FrameCheck(fifo)
    events = []

    def emit(ev):
        events.append(ev)
        print("config 5 event: " + json.dumps(ev), flush=True)

    t0 = time.perf_counter()
    try:
        rec = drv.record(seconds=seconds, n_side=n_side, steps_per_frame=steps_per_frame,
                         torch_device=torch_device, inspect="chip_smoke:hold_grid",
                         daemon_record=fifo, log_dir=workdir, emit=emit)
    finally:
        check.finish(60)
    phase_s = time.perf_counter() - t0
    print("config 5: " + json.dumps(rec), flush=True)
    with open(os.path.join(workdir, "daemon.log")) as f:
        daemon_log = f.read()
    with open(os.path.join(workdir, "webview.log")) as f:
        web_log = f.read()
    child_modules(daemon_log, "engine", "config 5: the daemon")
    child_modules(web_log, "editor UI", "config 5: the web editor")
    found = re.findall(r"^engine: disconnected after (\d+) frames", daemon_log, re.M)
    shipped = int(found[-1]) if found else 0
    held = inspect_lines([(0, "", daemon_log)], "config 5")
    # the daemon's step follows the scene as loaded
    step = held[0]["served_step"] if held else "step"
    verdict = config5_checks(rec, check, held, shipped, n_side * n_side,
                             (*STEP_PATHS[step], *CONFIG5_PATH[1:]) if torch_device == "cuda"
                             else ())
    print("config 5 held: " + json.dumps(
        {"shipped": shipped, "fifo_frames": check.frames, "particles_min_max": check.particles,
         "nonfinite_frames": check.nonfinite, "states": held, "launches": verdict["launches"],
         "max_abs_err_v": verdict["err"], "phase_s": phase_s}), flush=True)
    return verdict


# bench.py's JSON keys in each mode, frozen (tests/test_torch_bench.py holds
# them against bench.py's own lines)
_BENCH_COMMON = frozenset({"metric", "value", "unit", "vs_baseline", "particles",
                           "steps_per_frame", "frames", "elapsed_s", "sim_steps_per_sec",
                           "device"})
BENCH_KEYS = {
    "dense": _BENCH_COMMON | {"live_fraction_end"},
    "per-frame": _BENCH_COMMON | {"live_fraction_end", "frame_s", "frame_s_series"},
    "sharded": _BENCH_COMMON | {"live_fraction_end", "sharded_mesh"},
    "sharded per-frame": _BENCH_COMMON | {"live_fraction_end", "sharded_mesh", "frame_s",
                                          "frame_s_series"},
    "user": _BENCH_COMMON | {"scene", "readback_ms", "readback_k", "readback_ncap", "grid",
                             "lane_chunks", "ext_io"},
}
# the 1M user scene of phases 12 and 13 (a 1000 x 1000 lattice); bench.py's
# default --particles would draw 1024 x 1024, config 5's lattice
BENCH_USER = ("--user-scene", "--particles", "1000000")
# phase 22's runs: label -> (key set, the kernels of its path, the bench's arguments)
BENCH_RUNS = {
    "dense": ("dense", CONFIG5_PATH, ()),
    "per-frame": ("per-frame", CONFIG5_PATH, ("--per-frame",)),
    "sharded": ("sharded", HALO_KERNELS, ("--sharded",)),
    # the 1M user scene has 8 lane chunks: the Simulator steps its live tiles
    "user": ("user", (*STEP_PATHS["step_compact"], "dest", "place"), BENCH_USER),
}


class BenchHold(KernelHold):
    """``KernelHold`` on the bench's states (phase 22, through the bench's
    ``inspect`` hook): a grid holds the classic step, the dest, the place
    and, where the Simulator's load rule gives it more than one lane chunk,
    the live-tile step. A tuple of blocks is the sharded frame's:
    ``hold_halo`` on ``mesh`` with the global grid ``cfg``."""

    def __init__(self, mesh=None, cfg=None):
        super().__init__()
        self.mesh, self.cfg = mesh, cfg
        self.err.update(dict.fromkeys(("step_compact", *HALO_KERNELS), 0.0))

    def __call__(self, label: str, state, pv) -> None:
        if not hasattr(state, "_fields"):  # the mesh's blocks
            line = hold_halo(label, state, self.mesh, self.cfg, pv)
            for k, v in line["max_abs_err"].items():
                self.err[k] = max(self.err[k], v)
            self.held.append(line)
            return
        super().__call__(label, state, pv)


def bench_particles(args) -> int:
    """The live count a bench run of the parsed ``args`` starts with: the
    dense grid's interior buckets times ``fill``, or the user lattice's
    side squared."""
    from particle_simulator_tpu_torch import bench

    if args.user_scene:
        return max(2, int(round(args.particles ** 0.5))) ** 2
    cfg = bench.dense_grid_config(args.particles, args.fill)
    return (cfg.bx - 2) * (cfg.by - 2) * args.fill


def bench_checks(label: str, mode: str, rec: dict, launches: dict, path, particles: int,
                 device: str, mesh=None) -> None:
    """Phase 22's checks on one bench line: bench.py's keys for ``mode``,
    the device, ``particles``, a finite positive rate, the mesh's shape
    when sharded; each kernel of ``path`` (none on the CPU) launched once a
    step per block, the rebucket's at least once, and no other kernel."""
    if set(rec) != BENCH_KEYS[mode]:
        raise AssertionError(f"bench {label}: keys {sorted(set(rec) ^ BENCH_KEYS[mode])} "
                             "differ from bench.py's")
    if rec["device"] != device or rec["particles"] != particles:
        raise AssertionError(f"bench {label}: {rec['particles']} particles on "
                             f"{rec['device']}, expected {particles} on {device}")
    if not (np.isfinite(rec["value"]) and rec["value"] > 0):
        raise AssertionError(f"bench {label}: rate {rec['value']}")
    blocks = 1
    if mesh is not None:
        if rec["sharded_mesh"] != list(mesh.shape):
            raise AssertionError(f"bench {label}: mesh {rec['sharded_mesh']}, expected "
                                 f"{list(mesh.shape)}")
        blocks = len(mesh.blocks)
    if path:
        want = (rec["frames"] + 1) * rec["steps_per_frame"] * blocks  # the warm-up too
        if launches[path[0]] != want or any(launches[k] == 0 for k in path[1:]):
            raise AssertionError(f"bench {label}: launches {launches}, expected {want} "
                                 f"{path[0]} and every kernel of {path}")
    if any(v for k, v in launches.items() if k not in path):
        raise AssertionError(f"bench {label}: a kernel of another path launched: {launches}")


def bench_row(table: dict, label: str, device: str, size, devices, hold_cls, **hold_kw):
    """One row of ``table`` (``BENCH_RUNS`` or ``SCALE_RUNS``: label -> (key
    set, the kernels of its path, the bench's arguments)) through the port's
    bench in this process, ``size`` appended to its arguments, ``--sharded``
    over ``devices``, with a ``hold_cls`` hold (``BenchHold`` or a subclass,
    given ``hold_kw``) as the bench's ``inspect`` hook. The line must pass
    ``bench_checks`` and the hold must have held two states. Returns the
    record, the run's launches, the hold and the argument list."""
    import torch

    from particle_simulator_tpu_torch import bench

    mode, path, args = table[label]
    argv = [*args, "--torch-device", device, *size]
    parsed = bench.parser().parse_args(argv)
    mesh = bench.bench_mesh(torch.device(device), devices) if parsed.sharded else None
    hold = hold_cls(mesh=mesh, cfg=bench.dense_grid_config(parsed.particles, parsed.fill),
                    **hold_kw)
    with counted_launches() as launches:
        rec = bench.run(argv, devices=devices, inspect=hold)
    bench_checks(label, mode, rec, launches, path if device == "cuda" else (),
                 bench_particles(parsed), device, mesh)
    if len(hold.held) != 2:
        raise AssertionError(f"bench {label}: held {len(hold.held)} states, not 2")
    return rec, launches, hold, argv


def phase_bench(device: str = "cuda", runs=tuple(BENCH_RUNS), size=(), devices=None) -> dict:
    """Phase 22: the port's bench (``particle_simulator_tpu_torch/bench.py``)
    in this process, once in each mode of ``runs``, at bench.py's default
    sizes (``size`` appends arguments, as the CPU tests do to shrink them),
    ``--sharded`` over ``devices`` (every visible card by default). Every
    line must pass ``bench_checks`` (the bench itself raises on non-finite
    velocities); every kernel the run launched is held bit for bit against
    its plain version on the bench's states as loaded and after the last
    frame (``BenchHold``, whose launches are not counted; ``bench_row``).
    Returns the records, the launches summed over the runs and each
    kernel's largest error."""
    records, total = {}, {}
    err = dict.fromkeys(BenchHold().err, 0.0)
    for label in runs:
        rec, launches, hold, argv = bench_row(BENCH_RUNS, label, device, size, devices,
                                              BenchHold)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in hold.err.items():
            err[k] = max(err[k], v)
        records[label] = rec
        print(f"bench {label}: " + json.dumps(
            {**rec, "argv": argv, "launches": {k: v for k, v in launches.items() if v},
             "held": hold.held}), flush=True)
    return {"records": records, "launches": total, "err": err}


DRYRUN_SHARDS = (1, 3, 4, 8)


def phase_entry(device: str = "cuda", shards=DRYRUN_SHARDS) -> dict:
    """Phase 22's last part: the entry points of ``particle_simulator_tpu_
    torch/entry.py`` on ``device``. ``entry()``'s frame (the classic
    kernels on a card) must be finite on its live slots and equal the plain
    frame on the same tensors on every field and slot; ``dryrun_multichip(n)``
    raises unless its sharded frame equals the one-device frame bit for bit."""
    import torch

    from particle_simulator_tpu_torch import entry
    from particle_simulator_tpu_torch.physics.bucket import GridConfig, run_frame_bucket

    t0 = time.perf_counter()
    fn, (state, params) = entry.entry(device)
    out = fn(state, params)
    plain = run_frame_bucket(state, params, entry.STEPS, GridConfig(*entry.GRID).move_every)
    live = out.ty >= 0
    if not all(bool(torch.isfinite(v[live]).all()) for v in (out.vx, out.vy)):
        raise AssertionError("entry(): the frame is not finite")
    for name, a, b in zip(out._fields, out, plain):
        if not torch.equal(a, b):
            raise AssertionError(f"entry(): field {name} differs from the plain frame at "
                                 f"{int((a != b).sum())} slots")
    for n in shards:
        entry.dryrun_multichip(n, device)
    line = {"live": [int((state.ty >= 0).sum()), int(live.sum())],
            "dryrun_shards": list(shards), "seconds": time.perf_counter() - t0}
    print("entry: " + json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------
# phase 23: the main path at the sizes of the JAX package's recorded runs
# ---------------------------------------------------------------------------

# bench.py's commands of BASELINE.md's N-scaling record, with --per-frame: the
# dense grid at 4M (1024x512x8) and 16M (2048x1024x8), the user scene at 4M
# (a 2048 x 2048 lattice)
SCALE_4M = ("--particles", "4194304", "--frames", "24", "--per-frame")
SCALE_16M = ("--particles", "16000000", "--frames", "24", "--per-frame")
SCALE_USER = ("--user-scene", "--particles", "4194304", "--frames", "10")
# phase 23's rows: label -> (key set, the kernels of its path, the bench's arguments)
SCALE_RUNS = {
    "dense 4M": ("per-frame", CONFIG5_PATH, SCALE_4M),
    "dense 16M": ("per-frame", CONFIG5_PATH, SCALE_16M),
    "sharded 16M": ("sharded per-frame", HALO_KERNELS, (*SCALE_16M, "--sharded")),
    # 8 lane chunks, as at 1M: the Simulator steps the live tiles
    "user 4M": ("user", (*STEP_PATHS["step_compact"], "dest", "place"), SCALE_USER),
}
# the row after which a Simulator serving the same scene holds its readback
SCALE_READBACK = "user 4M"
SCALE_REPS = 10


def not_timed(fn, reps: int) -> None:
    """``cuda_ms``'s stand-in on the CPU: runs ``fn`` once and measures
    nothing (a CPU run has no device time to give)."""
    fn()
    return None


def device_peak() -> int | None:
    """The largest ``torch.cuda.max_memory_allocated()`` over the visible
    cards since their last reset, each card reset again; None without a
    card."""
    import torch

    if not torch.cuda.is_available():
        return None
    peak = 0
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
        peak = max(peak, torch.cuda.max_memory_allocated(i))
        torch.cuda.reset_peak_memory_stats(i)
    return peak


def rebucket_bounds(state, dest, out_slots: int, extra_bytes: int = 0) -> dict:
    """The dest's and the place's bounds by the bytes this state's data
    needs: the dest reads every slot's ty and the live slots' x and y and
    writes every slot's id (plus ``extra_bytes`` read); the place reads
    every id and the kept slots' 20 B and writes the ``out_slots``' 20 B.
    On a full grid that is phase 3's 16 and 44 B a slot; on a sparse one
    the dead slots' fields are work the data does not need."""
    slots = state.capacity
    live = int((state.ty >= 0).sum())
    kept = int((dest >= 0).sum())
    return {"dest": bound(8 * slots + 8 * live + extra_bytes),
            "place": bound(4 * slots + 20 * kept + 20 * out_slots)}


def scale_times(state, pv, timer, mesh=None, cfg=None) -> dict:
    """Each kernel of a bench state's path timed by ``timer`` (``cuda_ms`` on
    the card, ``SCALE_REPS`` launches), beside its bound and the share of
    the bound it reaches. A grid: the classic step (bound by every slot's
    bytes and the pairs on a grid of one lane chunk, by the live slots' on
    a sparse one:
    ``ext_bound``), the dest, the place with ``torch.index_copy``'s time
    beside it (their bounds by ``rebucket_bounds``), and the live-tile step
    where the Simulator's load rule gives the grid more than one lane chunk. The
    mesh's blocks (a tuple, ``mesh`` and the global grid ``cfg`` given):
    the halo step, dest and place on the first block, its ring filled by
    the exchange. The caller takes the timed launches and ring traffic out
    of the counts again."""
    import torch

    from particle_simulator_tpu_torch.engine.simulator import _lane_chunks_for
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.parallel import domain
    from particle_simulator_tpu_torch.physics import bucket

    reps, sass = SCALE_REPS, FORCE_LAW_COUNTS

    def entry(fn, bnd, **more):
        ms = timer(fn, reps)
        return {"ms": ms, **bnd, "share": None if ms is None else bnd["bound_ms"] / ms, **more}

    if not hasattr(state, "_fields"):  # the mesh's blocks
        padded = domain.exchange_halo(state, mesh)[0]
        offsets = domain.ring_plan(mesh, *state[0].x.shape[-3:-1]).offsets[0]
        log2, pv = (cfg.bx_log2, cfg.by_log2), pv[0]
        src = padded.capacity
        on = torch.cuda.device(padded.x.device) if padded.x.is_cuda else contextlib.nullcontext()
        with on:
            dest = bc.move_dest_halo_cuda(padded, *log2, offsets)
            rb = rebucket_bounds(padded, dest, state[0].capacity, offsets.numel() * 4)
            kernels = {
                "step_halo": entry(lambda: bc.bucket_step_halo_cuda(padded, pv),
                                   bound(36 * src, ops_bound_ms(halo_pairs(padded), sass))),
                "dest_halo": entry(lambda: bc.move_dest_halo_cuda(padded, *log2, offsets),
                                   rb["dest"]),
                "place_halo": entry(lambda: bc.bucket_place_halo_cuda(padded, dest),
                                    rb["place"]),
            }
        return {"block": list(padded.x.shape), "kernels": kernels}
    grid = bucket.GridConfig(*bucket.grid_log2(state), state.x.shape[-1])
    chunks = _lane_chunks_for((state.ty >= 0).sum(-1).cpu().numpy(), grid)
    slots = state.capacity
    step_bound = (ext_bound(state, sass) if chunks > 1
                  else bound(36 * slots, ops_bound_ms(bucket_pairs(state), sass)))
    dest = bc.move_dest_cuda(state)
    rb = rebucket_bounds(state, dest, slots)
    _, library_ms = place_library_call(state, dest, reps, timer=timer)
    kernels = {
        "step": entry(lambda: bc.bucket_step_cuda(state, pv), step_bound),
        "dest": entry(lambda: bc.move_dest_cuda(state), rb["dest"]),
        "place": entry(lambda: bc.bucket_place_cuda(state, dest), rb["place"],
                       library_ms=library_ms),
    }
    if chunks > 1:
        aux = bucket.ext_step_aux(state, pv, chunks, 8)
        pair = bc.ext_pair(state)
        kernels["step_compact"] = entry(
            lambda: bc.bucket_step_ext_cuda(pair, aux, True), ext_bound(state, sass))
    return {"lane_chunks": chunks, "kernels": kernels}


class ScaleHold(BenchHold):
    """``BenchHold`` for phase 23. On the first state it sees (the bench's
    state as loaded) it also times each kernel of the path
    (``scale_times``); it keeps the device-memory peak of the bench's run
    apart from its own (``device_peak``, read and reset as each hold begins
    and ends) and the clock of each hold. Its launches and ring traffic are
    not counted."""

    def __init__(self, mesh=None, cfg=None, timer=not_timed):
        super().__init__(mesh, cfg)
        self.timer = timer
        self.peaks = {"run": None, "holds": None}  # bytes; None without a card
        self.clock = []  # (entered, left) of each hold, time.perf_counter()
        self.times = None

    def peak(self, kind: str) -> None:
        """Fold ``device_peak()`` into the ``kind`` peak."""
        peak = device_peak()
        if peak is not None:
            self.peaks[kind] = max(self.peaks[kind] or 0, peak)

    def __call__(self, label: str, state, pv) -> None:
        from particle_simulator_tpu_torch.ops import bucket_cuda as bc
        from particle_simulator_tpu_torch.parallel import domain

        entered = time.perf_counter()
        self.peak("run")
        launches, exchange = dict(bc.LAUNCHES), dict(domain.EXCHANGE)
        super().__call__(label, state, pv)
        if self.times is None:
            self.times = scale_times(state, pv, self.timer, self.mesh, self.cfg)
        bc.LAUNCHES.update(launches)
        domain.EXCHANGE.update(exchange)
        self.peak("holds")
        self.clock.append((entered, time.perf_counter()))


def scale_readback(args) -> dict:
    """``readback_check`` on a Simulator serving the bench's user scene of
    the parsed ``args``: the ticket's wire bytes against the device pack of
    a copy and against its ``numpy_pack``."""
    from particle_simulator_tpu_torch import bench
    from particle_simulator_tpu_torch.engine.simulator import Simulator

    side = int(round(bench_particles(args) ** 0.5))
    frame = user_scene(side)
    frame.metadata.steps_per_frame = args.steps
    t0 = time.perf_counter()
    sim = Simulator(device=bench.torch_device(args.torch_device))
    sim.load_frame(frame)
    load_s = time.perf_counter() - t0
    line = readback_check(sim)
    if line["particles"] != side * side:
        raise AssertionError(f"readback: {line['particles']} particles, not {side * side}")
    return {**line, "grid": list(sim.grid.grid_shape), "readback_ncap": sim._readback_ncap,
            "load_s": load_s, "seconds": time.perf_counter() - t0}


def phase_scale(device: str = "cuda", runs=tuple(SCALE_RUNS), size=(), devices=None) -> dict:
    """Phase 23: the port's bench at the sizes of the JAX package's recorded
    runs (``SCALE_RUNS``), each row as phase 22 runs its rows (``bench_row``:
    bench.py's keys, a step launch a step per block and no kernel of another
    path, every kernel held bit for bit on the states as loaded and after
    the last frame) with a ``ScaleHold``: each kernel
    timed at the row's state with its bound, the device-memory peaks of the
    run and of the holds, the seconds of the load, the frames and the holds.
    After ``SCALE_READBACK``, ``scale_readback`` on the same scene. The
    previous row's tensors are freed before each row. One line a row;
    returns the records, the launches summed over the rows, each kernel's
    largest error and the lines."""
    import gc

    import torch

    from particle_simulator_tpu_torch import bench

    timer = cuda_ms if device == "cuda" else not_timed
    records, total, lines = {}, {}, {}
    err = dict.fromkeys(ScaleHold().err, 0.0)
    for label in runs:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        device_peak()
        t0 = time.perf_counter()
        rec, launches, hold, argv = bench_row(SCALE_RUNS, label, device, size, devices,
                                              ScaleHold, timer=timer)
        t1 = time.perf_counter()
        hold.peak("run")
        (in0, out0), (in1, out1) = hold.clock
        kernels = hold.times["kernels"]
        for k, v in kernels.items():
            v["launches"] = launches[k]
        line = {"record": rec, "argv": argv,
                "grid": rec.get("grid", list(hold.cfg.grid_shape)), "live": rec["particles"],
                "lane_chunks": hold.times.get("lane_chunks"), "block": hold.times.get("block"),
                "launches": {k: v for k, v in launches.items() if v},
                "max_abs_err": {k: hold.err[k] for k in kernels}, "kernels": kernels,
                "memory_peak_bytes": hold.peaks,
                "seconds": {"load": in0 - t0, "frames": in1 - out0,
                            "holds": out0 - in0 + out1 - in1, "end": t1 - out1, "row": t1 - t0},
                "held": hold.held}
        del hold
        if label == SCALE_READBACK:
            line["readback"] = scale_readback(bench.parser().parse_args(argv))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in line["max_abs_err"].items():
            err[k] = max(err[k], v)
        records[label], lines[label] = rec, line
        print(f"scale {label}: " + json.dumps(line), flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"records": records, "launches": total, "err": err, "lines": lines}


def multi_card_scale(device) -> dict:
    """Phase 23 across every card: the dense 16M row on the first card and
    the sharded 16M row on the single-controller mesh of every card (one
    shard a card), then phase 20's sharded frame at the 16M grid with one
    process a card over NCCL; one line with the three rates. Returns the
    halo kernels' largest errors."""
    import torch

    from particle_simulator_tpu_torch import bench
    from particle_simulator_tpu_torch.ops import build

    sc = phase_scale(device, runs=("dense 16M", "sharded 16M"))
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        mp = multiprocess_frame(bench.dense_grid_config(16_000_000), workdir, world=n,
                                n_shards=n, own_cards=True)
    one, cards = sc["records"]["dense 16M"], sc["records"]["sharded 16M"]
    rank0 = mp["line"]["processes"][0]
    line = {"grid": mp["line"]["grid"], "particles": one["particles"],
            "one_card_sim_steps_per_sec": one["sim_steps_per_sec"],
            "single_controller": {"mesh": cards["sharded_mesh"],
                                  "sim_steps_per_sec": cards["sim_steps_per_sec"]},
            "nccl_processes": {"world": n, "frame_ms": rank0["frame_ms"],
                               "sim_steps_per_sec": [MP_STEPS * 1e3 / ms
                                                     for ms in rank0["frame_ms"]]}}
    print("scale across cards: " + json.dumps(line), flush=True)
    held = held_errors(mp["held"])
    return {k: max(v, sc["err"][k]) for k, v in held.items()}


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bnd,
                 library_ms, launches_scripts=0, launches_multiprocess=0,
                 launches_config5=0, launches_bench=0, launches_scale=0):
    """One kernel of the kernels line. ``launches`` is the count of the
    served slice that runs the kernel; ``launches_scripts`` that of the
    scene runner's and the config scripts' path (phases 15-19);
    ``launches_multiprocess`` that of phase 20's two daemon processes,
    summed; ``launches_config5`` that of phase 21's daemon;
    ``launches_bench`` that of phase 22's bench runs, summed;
    ``launches_scale`` that of phase 23's rows, summed."""
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms,
            "launches_scripts": launches_scripts,
            "launches_multiprocess": launches_multiprocess,
            "launches_config5": launches_config5, "launches_bench": launches_bench,
            "launches_scale": launches_scale}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    # 1. card
    from particle_simulator_tpu_torch.utils.profiling import card_line

    name = torch.cuda.get_device_name(0)
    smi = card_line()
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
             "bucket_step_kernel_tiles": sass_pair_counts(
                 lib_path, "bucket_step_kernel_tiles", lib.ps_bucket_tiles_pairs_per_iter()),
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
    ap = phase_allpairs_kernel(device, reps=20, sass=sass)
    cs = phase_compact_slice(device, compact_frames=6, bucket_frames=3)
    phase_allpairs_throughput(device, frames=5, steps=100)
    halo = phase_halo_kernels(device, dense_cfg, GridConfig(4, 4, 16), reps=20, sass=sass)
    phase_sharded_frame(device, dense_cfg, frames=3, steps=100, timed=5)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        msl = phase_slice(device, "1024x1024", 16, workdir, mesh=one_card_mesh(device))
        # the same serve on one device, then both profiled
        phase_slice(device, "1024x1024", 8, workdir)
        for mesh in (None, one_card_mesh(device)):
            phase_slice(device, "1024x1024", 8, workdir, mesh=mesh, profile=True)
    rb = phase_readback_pack(device, reps=20)
    scene = user_scene()
    ext = phase_ext_kernels(device, scene, GridConfig(4, 4, 16), reps=20, sass=sass)
    phase_ext_frame(device, scene, frames=3, timed=5)
    phase_live_tile(device, reps=20, sass=sass)
    # 20. two processes sharing the card: the (2, 2) global mesh, two shards each
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        mp = phase_multiprocess(dense_cfg, workdir, world=2, n_shards=4, own_cards=False,
                                beside=msl)
    mp_err = mp["err"]
    if torch.cuda.device_count() > 1:
        nccl_err = multi_card(device, dense_cfg)["err"]
        mp_err = {k: max(v, nccl_err[k]) for k, v in mp_err.items()}

    # the scene runner's and the config scripts' path (phases 15-19); `hold`
    # compares every kernel with its plain version on each path's own states
    scripted, hold = {}, KernelHold()
    _, counts = phase_configs(device, frames=20, steps=100, hold=hold)
    _, sweep_counts = phase_sweep(device, hold)
    _, soak_counts = phase_soak(device, steps=100_000, check_every=10_000, hold=hold)
    _, integ_counts = phase_integrators(device, leapfrog_frames=400, euler_frames=8,
                                        steps_per_frame=250, hold=hold)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        _, cli_counts = phase_scene_cli(workdir, hold)
    for seen in (counts, sweep_counts, soak_counts, integ_counts, cli_counts):
        for k, v in seen.items():
            scripted[k] = scripted.get(k, 0) + v
    if min(scripted[k] for k in ("step", "dest", "place", "allpairs")) == 0:
        raise AssertionError(f"a kernel of the scripts' path never launched: {scripted}")
    print("held on the scripts' states: " + json.dumps(
        {"states": hold.held, "max_abs_err_v": hold.err}), flush=True)

    # 21. config 5: the web editor and the daemon, each a process of its own
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        c5 = phase_config5(workdir)
    c5l, c5err = c5["launches"], c5["err"]

    # 22. the bench in each mode, --sharded on a (1, 1) mesh of the first card
    bn = phase_bench(device, devices=[torch.device(device, 0)])
    bl, berr = bn["launches"], bn["err"]
    print("throughput: " + json.dumps(bn["records"]["dense"]), flush=True)
    phase_entry(device)

    # 23. the main path at the JAX package's recorded scale; the sharded row
    # on a (2, 2) mesh of the first card
    sc = phase_scale(device, devices=[torch.device(device, 0)] * 4)
    scl, serr = sc["launches"], sc["err"]

    if "jax" in sys.modules or any(m.split(".")[0] == "particle_simulator_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    ms, bnd = kern["dense"]["ms"], kern["dense"]["bounds"]
    err = max(kern["dense"]["step_max_abs_err_v"], kern["stress"]["step_max_abs_err_v"])
    gas = ap["gas_diffusion"]
    ap_err = max(line["max_abs_err_v"] for line in ap.values())
    kernels = [
        kernel_entry("bucket_step", "bucket_step.cu", STEP_KERNEL, sl["launches"]["step"],
                     max(err, hold.err["step"], c5err.get("step", 0.0), berr["step"],
                         serr["step"]),
                     ms["step"], ms["step_plain"], bnd["step"], None, scripted["step"],
                     launches_config5=c5l.get("step", 0), launches_bench=bl["step"],
                     launches_scale=scl["step"]),
        kernel_entry("bucket_dest", "bucket_dest.cu", DEST_KERNEL, sl["launches"]["dest"],
                     max(hold.err["dest"], c5err["dest"], berr["dest"], serr["dest"]),
                     ms["dest"], ms["dest_plain"], bnd["dest"], None, scripted["dest"],
                     launches_config5=c5l["dest"], launches_bench=bl["dest"],
                     launches_scale=scl["dest"]),
        kernel_entry("bucket_place", "bucket_place.cu", PLACE_KERNEL, sl["launches"]["place"],
                     max(hold.err["place"], c5err["place"], berr["place"], serr["place"]),
                     ms["place"], ms["place_plain"], bnd["place"], ms["place_library"],
                     scripted["place"], launches_config5=c5l["place"],
                     launches_bench=bl["place"], launches_scale=scl["place"]),
        kernel_entry("allpairs_step", "allpairs_step.cu", ALLPAIRS_KERNEL,
                     cs["launches"]["allpairs"], max(ap_err, hold.err["allpairs"]),
                     gas["ms"]["kernel"],
                     gas["ms"]["plain"], gas["bound"], gas["library_ms"], scripted["allpairs"],
                     launches_bench=bl["allpairs"], launches_scale=scl["allpairs"]),
    ]
    hms, hbnd = halo["dense"]["ms"], halo["dense"]["bounds"]
    herr = max(line["step_max_abs_err_v"] for line in halo.values())
    mpl = mp["launches"]
    kernels += [
        kernel_entry("bucket_step_halo", "bucket_step.cu", STEP_HALO_KERNEL,
                     msl["launches"]["step_halo"],
                     max(herr, mp_err["step_halo"], berr["step_halo"], serr["step_halo"]),
                     hms["step"], hms["step_plain"], hbnd["step"], None,
                     launches_multiprocess=mpl["step_halo"], launches_bench=bl["step_halo"],
                     launches_scale=scl["step_halo"]),
        kernel_entry("bucket_dest_halo", "bucket_dest.cu", DEST_HALO_KERNEL,
                     msl["launches"]["dest_halo"],
                     max(mp_err["dest_halo"], berr["dest_halo"], serr["dest_halo"]),
                     hms["dest"], hms["dest_plain"], hbnd["dest"], None,
                     launches_multiprocess=mpl["dest_halo"], launches_bench=bl["dest_halo"],
                     launches_scale=scl["dest_halo"]),
        kernel_entry("bucket_place_halo", "bucket_place.cu", PLACE_HALO_KERNEL,
                     msl["launches"]["place_halo"],
                     max(mp_err["place_halo"], berr["place_halo"], serr["place_halo"]),
                     hms["place"], hms["place_plain"], hbnd["place"], hms["place_library"],
                     launches_multiprocess=mpl["place_halo"], launches_bench=bl["place_halo"],
                     launches_scale=scl["place_halo"]),
    ]
    ems, ebnd = ext["user"]["ms"], ext["user"]["bound"]
    eerr = max(line["max_abs_err_v"] for line in ext.values())
    kernels += [
        kernel_entry("bucket_step_ext", "bucket_step.cu", EXT_KERNEL,
                     sl["launches"]["step_ext"], eerr, ems["ext"], ems["ext_plain"],
                     ebnd, None, launches_bench=bl["step_ext"], launches_scale=scl["step_ext"]),
        kernel_entry("bucket_step_compact", "bucket_step.cu", COMPACT_KERNEL,
                     sl["launches"]["step_compact"],
                     max(eerr, hold.err.get("step_compact", 0.0),
                         c5err.get("step_compact", 0.0), berr["step_compact"],
                         serr["step_compact"]), ems["compact"], ems["compact_plain"], ebnd,
                     None, scripted.get("step_compact", 0),
                     launches_config5=c5l.get("step_compact", 0),
                     launches_bench=bl["step_compact"], launches_scale=scl["step_compact"]),
    ]
    kernels += [
        kernel_entry("readback_pack", "readback_pack.cu", READBACK_KERNEL,
                     sl["readback_pack_launches"], 0.0, rb["ms"], rb["plain_ms"],
                     {k: rb[k] for k in ("bound_ms", "bound_by")}, None),
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


def multi_card(device, dense_cfg) -> dict:
    """Phases 10, 11, 22's ``--sharded`` and 20 over every card: the
    single-controller mesh's sharded frame, serve and bench, then one
    process a card over NCCL; then phase 23's 16M rows across the cards
    (``multi_card_scale``). Returns phase 20's result, with the bench's and
    phase 23's halo holds folded into its errors."""
    import torch

    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.parallel.domain import make_mesh

    cards = make_mesh()
    phase_sharded_frame(device, dense_cfg, frames=3, steps=100, timed=3, mesh=cards)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        msl = phase_slice(device, "1024x1024", 12, workdir, mesh=cards)
    bench_err = phase_bench(device, runs=("sharded",))["err"]
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        mp = phase_multiprocess(dense_cfg, workdir, world=n, n_shards=n, own_cards=True,
                                beside=msl)
    scale_err = multi_card_scale(device)
    return {**mp, "err": {k: max(v, bench_err[k], scale_err[k]) for k, v in mp["err"].items()}}


def main_alone(phase: str) -> int:
    """Phases 1, 2 and one other alone: 24 (``--readback-pack``) or 25
    (``--live-tile``)."""
    import torch

    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.utils.profiling import card_line

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    build.library()
    ptxas = ptxas_summary((build.BUILD_DIR / build.BUILD_LOG).read_text())
    shown = "pack" if phase == "--readback-pack" else "bucket_step"
    print("build: " + json.dumps({"seconds": time.perf_counter() - t0,
                                  "ptxas": {k: v for k, v in ptxas.items() if shown in k}}),
          flush=True)
    if phase == "--readback-pack":
        phase_readback_pack("cuda", reps=20)
    else:
        phase_live_tile("cuda", reps=20, sass=FORCE_LAW_COUNTS)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--readback-pack"], ["--live-tile"]):
        sys.exit(main_alone(sys.argv[1]))
    if sys.argv[1:2] == ["--child-frame"]:
        from particle_simulator_tpu_torch.physics.bucket import GridConfig

        workdir, grid, n_shards = sys.argv[2:5]
        sys.exit(multiprocess_frame_child(workdir, GridConfig(*map(int, grid.split(","))),
                                          int(n_shards)))
    sys.exit(main())
