"""Headline benchmark of the port: bucket-path particle-steps/s on one card.

Counterpart of the repository's ``bench.py``, with the same modes, arguments
and JSON keys. Scene: a full 1M-particle bucket grid (512 x 256 buckets x 8
slots at ``bench.py``'s default ``--particles``) at condensed-phase density,
advanced with the production frame runner (``ops/bucket_cuda.py:
run_frame_bucket_cuda``: 100 leapfrog steps a frame, rebucket every 16).

Modes:

- dense (default): ``--frames`` frames after one untimed warm-up frame (the
  kernels' ``nvcc`` build, at first use, falls there), one
  ``torch.cuda.synchronize`` on every card of the state as the barrier;
  ``--per-frame`` syncs every frame and reports the per-frame times;
- ``--sharded``: the sharded frame (``parallel/domain.py``) over a mesh of
  every visible card, one shard a card (a (1, 1) mesh on one card);
- ``--user-scene``: the editor-drawn configuration through the engine's own
  ``Simulator``, exactly as the daemon runs it (its grid choice, the runner
  its scene picks, per-frame dispatch, readback).

Prints ONE JSON line, the last on stdout; on the card the ``nvidia-smi``
name and power limit come first. The user scene's line keeps the keys of
the repository's ``bench.py``: ``ext_io`` is always ``"auto"``, the JAX
engine's name for the rule the port follows (live tiles where the scene
has more than one lane chunk), and ``readback_k`` is the grid's ``cap``,
the slot prefix the record pack reads. ``vs_baseline`` is measured against the
north star: 1M particles x 60 sim-steps/s = 6.0e7 particle-steps/s.

Usage (a machine with an NVIDIA H100; without a card it raises):
    python -m particle_simulator_tpu_torch.bench [--particles N] [--frames K] [--steps S]
On the CPU (the plain PyTorch versions, slow: shrink it):
    python -m particle_simulator_tpu_torch.bench --torch-device cpu \
        --particles 512 --frames 2 --steps 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

NORTH_STAR = 6.0e7  # particle-steps/sec: >=1M particles x >=60 steps/s


def dense_grid_scene(cfg, fill: int = 8):
    """The bench scene, in numpy: every interior bucket holds ``fill``
    particles on a bucket-aligned hexagonal lattice at spacing r0 (the 2D
    ground state, so it neither relaxes nor straddles bucket edges; ``cols``
    hex columns x ``rows`` hex rows a bucket), 1% jitter, cold (sigma 1 m/s),
    the outer bucket ring empty as a wall margin, dt = 10 fs (the reference's
    stability envelope; the 50 fs default blows up at this density).
    Particles are in (bucket row, bucket column, slot) order, so with
    ``fill == cfg.cap`` they are the grid's slots. Returns (PARTICLE_DTYPE
    array, metadata record, live count)."""
    from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, MieParams, default_metadata

    meta = default_metadata()
    n = cfg.buckets * fill
    r0 = MieParams.nitrogen().force0_r()
    rows = 2 if fill <= 8 else 4
    if fill % rows:
        raise ValueError(f"fill {fill} does not split into {rows} hex rows")
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
    ixg = gx * cols + gs % cols  # global hex column
    iyg = gy * rows + gs // cols  # global hex row
    # odd rows offset by d/2; +d/4 keeps every particle inside its bucket
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


def dense_grid_config(particles: int, fill: int = 8):
    """The smallest power-of-two grid holding ``particles`` at ``fill`` a
    bucket, its row and column bits grown in turns from 4 x 4 (rows first),
    with cap = ``fill``: at equal slot count a cap-8 grid does half the pair
    work of a cap-16 one, and the 3x3 window still covers the force range."""
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    kx = ky = 2
    while (1 << (kx + ky)) * fill < particles:
        if kx == ky:
            ky += 1
        else:
            kx += 1
    return GridConfig(kx, ky, fill)


def torch_device(name: str) -> torch.device:
    """The device a run asks for; CUDA must exist (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; --torch-device cpu runs the plain "
                           "PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def bench_mesh(dev: torch.device, devices=None):
    """The ``--sharded`` mesh: over ``devices`` when given, else every
    visible card (one shard a card; (1, 1) on one card), or one CPU shard."""
    from particle_simulator_tpu_torch.parallel.domain import make_mesh

    if devices is None and dev.type == "cpu":
        devices = [dev]
    return make_mesh(devices=devices)


def synchronize(blocks) -> None:
    """Wait for every card the blocks live on (nothing to wait for on the
    CPU)."""
    for d in {b.x.device for b in blocks}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def bench_dense(args, devices=None, inspect=None) -> dict:
    """The dense grid through ``run_frame_bucket_cuda`` (or the sharded
    frame with ``args.sharded``): one warm-up frame, then ``args.frames``
    timed frames. ``inspect(label, state, params)`` sees the state (the
    mesh's blocks when sharded) and its params vector(s) as loaded and after
    the last frame, outside the timed window."""
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.ops.bucket_cuda import run_frame_bucket_cuda
    from particle_simulator_tpu_torch.parallel.domain import (
        make_sharded_frame_fn,
        pad_rows_for_mesh,
        shard_state,
    )

    dev = torch_device(args.torch_device)
    cfg = dense_grid_config(args.particles, args.fill)
    parts, meta, n = dense_grid_scene(cfg, args.fill)
    params = SimParams.from_record(meta)
    state = state_from_numpy(parts, cfg.capacity, dev).reshape(cfg.grid_shape)
    steps = args.steps
    mesh = None
    if args.sharded:
        mesh = bench_mesh(dev, devices)
        frame_fn = make_sharded_frame_fn(cfg, mesh)
        state = shard_state(pad_rows_for_mesh(state, mesh)[0], mesh)
        pv = tuple(params.vector(d) for d, _ in mesh.blocks)

        def run(s):
            return frame_fn(s, pv, steps)

        def blocks(s):
            return s
    else:
        pv = params.vector(dev)

        def run(s):
            return run_frame_bucket_cuda(s, pv, steps, cfg.move_every)

        def blocks(s):
            return (s,)

    if inspect is not None:
        inspect("dense as loaded", state, pv)
    state = run(state)  # warm-up: the kernels are built or loaded here
    synchronize(blocks(state))

    frame_times = []
    t0 = time.perf_counter()
    for _ in range(args.frames):
        tf = time.perf_counter()
        state = run(state)
        if args.per_frame:
            synchronize(blocks(state))
            frame_times.append(time.perf_counter() - tf)
    synchronize(blocks(state))
    elapsed = time.perf_counter() - t0
    if inspect is not None:
        inspect(f"dense after {args.frames + 1} frames", state, pv)

    if not all(bool(torch.isfinite(b.vx).all() and torch.isfinite(b.vy).all())
               for b in blocks(state)):
        raise AssertionError("benchmark scene diverged")
    # sharded blocks hold interiors only (pad rows are tombstones): no ring
    # slot is counted
    live_end = sum(int((b.ty >= 0).sum()) for b in blocks(state))
    value = n * steps * args.frames / elapsed
    rec = {
        "metric": "particle-steps/sec/chip",
        "value": value,
        "unit": "particle*steps/s",
        "vs_baseline": value / NORTH_STAR,
        "particles": n,
        "steps_per_frame": steps,
        "frames": args.frames,
        "elapsed_s": elapsed,
        "sim_steps_per_sec": steps * args.frames / elapsed,
        # bucket-overflow drops are the reference's semantics
        "live_fraction_end": live_end / n,
        "device": dev.type,
    }
    if mesh is not None:
        rec["sharded_mesh"] = list(mesh.shape)
    if frame_times:
        rec["frame_s"] = {"min": min(frame_times), "p50": float(np.median(frame_times)),
                          "max": max(frame_times),
                          "cv": float(np.std(frame_times) / np.mean(frame_times))}
        rec["frame_s_series"] = frame_times
    return rec


def bench_user_scene(args, devices=None, inspect=None) -> dict:
    """The editor-drawn configuration: a hex lattice at 1.1 r0 filling half
    the box's side through the engine's own ``Simulator`` (grid from
    ``_grid_for``, per-frame dispatch as the daemon does it). Warm-up: one
    frame and three readbacks; the timed window enqueues ``args.frames``
    frames and ends at ``Simulator.sync()``; one readback is timed apart
    (the daemon overlaps it with the next frame). ``inspect(label, state,
    params)`` sees the Simulator's state and params as loaded and after the
    last frame."""
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.scenes.library import _scene

    dev = torch_device(args.torch_device)
    side = max(2, int(round(args.particles ** 0.5)))
    frame = _scene(side, side, distance_factor=1.1, speed=1.0, box_fill=0.5)
    frame.metadata.steps_per_frame = args.steps
    mesh = bench_mesh(dev, devices) if args.sharded else None
    sim = Simulator(device=dev, mesh=mesh)
    sim.load_frame(frame)
    n = int(np.count_nonzero(frame.particles["ty"] >= 0))
    if inspect is not None:
        inspect("user scene as loaded", sim.state, sim._pvec)

    sim.frame_async()
    for _ in range(3):
        sim.read_frame()

    sim.sync()
    t0 = time.perf_counter()
    for _ in range(args.frames):
        sim.frame_async()
    sim.sync()
    elapsed = time.perf_counter() - t0
    if inspect is not None:
        inspect(f"user scene after {args.frames + 1} frames", sim.state, sim._pvec)

    t0 = time.perf_counter()
    out = sim.read_frame()
    readback_s = time.perf_counter() - t0
    if not (np.isfinite(out.particles["vx"]).all() and np.isfinite(out.particles["vy"]).all()):
        raise AssertionError("benchmark scene diverged")

    g = sim.grid
    value = n * args.steps * args.frames / elapsed
    rec = {
        "metric": "particle-steps/sec/chip",
        "scene": "user-lattice",
        "value": value,
        "unit": "particle*steps/s",
        "vs_baseline": value / NORTH_STAR,
        "particles": n,
        "steps_per_frame": args.steps,
        "frames": args.frames,
        "elapsed_s": elapsed,
        "sim_steps_per_sec": args.steps * args.frames / elapsed,
        "readback_ms": readback_s * 1e3,
        "readback_k": g.cap,
        "readback_ncap": sim._readback_ncap,
        "grid": [g.by, g.bx, g.cap],
        # lane chunks picked from the scene's occupancy at load; the
        # live-tile frame runs only with more than one
        "lane_chunks": sim._lane_chunks,
        "ext_io": "auto",
        "device": dev.type,
    }
    if mesh is not None:
        rec["sharded_mesh"] = list(mesh.shape)
    return rec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--particles", type=int, default=1_048_576)
    ap.add_argument("--frames", type=int, default=10, help="timed frames")
    ap.add_argument("--steps", type=int, default=100, help="physics steps per frame")
    ap.add_argument("--fill", type=int, default=8, help="particles per bucket")
    ap.add_argument("--sharded", action="store_true",
                    help="run the sharded frame (halo kernels and the ring exchange) "
                         "over a mesh of every visible card, one shard a card; on one "
                         "card this measures the shard overhead against the "
                         "one-device runner")
    ap.add_argument("--user-scene", action="store_true",
                    help="bench the editor-drawn configuration instead of the dense "
                         "grid: a hex lattice at 1.1 r0 spacing filling half the box, "
                         "grid chosen by the engine's own _grid_for")
    ap.add_argument("--per-frame", action="store_true",
                    help="barrier every frame (torch.cuda.synchronize) and report the "
                         "per-frame time distribution")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain "
                         "PyTorch versions)")
    return ap


def run(argv=None, devices=None, inspect=None) -> dict:
    """Parse ``argv`` as the command line does and return the record. For
    in-process callers: ``devices`` replaces the ``--sharded`` mesh's
    devices, ``inspect`` is the runners' hook."""
    args = parser().parse_args(argv)
    if args.user_scene:
        return bench_user_scene(args, devices, inspect)
    return bench_dense(args, devices, inspect)


def main(argv=None) -> int:
    from particle_simulator_tpu_torch.utils.log import report_foreign_modules

    args = parser().parse_args(argv)
    try:
        if torch_device(args.torch_device).type == "cuda":
            from particle_simulator_tpu_torch.utils.profiling import card_line

            print(card_line(), flush=True)
        print(json.dumps(run(argv)), flush=True)
    finally:
        report_foreign_modules("bench")
    return 0


if __name__ == "__main__":
    sys.exit(main())
