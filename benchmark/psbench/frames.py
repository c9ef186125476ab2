"""The ``frames`` runner: frames of the dense crystal back to back, with no
readback and no wire.

On one chip the harness's own process runs
``ops.bucket_cuda.run_frame_bucket_cuda`` until the window's seconds are
spent and ends the window at a device synchronise. On several chips one
process a card (``benchmark/rank_child.py``) runs
``parallel.domain.make_sharded_frame_fn`` on ``multihost.global_mesh``,
one shard a card, over NCCL; the ranks run a frame count fixed from the
set-up's frame time, between two barriers.

``correct`` compares, exactly, the first frame (computed in set-up from the
scene the harness made) and the window's last frame (computed from the
program's state before it) with the reference. On a grid of more than
``REGION_LIVE`` particles the comparison covers a square of buckets around
the shards' meeting point, drawn from the seed, which the reference
computes from the state of that square widened by the frame's light cone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from psbench import faults, refsim, roofline, scenes, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION_LIVE = 2_000_000
# the launches a step's device time is read from: the classic step on one card
STEP_KERNELS = ("bucket_step_kernel<false>",)
WARM_FRAMES = 2


def grid_of(cfg: dict) -> scenes.Grid:
    return scenes.Grid(int(cfg["bx_log2"]), int(cfg["by_log2"]), int(cfg["cap"]),
                       int(cfg.get("move_every", 16)))


def region(g: scenes.Grid, live: int, seed: int, traffic: dict, steps: int):
    """(rows, cols) of the buckets compared and of the reference's input,
    or None to compare the whole grid."""
    if live <= REGION_LIVE:
        return None
    half = int(traffic.get("region_half_buckets", 64))
    off = np.random.default_rng([seed, 3]).integers(-16, 17, size=2)
    cy, cx = g.by // 2 + int(off[0]), g.bx // 2 + int(off[1])
    wide = half + refsim.light_cone(steps, g.move_every)
    return ((cy - half, cy + half), (cx - half, cx + half)), \
        ((max(0, cy - wide), min(g.by, cy + wide)), (max(0, cx - wide), min(g.bx, cx + wide)))


def crop(lay: refsim.Layout, box) -> refsim.Layout:
    return lay if box is None else refsim.restrict(lay, *box)


def frame_mismatch(before: refsim.Layout, after: refsim.Layout, params, steps: int,
                   boxes) -> int:
    """Particles of ``after`` (in the compared buckets) that differ from the
    reference's frame from ``before``."""
    inner, outer = (None, None) if boxes is None else boxes
    ref = refsim.frame(crop(before, outer), params, steps)
    return refsim.layout_mismatches(crop(after, inner), crop(ref, inner))


def run(ctx: dict) -> dict:
    return run_single(ctx) if ctx["chips"] == 1 else run_multi(ctx)


def run_single(ctx: dict) -> dict:
    saved = faults.apply()
    try:
        return _run_single(ctx)
    finally:
        faults.undo(saved)


def _run_single(ctx: dict) -> dict:
    from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams
    from particle_simulator_tpu_torch.ops import bucket_cuda

    cfg, traffic, seed, seconds = ctx["config"], ctx["traffic"], ctx["seed"], ctx["seconds"]
    g = grid_of(cfg)
    steps = int(cfg["steps_per_frame"])
    dev = torch.device("cuda", 0) if ctx["device"] == "cuda" else torch.device("cpu")
    scene, meta, live = scenes.dense_crystal(g, seed, cfg["step_dt"], dev, cfg["fill"])
    pv = SimParams.from_record(meta).vector(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def frame(s):
        return bucket_cuda.run_frame_bucket_cuda(s, pv, steps, g.move_every)

    first = frame(ParticleState(*scene))
    cur = first
    for _ in range(WARM_FRAMES):
        cur = frame(cur)
    sync()
    tracer, spans = trace.DeviceTrace(), []
    trace_s = float(traffic.get("trace_s", 3.0))
    if ctx["trace"]:
        tracer.warm()
    t0 = time.perf_counter()
    t_on = t0 + max(0.0, (seconds - trace_s) / 2)
    done, prev = 0, cur
    # the particles that completed each frame, summed on the device: the
    # crystal sheds particles at its full buckets, so the count falls
    completed = torch.zeros((), dtype=torch.int64, device=dev)
    live_at = [int((cur.ty >= 0).sum())]
    while time.perf_counter() < t0 + seconds:
        now = time.perf_counter()
        if ctx["trace"] and tracer.t0 is None and now >= t_on:
            tracer.start()
        elif tracer.active and now >= t_on + trace_s:
            tracer.stop()
        a = time.time_ns()
        prev, cur = cur, frame(cur)
        completed += (cur.ty >= 0).sum()
        if tracer.active:
            spans.append(("run_frame_bucket_cuda", a, time.time_ns()))
        done += 1
    sync()
    t1 = time.perf_counter()
    if tracer.active:
        tracer.stop()
    live_at.append(int((cur.ty >= 0).sum()))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    record = {"window_s": t1 - t0, "window": (t0, t1), "frames": done,
              "steps": steps, "particle_steps": int(completed) * steps,
              "live_at_window_edges": live_at,
              "memory_peak": peak, "attempted": done, "failed": 0}
    if ctx["trace"] and tracer.ops is not None and tracer.t0 is not None:
        red = trace.reduce(tracer.ops, tracer.t0, tracer.t1, spans)
        after = refsim.from_grid(tuple(cur), g)
        counts = roofline.counts_of(after.bucket, g.by, g.bx)
        least = roofline.step_least_ms(roofline.pairs_from_counts(counts), len(after.x))
        step_ms = trace.kernel_mean_ms(red, STEP_KERNELS)
        record["trace"] = red
        record["ranks"] = [{"trace": red, "step_least": least, "step_ms": step_ms}]
    params = refsim.params_vector(meta, dev)
    boxes = region(g, live, seed, traffic, steps)
    checks = [
        ("first_frame_mismatch", frame_mismatch(refsim.from_grid(scene, g),
                                                refsim.from_grid(tuple(first), g),
                                                params, steps, boxes), 0),
        ("last_frame_mismatch", frame_mismatch(refsim.from_grid(tuple(prev), g),
                                               refsim.from_grid(tuple(cur), g),
                                               params, steps, boxes), 0)]
    record["checks"] = checks
    return record


def _rank_env(rank: int, world: int, store: str) -> dict:
    env = dict(os.environ)
    env.update({"PS_TPU_COORDINATOR": f"file://{store}", "PS_TPU_NUM_PROCESSES": str(world),
                "PS_TPU_PROCESS_ID": str(rank), "LOCAL_RANK": str(rank)})
    return env


def run_multi(ctx: dict) -> dict:
    world = int(ctx["chips"])
    store_dir = tempfile.mkdtemp(prefix="psbench-store-", dir=ctx["workdir"])
    store = os.path.join(store_dir, "store")
    logs, procs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(ctx["workdir"], f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "rank_child.py"), "--ctx",
                 os.path.join(ctx["workdir"], "ctx.json"), "--out", ctx["workdir"]],
                env=_rank_env(r, world, store), stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(HERE)))
        deadline = time.monotonic() + 1100.0
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = open(os.path.join(ctx["workdir"], f"rank{r}.log")).read()[-3000:]
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{tail}")
    ranks = []
    for r in range(world):
        with open(os.path.join(ctx["workdir"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    record = {"window_s": (r0["t1"] - r0["t0"]) / 1e9, "window_unix": (r0["t0"], r0["t1"]),
              "frames": r0["frames"],
              "particle_steps": sum(r["completed"] for r in ranks) * r0["steps"],
              "live_at_window_edges": [sum(r["live_at"][k] for r in ranks) for k in (0, 1)],
              "memory_peak": max(r["memory_peak"] for r in ranks), "ranks": ranks,
              "attempted": r0["frames"], "failed": 0}
    if ctx["trace"]:
        record["trace"] = merge_traces([r["trace"] for r in ranks])
    cfg = ctx["config"]
    g = grid_of(cfg)
    dev = "cuda" if ctx["device"] == "cuda" else "cpu"
    steps = int(cfg["steps_per_frame"])
    params = refsim.params_vector(scenes.dense_metadata(g, cfg["step_dt"], cfg["fill"]), dev)
    boxes = None if r0["inner"] is None else (r0["inner"], None)

    def load(name):
        with np.load(os.path.join(ctx["workdir"], name + ".npz")) as z:
            parts = np.zeros(len(z["x"]), dtype=refsim.wire.PARTICLE_DTYPE)
            for f in refsim.wire.PARTICLE_DTYPE.names:
                parts[f] = z[f].view(refsim.wire.PARTICLE_DTYPE[f])
            return refsim.from_particles(parts, z["bucket"], z["slot"], g, dev)

    record["checks"] = [
        ("first_frame_mismatch", frame_mismatch(load("scene"), load("first"), params, steps,
                                                boxes), 0),
        ("last_frame_mismatch", frame_mismatch(load("before"), load("after"), params, steps,
                                               boxes), 0),
        ("ranks_frames_differ", len({r["frames"] for r in ranks}) - 1, 0)]
    return record


def merge_traces(traces: list) -> dict:
    """The mean of the ranks' trace reductions (busy, window, idle share,
    device time by operation, idle gaps)."""
    n = len(traces)
    out = {k: sum(t[k] for t in traces) / n for k in ("busy_s", "window_s", "idle_pct")}
    for key in ("device_ops", "idle_gaps"):
        acc: dict = {}
        for t in traces:
            for name, v in t[key]:
                acc[name] = acc.get(name, 0.0) + v / n
        out[key] = [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
    return out
