"""One rank of a several-chip frames cell: one process a card, over NCCL.

    python benchmark/rank_child.py --ctx DIR/ctx.json --out DIR

with ``PS_TPU_COORDINATOR`` (a ``file://`` store), ``PS_TPU_NUM_PROCESSES``
and ``PS_TPU_PROCESS_ID`` set (``psbench/frames.py:run_multi`` starts the
ranks). Every rank draws the dense crystal from the seed on its card, keeps
its shard of ``multihost.global_mesh``, runs the first frame (the kernels'
build), times two frames to fix the window's frame count, and runs that many
frames of ``make_sharded_frame_fn`` between two barriers, the device trace
over a steady stretch of them with ``trace`` set. Rank 0 gathers the grid
through the program's gather and writes the square of buckets the check
compares (``scene``, ``first``, ``before``, ``after``: ``.npz``). Each rank
writes ``rank<r>.json`` and exits 3 if it found a module of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from psbench import faults, frames, nojax, refsim, roofline, scenes, trace  # noqa: E402

# the launches a step's device time is read from: the halo step of each shard
STEP_KERNELS = ("bucket_step_kernel<true>",)


def save_region(lay: refsim.Layout, box, path: str) -> None:
    lay = frames.crop(lay, box)
    parts = refsim.pack(lay)
    np.savez(path, **{n: parts[n] for n in parts.dtype.names},
             bucket=lay.bucket.cpu().numpy(), slot=lay.slot.cpu().numpy())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    with open(args.ctx) as f:
        ctx = json.load(f)

    import torch.distributed as dist

    from particle_simulator_tpu_torch.engine.state import ParticleState, SimParams
    from particle_simulator_tpu_torch.parallel import domain, multihost

    faults.apply()
    device_type = ctx["device"]
    if device_type == "cpu":
        torch.set_num_threads(1)  # four ranks of plain versions on a shared host
    if not multihost.init_distributed(device_type):
        raise SystemExit("rank: no PS_TPU_* group in the environment")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = multihost.process_device(device_type)
    cfg, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    g = frames.grid_of(cfg)
    steps = int(cfg["steps_per_frame"])
    scene, meta, live = scenes.dense_crystal(g, seed, cfg["step_dt"], dev, cfg["fill"])
    mesh = multihost.global_mesh(world, device_type)
    padded, _ = domain.pad_rows_for_mesh(ParticleState(*scene), mesh)
    blocks = multihost.shard_state_global(padded, mesh)
    boxes = frames.region(g, live, seed, traffic, steps)
    inner, outer = (None, None) if boxes is None else boxes
    if rank == 0:
        save_region(refsim.from_grid(scene, g), outer, os.path.join(args.out, "scene.npz"))
    del scene, padded
    pv = SimParams.from_record(meta).vector(dev)
    pvs = [pv] * len(blocks)
    fn = domain.make_sharded_frame_fn(g, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def gathered(bl):
        got = multihost.gather_global(bl, mesh)
        return None if got is None else refsim.from_grid(tuple(a[:g.by] for a in got), g)

    blocks = fn(blocks, pvs, steps)
    first = gathered(blocks)
    if rank == 0:
        save_region(first, inner, os.path.join(args.out, "first.npz"))
    del first
    sync()
    multihost.barrier(dev)
    a = time.perf_counter()
    for _ in range(frames.WARM_FRAMES):
        blocks = fn(blocks, pvs, steps)
    sync()
    multihost.barrier(dev)
    frame_s = torch.tensor([(time.perf_counter() - a) / frames.WARM_FRAMES], dtype=torch.float64,
                           device=dev if dev.type == "cuda" else "cpu")
    dist.broadcast(frame_s, 0)  # rank 0 fixes the count every rank runs
    n = max(2, round(ctx["seconds"] / float(frame_s)))
    trace_s = float(traffic.get("trace_s", 3.0))
    n_trace = max(1, round(trace_s / float(frame_s))) if ctx["trace"] else 0
    on = (n - n_trace) // 2
    tracer, spans = trace.DeviceTrace(), []
    if ctx["trace"]:
        tracer.warm()
    ex0 = dict(domain.EXCHANGE)

    def live_now(bl):
        return sum((b.ty >= 0).sum() for b in bl)

    live_at = [int(live_now(blocks))]
    completed = torch.zeros((), dtype=torch.int64, device=dev)
    multihost.barrier(dev)
    t0 = time.time_ns()
    prev = blocks
    for i in range(n):
        if i == on and n_trace:
            tracer.start()
        elif i == on + n_trace and tracer.active:
            tracer.stop()
        s = time.time_ns()
        prev, blocks = blocks, fn(blocks, pvs, steps)
        completed += live_now(blocks)
        if tracer.active:
            spans.append(("sharded frame", s, time.time_ns()))
    sync()
    multihost.barrier(dev)
    t1 = time.time_ns()
    live_at.append(int(live_now(blocks)))
    if tracer.active:
        tracer.stop()
    ex1 = dict(domain.EXCHANGE)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {"rank": rank, "world": world, "device": str(dev), "t0": t0, "t1": t1, "frames": n,
           "steps": steps, "live": live, "completed": int(completed), "live_at": live_at,
           "memory_peak": peak, "inner": inner,
           "exchange": {k: ex1[k] - ex0[k] for k in ex1},
           "foreign_modules": nojax.foreign_modules()}
    before, after = gathered(prev), gathered(blocks)
    shards = None
    if rank == 0:
        save_region(before, outer, os.path.join(args.out, "before.npz"))
        save_region(after, inner, os.path.join(args.out, "after.npz"))
        counts = roofline.counts_of(after.bucket, g.by, g.bx).to(torch.int64)
        nbr = torch.nn.functional.pad(counts, (1, 1, 1, 1))
        nbr = sum(nbr[dy:dy + g.by, dx:dx + g.bx] for dy in range(3) for dx in range(3))
        per = (counts * (nbr - 1)).clamp(min=0)
        ny, nx = mesh.shape
        ly, lx = g.by // ny, g.bx // nx
        shards = [[int(per[r // nx * ly:(r // nx + 1) * ly, r % nx * lx:(r % nx + 1) * lx].sum()),
                   int(counts[r // nx * ly:(r // nx + 1) * ly,
                              r % nx * lx:(r % nx + 1) * lx].sum())] for r in range(ny * nx)]
    del before, after, prev
    shard_list = [shards]
    dist.broadcast_object_list(shard_list, 0)
    pairs, live_r = shard_list[0][rank]
    if ctx["trace"]:
        red = trace.reduce(tracer.ops, tracer.t0, tracer.t1, spans)
        out["trace"] = red
        out["step_least"] = roofline.step_least_ms(pairs, live_r)
        out["step_ms"] = trace.kernel_mean_ms(red, STEP_KERNELS)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    if out["foreign_modules"]:
        print(f"rank {rank}: foreign modules {out['foreign_modules']}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
