"""The benchmark of ``particle_simulator_tpu_torch`` on NVIDIA H100 cards.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
configuration (``benchmark/configs/``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``mode`` names the runner:
``serve`` or ``frames``) and its chips. Set-up (the process's start to the
window's: the daemon or the ranks, the scene, the kernels' build on a
checkout's first run, warm-up) is ``setup_s``; the window lasts ``S``
seconds. Then the reference checks what the window produced (``correct``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<name>.py``), the
device's busy seconds and a breakdown.

The last line on standard output is one JSON object; the numbers compared
and their limits are the last lines on standard error and the result's last
key. The run exits 2 without a result when CUDA is missing or has fewer
cards than the cell asks for, and 3 when a process loaded a module of JAX
or of the JAX package.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from psbench import cells, nojax  # noqa: E402


def card_power() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: str,
             root: str = cells.ROOT) -> dict:
    """Run one cell on ``device`` ("cuda", or "cpu" for the CPU tests) and
    return the result object."""
    import torch

    from psbench import frames, serve

    bench = cells.load(root)
    wl, config, traffic = cells.cell(bench, workload, root)
    workdir = tempfile.mkdtemp(prefix="psbench-", dir=os.environ.get("TMPDIR"))
    ctx = {"workload": workload, "config": config, "traffic": traffic,
           "seed": int(seed) % 2**63, "seconds": float(seconds), "trace": int(traced),
           "device": device, "chips": int(wl["chips"]), "workdir": workdir, "root": root}
    with open(os.path.join(workdir, "ctx.json"), "w") as f:
        json.dump(ctx, f)
    try:
        runner = {"serve": serve, "frames": frames}[traffic["mode"]]
        record = runner.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t0_unix = record["window_unix"][0] / 1e9 if "window_unix" in record else None
    if t0_unix is None:
        t0_unix = time.time() - (time.perf_counter() - record["window"][0])
    record["setup_s"] = t0_unix - T_START
    if record.get("trace") and record["trace"]["busy_s"] <= 0:
        record["trace"] = None  # no device operation was traced: nothing to read
    metrics = {}
    for m in cells.metrics(bench, workload, traced):
        value = cells.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": int(wl["chips"]),
                "memory_peak_bytes": int(record.get("memory_peak") or 0)}
    out = {"correct": None, "attempted": int(record.get("attempted", 0)),
           "failed": int(record.get("failed", 0)), "metrics": metrics, "device": dev_info}
    tr = record.get("trace")
    if traced and tr:
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    checks = record["checks"]
    out["correct"] = all(v <= limit for _, v, limit in checks) and out["failed"] == 0
    out["card"] = card_power() if cuda else None
    if "live_at_window_edges" in record:
        out["live_at_window_edges"] = record["live_at_window_edges"]
    if (traced or not out["correct"]) and record.get("log_tail"):
        out["log_tail"] = record["log_tail"]
    if traced and tr:
        out["kernels"] = tr.get("kernels")
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    wl = next((w for w in cells.load()["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {wl['chips']} CUDA cards, this machine has {found}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    foreign = nojax.foreign_modules()
    if foreign:
        print(f"benchmark: foreign modules loaded: {foreign}", file=sys.stderr)
        return 3
    for line in out.pop("log_tail", None) or ():
        print(f"log: {line}", file=sys.stderr)
    for name, (count, mean_ns) in sorted((out.pop("kernels", None) or {}).items(),
                                         key=lambda kv: -kv[1][0] * kv[1][1])[:8]:
        print(f"kernel {name}: {count} launches, {mean_ns / 1e6:.4f} ms each", file=sys.stderr)
    if out["card"]:
        print(f"card: {out['card']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
