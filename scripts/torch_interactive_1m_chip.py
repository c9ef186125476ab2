#!/usr/bin/env python3
"""Config 5 on the PyTorch + CUDA port: the assembled interactive editor at 1M.

Counterpart of ``scripts/interactive_1m_chip.py``: a web editor process (the
editor side, on the host's CPU: ``particle_simulator_tpu_torch.editor.webview``)
and a daemon process (the engine side, on the card:
``particle_simulator_tpu_torch.engine.daemon``) over a real TCP socket, with a
1024x1024 lattice (1,048,576 particles) drawn through the HTTP surface as a
user would: the box at 1024 x 1.1 r0 / 0.5, dt = 10 fs, 100 steps a frame.

Reported (one JSON line, the JAX script's keys):
- engine_fps: engine frames/s arriving in the editor's timeline (frame_count
  growth over the window); sim_steps_per_sec = engine_fps x steps_per_frame
- frame_bin_payloads_per_sec / frame_bin_mb_per_payload: the sustained
  /frame.bin fetch rate under load (the WebGL client's data feed)
- limiter: which side bounds the assembled loop, the engine feed (compute +
  shipping, = engine_fps) or the /frame.bin fetch path

The web editor keeps every frame (the reference's timeline, ~21 MB a frame
at 1M). The script reads MemAvailable first; the window ends early, and
``seconds`` says how long it ran, once the timeline holds half of it.

Usage (a machine with one NVIDIA H100, from the repository root):
    python3 scripts/torch_interactive_1m_chip.py [--seconds 60] [--steps-per-frame 100]
On the CPU (the plain versions; shrink it):
    python3 scripts/torch_interactive_1m_chip.py --torch-device cpu --n-side 32 --seconds 2 --steps-per-frame 5
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# seconds between the window's progress events
WINDOW_EVENT_S = 5.0


def post(base: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read() or b"{}")


def get_json(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mem_available() -> int | None:
    """The host's MemAvailable in bytes (``/proc/meminfo``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def cpu_seconds(pid: int) -> float | None:
    """User + system CPU seconds a process has used (``/proc/PID/stat``),
    or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def check_device(torch_device: str) -> None:
    """Raise unless the daemon's device exists: there is no CPU fallback."""
    if torch_device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; --torch-device cpu runs the daemon "
                               "on the CPU")


def _emit_json(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _stop(proc, timeout: float) -> None:
    """Wait for ``proc`` to end; SIGTERM after ``timeout`` s, SIGKILL after as
    long again."""
    if proc is None:
        return
    try:
        proc.wait(timeout=timeout)
        return
    except subprocess.TimeoutExpired:
        proc.terminate()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def record(seconds: float = 60.0, n_side: int = 1024, steps_per_frame: int = 100,
           torch_device: str = "cuda", http_port: int = 0, tcp_port: int = 0,
           readback_pipeline: int = 1, first_frame_wait: float = 300.0,
           inspect: str | None = None, daemon_record: str | None = None,
           log_dir: str | None = None, emit=_emit_json) -> dict:
    """Start the web editor and the daemon, draw the lattice, measure for
    ``seconds`` and return the result line. Ports of 0 are picked free.
    ``inspect`` (``MODULE:FUNCTION``) and ``daemon_record`` (a path) go to the
    daemon's ``--inspect`` and ``--record``. The processes' output goes to
    ``webview.log`` and ``daemon.log`` in ``log_dir`` (a new temporary
    directory by default). ``emit`` gets the event lines (memory, first
    frames, and every ``WINDOW_EVENT_S`` of the window its counts so far and
    both processes' CPU seconds, to show which side limits and whether that
    changes as the timeline grows). Both processes are stopped on every path: the editor
    disconnects the engine first, then the web editor gets SIGTERM."""
    check_device(torch_device)
    http_port = http_port or free_port()
    tcp_port = tcp_port or free_port()
    log_dir = log_dir or tempfile.mkdtemp(prefix="config5-")
    os.makedirs(log_dir, exist_ok=True)
    base = f"http://127.0.0.1:{http_port}"
    mem = mem_available()
    budget = None if mem is None else mem // 2
    emit({"event": "memory", "mem_available_mb": None if mem is None else round(mem / 1e6, 1),
          "timeline_budget_mb": None if budget is None else round(budget / 1e6, 1)})
    daemon_cmd = [sys.executable, "-m", "particle_simulator_tpu_torch.engine.daemon",
                  "--addr", f"127.0.0.1:{tcp_port}",
                  "--readback-pipeline", str(readback_pipeline),
                  "--retry-s", "60", "--torch-device", torch_device]
    if inspect:
        daemon_cmd += ["--inspect", inspect]
    if daemon_record:
        daemon_cmd += ["--record", daemon_record]
    web = daemon = None
    web_log = open(os.path.join(log_dir, "webview.log"), "wb")
    daemon_log = open(os.path.join(log_dir, "daemon.log"), "wb")
    try:
        web = subprocess.Popen(
            [sys.executable, "-m", "particle_simulator_tpu_torch.editor.webview",
             "--http", f"127.0.0.1:{http_port}", "--addr", f"127.0.0.1:{tcp_port}"],
            cwd=REPO, stdout=web_log, stderr=subprocess.STDOUT)
        daemon = subprocess.Popen(daemon_cmd, cwd=REPO, stdout=daemon_log,
                                  stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                get_json(base, "/stats")
                break
            except Exception:
                time.sleep(0.2)
        else:
            raise RuntimeError("the web editor's HTTP never came up")

        # the box sized to the lattice (2x occupancy headroom: the cap-16
        # grid), dt = 10 fs, stable for a dense lattice
        from particle_simulator_tpu_torch.io.frame import MieParams

        r0 = MieParams.nitrogen().force0_r()
        box = n_side * 1.1 * r0 / 0.5
        post(base, "/params", {"box_width": box, "box_height": box, "step_dt": 10e-15,
                               "steps_per_frame": steps_per_frame})
        post(base, "/control", {"action": "lattice", "nx": n_side, "ny": n_side})
        n_expect = n_side * n_side

        # the engine's start, the kernels' build and the scene's load
        t0 = time.monotonic()
        first = st = None
        while time.monotonic() - t0 < first_frame_wait:
            st = get_json(base, "/stats")
            if st["particle_count"] >= 0.9 * n_expect and st["frame_count"] >= 2:
                first = st
                break
            if daemon.poll() is not None:
                raise RuntimeError(f"the daemon exited {daemon.returncode} before its "
                                   f"frames arrived (see {log_dir}/daemon.log)")
            time.sleep(0.2)
        if first is None:
            raise RuntimeError(f"engine frames never arrived: {st}")
        ttff = time.monotonic() - t0
        emit({"event": "first_frames", "wait_s": round(ttff, 1),
              "stats": {k: first[k] for k in ("frame_count", "particle_count", "device")}})

        # the window: timeline growth under a sustained /frame.bin fetch
        fetch_stats = {"count": 0, "bytes": 0, "errors": 0}
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(base + "/frame.bin", timeout=30) as r:
                        fetch_stats["bytes"] += len(r.read())
                    fetch_stats["count"] += 1
                except Exception:
                    fetch_stats["errors"] += 1
                    time.sleep(0.1)

        th = threading.Thread(target=hammer, daemon=True)
        s0 = get_json(base, "/stats")
        w0 = time.monotonic()
        th.start()
        s1 = s0
        next_event = WINDOW_EVENT_S
        while time.monotonic() - w0 < seconds:
            time.sleep(min(0.5, max(0.0, seconds - (time.monotonic() - w0))))
            s1 = get_json(base, "/stats")
            if time.monotonic() - w0 >= next_event:
                next_event += WINDOW_EVENT_S
                emit({"event": "window", "t_s": time.monotonic() - w0,
                      "engine_frames": s1["frame_count"] - s0["frame_count"],
                      "payloads": fetch_stats["count"],
                      "timeline_ram_mb": s1["timeline_ram"] / 1e6,
                      "webview_cpu_s": cpu_seconds(web.pid),
                      "daemon_cpu_s": cpu_seconds(daemon.pid)})
            if budget is not None and s1["timeline_ram"] >= budget:
                break
        elapsed = time.monotonic() - w0
        stop.set()
        th.join(timeout=30)

        frames = s1["frame_count"] - s0["frame_count"]
        engine_fps = frames / elapsed
        payload_rate = fetch_stats["count"] / elapsed
        return {
            "metric": "interactive-editor-1m",
            "particles": s1["particle_count"],
            "seconds": round(elapsed, 1),
            "engine_frames": frames,
            "engine_fps": round(engine_fps, 2),
            "sim_steps_per_sec": round(engine_fps * steps_per_frame, 1),
            "steps_per_frame": steps_per_frame,
            "frame_bin_payloads_per_sec": round(payload_rate, 1),
            "frame_bin_mb_per_payload": round(
                fetch_stats["bytes"] / max(1, fetch_stats["count"]) / 1e6, 2),
            "fetch_errors": fetch_stats["errors"],
            "timeline_ram_mb": round(s1["timeline_ram"] / 1e6, 1),
            "first_frames_wait_s": round(ttff, 1),
            "device": s1["device"],
            # the in-page self-test's verdict when a browser attached
            # during the window; null in headless runs
            "selftest": s1.get("selftest"),
            "limiter": "engine" if engine_fps < payload_rate else "frame.bin-fetch",
        }
    finally:
        # the engine first: the editor's disconnect ends its loop, and it
        # exits by itself (and runs its --inspect hook) before any signal
        try:
            post(base, "/control", {"action": "disconnect"})
        except Exception:  # the web editor is gone already: stop what is left
            pass
        _stop(daemon, 120)
        if web is not None and web.poll() is None:
            web.terminate()
        _stop(web, 30)
        web_log.close()
        daemon_log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--n-side", type=int, default=1024)
    ap.add_argument("--steps-per-frame", type=int, default=100,
                    help="reference default interactive cadence (particle.rs:139-142)")
    ap.add_argument("--http-port", type=int, default=0, help="0: a free port")
    ap.add_argument("--tcp-port", type=int, default=0, help="0: a free port")
    ap.add_argument("--first-frame-wait", type=float, default=300.0,
                    help="seconds for the engine's start, the kernels' nvcc build "
                         "and the scene's load")
    ap.add_argument("--readback-pipeline", type=int, default=1)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the daemon runs the scene: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--inspect", default=None, metavar="MODULE:FUNCTION",
                    help="passed to the daemon's --inspect")
    ap.add_argument("--log-dir", default=None,
                    help="where webview.log and daemon.log go (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)

    check_device(args.torch_device)
    if args.torch_device == "cuda":
        from particle_simulator_tpu_torch.utils.profiling import card_line

        print(card_line(), flush=True)
    result = record(args.seconds, args.n_side, args.steps_per_frame, args.torch_device,
                    args.http_port, args.tcp_port, args.readback_pipeline,
                    args.first_frame_wait, args.inspect, log_dir=args.log_dir)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
