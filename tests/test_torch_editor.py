"""The port's editor (``particle_simulator_tpu_torch/editor``, ``utils/numfmt.py``)
against the JAX package's, on the same seeded inputs, with exact equality:
every output here is bytes, integers or strings.

Where the two may differ by design, the difference is named in a list here:
the port's wire codec calls device 0 ``GPU`` where the JAX package's calls it
``TPU`` (``DEVICE_NAMES``), and a file backend's status line names its paths.
"""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from particle_simulator_tpu.editor import headless as jheadless
from particle_simulator_tpu.editor import timeline as jtimeline
from particle_simulator_tpu.editor import tools as jtools
from particle_simulator_tpu.editor.backend import Backend as JBackend
from particle_simulator_tpu.editor.core import Editor as JEditor
from particle_simulator_tpu.engine import daemon as jdaemon
from particle_simulator_tpu.engine.state import SimParams as JSimParams
from particle_simulator_tpu.io.frame import Frame as JFrame
from particle_simulator_tpu.io.transport import Writer as JWriter
from particle_simulator_tpu.physics.bucket import GridConfig as JGridConfig
from particle_simulator_tpu.utils import numfmt as jnumfmt
import particle_simulator_tpu.editor as jeditor_pkg

import particle_simulator_tpu_torch.editor as editor_pkg
from particle_simulator_tpu_torch.editor import headless, timeline, tools
from particle_simulator_tpu_torch.editor.backend import Backend
from particle_simulator_tpu_torch.editor.core import Editor
from particle_simulator_tpu_torch.engine.state import SimParams
from particle_simulator_tpu_torch.io.frame import Frame, default_metadata
from particle_simulator_tpu_torch.io.presets import ParticleLattice
from particle_simulator_tpu_torch.utils import numfmt
from particle_simulator_tpu_torch.utils.log import FOREIGN_MODULES_TAG

REPO = Path(__file__).resolve().parent.parent

# the one display name the two wire codecs give differently (io/frame.py)
DEVICE_NAMES = {"TPU": "GPU"}


def as_port(stats: dict) -> dict:
    """A JAX editor's stats with the JAX device name mapped to the port's."""
    return {k: DEVICE_NAMES.get(v, v) if k == "device" else v for k, v in stats.items()}


# -- numfmt ------------------------------------------------------------------

NUMFMT_VALUES = [
    0.0, -0.0, 1.0, -1.0, 5e-14, 1500.0, 2.5e-7, 1.5e9, -0.00042, 9.87e-16, 123.456,
    1048576.0, 6.022e23, 0.001, 42.0, 1e-7, 999.95, 9.9999e2, 1e21, -1e21, 1234567.89,
    -1234.56, 0.05, 3.14159, 2500.0, 1e-18, 7.77e-13, 12345.6789, 0.999999, 1e3, 1e-3,
    float("inf"), float("-inf"), float("nan"), 3.3e12, -8.125e-9,
]


@pytest.mark.parametrize("significant", [1, 2, 4, 6])
@pytest.mark.parametrize("fmt", ["dashed", "scientific", "metric"])
def test_numfmt_matches_jax(fmt, significant):
    for unit in ("", "s", "B"):
        ours = numfmt.NumFormatter(numfmt.NumFormat(fmt), significant)
        ref = jnumfmt.NumFormatter(jnumfmt.NumFormat(fmt), significant)
        for v in NUMFMT_VALUES:
            assert ours.format(v, unit) == ref.format(v, unit), (fmt, significant, v, unit)


def test_format_with_underscores_matches_jax():
    for s in ["", "0", "12", "123", "1234", "-1234567", "+98765.4321", "1000000.000",
              "-0.5", "12345678901234567890"]:
        assert numfmt.format_with_underscores(s) == jnumfmt.format_with_underscores(s)
    assert [f.value for f in numfmt.NumFormat] == [f.value for f in jnumfmt.NumFormat]


# -- timeline ------------------------------------------------------------------

def frame_pair(dt=50e-15, spf=100, n=0, seed=0):
    """The same frame in both codecs: ``n`` random particles."""
    frame = Frame.new()
    frame.metadata.step_dt = dt
    frame.metadata.steps_per_frame = spf
    if n:
        rng = np.random.default_rng(seed)
        parts = np.zeros(n, dtype=frame.particles.dtype)
        parts["x"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        parts["y"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        parts["vx"] = rng.normal(0, 100, n)
        parts["vy"] = rng.normal(0, 100, n)
        parts["ty"] = rng.integers(-1, 2, n)
        frame.extend(parts)
    return frame, JFrame.from_bytes(frame.bytes)


def test_timeline_lookups_match_jax():
    ours, ref = timeline.Timeline(), jtimeline.Timeline()
    # runs of frames under changing dt, back to an earlier one, sizes varying
    schedule = [(50e-15, 100)] * 4 + [(10e-15, 100)] * 3 + [(10e-15, 7)] * 5 + \
        [(50e-15, 100)] * 2 + [(1e-15, 1)]
    for i, (dt, spf) in enumerate(schedule):
        a, b = frame_pair(dt, spf, n=i % 4, seed=i)
        ours.push_frame(a)
        ref.push_frame(b)
        assert ours.sim_len() == ref.sim_len()
        assert ours.timeline_ram == ref.timeline_ram
    assert len(ours._intervals) == len(ref._intervals) == 5
    for a, b in zip(ours._intervals, ref._intervals):
        assert (a.start_time, a.frame_dt, a.first_frame, a.frame_count) == (
            b.start_time, b.frame_dt, b.first_frame, b.frame_count)
        assert a.end_time() == b.end_time()
    end = ref.sim_len()
    for t in np.concatenate([np.linspace(-2e-12, end + 2e-12, 997), [0.0, end]]):
        got, want = ours.at(float(t)), ref.at(float(t))
        assert got[1:] == want[1:] and got[0].bytes == want[0].bytes, t
        assert ours.frame_index_at(float(t)) == ref.frame_index_at(float(t))
        assert ours.frame(float(t))[1] == ref.frame(float(t))[1]
    assert ours.last_frame().bytes == ref.last_frame().bytes
    assert ours.frame_at_index(3).bytes == ref.frame_at_index(3).bytes
    ours.clear()
    ref.clear()
    assert (ours.frame_count, ours.timeline_ram, ours.sim_len(), ours.at(0.0)) == (
        ref.frame_count, ref.timeline_ram, ref.sim_len(), ref.at(0.0))


def test_time_interval_matches_jax():
    for args in [(0.0, 5e-12, 0, 4), (1e-12, 0.0, 3, 1), (2e-12, 1e-13, 7, 10)]:
        a, b = timeline.TimeInterval(*args), jtimeline.TimeInterval(*args)
        assert a.end_time() == b.end_time()
        for t in np.linspace(-1e-12, 5e-12, 61):
            assert a.frame_at(float(t)) == b.frame_at(float(t))


# -- tools ---------------------------------------------------------------------

def tool_scene():
    """A 12x12 hex lattice at 2 r0 in the middle of the default box, plus two
    tombstones, in both codecs (random velocity directions, seeded)."""
    frame = Frame.new()
    meta = frame.metadata
    ParticleLattice((12, 12), distance_factor=2.0, velocity=(0.0, 50.0)).hex_square(
        frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(3))
    tomb = np.zeros(2, dtype=frame.particles.dtype)
    tomb["ty"] = -1
    frame.extend(tomb)
    return frame, JFrame.from_bytes(frame.bytes)


@pytest.mark.parametrize("angle", [None, 0.7])
@pytest.mark.parametrize("lattice", ["square", "hex"])
@pytest.mark.parametrize("tool", ["brush", "eraser", "speed", "clear"])
def test_apply_stroke_matches_jax(tool, lattice, angle):
    ours, ref = tool_scene()
    box = ours.metadata.box_width
    points = [(0.3 * box, 0.45 * box), (0.55 * box, 0.5 * box), (0.7 * box, 0.62 * box)]
    affected = 0
    for seed, pts, w in [(0, points, 0.06), (1, points[:1], 0.12), (2, [], 0.05)]:
        stroke = tools.Stroke(points=pts, width=w * box, height=0.5 * w * box)
        jstroke = jtools.Stroke(points=pts, width=w * box, height=0.5 * w * box)
        kw = dict(distance_factor=1.5, velocity=250.0, angle=angle, ty=1)
        options = tools.ToolOptions(tool=tools.Tool(tool), lattice=tools.LatticeKind(lattice), **kw)
        joptions = jtools.ToolOptions(tool=jtools.Tool(tool), lattice=jtools.LatticeKind(lattice),
                                      **kw)
        assert tools.lattice_resolution(ours, options) == jtools.lattice_resolution(ref, joptions)
        np.testing.assert_array_equal(tools.rasterize_stroke(ours, stroke, options),
                                      jtools.rasterize_stroke(ref, jstroke, joptions))
        n = tools.apply_stroke(ours, stroke, options, rng=np.random.default_rng(seed))
        jn = jtools.apply_stroke(ref, jstroke, joptions, rng=np.random.default_rng(seed))
        assert n == jn
        assert ours.bytes == ref.bytes, (tool, lattice, angle, seed)
        affected += n
    assert affected > 0


def test_tool_enums_and_exports_match_jax():
    for ours, ref in [(tools.Tool, jtools.Tool), (tools.LatticeKind, jtools.LatticeKind)]:
        assert [(e.name, e.value) for e in ours] == [(e.name, e.value) for e in ref]
    assert editor_pkg.__all__ == jeditor_pkg.__all__
    assert vars(tools.ToolOptions()).keys() == vars(jtools.ToolOptions()).keys()


def test_no_cursor_matches_jax():
    meta = default_metadata()
    meta["cursor_pos"] = (0.25, 0.75)
    meta["cursor_size"] = 0.1
    ours, ref = SimParams.from_record(meta).no_cursor(), JSimParams.from_record(meta).no_cursor()
    assert (ours.cursor_x, ours.cursor_y) == (ref.cursor_x, ref.cursor_y) == (-1.0, -1.0)
    assert SimParams._fields == JSimParams._fields
    for name in SimParams._fields:
        assert np.float64(getattr(ours, name)) == np.float64(getattr(ref, name)), name


# -- an Editor session through the files backend ----------------------------------

def write_stream(path, frames):
    w = JWriter.open_file(str(path))
    for f in frames:
        assert w.write(f)
    w.close()


def engine_stream():
    """Three engine frames (two dt intervals) for the editor to ingest: just
    past the two that interactive mode wants."""
    out = []
    for i in range(3):
        _, jf = frame_pair(dt=10e-15 if i < 2 else 20e-15, spf=100, n=30, seed=10 + i)
        out.append(jf)
    return out


def run_session(editor_cls, backend_cls, stroke_cls, options_cls, tool_cls, workdir):
    """A scripted session: ingest three frames, ride the live edge, edit params
    and the cursor, draw, resend, presets, loop; every write goes to the
    files backend's out file. Returns (out bytes, stats after each step)."""
    os.makedirs(workdir)
    write_stream(os.path.join(workdir, "in.bin"), engine_stream())
    e = editor_cls(backend_cls(tcp=False))
    e.backend.open_backend_files(os.path.join(workdir, "in.bin"),
                                 os.path.join(workdir, "out.bin"))
    deadline = time.monotonic() + 30
    while e.backend._reader._alive and time.monotonic() < deadline:
        time.sleep(0.005)  # the reader thread has queued the whole file
    seen = []

    def step(wall_dt=0.05):
        e.tick(wall_dt)
        st = e.stats()
        st["connection"] = st["connection"].replace(str(workdir), "<dir>")
        seen.append(st)

    for _ in range(3):
        step()
    e.sim_params["step_dt"] = 5e-15
    step()
    step()  # unchanged params: nothing sent
    e.cursor_move(0.3, 0.6, True)
    step()
    e.cursor_move(0.3, 0.6, False)
    step()
    e.seek_frames(-2)
    step()
    e.seek_live()
    step()
    e.send_lattice(6, 5, distance_factor=1.3, velocity=(10.0, 40.0), hex_grid=False, ty=1,
                   rng=np.random.default_rng(5))
    step()
    box = float(e.sim_params["box_width"])
    e.apply_tool(stroke_cls(points=[(0.4 * box, 0.4 * box), (0.6 * box, 0.45 * box)],
                            width=0.05 * box, height=0.05 * box),
                 options_cls(tool=tool_cls("brush"), velocity=80.0),
                 rng=np.random.default_rng(6))
    step()
    e.save_preset("drawn")
    e.resend_current()
    step()
    e.duplicate_preset(0)
    e.rename_preset(1, "copy")
    e.next_send_and_clear = True
    e.send_preset(1)
    step()
    e.toggle_loop()
    e.sim_params["steps_per_frame"] = 3
    step(0.5)
    e.toggle_loop()
    e.toggle_play()
    step(0.5)
    e.toggle_play()
    e.begin_editing_empty()
    e.resend_current()  # an empty edit ships one tombstone
    step()
    e.clear_scene()
    e.clear_timeline()
    step()
    e.backend.close()
    return (Path(workdir) / "out.bin").read_bytes(), seen


def test_editor_session_writes_the_jax_wire_bytes(tmp_path):
    ours, ours_stats = run_session(Editor, Backend, tools.Stroke, tools.ToolOptions, tools.Tool,
                                   tmp_path / "port")
    ref, ref_stats = run_session(JEditor, JBackend, jtools.Stroke, jtools.ToolOptions,
                                 jtools.Tool, tmp_path / "jax")
    assert len(ours) > 0 and ours == ref
    assert ours_stats == [as_port(st) for st in ref_stats]
    assert any(st["interactive"] for st in ours_stats)


# -- the headless CLI ----------------------------------------------------------------

def replay_stream(path):
    frames = []
    for i, (dt, n) in enumerate([(10e-15, 40), (10e-15, 40), (20e-15, 55), (20e-15, 0)]):
        _, jf = frame_pair(dt=dt, spf=50, n=n, seed=20 + i)
        frames.append(jf)
    write_stream(path, frames)


def test_replay_render_matches_jax(tmp_path, capsys):
    stream = tmp_path / "stream.bin"
    replay_stream(stream)
    assert headless.main(["--replay", str(stream), "--render", str(tmp_path / "port"),
                          "--size", "40"]) == 0
    ours = capsys.readouterr()
    assert jheadless.main(["--replay", str(stream), "--render", str(tmp_path / "jax"),
                           "--size", "40"]) == 0
    ref = capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    import json

    assert json.loads(ours.out) == as_port(json.loads(ref.out))
    assert f"editor: {FOREIGN_MODULES_TAG}" in ours.err


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_port_headless_against_the_jax_daemon(monkeypatch):
    """The port's headless editor sends the JAX editor's scene, byte for
    byte, to the JAX daemon and collects its frames."""
    received = []
    connect = jdaemon.Frontend.connect_tcp

    class Capture(jdaemon.Frontend):
        def read(self):
            frame = super().read()
            if frame is not None:
                received.append(frame.bytes)
            return frame

    def connect_capture(addr, retry_s=0.0, native=False):
        inner = connect(addr, retry_s=retry_s, native=native)
        return Capture(inner.reader, inner.writer, verbose=False)

    monkeypatch.setattr(jdaemon.Frontend, "connect_tcp", staticmethod(connect_capture))
    port = _free_port()
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu_torch.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--lattice", "10x10", "--frames", "4",
         "--steps-per-frame", "5", "--timeout", "120"],
        cwd=REPO, env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        n = jdaemon.serve(("127.0.0.1", port), JGridConfig(4, 4, 8), max_frames=4,
                          retry_s=60.0)
        out, err = editor.communicate(timeout=120)
    finally:
        if editor.poll() is None:
            editor.kill()
            editor.wait()
    assert editor.returncode == 0, err[-2000:]
    assert n == 4
    import json

    stats = json.loads(out.strip().splitlines()[-1])
    ref_editor = JEditor(JBackend(tcp=False))
    ref_editor.sim_params["steps_per_frame"] = 5
    ref_editor.send_lattice(10, 10, distance_factor=1.1, velocity=(0.0, 0.0),
                            rng=np.random.default_rng(0))
    assert received[0] == ref_editor.backend.read().bytes
    assert set(stats) == set(ref_editor.stats())
    assert stats["frame_count"] >= 4 and stats["particle_count"] == 100
    assert f"editor: {FOREIGN_MODULES_TAG}[]" in err


def foreign_report(text: str, who: str) -> list:
    import json

    tag = f"{who}: {FOREIGN_MODULES_TAG}"
    found = [json.loads(ln[len(tag):]) for ln in text.splitlines() if ln.startswith(tag)]
    assert len(found) == 1, text[-2000:]
    return found[0]


def test_port_runs_in_a_tree_without_the_jax_package(tmp_path):
    """The port's headless editor against the port's daemon on the CPU, in a
    copy of the port alone: both succeed and import nothing of jax or of the
    JAX package."""
    shutil.copytree(REPO / "particle_simulator_tpu_torch", tmp_path / "particle_simulator_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = child_env()
    probe = subprocess.run([sys.executable, "-c", "import particle_simulator_tpu"],
                           cwd=tmp_path, env=env, capture_output=True, text=True)
    assert probe.returncode != 0 and "No module named" in probe.stderr
    port = _free_port()
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu_torch.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--lattice", "10x10", "--frames", "3",
         "--steps-per-frame", "2", "--timeout", "120"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        engine = subprocess.run(
            [sys.executable, "-m", "particle_simulator_tpu_torch.engine.daemon",
             "--addr", f"127.0.0.1:{port}", "--torch-device", "cpu", "--max-frames", "4",
             "--retry-s", "60"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
        out, err = editor.communicate(timeout=120)
    finally:
        if editor.poll() is None:
            editor.kill()
            editor.wait()
    assert engine.returncode == 0, engine.stderr[-2000:]
    assert editor.returncode == 0, err[-2000:]
    import json

    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["frame_count"] >= 3 and stats["particle_count"] == 100
    assert foreign_report(err, "editor") == []
    assert foreign_report(engine.stderr, "engine") == []
