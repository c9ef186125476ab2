"""The port's serving slice against the JAX package: Simulator frames on
both data structures, the daemon over TCP against the unchanged headless
editor, the readback pipeline's wire stream, the device requests and live
switches, and the rule that the port imports neither jax nor the JAX
package. Frames and scenes travel through the port's own codec
(``particle_simulator_tpu_torch.io``); the JAX engine reads the same bytes.

Envelope for frames after physics steps (tests/test_pallas.py's frame
envelope): ``ty`` equal, x/y within 16 fixed-point units, vx/vy within
rtol 1e-3, atol 0.05. Echoed scenes and metadata are byte-identical.
"""

import os
import pkgutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from particle_simulator_tpu.engine.simulator import Simulator as JSimulator
from particle_simulator_tpu_torch.io.frame import DataStructure, Device, Frame
from particle_simulator_tpu_torch.io.presets import ParticleLattice
from particle_simulator_tpu_torch.io.transport import new_tcp_server
from particle_simulator_tpu.physics.bucket import GridConfig as JGridConfig
import particle_simulator_tpu_torch
from particle_simulator_tpu_torch.engine import daemon
from particle_simulator_tpu_torch.engine.daemon import Frontend, main_loop, serve
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.physics.bucket import GridConfig
from particle_simulator_tpu_torch.scenes.library import _scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = 96  # wire header bytes (metadata included)


def assert_frame_envelope(got: Frame, ref: Frame):
    assert got.bytes[:HEADER] == ref.bytes[:HEADER]  # count + metadata
    g, r = got.particles, ref.particles
    np.testing.assert_array_equal(g["ty"], r["ty"])
    for name in ("x", "y"):
        np.testing.assert_allclose(g[name].astype(np.int64), r[name].astype(np.int64),
                                   rtol=0, atol=16, err_msg=name)
    for name in ("vx", "vy"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-3, atol=0.05, err_msg=name)


def test_slice_matches_jax_simulator():
    frame = _scene(12, 12, distance_factor=1.1, speed=20.0, box_fill=0.5, steps_per_frame=20)
    jsim = JSimulator()
    jsim.load_frame(frame)
    sim = Simulator(device="cpu")
    sim.load_frame(frame)
    assert tuple(sim.grid) == tuple(jsim.grid)
    assert sim.read_frame().bytes == jsim.read_frame().bytes  # the scene echo
    for _ in range(2):
        jsim.frame_async()
        sim.frame_async()
        got, ref = sim.read_frame(), jsim.read_frame()
        assert sim.live_count == jsim.live_count == frame.particle_count
        assert_frame_envelope(got, ref)
    assert sim.active_kernel == "bucket-torch-cpu"
    assert got.metadata.device == Device.CPU_THREAD_POOL


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sorted_records(parts: np.ndarray) -> bytes:
    order = np.lexsort((parts["x"], parts["y"]))
    return parts[order].tobytes()


def test_daemon_serves_headless_editor_and_echoes_scene(monkeypatch):
    """``serve`` against the unchanged editor CLI: 5 frames reach it, and
    the first frame shipped is the scene it sent, byte for byte (records in
    bucket order, the device field echoing the CPU fallback), identical to
    the JAX engine's echo of the same scene."""
    received, shipped = [], []
    connect = Frontend.connect_tcp

    class Capture(Frontend):
        def read(self):
            frame = super().read()
            if frame is not None:
                received.append(frame.copy())
            return frame

        def write(self, frame):
            shipped.append(frame.bytes)
            super().write(frame)

    def connect_capture(addr, retry_s=0.0, native=False):
        inner = connect(addr, retry_s=retry_s, native=native)
        return Capture(inner.reader, inner.writer, verbose=False)

    monkeypatch.setattr(daemon.Frontend, "connect_tcp", staticmethod(connect_capture))
    port = _free_port()
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--lattice", "10x10", "--frames", "5",
         "--steps-per-frame", "5", "--timeout", "120"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        n = serve(("127.0.0.1", port), Simulator(GridConfig(4, 4, 8), device="cpu"),
                  max_frames=5, retry_s=60.0)
        out, err = editor.communicate(timeout=120)
    finally:
        if editor.poll() is None:
            editor.kill()
            editor.wait()
    assert editor.returncode == 0, err[-2000:]
    assert n == 5 and len(shipped) == 5
    scene = received[0]
    assert scene.particle_count == 100

    echo = Frame.from_bytes(shipped[0])
    assert _sorted_records(echo.particles) == _sorted_records(scene.particles)
    expect = scene.metadata.copy()
    expect["device"] = Device.CPU_THREAD_POOL
    assert echo.metadata.copy().tobytes() == expect.tobytes()
    jsim = JSimulator(JGridConfig(4, 4, 8))
    jsim.load_frame(scene)
    assert shipped[0] == jsim.read_frame().bytes
    for raw in shipped[1:]:
        f = Frame.from_bytes(raw)
        assert f.particle_count == 100 and np.isfinite(f.particles["vx"]).all()


def _lattice_frame(n=8, steps=5):
    """Sparse lattice (spacing 4 r0): no bucket overflows on 16x16x8."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((n, n), distance_factor=4.0, velocity=(0.0, 10.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(0))
    meta.steps_per_frame = steps
    return frame


def _accept(server, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        conn = server.try_accept()
        if conn:
            return conn
        time.sleep(0.005)
    raise TimeoutError("engine never connected")


def _read_until(reader, pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        f = reader.read()
        if f is None:
            time.sleep(0.002)
        elif pred(f):
            return f
    raise TimeoutError("condition never met on the wire")


def test_metadata_frame_reconfigures_live_and_scene_frame_resets():
    server = new_tcp_server(("127.0.0.1", 0))
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    t = threading.Thread(
        target=serve, args=(("127.0.0.1", server.addr[1]), sim),
        kwargs=dict(retry_s=10.0), daemon=True,
    )
    t.start()
    reader, writer = _accept(server)
    try:
        scene = _lattice_frame()
        assert writer.write(scene)
        first = _read_until(reader, lambda f: True)
        assert first.particle_count == scene.particle_count

        update = Frame.new()
        update.header["metadata"] = scene.metadata.copy()
        update.metadata.step_dt = 1e-15
        update.metadata.cursor_pos = (0.5, 0.5)
        assert update.particle_count == 0
        assert writer.write(update)
        later = _read_until(reader, lambda f: abs(f.metadata.step_dt - 1e-15) < 1e-20)
        assert later.particle_count == scene.particle_count  # no reset
        assert tuple(later.metadata.cursor_pos) == pytest.approx((0.5, 0.5))

        bigger = _lattice_frame(n=10)
        assert writer.write(bigger)
        echo = _read_until(reader, lambda f: f.particle_count == bigger.particle_count)
        assert _sorted_records(echo.particles) == _sorted_records(bigger.particles)
        nxt = _read_until(reader, lambda f: True)
        assert nxt.particle_count == bigger.particle_count
        assert not np.array_equal(np.sort(nxt.particles["y"]), np.sort(echo.particles["y"]))
    finally:
        reader.close()
        writer.close()
        server.close()
    t.join(timeout=60)
    assert not t.is_alive(), "daemon did not exit after the editor closed"


def _scripted_stream(ship_thread: bool, depth: int) -> list[bytes]:
    """main_loop over a deterministic frontend that injects a live metadata
    edit (poll 2) and a scene reset (poll 4); returns the wire stream."""

    class ScriptedFrontend:
        is_connected = True

        def __init__(self):
            self.polls = 0
            self.sent = []

        def read(self):
            self.polls += 1
            if self.polls == 2:
                edit = Frame.new()
                edit.metadata.steps_per_frame = 7
                return edit
            if self.polls == 4:
                return _lattice_frame(n=5, steps=3)
            return None

        def write(self, frame):
            self.sent.append(frame.bytes)

    frontend = ScriptedFrontend()
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(_lattice_frame(n=6, steps=2))
    shipped = main_loop(frontend, sim, max_frames=8, readback_depth=depth,
                        ship_thread=ship_thread)
    assert shipped == 8 and len(frontend.sent) == 8
    return frontend.sent


def test_readback_depth_and_ship_thread_ship_identical_streams():
    streams = {(ship, depth): _scripted_stream(ship, depth)
               for ship in (False, True) for depth in (0, 1)}
    ref = streams[(False, 0)]
    for key, stream in streams.items():
        assert stream == ref, f"ship_thread/depth {key} changed the wire stream"
    counts = [Frame.from_bytes(b).particle_count for b in ref]
    assert len(set(counts)) == 2  # the reset really landed mid-stream


def _with(frame: Frame, **fields) -> Frame:
    frame = frame.copy()
    for name, value in fields.items():
        setattr(frame.metadata, name, value)
    return frame


def _metadata_only(scene: Frame, **fields) -> Frame:
    edit = Frame.new()
    edit.header["metadata"] = scene.metadata.copy()
    for name, value in fields.items():
        setattr(edit.metadata, name, value)
    assert edit.particle_count == 0
    return edit


def _live_data_structure_switch(scene, sim, n):
    """MatrixBuckets -> CompactArray -> back, live, with no particle lost
    (tests/test_daemon.py:test_metadata_only_frame_switches_data_structure_live)."""
    for ds, kernel in ((DataStructure.COMPACT_ARRAY, "allpairs-torch-cpu"),
                       (DataStructure.MATRIX_BUCKETS, "bucket-torch-cpu")):
        sim.update_metadata(_metadata_only(scene, data_structure=ds))
        assert sim.data_structure == ds
        assert sim.live_count == n
        for _ in range(2):
            sim.frame_async()
        assert sim.active_kernel == kernel and sim.live_count == n
        out = sim.read_frame()
        assert out.metadata.data_structure == ds
        assert out.particle_count == n and np.isfinite(out.particles["vx"]).all()
    assert sim.state.x.dim() == 3


def _live_device_switch(scene, sim, n):
    """A device change re-lays the running scene out on the new device;
    the wire echoes the device in effect
    (tests/test_daemon.py:test_metadata_only_frame_switches_device_live)."""
    assert sim.active_device == Device.CPU_THREAD_POOL
    sim.update_metadata(_metadata_only(scene, device=Device.CPU_MAIN_THREAD))
    assert sim.active_device == Device.CPU_MAIN_THREAD and sim.live_count == n
    sim.frame_async()
    out = sim.read_frame()
    assert out.metadata.device == Device.CPU_MAIN_THREAD and out.particle_count == n
    # a GPU request on a Simulator without a card runs on the CPU pool
    sim.update_metadata(_metadata_only(scene, device=Device.GPU))
    assert sim.active_device == Device.CPU_THREAD_POOL and sim.live_count == n
    assert sim.read_frame().metadata.device == Device.CPU_THREAD_POOL


def _garbage_enums_ignored(scene, sim, n):
    """Out-of-range enum bytes keep the running values; the params still
    apply (tests/test_daemon.py:test_metadata_only_frame_with_garbage_enums_is_ignored)."""
    edit = _metadata_only(scene)
    edit.header["metadata"]["device"] = 7
    edit.header["metadata"]["data_structure"] = 9
    edit.header["metadata"]["steps_per_frame"] = 3
    sim.update_metadata(edit)
    assert sim.data_structure == DataStructure.MATRIX_BUCKETS
    assert sim.active_device == Device.CPU_THREAD_POOL
    assert int(sim.meta_record["steps_per_frame"]) == 3
    assert int(sim.meta_record["device"]) == Device.CPU_THREAD_POOL
    sim.frame_async()
    assert sim.live_count == n


@pytest.mark.parametrize("case", [_live_data_structure_switch, _live_device_switch,
                                  _garbage_enums_ignored], ids=lambda f: f.__name__[1:])
def test_live_switches(case):
    scene = _lattice_frame(n=8, steps=2)
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(scene)
    for _ in range(2):
        sim.frame_async()
    case(scene, sim, scene.particle_count)


@pytest.mark.parametrize("ds", list(DataStructure))
@pytest.mark.parametrize("dev", list(Device))
def test_requests_echo_like_jax(ds, dev):
    """Every (data structure, device) request: the echoed scene is the JAX
    engine's, byte for byte, on a host without an accelerator."""
    scene = _with(_lattice_frame(n=6, steps=2), data_structure=ds, device=dev)
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    sim.load_frame(scene)
    jsim = JSimulator(JGridConfig(4, 4, 8))
    jsim.load_frame(scene)
    assert (sim.data_structure, sim.active_device) == (jsim.data_structure, jsim.active_device)
    assert sim.read_frame().bytes == jsim.read_frame().bytes
    assert sim.state.x.device.type == "cpu"
    assert sim.state.x.dim() == (1 if ds == DataStructure.COMPACT_ARRAY else 3)


def test_compact_slice_matches_jax_simulator():
    """CompactArray frames on the CPU against the JAX engine's: the echo
    byte for byte (live first, in slot order, 1024 slots), then two
    20-step frames within the frame envelope."""
    frame = _with(_scene(10, 10, distance_factor=1.1, speed=20.0, box_fill=0.5,
                         steps_per_frame=20), data_structure=DataStructure.COMPACT_ARRAY)
    jsim = JSimulator()
    jsim.load_frame(frame)
    sim = Simulator(device="cpu")
    sim.load_frame(frame)
    assert sim.state.x.shape == (1024,) == jsim.state.x.shape
    assert sim.read_frame().bytes == jsim.read_frame().bytes
    for _ in range(2):
        jsim.frame_async()
        sim.frame_async()
        assert_frame_envelope(sim.read_frame(), jsim.read_frame())
    assert sim.active_kernel == "allpairs-torch-cpu"
    assert sim.live_count == frame.particle_count


def test_daemon_scene_reset_switches_data_structure():
    """A scene reset switches MatrixBuckets -> CompactArray mid-run
    (tests/test_daemon.py:test_daemon_data_structure_switch_mid_run), over
    the port's own transport."""
    server = new_tcp_server(("127.0.0.1", 0))
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    t = threading.Thread(
        target=serve, args=(("127.0.0.1", server.addr[1]), sim),
        kwargs=dict(retry_s=10.0), daemon=True,
    )
    t.start()
    reader, writer = _accept(server)
    try:
        scene = _lattice_frame(n=8, steps=2)
        assert writer.write(scene)
        first = _read_until(reader, lambda f: True)
        assert first.metadata.data_structure == DataStructure.MATRIX_BUCKETS
        compact = _with(_lattice_frame(n=6, steps=2), data_structure=DataStructure.COMPACT_ARRAY)
        assert writer.write(compact)
        echo = _read_until(reader, lambda f: f.particle_count == compact.particle_count)
        assert echo.metadata.data_structure == DataStructure.COMPACT_ARRAY
        assert echo.particles.tobytes() == compact.particles.tobytes()  # slot order
        nxt = _read_until(reader, lambda f: True)
        assert nxt.metadata.data_structure == DataStructure.COMPACT_ARRAY
        assert nxt.particle_count == compact.particle_count
        assert np.isfinite(nxt.particles["vx"]).all()
    finally:
        reader.close()
        writer.close()
        server.close()
    t.join(timeout=60)
    assert not t.is_alive(), "daemon did not exit after the editor closed"
    assert sim.active_kernel == "allpairs-torch-cpu"


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert Simulator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulator()
    with pytest.raises(ValueError):
        Simulator(device="meta")


def test_port_never_imports_jax():
    pkg_dir = os.path.dirname(particle_simulator_tpu_torch.__file__)
    modules = ["particle_simulator_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([pkg_dir], "particle_simulator_tpu_torch.")
    ]
    assert "particle_simulator_tpu_torch.engine.daemon" in modules
    assert "particle_simulator_tpu_torch.ops.bucket_cuda" in modules
    assert {"particle_simulator_tpu_torch.bench", "particle_simulator_tpu_torch.entry"} <= set(
        modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "ref = sorted(k for k in sys.modules if k == 'particle_simulator_tpu'\n"
        "             or k.startswith('particle_simulator_tpu.'))\n"
        "assert not ref, ref\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
