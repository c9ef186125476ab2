"""The port's web editor (``particle_simulator_tpu_torch/editor/webview.py``)
against the JAX package's: the same HTTP calls on both, the same answers.

Both servers run in this process, each with its engine port unconnected (the
loopback backend) and its own presets directory; unseeded generators are
seeded alike (``np.random.default_rng``), so every answer is bytes to
compare. What may differ is named here and nowhere else:
- ``PAGE_RENAMES``: the page names device 0 ``GPU`` in the port, ``TPU`` in
  the JAX package (the two wire codecs' display names, ``DEVICE_NAMES``);
- ``CLOCK_FIELDS``: the ``/stats`` fields and ``/frame.bin`` header fields
  that follow the wall clock through the playhead;
- ``ADDRESS_FIELDS``: the ``/stats`` fields that name the server's own port.
"""

import json
import os
import re
import signal
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from particle_simulator_tpu.editor import webview as jwebview

from particle_simulator_tpu_torch.editor import webview
from particle_simulator_tpu_torch.utils.log import FOREIGN_MODULES_TAG

REPO = Path(__file__).resolve().parent.parent

PAGE_RENAMES = [("<h3>particle simulator (TPU)</h3>", "<h3>particle simulator (GPU)</h3>"),
                ('<option value="0" selected>TPU</option>', '<option value="0" selected>GPU</option>')]
DEVICE_NAMES = {"TPU": "GPU"}
CLOCK_FIELDS = ("time", "frame_time", "frame_index", "interactive")
ADDRESS_FIELDS = ("tcp_server",)
FRAME_BIN_FIELDS = ("magic", "count", "frame_time", "play_time", "play_speed", "box_w",
                    "box_h", "vscale", "sigma0", "flags")


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read()


def post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def start(module, presets_dir):
    web = module.WebEditor(backend_addr=("127.0.0.1", 0), size=48, presets_dir=presets_dir)
    server = module.make_server(("127.0.0.1", 0), web)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return web, server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture
def pair(monkeypatch, tmp_path):
    """(port web, port base, JAX web, JAX base), unseeded generators seeded 0."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(0 if seed is None else seed))
    ours = start(webview, str(tmp_path / "port_presets"))
    ref = start(jwebview, str(tmp_path / "jax_presets"))
    yield ours[0], ours[2], ref[0], ref[2]
    for web, server, _ in (ours, ref):
        server.shutdown()
        server.server_close()
        web.close()


def stats_view(raw: bytes, jax: bool) -> dict:
    st = json.loads(raw)
    for k in CLOCK_FIELDS:
        st.pop(k)
    for k in ADDRESS_FIELDS:
        st[k] = re.sub(r":\d+$", ":<port>", st[k])
    if jax and st["device"] in DEVICE_NAMES:
        st["device"] = DEVICE_NAMES[st["device"]]
    return st


def frame_bin_view(raw: bytes):
    header = dict(zip(FRAME_BIN_FIELDS, struct.unpack_from("<IIfffffffI", raw)))
    for k in CLOCK_FIELDS:
        header.pop(k, None)
    return header, raw[40:]


def settle(web, frames: int):
    """Wait until the tick thread has drained the loopback into ``frames``
    timeline frames."""
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        with web.lock:
            if web.editor.timeline.frame_count == frames and not web.editor.backend._loopback:
                return
        time.sleep(0.01)
    raise TimeoutError(f"the timeline never held {frames} frames")


def same_gets(ours, base, ref, jbase):
    assert stats_view(get(base, "/stats"), False) == stats_view(get(jbase, "/stats"), True)
    assert get(base, "/presets") == get(jbase, "/presets")
    assert frame_bin_view(get(base, "/frame.bin")) == frame_bin_view(get(jbase, "/frame.bin"))
    assert get(base, "/frame.png") == get(jbase, "/frame.png")
    names = sorted(os.listdir(ours.presets_dir)) if os.path.isdir(ours.presets_dir) else []
    ref_names = sorted(os.listdir(ref.presets_dir)) if os.path.isdir(ref.presets_dir) else []
    assert names == ref_names
    for name in names:
        assert (Path(ours.presets_dir) / name).read_bytes() == \
            (Path(ref.presets_dir) / name).read_bytes()


# (path, body, timeline frames after it)
SESSION = [
    ("/params", {"box_width": 3e-8, "box_height": 2.5e-8, "step_dt": 2e-15,
                 "steps_per_frame": 7, "sigma0": 3.5e-10, "n1": 13.0, "data_structure": 1,
                 "device": 0, "gpu_threads_per_block_log2": 6, "cursor_size": 0.08}, 0),
    ("/control", {"action": "lattice", "nx": 12, "ny": 9, "distance_factor": 1.4,
                  "vmin": 5.0, "vmax": 30.0, "hex": False, "ty": 1}, 1),
    ("/cursor", {"x": 0.25, "y": 0.75, "down": True}, 1),
    ("/tool", {"tool": "brush", "points": [[0.2, 0.2], [0.4, 0.3]], "width_cells": 3,
               "height_cells": 2, "lattice": "hex", "velocity": 120.0, "angle": None,
               "ty": 0, "distance_factor": 1.2}, 1),
    ("/tool", {"tool": "eraser", "points": [[0.5, 0.5]], "width_cells": 4,
               "height_cells": 4, "lattice": "square"}, 1),
    ("/tool", {"tool": "speed", "points": [[0.45, 0.5], [0.55, 0.5]], "velocity": 300.0,
               "angle": 1.0, "width_cells": 6, "height_cells": 6}, 1),
    ("/tool", {"tool": "bogus"}, 1),
    ("/tool", {"tool": "brush", "lattice": "triangle"}, 1),
    ("/control", {"action": "preset_save", "name": "drawn"}, 1),
    ("/control", {"action": "preset_duplicate", "index": 0}, 1),
    ("/control", {"action": "preset_rename", "index": 1, "name": "second"}, 1),
    ("/control", {"action": "toggle_play"}, 1),
    ("/control", {"action": "edit_resend"}, 2),
    ("/control", {"action": "seek_frac", "value": 1.0}, 2),
    ("/control", {"action": "preset_edit", "index": 1}, 2),
    ("/tool", {"tool": "brush", "points": [[0.7, 0.7]], "width_cells": 5, "height_cells": 5,
               "velocity": 10.0}, 2),
    ("/control", {"action": "preset_update", "name": "edited"}, 2),
    ("/control", {"action": "preset_delete", "index": 0}, 2),
    ("/control", {"action": "preset_send", "index": 0}, 3),
    ("/control", {"action": "seek_frames", "delta": -1}, 3),
    ("/selftest", {"total": 9, "failed": 1, "failures": ["fmtNum 1e21"]}, 3),
    ("/control", {"action": "toggle_loop"}, 3),
    ("/control", {"action": "toggle_send_clear"}, 3),
    ("/control", {"action": "speed", "value": 2e-12}, 3),
    ("/control", {"action": "edit_begin_empty"}, 3),
    ("/control", {"action": "edit_cancel"}, 3),
    ("/control", {"action": "clear"}, 4),
    ("/control", {"action": "seek_live"}, 4),
    ("/control", {"action": "connect_files", "in": "/nonexistent/in.bin",
                  "out": "/nonexistent/out.bin"}, 4),
    ("/control", {"action": "clear_timeline"}, 0),
    ("/control", {"action": "disconnect"}, 0),
]


def test_http_session_matches_jax(pair):
    ours, base, ref, jbase = pair
    same_gets(ours, base, ref, jbase)
    for path, body, frames in SESSION:
        assert post(base, path, body) == post(jbase, path, body), (path, body)
        settle(ours, frames)
        settle(ref, frames)
        same_gets(ours, base, ref, jbase)
    assert [p.name for p in ours.editor.presets] == ["edited"]


def test_page_matches_jax_but_for_the_device_name(pair):
    _, base, _, jbase = pair
    page, ref = get(base, "/").decode(), get(jbase, "/").decode()
    for jax_text, port_text in PAGE_RENAMES:
        assert ref.count(jax_text) == 1 and port_text not in ref
        ref = ref.replace(jax_text, port_text)
    assert page == ref
    assert page == webview.render_page()


def test_selftest_vectors_and_helpers_match_jax():
    assert webview.selftest_vectors() == jwebview.selftest_vectors()
    for args in [(0.0, 1.5e-12, 1e-11, 2, 0.0, 500.0), (1e-12, 2e-12, 5e-12, 3, 10.0, 20.0),
                 (0.0, 0.0, 1.0, 0, 0.0, 1e4)]:
        assert webview.extrap_dt_spec(*args) == jwebview.extrap_dt_spec(*args)
    img = np.random.default_rng(4).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    assert webview._png_bytes(img) == jwebview._png_bytes(img)
    assert (webview._BIN_MAGIC, webview._BIN_HEADER.format) == (
        jwebview._BIN_MAGIC, jwebview._BIN_HEADER.format)


def help_flags(main) -> list:
    """The option strings of a CLI's ``--help``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return sorted(set(re.findall(r"(?<![\w-])(--[a-z][a-z-]*)", out.getvalue())))


def test_clis_take_the_jax_flags():
    from particle_simulator_tpu.editor import headless as jheadless
    from particle_simulator_tpu_torch.editor import headless

    assert help_flags(webview.main) == help_flags(jwebview.main)
    assert help_flags(headless.main) == help_flags(jheadless.main)
    assert "--presets-dir" in help_flags(webview.main)
    assert "--replay" in help_flags(headless.main)


def test_presets_dir_is_the_only_place_written(tmp_path):
    """``--presets-dir`` saves there and nowhere else; a second editor on
    the same directory loads what the first one saved."""
    d = tmp_path / "presets"
    before = set(os.listdir(tmp_path))
    web = webview.WebEditor(backend_addr=("127.0.0.1", 0), size=32, presets_dir=str(d))
    try:
        with web.lock:
            web.editor.send_lattice(4, 3)
        settle(web, 1)
        web.control({"action": "preset_save", "name": "kept"})
        web.control({"action": "preset_save", "name": "dropped"})
        web.control({"action": "preset_delete", "index": 1})
    finally:
        web.close()
    assert set(os.listdir(tmp_path)) - before == {"presets"}
    web2 = webview.WebEditor(backend_addr=("127.0.0.1", 0), size=32, presets_dir=str(d))
    try:
        assert [(p.name, len(p.particles)) for p in web2.editor.presets] == [("kept", 12)]
    finally:
        web2.close()


def test_brush_stroke_reaches_the_port_daemon_on_the_cpu():
    """A brush stroke drawn through the port's HTTP surface spawns particles
    that the port's daemon (the plain versions on the CPU) loads as a scene
    reset and streams back."""
    from particle_simulator_tpu_torch.engine.daemon import serve
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    web = webview.WebEditor(backend_addr=("127.0.0.1", 0), size=32)
    server = webview.make_server(("127.0.0.1", 0), web)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    port = web.editor.backend._server.addr[1]
    shipped = []
    engine = threading.Thread(
        target=lambda: shipped.append(serve(("127.0.0.1", port),
                                            Simulator(GridConfig(4, 4, 8), device="cpu"),
                                            retry_s=10.0)),
        daemon=True)
    try:
        post(base, "/params", {"steps_per_frame": 2})
        engine.start()
        out = json.loads(post(base, "/tool", {
            "tool": "brush", "points": [[0.3, 0.5], [0.7, 0.5]], "width_cells": 4,
            "height_cells": 4, "lattice": "hex", "velocity": 100.0, "angle": None, "ty": 0,
            "distance_factor": 4.0,  # sparse: nothing drops on a 16x16x8 grid
        }))
        assert out["affected"] > 0 and web.editor.editing
        spawned = out["count"]
        post(base, "/control", {"action": "edit_resend"})
        deadline = time.monotonic() + 120
        stats = {}
        while time.monotonic() < deadline:
            stats = json.loads(get(base, "/stats"))
            if stats["particle_count"] == spawned and stats["frame_count"] > 3:
                break
            time.sleep(0.05)
        assert stats["particle_count"] == spawned and stats["frame_count"] > 3, stats
        assert stats["device"] == "CPU Thread Pool" and stats["reader_connected"]
    finally:
        post(base, "/control", {"action": "disconnect"})
        engine.join(timeout=60)
        server.shutdown()
        server.server_close()
        web.close()
    assert not engine.is_alive() and shipped and shipped[0] > 2


def test_main_stops_on_sigterm_and_names_no_foreign_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu_torch.editor.webview",
         "--http", "127.0.0.1:0", "--addr", "127.0.0.1:0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        line = ""
        while "editor UI: http" not in line and time.monotonic() < deadline:
            line = proc.stderr.readline()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert f"editor UI: {FOREIGN_MODULES_TAG}[]" in err.splitlines()
