"""The port's span recorder (``utils/profiling.py``) and the spans of the
daemon and the Simulator: off, ``annotate`` reads no clock and opens no
range; on, it keeps each span's parent, thread and frame id on the Unix-ns
clock of the profiler's own events, in a bounded buffer that counts what it
drops; a CPU ``main_loop`` gives every shipped frame one span of each stage
under one frame id; ``engine.daemon --spans`` writes them as JSON."""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from particle_simulator_tpu_torch.engine import daemon
from particle_simulator_tpu_torch.engine.daemon import main_loop
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.io.frame import Frame
from particle_simulator_tpu_torch.io.presets import ParticleLattice
from particle_simulator_tpu_torch.io.transport import Writer
from particle_simulator_tpu_torch.physics.bucket import GridConfig
from particle_simulator_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the module's place."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _spans(export: dict) -> list[dict]:
    keys = ("name", "start", "end", "thread", "frame", "parent")
    return [dict(zip(keys, s)) for s in export["spans"]]


def test_annotate_off_reads_no_clock_and_opens_no_range(recorder, monkeypatch):
    class NoClock:
        def time_ns(self):
            raise AssertionError("annotate read the clock while recording was off")

    def boom(*a, **k):
        raise AssertionError("annotate opened a range while recording was off")

    monkeypatch.setattr(profiling, "time", NoClock())
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    assert recorder.depth == 0
    # one shared context: nothing is allocated per call
    assert profiling.annotate("a") is profiling.annotate("b", frame=3)
    with profiling.annotate("outer", frame=1):
        with profiling.annotate("inner"):
            profiling.count("c")
    assert profiling.export() == {"clock": "unix_ns", "spans": [], "counters": {},
                                  "dropped": 0}


def test_recording_keeps_parent_thread_frame_and_drops(recorder, monkeypatch):
    with profiling.recording():
        with profiling.recording():  # blocks nest
            with profiling.annotate("outer", frame=7):
                with profiling.annotate("inner"):  # takes its parent's frame
                    pass
                with profiling.annotate("other", frame=8):
                    pass
        assert recorder.depth == 1

        def worker():
            with profiling.annotate("work", frame=9):
                profiling.count("c", 2)

        t = threading.Thread(target=worker, name="ship-tx")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        profiling.count("c")
        with pytest.raises(ZeroDivisionError):
            with profiling.annotate("boom"):
                1 / 0
    assert recorder.depth == 0
    with profiling.annotate("after"):  # off again: not kept
        pass
    out = profiling.export()
    spans = {s["name"]: s for s in _spans(out)}
    assert list(spans) == ["inner", "other", "outer", "work", "boom"]  # in end order
    assert spans["outer"]["parent"] is None and spans["outer"]["frame"] == 7
    assert spans["inner"]["parent"] == "outer" and spans["inner"]["frame"] == 7
    assert spans["other"]["parent"] == "outer" and spans["other"]["frame"] == 8
    assert spans["work"]["thread"] == "ship-tx" and spans["work"]["parent"] is None
    assert spans["outer"]["thread"] == threading.current_thread().name
    assert spans["outer"]["start"] <= spans["inner"]["start"] <= spans["inner"]["end"] \
        <= spans["other"]["start"] <= spans["other"]["end"] <= spans["outer"]["end"]
    assert spans["boom"]["parent"] is None  # the failed span closed and left the stack
    assert out["counters"] == {"c": 3} and out["dropped"] == 0
    json.dumps(out)

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(capacity=2))
    with profiling.recording():
        for k in range(5):
            with profiling.annotate("s", frame=k):
                pass
    out = profiling.export()
    assert [s["frame"] for s in _spans(out)] == [3, 4] and out["dropped"] == 3


def test_trace_turns_recording_on(recorder, tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        assert recorder.depth == 1
        with profiling.annotate("dispatch", frame=0):
            torch.ones(8).sum()
    assert recorder.depth == 0
    assert [s["name"] for s in _spans(profiling.export())] == ["dispatch"]


def test_span_encloses_its_profiler_event_on_one_clock(recorder):
    """The recorder's clock is the profiler's: a span holds the CPU event
    that its own ``record_function`` range leaves in the kineto trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording():
        for k in range(3):
            with profiling.annotate("enclosed", frame=k):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "enclosed" and e.device_type() == DeviceType.CPU)
    spans = sorted((s["start"], s["end"]) for s in _spans(profiling.export()))
    assert len(events) == len(spans) == 3
    for (es, ee), (ss, se) in zip(events, spans):
        assert ss <= es <= ee <= se
        assert es - ss < 50_000_000  # the same clock, not merely an ordered one


def _lattice_frame(n=6, steps=2):
    """Sparse lattice (spacing 4 r0): no bucket overflows on 16x16x8."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((n, n), distance_factor=4.0, velocity=(0.0, 10.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(0))
    meta.steps_per_frame = steps
    return frame


class ScriptedFrontend:
    """A live metadata edit at poll 2 and a scene reset at poll 4."""

    is_connected = True

    def __init__(self):
        self.polls = 0
        self.sent = []

    def read(self):
        self.polls += 1
        if self.polls == 2:
            edit = Frame.new()
            edit.metadata.steps_per_frame = 3
            return edit
        if self.polls == 4:
            return _lattice_frame(n=5, steps=3)
        return None

    def write(self, frame):
        self.sent.append(frame.particle_count)


@pytest.mark.parametrize("depth", [0, 1])
def test_main_loop_gives_each_shipped_frame_one_span_a_stage(recorder, depth):
    frontend = ScriptedFrontend()
    sim = Simulator(GridConfig(4, 4, 8), device="cpu")
    with profiling.recording():
        sim.load_frame(_lattice_frame())
        shipped = main_loop(frontend, sim, max_frames=8, readback_depth=depth)
    assert shipped == 8 and len(frontend.sent) == 8
    spans = _spans(profiling.export())
    by = collections.defaultdict(list)
    for s in spans:
        by[s["name"], s["frame"]].append(s)
    sends = [s for s in spans if s["name"] == "daemon.send"]
    ids = [s["frame"] for s in sends]
    assert len(sends) == 8 and all(s["thread"] == "ship-tx" for s in sends)
    assert ids == sorted(ids) and len(set(ids)) == 8  # sent in dispatch order
    assert [s["end"] for s in sends] == sorted(s["end"] for s in sends)
    loads = [k for (name, k) in by if name == "sim.load_frame"]
    assert len(loads) == 2 and loads[0] == ids[0]  # the first scene's echo
    assert loads[1] in ids  # the reset's echo
    for k in ids:
        made = by["sim.frame_async", k] + by["sim.load_frame", k]
        assert len(made) == 1, k
        for name in ("sim.start_readback", "daemon.commit"):
            assert len(by[name, k]) == 1 and by[name, k][0]["thread"] == "MainThread"
        for name in ("sim.read_frame", "readback.wait", "readback.unpack"):
            (s,) = by[name, k]
            assert s["thread"] == "ship-rb"
        assert by["readback.wait", k][0]["parent"] == "sim.read_frame"
        assert by["readback.unpack", k][0]["end"] <= by["daemon.send", k][0]["start"]
        assert made[0]["end"] <= by["sim.start_readback", k][0]["start"]
    # the frames dispatched before the reset and never shipped
    dropped = [k for (name, k) in by if name == "sim.frame_async" and k < loads[1]
               and k not in ids]
    assert dropped == [loads[1] - 2, loads[1] - 1]
    # each poll names the next frame id: the edit's first frame
    polls = [s["frame"] for s in spans if s["name"] == "daemon.poll"]
    assert polls[1] in [k for (name, k) in by if name == "sim.frame_async"]
    assert polls[3] == loads[1]
    for name in ("load.grid_pick", "load.bucketize", "load.upload"):
        assert [s["parent"] for s in spans if s["name"] == name] == ["sim.load_frame"] * 2


def test_daemon_spans_file_parses(tmp_path, capsys):
    writer = Writer.open_file(str(tmp_path / "backend_in.bin"))
    assert writer.write(_lattice_frame())
    writer.close()
    path = tmp_path / "spans.json"
    rc = daemon.main(["--files", str(tmp_path), "--torch-device", "cpu", "--max-frames", "2",
                      "--readback-pipeline", "0", "--spans", str(path)])
    assert rc == 0
    assert f"engine: spans written to {path}" in capsys.readouterr().err
    out = json.loads(path.read_text())
    assert set(out) == {"clock", "spans", "counters", "dropped"}
    assert out["clock"] == "unix_ns" and out["dropped"] == 0
    names = collections.Counter(s[0] for s in out["spans"])
    assert names["sim.load_frame"] == 1 and names["sim.frame_async"] >= 1
    assert names["daemon.send"] >= 1 and names["readback.unpack"] == names["daemon.send"]
    assert all(s[1] <= s[2] and isinstance(s[3], str) for s in out["spans"])
    assert profiling.RECORDER.depth == 0
