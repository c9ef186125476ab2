"""The port's own wire codec (``particle_simulator_tpu_torch.io``) against
the JAX package's (``particle_simulator_tpu.io``) on the same frames.

The wire format is frozen, so everything here is byte for byte: dtypes,
header and metadata bytes, particle bytes, ``Frame.from_bytes`` round trips
in both directions, lattice positions for a seed, the file and TCP
transports across the two packages, the scene builders, and the port's
ctypes binding to the repo's ``native/`` C library.
"""

import ctypes
import dataclasses
import threading
import time

import numpy as np
import pytest

from particle_simulator_tpu.io import frame as jframe
from particle_simulator_tpu.io import presets as jpresets
from particle_simulator_tpu.io import transport as jtransport
from particle_simulator_tpu.scenes import library as jlibrary
from particle_simulator_tpu_torch.io import frame, native, presets, transport
from particle_simulator_tpu_torch.scenes import library


def random_frame(mod, seed=0, n=257):
    """A frame of ``mod`` (either package's frame module) with seeded
    particles (tombstones included) and non-default metadata."""
    rng = np.random.default_rng(seed)
    f = mod.Frame.new()
    meta = f.metadata
    meta.set_species(0, mod.MieParams.argon())
    meta.set_species(1, mod.MieParams(2.5e-10, 1.1e-21, 11.5, 5.5))
    meta.cursor_pos = (0.25, 0.75)
    meta.cursor_size = 0.125
    meta.step_dt = 1.5e-14
    meta.steps_per_frame = 37
    meta.box_width, meta.box_height = 7e-8, 3e-8
    meta.data_structure = mod.DataStructure.COMPACT_ARRAY
    meta.device = mod.Device.CPU_MAIN_THREAD
    meta.gpu_threads_per_block_log2 = 9
    parts = np.zeros(n, dtype=mod.PARTICLE_DTYPE)
    parts["x"] = rng.integers(0, 2**32, n, dtype=np.uint32)
    parts["y"] = rng.integers(0, 2**32, n, dtype=np.uint32)
    parts["vx"] = rng.normal(0, 300, n).astype(np.float32)
    parts["vy"] = rng.normal(0, 300, n).astype(np.float32)
    parts["ty"] = rng.integers(-1, 2, n)
    f.extend(parts)
    return f


def test_layout_and_constants_match():
    for name in ("MIE_PARAMS_DTYPE", "METADATA_DTYPE", "HEADER_DTYPE", "PARTICLE_DTYPE",
                 "METADATA_SIZE", "HEADER_SIZE", "PARTICLE_SIZE", "SIGNATURE_START",
                 "SIGNATURE_END", "U32_MAX", "BOLTZMANN"):
        assert getattr(frame, name) == getattr(jframe, name), name
    for enum_name in ("DataStructure", "Device"):
        ours, theirs = getattr(frame, enum_name), getattr(jframe, enum_name)
        assert [(e.name, int(e)) for e in ours] == [(e.name, int(e)) for e in theirs]
    assert frame.default_metadata().tobytes() == jframe.default_metadata().tobytes()
    assert frame.Frame.new().bytes == jframe.Frame.new().bytes
    for n in (0, 1, 1000):
        assert frame.packet_size(n) == jframe.packet_size(n)
    for species in ("nitrogen", "argon"):
        ours, theirs = getattr(frame.MieParams, species)(), getattr(jframe.MieParams, species)()
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert ours.force0_r() == theirs.force0_r()


@pytest.mark.parametrize("seed, n", [(0, 0), (1, 1), (2, 257), (3, 4096)])
def test_frames_serialize_identically(seed, n):
    ours, theirs = random_frame(frame, seed, n), random_frame(jframe, seed, n)
    assert ours.bytes == theirs.bytes
    assert ours.header.tobytes() == theirs.header.tobytes()
    assert ours.metadata.copy().tobytes() == theirs.metadata.copy().tobytes()
    assert ours.particles.tobytes() == theirs.particles.tobytes()
    head, body = ours.wire_views()
    assert head + bytes(body) == theirs.bytes


@pytest.mark.parametrize("seed", [0, 5])
def test_from_bytes_round_trips_across_packages(seed):
    raw = random_frame(jframe, seed).bytes
    ours = frame.Frame.from_bytes(raw)
    assert ours.bytes == raw
    assert jframe.Frame.from_bytes(ours.bytes).bytes == raw
    assert frame.Frame.from_buffer(bytearray(raw)).bytes == raw
    assert ours.metadata.data_structure == frame.DataStructure.COMPACT_ARRAY
    assert ours.metadata.device == frame.Device.CPU_MAIN_THREAD
    with pytest.raises(ValueError):
        frame.Frame.from_bytes(raw[:-1])
    compacted, jcompacted = frame.Frame.from_bytes(raw), jframe.Frame.from_bytes(raw)
    compacted.compact()
    jcompacted.compact()
    assert compacted.bytes == jcompacted.bytes


def test_garbage_enum_bytes_read_as_the_defaults():
    for mod in (frame, jframe):
        f = mod.Frame.new()
        f.header["metadata"]["data_structure"] = 9
        f.header["metadata"]["device"] = 7
        assert f.metadata.data_structure == mod.DataStructure.MATRIX_BUCKETS
        assert f.metadata.device == mod.Device.GPU


@pytest.mark.parametrize("shape, method", [((7, 5), "hex_square"), ((6, 9), "square")])
def test_lattice_positions_match_for_a_seed(shape, method):
    frames = []
    for fmod, pmod in ((frame, presets), (jframe, jpresets)):
        f = fmod.Frame.new()
        meta = f.metadata
        lat = pmod.ParticleLattice(shape, distance_factor=1.3, velocity=(5.0, 40.0))
        getattr(lat, method)(f, (meta.box_width / 3, meta.box_height / 2), ty=0,
                             rng=np.random.default_rng(11))
        frames.append(f.bytes)
    assert frames[0] == frames[1]


@pytest.mark.parametrize("name", sorted(library.SCENES))
def test_scene_builders_match(name):
    assert library.SCENES[name]().bytes == jlibrary.SCENES[name]().bytes


def test_file_transport_interoperates(tmp_path):
    """Frames the port writes, the JAX reader reads, and the other way."""
    sent = [random_frame(frame, s, n) for s, n in ((0, 3), (1, 0), (2, 64))]
    for writer_mod, reader_mod in ((transport, jtransport), (jtransport, transport)):
        path = str(tmp_path / f"{writer_mod.__name__}.bin")
        writer = writer_mod.Writer.open_file(path)
        for f in sent:
            assert writer.write(f)
        writer.close()
        reader = reader_mod.Reader.open_file(path)
        got = [reader.read_blocking(timeout=10).bytes for _ in sent]
        reader.close()
        assert got == [f.bytes for f in sent]


def test_tcp_transport_interoperates():
    """The port's TCP server (the editor side) against the JAX client, and
    the newest-wins read of the port's reader."""
    server = transport.new_tcp_server(("127.0.0.1", 0))
    client_reader, client_writer = jtransport.new_tcp_client(("127.0.0.1", server.addr[1]))
    try:
        conn = None
        deadline = time.monotonic() + 10
        while conn is None and time.monotonic() < deadline:
            conn = server.try_accept()
            time.sleep(0.005)
        reader, writer = conn
        scene = random_frame(frame, 4)
        assert writer.write(scene)
        assert client_reader.read_blocking(timeout=10).bytes == scene.bytes
        for k in range(3):
            assert client_writer.write(random_frame(jframe, 10 + k, 5))
        deadline = time.monotonic() + 10
        last = None
        while time.monotonic() < deadline:
            last = reader.read_last() or last
            if last is not None and last.bytes == random_frame(frame, 12, 5).bytes:
                break
            time.sleep(0.01)
        assert last.bytes == random_frame(frame, 12, 5).bytes
    finally:
        client_reader.close()
        client_writer.close()
        server.close()
    with pytest.raises(transport.Disconnected):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            reader.read()
            time.sleep(0.01)


def test_native_codec_matches_the_port_codec():
    """The port's binding builds the repo's native library into the port's
    own build directory and reads and writes the same bytes."""
    assert native.available()
    assert native._LIB_PATH.parent != native._NATIVE_DIR / "build"
    lib = native.load()
    for n in (0, 1, 1000):
        assert lib.packet_size(n) == frame.packet_size(n)
    scene = random_frame(frame, 6, 33)
    cframe = native.cframe_from_pyframe(scene)
    try:
        assert native.frame_bytes(cframe) == scene.bytes
        assert native.pyframe_from_cframe(cframe).bytes == scene.bytes
        assert lib.frame_particle_count(ctypes.byref(cframe)) == 33
        assert lib.frame_is_valid(ctypes.byref(cframe))
    finally:
        lib.frame_destroy(ctypes.byref(cframe))


def test_native_tcp_client_against_the_port_server():
    """The daemon's ``--native-io`` transport against the port's editor-side
    server: a scene out, its echo back."""
    server = transport.new_tcp_server(("127.0.0.1", 0))
    scene = random_frame(frame, 8, 25)
    received = {}

    def editor_side():
        conn = None
        deadline = time.monotonic() + 10
        while conn is None and time.monotonic() < deadline:
            conn = server.try_accept()
            time.sleep(0.005)
        reader, writer = conn
        assert writer.write(scene)
        received["frame"] = reader.read_blocking(timeout=10)

    t = threading.Thread(target=editor_side, daemon=True)
    t.start()
    reader, writer = native.new_tcp_client_native(("127.0.0.1", server.addr[1]))
    try:
        got = None
        deadline = time.monotonic() + 10
        while got is None and time.monotonic() < deadline:
            got = reader.read_last()
            time.sleep(0.005)
        assert got.bytes == scene.bytes
        assert writer.write(got)
        t.join(timeout=15)
        assert received["frame"].bytes == scene.bytes
    finally:
        reader.close()
        writer.close()
        server.close()
