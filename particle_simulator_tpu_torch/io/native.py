"""ctypes binding to the native particle_io C library (native/).

The port's own copy of ``particle_simulator_tpu/io/native.py``. The native
library is the compatibility contract for the editor protocol: a C-ABI frame
codec + transport matching the surface the reference exports through
cbindgen (reference: particle_io/c_api/). This binding lets the daemon
(``--native-io``) and the tests drive the exact native code a C/C++ host
would link; ``tests/test_torch_io.py`` holds its bytes against the port's
Python codec.

The sources are the repository's ``native/`` directory, found from this
file's path. ``load()`` builds them lazily with ``make -C native
BUILD=<port build dir>/native``, so the port's library lives in the port's
git-ignored build directory and never races the JAX package's build of the
same sources into ``native/build``.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

from particle_simulator_tpu_torch.io.frame import Frame as PyFrame

_REPO = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
_LIB_PATH = _BUILD_DIR / "libparticle_io_c.so"


class CFrame(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("cap", ctypes.c_size_t),
        ("len", ctypes.c_size_t),
    ]


class CReader(ctypes.Structure):
    _fields_ = [("opaque", ctypes.c_uint64 * 2)]


class CWriter(ctypes.Structure):
    _fields_ = [("opaque", ctypes.c_uint64 * 2)]


class CParticle(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_uint32),
        ("y", ctypes.c_uint32),
        ("vx", ctypes.c_float),
        ("vy", ctypes.c_float),
        ("ty", ctypes.c_int32),
    ]


def build(force: bool = False) -> Path:
    """Build the native library if needed; returns the .so path.

    Invokes make when the .so is missing or older than the sources (so a
    stale .so never shadows edited code), but tolerates a missing toolchain
    or read-only tree when a usable prebuilt .so exists."""
    make = ["make", "-C", str(_NATIVE_DIR), f"BUILD={_BUILD_DIR}"]
    if force:
        subprocess.run([*make, "clean"], check=True, capture_output=True)
    sources = [_NATIVE_DIR / "src" / "particle_io.cpp", _NATIVE_DIR / "include" / "particle_io.h"]
    stale = not _LIB_PATH.exists() or any(
        src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime
        for src in sources
    )
    if stale:
        try:
            subprocess.run([*make, str(_LIB_PATH)], check=True, capture_output=True)
        except OSError:
            # no toolchain in this environment: a prebuilt .so is acceptable
            if not _LIB_PATH.exists():
                raise
        except subprocess.CalledProcessError as e:
            # a FAILED build must never fall back to the stale .so — that is
            # exactly the "stale library shadows edited code" hazard
            raise RuntimeError(
                f"native build failed (sources newer than {_LIB_PATH.name}):\n"
                f"{e.stderr.decode(errors='replace') if e.stderr else e}"
            ) from e
    return _LIB_PATH


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Load (building if necessary) the native library with typed signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))

    # -- reference-identical surface (particle_io/c_api) -----------------------
    lib.packet_size.restype = ctypes.c_size_t
    lib.packet_size.argtypes = [ctypes.c_uint32]
    lib.frame_destroy.argtypes = [ctypes.POINTER(CFrame)]
    # frame_print / frame_compact / frame_compact_into / writer_write take the
    # raw FrameHeader* of the packet buffer (length implied by particle_count)
    lib.frame_compact.argtypes = [ctypes.c_void_p]
    lib.frame_compact_into.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.frame_print.argtypes = [ctypes.c_void_p]
    lib.particle_is_null.restype = ctypes.c_bool
    lib.particle_is_null.argtypes = [CParticle]

    lib.reader_open_file.restype = None
    lib.reader_open_file.argtypes = [ctypes.POINTER(CReader), ctypes.c_char_p]
    lib.reader_read.restype = CFrame
    lib.reader_read.argtypes = [ctypes.POINTER(CReader)]
    lib.reader_read_last.restype = ctypes.c_bool
    lib.reader_read_last.argtypes = [ctypes.POINTER(CReader), ctypes.POINTER(CFrame)]
    lib.reader_destroy.argtypes = [ctypes.POINTER(CReader)]

    lib.writer_open_file.restype = None
    lib.writer_open_file.argtypes = [ctypes.POINTER(CWriter), ctypes.c_char_p]
    lib.writer_write.restype = ctypes.c_bool
    lib.writer_write.argtypes = [ctypes.POINTER(CWriter), ctypes.c_void_p]
    lib.writer_destroy.argtypes = [ctypes.POINTER(CWriter)]

    lib.new_tcp_client.restype = ctypes.c_bool
    lib.new_tcp_client.argtypes = [
        ctypes.POINTER(CReader),
        ctypes.POINTER(CWriter),
        ctypes.c_char_p,
    ]

    # -- extensions -------------------------------------------------------------
    lib.frame_new.restype = CFrame
    lib.frame_new.argtypes = [ctypes.c_uint32]
    lib.frame_particles.restype = ctypes.POINTER(CParticle)
    lib.frame_particles.argtypes = [ctypes.POINTER(CFrame)]
    lib.frame_metadata.restype = ctypes.c_void_p
    lib.frame_metadata.argtypes = [ctypes.POINTER(CFrame)]
    lib.frame_particle_count.restype = ctypes.c_uint32
    lib.frame_particle_count.argtypes = [ctypes.POINTER(CFrame)]
    lib.frame_is_valid.restype = ctypes.c_bool
    lib.frame_is_valid.argtypes = [ctypes.POINTER(CFrame)]
    lib.frame_push.argtypes = [ctypes.POINTER(CFrame), CParticle]
    lib.reader_read_blocking.restype = ctypes.c_bool
    lib.reader_read_blocking.argtypes = [ctypes.POINTER(CReader), ctypes.POINTER(CFrame)]
    lib.reader_try_open_file.restype = ctypes.c_bool
    lib.reader_try_open_file.argtypes = [ctypes.POINTER(CReader), ctypes.c_char_p]
    lib.writer_try_open_file.restype = ctypes.c_bool
    lib.writer_try_open_file.argtypes = [ctypes.POINTER(CWriter), ctypes.c_char_p]

    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


# -- conversion helpers ------------------------------------------------------

def frame_bytes(frame: CFrame) -> bytes:
    """Raw packet bytes of a native frame."""
    return ctypes.string_at(frame.ptr, frame.len)


def cframe_from_bytes(data: bytes) -> CFrame:
    """Native frame from raw packet bytes (allocated by the C library)."""
    lib = load()
    # allocate with enough particle capacity, then overwrite the buffer
    n = max(0, (len(data) - 96) // 20)
    frame = lib.frame_new(n)
    ctypes.memmove(frame.ptr, data, len(data))
    frame.len = len(data)
    return frame


def cframe_from_pyframe(pyframe: PyFrame) -> CFrame:
    return cframe_from_bytes(pyframe.bytes)


def pyframe_from_cframe(frame: CFrame) -> PyFrame:
    return PyFrame.from_bytes(frame_bytes(frame))


# -- native transport (engine-side) -------------------------------------------
#
# Drop-in replacements for the Python ``transport.Reader``/``Writer`` pair on
# the ENGINE side of the protocol, backed by the C++ library — the same role
# the reference's native frontend plays around its CUDA kernel
# (cuda_simulator/src/lib/frontend.hpp). The editor side stays Python (the
# reference's C ABI has no TCP server either; serving is the editor's job).

# the SAME exception class the Python transport raises, so Frontend's
# except-clauses catch both transports uniformly
from particle_simulator_tpu_torch.io.transport import Disconnected  # noqa: E402


class NativeReader:
    """Newest-wins frame reader over the native background-thread Reader."""

    def __init__(self, creader: "CReader"):
        self._reader = creader
        self._lib = load()
        self._dead = False

    def read_last(self) -> Optional[PyFrame]:
        """Drain pending frames, return the newest (None if nothing pending).
        Raises Disconnected once the stream has ended and drained."""
        if self._dead:
            raise Disconnected()
        out = CFrame(None, 0, 0)
        connected = self._lib.reader_read_last(
            ctypes.byref(self._reader), ctypes.byref(out)
        )
        frame = None
        if out.ptr:
            frame = pyframe_from_cframe(out)
            self._lib.frame_destroy(ctypes.byref(out))
        if not connected:
            # deliver the final frame (if any); report Disconnected next call
            self._dead = True
            if frame is None:
                raise Disconnected()
        return frame

    def read(self) -> Optional[PyFrame]:
        """Non-blocking read of the next frame in stream order."""
        if self._dead:
            raise Disconnected()
        out = self._lib.reader_read(ctypes.byref(self._reader))
        if not out.ptr:
            return None
        frame = pyframe_from_cframe(out)
        self._lib.frame_destroy(ctypes.byref(out))
        return frame

    def close(self) -> None:
        if self._reader is not None:
            self._lib.reader_destroy(ctypes.byref(self._reader))
            self._reader = None


class NativeWriter:
    """Blocking frame writer over the native Writer."""

    def __init__(self, cwriter: "CWriter"):
        self._writer = cwriter
        self._lib = load()

    def write(self, frame: PyFrame) -> bool:
        data = frame.bytes
        buf = ctypes.create_string_buffer(data, len(data))
        return bool(self._lib.writer_write(ctypes.byref(self._writer), buf))

    def close(self) -> None:
        if self._writer is not None:
            self._lib.writer_destroy(ctypes.byref(self._writer))
            self._writer = None


def new_tcp_client_native(addr) -> tuple[NativeReader, NativeWriter]:
    """Connect to the editor's TCP server through the C++ library
    (new_tcp_client, the reference frontend's own entry point). ``addr`` is a
    (host, port) pair. Raises OSError on connection failure (matching
    transport.new_tcp_client so Frontend.connect_tcp's retry loop works)."""
    lib = load()
    reader = CReader()
    writer = CWriter()
    host, port = addr
    if not lib.new_tcp_client(
        ctypes.byref(reader), ctypes.byref(writer), f"{host}:{port}".encode()
    ):
        raise OSError(f"native tcp connect to {host}:{port} failed")
    return NativeReader(reader), NativeWriter(writer)
