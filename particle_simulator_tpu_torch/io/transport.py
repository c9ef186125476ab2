"""Frame stream transport: background reader, blocking writer, TCP helpers.

Copy of ``particle_simulator_tpu/io/transport.py`` for the port.

Mirrors the reference's ``particle_io::{Reader, Writer, TcpClient}``
(particle_io/src/{reader,writer,tcp}.rs):

- ``Reader`` runs a background thread that loops {read 96 header bytes, validate
  signatures (skip frame + warn on mismatch), read body, enqueue} into a bounded
  queue (2048 frames). ``read()`` is a non-blocking poll; ``Disconnected`` is
  raised once the stream ends *and* the queue is drained.
- ``read_last()`` drains the queue and returns only the newest frame — the
  simulator-side consumption pattern (newest-wins, reference:
  particle_io/c_api/src/reader.rs:51-63).
- ``Writer`` is a thin blocking write-all.
- ``new_tcp_client(addr)`` connects and returns (Reader, Writer) over the same
  socket (the engine side); ``new_tcp_server(addr)`` binds a non-blocking listener
  (the editor side, reference: particle_editor/src/backend.rs:37-46).
"""

from __future__ import annotations

import queue
import socket
import sys
import threading
from typing import Optional

from particle_simulator_tpu_torch.io.frame import (
    Frame,
    HEADER_DTYPE,
    HEADER_SIZE,
    SIGNATURE_END,
    SIGNATURE_START,
    packet_size,
)

import numpy as np

MAX_ENQUEUED_FRAMES = 2048

DEFAULT_ADDR = ("0.0.0.0", 53123)


class Disconnected(Exception):
    """The stream ended (EOF / connection closed / reader thread died)."""


def _read_exact(stream, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF/closed connection."""
    chunks = []
    remaining = n
    while remaining > 0:
        try:
            chunk = stream.recv(remaining) if hasattr(stream, "recv") else stream.read(remaining)
        except (OSError, ValueError):
            return None
        if not chunk:
            return None
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _read_exact_into(stream, buf: memoryview) -> bool:
    """Fill ``buf`` exactly; False on clean EOF/closed connection. Uses
    recv_into on sockets so a 1M-particle frame body (20 MB) lands in one
    preallocated buffer with zero join/concat copies — the ingest half of
    the config-5 ship path."""
    if not hasattr(stream, "recv_into"):
        data = _read_exact(stream, len(buf))
        if data is None:
            return False
        buf[:] = data
        return True
    got = 0
    n = len(buf)
    while got < n:
        try:
            r = stream.recv_into(buf[got:])
        except (OSError, ValueError):
            return False
        if not r:
            return False
        got += r
    return True


class Reader:
    """Background-thread frame stream reader with a bounded queue."""

    def __init__(self, stream):
        self._queue: queue.Queue = queue.Queue(maxsize=MAX_ENQUEUED_FRAMES)
        self._stream = stream
        self._alive = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def open_file(path: str) -> "Reader":
        return Reader(open(path, "rb"))

    def _run(self) -> None:
        try:
            while True:
                raw_header = _read_exact(self._stream, HEADER_SIZE)
                if raw_header is None:
                    break
                hdr = np.frombuffer(raw_header, dtype=HEADER_DTYPE, count=1)[0]
                if (
                    hdr["signature_start"].tobytes() != SIGNATURE_START
                    or hdr["signature_end"].tobytes() != SIGNATURE_END
                ):
                    print("Read frame with invalid signature", file=sys.stderr)
                    continue
                body_size = packet_size(int(hdr["particle_count"])) - HEADER_SIZE
                # one exact-size buffer per frame, filled in place and handed
                # to the Frame without re-copy (from_buffer takes ownership)
                packet = bytearray(HEADER_SIZE + body_size)
                packet[:HEADER_SIZE] = raw_header
                if body_size and not _read_exact_into(
                    self._stream, memoryview(packet)[HEADER_SIZE:]
                ):
                    break
                self._queue.put(Frame.from_buffer(packet))
        finally:
            self._alive = False

    def read(self) -> Optional[Frame]:
        """Non-blocking poll. Returns a Frame, or None if no frame pending.
        Raises Disconnected once the stream is gone and the queue is drained."""
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            if not self._alive:
                raise Disconnected() from None
            return None

    def read_last(self) -> Optional[Frame]:
        """Drain the queue, return only the newest pending frame (newest-wins).
        Raises Disconnected when the stream is gone and nothing is pending."""
        last = None
        while True:
            try:
                frame = self.read()
            except Disconnected:
                if last is not None:
                    return last
                raise
            if frame is None:
                return last
            last = frame

    def read_blocking(self, timeout: Optional[float] = None) -> Frame:
        """Block until a frame arrives. Raises Disconnected on stream end,
        TimeoutError on timeout."""
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            if not self._alive:
                raise Disconnected() from None
            raise TimeoutError() from None

    def close(self) -> None:
        try:
            if hasattr(self._stream, "shutdown"):
                self._stream.shutdown(socket.SHUT_RDWR)
            self._stream.close()
        except OSError:
            pass


class Writer:
    """Blocking frame writer over a socket or file object."""

    def __init__(self, stream):
        self._stream = stream
        self._lock = threading.Lock()

    @staticmethod
    def open_file(path: str) -> "Writer":
        return Writer(open(path, "wb"))

    def write(self, frame: Frame) -> bool:
        """Write one frame. Returns False (and warns) on failure, like the
        reference's ``writer_write`` (particle_io/c_api/src/writer.rs:41-59).

        Sends header and particle body as two writes under one lock — the
        body goes out as a zero-copy memoryview of the particle array
        instead of materializing a ~20 MB ``frame.bytes`` concat at 1M."""
        header, body = frame.wire_views()
        try:
            with self._lock:
                if hasattr(self._stream, "sendall"):
                    self._stream.sendall(header)
                    if body.nbytes:
                        self._stream.sendall(body)
                else:
                    self._stream.write(header)
                    if body.nbytes:
                        self._stream.write(body)
                    self._stream.flush()
            return True
        except (OSError, ValueError) as e:
            print(f"frame write failed: {e}", file=sys.stderr)
            return False

    def close(self) -> None:
        try:
            self._stream.close()
        except OSError:
            pass


def new_tcp_client(addr=DEFAULT_ADDR, timeout: Optional[float] = 10.0):
    """Connect to the editor's TCP server; returns (Reader, Writer) sharing the
    socket. Raises OSError on connection failure."""
    sock = socket.create_connection(addr, timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return Reader(sock), Writer(sock)


class TcpServer:
    """Non-blocking single-connection TCP acceptor (the editor side).

    ``try_accept()`` polls for a pending connection and returns (Reader, Writer)
    or None — matching the editor's non-blocking accept loop
    (particle_editor/src/backend.rs:150-158).
    """

    def __init__(self, addr=DEFAULT_ADDR):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(addr)
        self._listener.listen(1)
        self._listener.setblocking(False)
        self.addr = self._listener.getsockname()

    def try_accept(self):
        try:
            sock, _peer = self._listener.accept()
        except BlockingIOError:
            return None
        except OSError:
            # listener closed under us (editor teardown races the tick
            # thread's accept poll) — report "no connection", never raise
            return None
        sock.setblocking(True)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return Reader(sock), Writer(sock)

    def close(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass


def new_tcp_server(addr=DEFAULT_ADDR) -> TcpServer:
    return TcpServer(addr)
