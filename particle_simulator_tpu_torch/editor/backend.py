"""Editor-side transport: TCP server, file transport, and the loopback queue.

Functional equivalent of the reference editor's ``Backend`` module
(particle_editor/src/backend.rs): the editor is the TCP **server** (the engine
connects as a client, backend.rs:37-46); alternatively a file pair
``backend_out.bin`` / ``backend_in.bin`` records/replays the stream
(backend.rs:70-105); and when no engine is connected, writes land in a
**loopback queue** that reads pop — the editor echoes frames to itself so
drawing/presets work standalone (backend.rs:21,160-188).

Read/write errors tear the connection down and keep a human-readable details
string for the UI/stats surface (backend.rs ConnectionState). The port's own
copy of ``particle_simulator_tpu/editor/backend.py``, on the port's transport.
"""

from __future__ import annotations

import collections
from typing import Optional

from particle_simulator_tpu_torch.io.frame import Frame
from particle_simulator_tpu_torch.io.transport import (
    DEFAULT_ADDR,
    Disconnected,
    Reader,
    TcpServer,
    Writer,
    new_tcp_server,
)


class Backend:
    """Editor-side connection manager with loopback fallback."""

    def __init__(self, addr=DEFAULT_ADDR, tcp: bool = True):
        self._server: Optional[TcpServer] = None
        self._server_error: Optional[str] = None
        if tcp:
            try:
                self._server = new_tcp_server(addr)
            except OSError as e:  # port taken etc. — editor still works standalone
                self._server_error = str(e)
        self._reader: Optional[Reader] = None
        self._writer: Optional[Writer] = None
        self._loopback: collections.deque[Frame] = collections.deque()
        self.connection_details: str = "no backend"

    # -- connection state ---------------------------------------------------------
    @property
    def is_connected(self) -> bool:
        return self._reader is not None

    def reader_connected(self) -> bool:
        """backend.rs:126-128 — the half-connections report independently."""
        return self._reader is not None

    def writer_connected(self) -> bool:
        """backend.rs:130-132."""
        return self._writer is not None

    def tcp_server_status(self) -> str:
        if self._server is None:
            return f"tcp server error: {self._server_error}" if self._server_error else "tcp off"
        host, port = self._server.addr
        return f"listening on {host}:{port}"

    def close_connection(self) -> None:
        if self._reader is not None:
            self._reader.close()
        if self._writer is not None:
            self._writer.close()
        self._reader = None
        self._writer = None
        self.connection_details = "disconnected"

    def open_backend_files(self, in_path: str, out_path: str) -> None:
        """File transport: replay ``in_path`` as the incoming stream, record
        outgoing frames to ``out_path`` (backend.rs:70-105). Note the editor's
        *out* is the engine's *in* and vice versa.

        Opens the new pair BEFORE tearing down the current connection, so a
        bad path (FileNotFoundError propagates to the caller) leaves a live
        TCP session untouched instead of disconnecting it as a side effect."""
        reader = Reader.open_file(in_path)
        try:
            writer = Writer.open_file(out_path)
        except OSError:
            reader.close()
            raise
        self.close_connection()
        self._reader = reader
        self._writer = writer
        self.connection_details = f"files: {in_path} -> {out_path}"

    def _try_accept(self) -> None:
        if self._server is None or self._reader is not None:
            return
        conn = self._server.try_accept()
        if conn is not None:
            # like the reference's open_tcp (backend.rs:107-118) an accepted
            # engine replaces BOTH halves — close a still-recording file
            # writer instead of leaking its handle
            if self._writer is not None:
                self._writer.close()
            self._reader, self._writer = conn
            self.connection_details = "tcp backend connected"
            self._loopback.clear()

    # -- frame io (backend.rs:160-188) ---------------------------------------------
    def read(self) -> Optional[Frame]:
        """Next pending frame from the engine, or from the loopback queue when
        no engine is connected. None = nothing pending."""
        self._try_accept()
        if self._reader is None:
            return self._loopback.popleft() if self._loopback else None
        try:
            return self._reader.read()
        except Disconnected:
            # only the reader half dies (backend.rs:160-173): a file/pipe
            # writer keeps recording after the replay stream ends, and a dead
            # TCP socket surfaces on the next write anyway
            self._reader.close()
            self._reader = None
            # keep naming the transport that died: a finished file replay or a
            # dropped engine read identically as Disconnected, and the status
            # line is the only place the user (and tests) can tell which
            self.connection_details = f"backend disconnected (read); was {self.connection_details}"
            return None

    def write(self, frame: Frame) -> None:
        """Send a frame to the engine; with no backend at all, queue it to
        loopback so the editor consumes its own frame next read (the built-in
        fake backend, backend.rs:176-188). Like the reference, the writer
        half fails independently of the reader (backend.rs:176-190), and a
        missing writer only falls back to loopback when the reader is gone
        too — mid-replay sends are dropped, not echoed."""
        self._try_accept()
        if self._writer is None:
            if self._reader is None:
                self._loopback.append(frame.copy())
            return
        if not self._writer.write(frame):
            self._writer = None
            self.connection_details = f"backend disconnected (write); was {self.connection_details}"
            if self._reader is None:
                self._loopback.append(frame.copy())

    def close(self) -> None:
        self.close_connection()
        if self._server is not None:
            self._server.close()
            self._server = None
