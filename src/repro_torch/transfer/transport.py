"""Transports that carry wire frames between client and server (port of
``repro/transfer/transport.py``): frames are addressed by message id,
byte counts are the real encoded lengths, and a frame is delivered at
most once.

* ``LoopbackTransport`` — the in-memory implementation the simulator and
  the pod schemes ride.
* ``ProcessTransport`` — frames cross a real OS process boundary: a
  broker process (plain CPython, no torch) owns the in-flight frame
  store, and send / recv / drop are length-prefixed RPCs over a
  localhost TCP socket.  The wall-clock runtime (``launch/vc_serve.py``)
  rides it on both legs.
"""
from __future__ import annotations

import abc
import itertools
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class TransportStats:
    frames_sent: int = 0
    bytes_sent: int = 0
    frames_recv: int = 0
    bytes_recv: int = 0
    frames_dropped: int = 0        # sent but never delivered (preemption,
    bytes_dropped: int = 0         # timeout reassignment, torn frames)


class TransportError(RuntimeError):
    pass


class Transport(abc.ABC):
    """Message-id-addressed frame carrier with real byte accounting."""

    stats: TransportStats

    @abc.abstractmethod
    def send(self, frame: bytes) -> int:
        """Put one encoded frame on the wire; returns its message id."""

    @abc.abstractmethod
    def recv(self, msg_id: int) -> bytes:
        """Take delivery of a frame (exactly once); raises TransportError
        if the id is unknown or already delivered/dropped."""

    @abc.abstractmethod
    def drop(self, msg_id: int) -> None:
        """Discard an in-flight frame; the bytes were still spent.
        Idempotent."""

    @property
    @abc.abstractmethod
    def in_flight(self) -> int:
        """Number of frames sent but neither delivered nor dropped."""


@dataclass
class LoopbackTransport(Transport):
    """In-memory message-id-addressed transport with real byte accounting."""

    stats: TransportStats = field(default_factory=TransportStats)
    _inflight: Dict[int, bytes] = field(default_factory=dict)
    _ids: "itertools.count" = field(default_factory=itertools.count)

    def send(self, frame: bytes) -> int:
        if not isinstance(frame, (bytes, bytearray)):
            raise TypeError(f"transport carries bytes, got {type(frame)}")
        mid = next(self._ids)
        self._inflight[mid] = bytes(frame)
        self.stats.frames_sent += 1
        self.stats.bytes_sent += len(frame)
        return mid

    def recv(self, msg_id: int) -> bytes:
        frame = self._inflight.pop(msg_id, None)
        if frame is None:
            raise TransportError(f"no in-flight frame with id {msg_id}")
        self.stats.frames_recv += 1
        self.stats.bytes_recv += len(frame)
        return frame

    def drop(self, msg_id: int) -> None:
        frame = self._inflight.pop(msg_id, None)
        if frame is not None:
            self.stats.frames_dropped += 1
            self.stats.bytes_dropped += len(frame)

    @property
    def in_flight(self) -> int:
        return len(self._inflight)


# ---------------------------------------------------------------------------
# ProcessTransport: frames cross a real OS process boundary
# ---------------------------------------------------------------------------

# The broker is a self-contained stdlib-only script run by ``python -c``:
# it imports no torch (slow to start; the in-flight store is just bytes)
# and nothing of this package.  It exits when its socket reaches EOF, so a
# killed server leaves no broker behind.  RPC framing, little-endian:
#   request:  op u8 ('S'end | 'R'ecv | 'D'rop | 'Q'uery | 'X' exit)
#             | mid u64 | body_len u64 | body
#   response: status u8 ('O' ok | 'E' unknown id)
#             | value u64 (drop: dropped frame length; query: store size)
#             | body_len u64 | body (recv: the frame)
# On connect the broker sends its PID (u64) so callers can verify the
# frames really live in another process.
_BROKER_SRC = r"""
import os, socket, struct, sys

def rd(c, n):
    b = b""
    while len(b) < n:
        ch = c.recv(n - len(b))
        if not ch:
            raise SystemExit(0)
        b += ch
    return b

def resp(c, ok, value=0, body=b""):
    c.sendall((b"O" if ok else b"E")
              + struct.pack("<QQ", value, len(body)) + body)

c = socket.create_connection(("127.0.0.1", int(sys.argv[1])))
c.sendall(struct.pack("<Q", os.getpid()))
store = {}
while True:
    op = rd(c, 1)
    mid, ln = struct.unpack("<QQ", rd(c, 16))
    body = rd(c, ln) if ln else b""
    if op == b"S":
        store[mid] = body
        resp(c, True)
    elif op == b"R":
        f = store.pop(mid, None)
        resp(c, f is not None, body=f or b"")
    elif op == b"D":
        f = store.pop(mid, None)
        resp(c, f is not None, value=len(f) if f is not None else 0)
    elif op == b"Q":
        resp(c, True, value=len(store))
    else:
        c.close()
        raise SystemExit(0)
"""

_REQ = struct.Struct("<QQ")
_LEN = struct.Struct("<Q")
_RSP = struct.Struct("<QQ")


class ProcessTransport(Transport):
    """Frames held by a broker in ANOTHER OS process, carried over a real
    localhost TCP socket.  Same contract as ``LoopbackTransport`` — the
    Coordinator cannot tell them apart except by ``broker_pid`` — but
    every byte leaves this process and comes back.

    Thread-safe: one lock is held over each whole request/response and
    the stats update that goes with it, so two threads (the runtime's
    handout prefetch and its submit) never interleave their bytes on the
    socket.  A serial caller sees the same frames, ids and counts as
    without it.  ``rpc_s`` sums the host seconds spent inside RPCs.

    Use as a context manager (or call ``close()``) so the broker process
    is reaped."""

    def __init__(self, timeout_s: float = 60.0):
        self.stats = TransportStats()
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.rpc_s = 0.0
        self._conn = None
        self._proc = None
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        self._proc = subprocess.Popen([sys.executable, "-c", _BROKER_SRC,
                                       str(port)])
        srv.settimeout(timeout_s)
        # if the handshake fails at ANY point (accept timeout, connection
        # reset, short PID read) the broker is reaped here: the
        # constructor raising leaves no ProcessTransport to close()
        try:
            try:
                self._conn, _ = srv.accept()
            finally:
                srv.close()
            self._conn.settimeout(timeout_s)
            (self.broker_pid,) = _LEN.unpack(self._read(8))
        except BaseException:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            self._proc.kill()
            self._proc.wait()
            self._proc = None
            raise

    # -- rpc plumbing -------------------------------------------------------
    def _read(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                raise TransportError("broker process closed the connection")
            buf += chunk
        return bytes(buf)

    def _rpc(self, op: bytes, mid: int, body: bytes = b""):
        """One request/response; the caller holds ``_lock``."""
        t0 = time.perf_counter()
        self._conn.sendall(op + _REQ.pack(mid, len(body)) + body)
        status = self._read(1)
        value, ln = _RSP.unpack(self._read(_RSP.size))
        payload = self._read(ln) if ln else b""
        self.rpc_s += time.perf_counter() - t0
        return status == b"O", value, payload

    # -- Transport ----------------------------------------------------------
    def send(self, frame: bytes) -> int:
        if not isinstance(frame, (bytes, bytearray)):
            raise TypeError(f"transport carries bytes, got {type(frame)}")
        with self._lock:
            mid = next(self._ids)
            ok, _, _ = self._rpc(b"S", mid, bytes(frame))
            if not ok:
                raise TransportError(f"broker rejected frame {mid}")
            self.stats.frames_sent += 1
            self.stats.bytes_sent += len(frame)
        return mid

    def recv(self, msg_id: int) -> bytes:
        with self._lock:
            ok, _, frame = self._rpc(b"R", msg_id)
            if not ok:
                raise TransportError(f"no in-flight frame with id {msg_id}")
            self.stats.frames_recv += 1
            self.stats.bytes_recv += len(frame)
        return frame

    def drop(self, msg_id: int) -> None:
        with self._lock:
            ok, ln, _ = self._rpc(b"D", msg_id)
            if ok:
                self.stats.frames_dropped += 1
                self.stats.bytes_dropped += int(ln)

    @property
    def in_flight(self) -> int:
        with self._lock:
            _, ln, _ = self._rpc(b"Q", 0)
        return int(ln)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        lock = getattr(self, "_lock", None)
        if lock is None:
            return
        with lock:
            if getattr(self, "_conn", None) is not None:
                try:
                    self._conn.sendall(b"X" + _REQ.pack(0, 0))
                except OSError:
                    pass
                self._conn.close()
                self._conn = None
            if getattr(self, "_proc", None) is not None:
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
                self._proc = None

    def __enter__(self) -> "ProcessTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
