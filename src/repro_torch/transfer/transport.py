"""Transports that carry wire frames between client and server (port of
``repro/transfer/transport.py``): frames are addressed by message id,
byte counts are the real encoded lengths, and a frame is delivered at
most once.  ``LoopbackTransport`` is the in-memory implementation the
simulator rides; the cross-process transport comes with the port of the
wall-clock runtime (``launch/vc_serve.py``)."""
from __future__ import annotations

import abc
import itertools
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
