"""Content-addressed handout frame cache: encode once, serve millions.

The delta-handout ledger (protocol/coordinator.py) made each client's
download cheap — but the coordinator still ENCODED a fresh wire frame
per client per changed shard: O(clients x changed-bytes) work per round,
which caps the read path far below "millions of users pulling the
model".  This cache closes that gap: the bus is chunked by shard, each
chunk's bytes are hashed once per write-version, and the encoded frame
is kept in a round-addressed immutable cache keyed by

    (round, chunk, content_hash)

``round`` is part of the key because the wire header embeds it
(``wire.encode_shard(..., round=...)``): identical chunk bytes at two
different rounds are two different frames, and the cache must be
byte-identical to a fresh per-client encode.  ``content_hash`` makes a
stale entry structurally unreachable — a content change produces a new
key, it never serves old bytes under a new version.

Bounded memory (the retention watermark):

* **Within a round** an entry is superseded when its chunk's content
  moves (handouts always ship the CURRENT bus content — an old
  content's frame can never be served again), so at most one live frame
  per (chunk, round).
* **Across rounds** an explicit retention watermark evicts every frame
  whose round fell behind ``max_round_seen - keep_rounds + 1``: once
  every requester's round passed R, round-R frames are unreachable (the
  round is in the header, so a caught-up reader at round R' > R could
  never be served them anyway).  Requests from BELOW the watermark
  (a rewound restore) bypass the cache — encoded fresh, never stored,
  never wrong.

Total: at most ``n_chunks * keep_rounds`` frames resident, regardless
of how many clients/subscribers are served — the invariant the
1M-subscriber scenarios lean on (tests/test_handout.py pins it).

The cache is a pure encode-memoizer: a miss is only a wasted encode,
never wrong bytes, because the key binds the exact (round, content)
pair that determines the frame.

Copied unchanged from ``repro/transfer/handout_cache.py`` (numpy and the standard library
only): the port keeps its own copy so that it never imports the
reference, and every numpy rng stream stays identical.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def chunk_hash(data: np.ndarray) -> bytes:
    """Content hash of one bus chunk (16-byte blake2b over the raw
    bytes).  Computed once per (chunk, write-version) — the caller
    memoizes through ``HandoutCache.get``."""
    return hashlib.blake2b(np.ascontiguousarray(data).view(np.uint8),
                           digest_size=16).digest()


class HandoutCache:
    """Round-addressed immutable frame cache for the download leg.

    ``get`` is the only hot-path entry point: it returns the encoded
    frame for (round, chunk, current content), encoding at most once
    per (round, chunk, write-version).  Serving stats (bytes served vs
    unique bytes encoded) accumulate here, so the dedup ratio of the
    whole download leg is an O(1) read."""

    def __init__(self, keep_rounds: int = 2):
        if keep_rounds < 1:
            raise ValueError("keep_rounds must be >= 1")
        self.keep_rounds = int(keep_rounds)
        # (round, chunk, content_hash) -> immutable frame bytes
        self._frames: Dict[Tuple[int, int, bytes], bytes] = {}
        # chunk -> {round -> key}: the live entry per (chunk, round),
        # replaced when the chunk's content moves within the round
        self._live: Dict[int, Dict[int, Tuple[int, int, bytes]]] = {}
        # chunk -> (write_version, digest): hash memo for the CURRENT
        # version only (old versions are never served again)
        self._hash_memo: Dict[int, Tuple[int, bytes]] = {}
        self.watermark = 0              # lowest round still cacheable
        self._max_round = -1
        # ---- serving stats ------------------------------------------------
        self.encodes = 0                # cache misses (fresh encodes)
        self.encoded_bytes = 0          # unique bytes encoded
        self.hits = 0                   # frames served from cache
        self.served_frames = 0          # every frame returned by get()
        self.served_bytes = 0           # summed lengths of served frames
        self.evicted = 0                # frames dropped by the watermark

    # -- introspection -------------------------------------------------------

    @property
    def frames_held(self) -> int:
        return len(self._frames)

    @property
    def bytes_held(self) -> int:
        return sum(len(f) for f in self._frames.values())

    @property
    def dedup_ratio(self) -> float:
        """bytes-served / unique-bytes-encoded (1.0 = no reuse)."""
        return self.served_bytes / max(self.encoded_bytes, 1)

    # -- the hot path --------------------------------------------------------

    def get(self, *, round: int, chunk: int, version: int,
            data: np.ndarray, encode: Callable[[], bytes]
            ) -> Tuple[bytes, bool]:
        """Frame for ``chunk`` at ``round`` with content ``data`` (the
        bus cache slice at write-version ``version``).  Returns
        ``(frame, fresh)`` where ``fresh`` is True iff this call paid
        the encode.  ``encode`` must be deterministic in (data, round,
        chunk) — that is what makes the cached frame byte-identical to
        a per-client encode."""
        if round > self._max_round:
            self._max_round = round
            new_mark = round - self.keep_rounds + 1
            if new_mark > self.watermark:
                self._evict_below(new_mark)
        if round < self.watermark:
            # rewound requester (e.g. issue after a checkpoint restore
            # cleared nothing but rounds went backwards): serve fresh,
            # never cache below the watermark
            frame = encode()
            self.encodes += 1
            self.encoded_bytes += len(frame)
            self._serve(frame)
            return frame, True
        digest = self._digest(chunk, version, data)
        key = (round, chunk, digest)
        frame = self._frames.get(key)
        if frame is not None:
            self.hits += 1
            self._serve(frame)
            return frame, False
        frame = encode()
        self.encodes += 1
        self.encoded_bytes += len(frame)
        per_round = self._live.setdefault(chunk, {})
        old = per_round.get(round)
        if old is not None:
            # content moved within the round: the old frame can never
            # be served again (handouts ship current content only)
            self._frames.pop(old, None)
            self.evicted += 1
        per_round[round] = key
        self._frames[key] = frame
        self._serve(frame)
        return frame, True

    def _serve(self, frame: bytes) -> None:
        self.served_frames += 1
        self.served_bytes += len(frame)

    # -- retention -----------------------------------------------------------

    def _evict_below(self, mark: int) -> None:
        """Advance the retention watermark: every frame from a round
        below ``mark`` is unreachable (callers' rounds are monotone) —
        drop it."""
        self.watermark = mark
        for chunk, per_round in list(self._live.items()):
            for rnd in [r for r in per_round if r < mark]:
                self._frames.pop(per_round.pop(rnd), None)
                self.evicted += 1
            if not per_round:
                del self._live[chunk]

    def reset(self) -> None:
        """Forget every frame and the round watermark (checkpoint
        restore: rounds may rewind; the serving stats survive — they
        describe the process, not the cache content)."""
        self._frames.clear()
        self._live.clear()
        self._hash_memo.clear()
        self.watermark = 0
        self._max_round = -1

    # -- internals -----------------------------------------------------------

    def _digest(self, chunk: int, version: int, data: np.ndarray) -> bytes:
        memo = self._hash_memo.get(chunk)
        if memo is not None and memo[0] == version:
            return memo[1]
        digest = chunk_hash(data)
        # current version only: old versions' content is never served
        # again, so the memo stays O(n_chunks)
        self._hash_memo[chunk] = (version, digest)
        return digest
