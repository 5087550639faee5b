"""Read-only handout serving: the fan-out face of a Coordinator's bus
(port of ``repro/protocol/handout.py``).

Training clients pull the model through leases (``Coordinator.issue``);
*subscribers* — evaluators, downstream consumers, the paper's "millions
of users" — only ever READ.  ``HandoutService`` serves them the same
immutable frames the lease path ships, through the same two ledgers:

* the Coordinator's **version-vector ledger** decides WHICH chunks a
  subscriber needs (one u32 vector compare per pull; a caught-up
  subscriber fetching an unchanged server costs zero frames — on the
  read path this applies even to a single-chunk dense bus), and
* the **content-addressed frame cache** (transfer/handout_cache.py)
  guarantees each chunk is ENCODED at most once per (round,
  write-version), no matter how many subscribers pull it — the
  flash-crowd case costs one encode plus N sends instead of N encodes.

Subscriber state is one version-vector *reference* per subscriber: the
Coordinator copies-on-write when versions bump, so a million caught-up
subscribers share a handful of immutable vectors instead of holding a
million copies.

The service never mutates lease or client state — ``_refresh_bus`` is
content-driven (a version bumps exactly when bytes moved), so a
subscriber pull happening before a client's issue changes WHEN the
compare runs, never which frames anyone is sent.  On the card a pull of
a bus buffer the ledger has already seen costs no device->host copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.protocol.coordinator import Coordinator
from repro_torch.protocol.types import as_flat
from repro_torch.transfer import wire
from repro_torch.transfer.transport import Transport


@dataclass
class PullStats:
    """One subscriber pull: what crossed (or would cross) the wire."""
    frames: int = 0                 # frames served to this subscriber
    bytes: int = 0                  # summed frame lengths
    encoded_bytes: int = 0          # cache misses THIS pull paid for
    fresh: bool = False             # first pull (full download)


class HandoutService:
    """Serve read-only subscribers from a Coordinator's frame cache.

    With ``transport`` set (any ``Transport`` of the port), every served
    frame crosses it and is decoded on receipt.  Without it (the
    discrete-event simulator at 1M subscribers), frames are served by
    reference and only counted — they are the same immutable cache bytes
    either way."""

    def __init__(self, coord: Coordinator, *,
                 transport: Optional[Transport] = None):
        self.coord = coord
        self.transport = transport
        self._sub_vec: Dict[int, np.ndarray] = {}
        self.pulls = 0
        self.frames_served = 0
        self.bytes_served = 0

    @property
    def subscribers(self) -> int:
        return len(self._sub_vec)

    def pull(self, sub_id: int, params, *, round: int) -> PullStats:
        """One subscriber pull against the current ``params`` bus: send
        every chunk whose write version moved past the subscriber's
        vector (all of them on first contact), snapshot the vector, and
        account the serve.  Frames come out of the coordinator's
        content-addressed cache — a flash crowd of N subscribers behind
        one content change costs ONE encode and N serves."""
        coord = self.coord
        n = coord._refresh_bus(as_flat(params))
        vec = self._sub_vec.get(sub_id)
        if vec is None:
            changed = range(n)
        else:
            changed = np.flatnonzero(coord._bus_versions != vec).tolist()
        st = PullStats(fresh=vec is None)
        for i in changed:
            frame, fresh = coord._chunk_frame(i, round)
            if self.transport is not None:
                # prove the leg: the frame crosses the broker and must
                # decode clean (magic/version/length/crc) on receipt
                wire.decode(self.transport.recv(self.transport.send(frame)))
            st.frames += 1
            st.bytes += len(frame)
            if fresh:
                st.encoded_bytes += len(frame)
        self._sub_vec[sub_id] = coord._bus_versions
        self.pulls += 1
        self.frames_served += st.frames
        self.bytes_served += st.bytes
        return st

    def drop_subscriber(self, sub_id: int) -> None:
        """Forget a subscriber (its next pull is a full download)."""
        self._sub_vec.pop(sub_id, None)

    def reset(self) -> None:
        """Checkpoint restore: every subscriber re-pulls in full (the
        serving counters survive — they describe the whole process)."""
        self._sub_vec.clear()
