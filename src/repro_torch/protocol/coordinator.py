"""The Coordinator: one object that owns the VC protocol's state (port of
the plain-bus path of ``repro/protocol/coordinator.py``).

* **Lease lifecycle** — ``issue`` / ``expire`` / ``drop`` /
  ``assimilate``; every terminal transition consumes a lease exactly once
  and clears its reconstruction-base ref (``LeaseError`` on a double).
* **Error-feedback residual ledger** — per-client residual buffers on
  the bus's device plus running l2-norm totals, updated at submit and
  drop time, so ``residual_norm(cid)`` and ``residual_mass()`` are O(1)
  reads.
* **The wire, both legs** — every handout is encoded to one full-model
  dense frame (out of the content-addressed ``HandoutCache``), pushed
  through the ``Transport`` and decoded client-side, and the lease's base
  is rebuilt from the DECODED bytes (f32 round-trips exactly), moved back
  to the bus's device.  Every result is encoded (dense, or sparse for a
  compressed payload), sent, and decoded (magic/version/length/crc
  validated) before assimilation.

The port covers the float32 plain bus: bf16 handout frames and a sharded
bus (per-shard delta frames) raise ``NotImplementedError`` naming the
slice they come with.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import flat as F
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import (LEASE_ASSIMILATED, LEASE_DROPPED,
                                        LEASE_EXPIRED, LEASE_IN_FLIGHT,
                                        LEASE_ISSUED, Lease, LeaseError,
                                        ResultMeta, SchemeState, as_flat)
from repro_torch.transfer import wire
from repro_torch.transfer.handout_cache import HandoutCache
from repro_torch.transfer.transport import LoopbackTransport, Transport


class Coordinator:
    """Owns leases, the wire boundary, and the scheme state."""

    def __init__(self, scheme: ServerScheme, params0, *,
                 transport: Optional[Transport] = None,
                 timeout_s: float = math.inf,
                 handout_dtype: str = "float32"):
        if handout_dtype not in ("float32", "f32"):
            raise NotImplementedError(
                f"handout_dtype {handout_dtype!r}: only float32 handout "
                f"frames are ported; bf16 frames come with the "
                f"handout-serving slice")
        self.scheme = scheme
        self.state: SchemeState = scheme.init_state(as_flat(params0))
        self.transport: Transport = transport or LoopbackTransport()
        self.timeout_s = timeout_s
        self.leases: Dict[tuple, Lease] = {}        # (cid, uid) -> live lease
        # lease-deadline heap (deadline, dl_seq, key), validated lazily
        self._lease_heap: List = []
        self._seq = 0
        self._cid_leases: Dict[int, Dict[tuple, None]] = {}
        # error-feedback ledger: per-client residual buffer + running norms
        self._residuals: Dict[int, torch.Tensor] = {}
        self._res_norms: Dict[int, float] = {}
        self._res_norm_total = 0.0
        # download-leg ledger of the plain bus (ONE chunk): a monotone
        # write version bumped when the handout bytes change vs the cached
        # copy, so the frame cache encodes once per content change
        self._bus_version = 0
        self._bus_cache: Optional[np.ndarray] = None
        self._bus_src = None
        self.handout_cache = HandoutCache()
        self.handout_frames = 0
        self.handout_bytes = 0
        # upload-leg frame kinds, measured at delivery (same keys as the
        # reference; aggregate frames are not ported)
        self.frames = {wire.KIND_DENSE: 0, wire.KIND_SPARSE: 0,
                       wire.KIND_AGG: 0}
        self.assimilated = 0
        self.dropped = 0
        self.expired = 0

    # -- lease lifecycle -----------------------------------------------------

    def issue(self, *, cid: int, uid: int, round: int, shard: int = 0,
              read_version: int = 0, base, now: float = 0.0,
              deadline: Optional[float] = None) -> Lease:
        """Hand out params for one work unit.  The handout is encoded to a
        real frame, pushed through the transport and delivered right here
        (the caller IS the client): ``lease.handout_bytes`` is the
        measured transfer size and ``lease.base`` the decoded copy."""
        key = (cid, uid)
        if key in self.leases:
            raise LeaseError(f"lease {key} already live "
                             f"({self.leases[key].status})")
        fp = as_flat(self.scheme.handout(self.state, cid, as_flat(base)))
        lease = Lease(cid=cid, uid=uid, round=round, shard=shard,
                      read_version=read_version, base=fp, issued_at=now,
                      deadline=(now + self.timeout_s if deadline is None
                                else deadline))
        lease.base = self._deliver_handout(lease, fp)
        self.leases[key] = lease
        self._seq += 1
        lease._issue_seq = lease._dl_seq = self._seq
        try:
            if lease.deadline != math.inf:
                heapq.heappush(self._lease_heap,
                               (lease.deadline, self._seq, key))
            self._cid_leases.setdefault(cid, {})[key] = None
            self.scheme.on_issue(self.state, lease)
        except BaseException:
            # a half-issued lease must not outlive the failure as a live
            # registry entry
            self._terminate(lease, LEASE_DROPPED)
            raise
        return lease

    def _deliver_handout(self, lease: Lease, fp: F.FlatParams
                         ) -> F.FlatParams:
        """One full-model dense frame, always sent (the plain bus has no
        delta rule), encoded through the frame cache; the returned
        FlatParams is rebuilt from the decoded bytes on ``fp``'s device."""
        self._refresh_bus(fp)
        frame, _ = self._chunk_frame(lease.round)
        msg = wire.decode(self.transport.recv(self.transport.send(frame)))
        lease.handout_frames += 1
        lease.handout_bytes += len(frame)
        self.handout_frames += 1
        self.handout_bytes += len(frame)
        return F.FlatParams(msg.payload.to(fp.buf.device), fp.spec)

    def _refresh_bus(self, fp: F.FlatParams) -> None:
        """Sync the write version to the handout buffer's content (one
        device->host copy of the bus per new buffer; a reissued buffer
        skips the compare)."""
        if fp.buf is self._bus_src:
            return
        buf = fp.buf.detach().to("cpu").numpy()
        if (self._bus_cache is None or self._bus_cache.shape != buf.shape
                or self._bus_cache.dtype != buf.dtype):
            self._bus_version += 1
            self._bus_cache = buf.copy()
            self.handout_cache.reset()
        elif np.any(buf != self._bus_cache):
            self._bus_version += 1
            self._bus_cache[...] = buf
        self._bus_src = fp.buf

    def _chunk_frame(self, round: int):
        """The bus's dense frame out of the content-addressed cache —
        ``(frame, fresh)``; must follow ``_refresh_bus``."""
        return self.handout_cache.get(
            round=round, chunk=0, version=self._bus_version,
            data=self._bus_cache,
            encode=lambda: wire.encode_dense(self._bus_cache, round=round))

    def submit(self, lease: Lease, trained_buf: torch.Tensor) -> Lease:
        """Client finished local training: encode the payload (applying
        error feedback), push the frame through the transport, and record
        the wire stats on the lease.  The upload duration is the frame's
        REAL length."""
        if self._live(lease).status != LEASE_ISSUED:
            raise LeaseError(f"lease {lease.key} already submitted "
                             f"({lease.status})")
        payload, new_res = self.scheme.encode_payload(
            trained_buf, lease.base, self._residuals.get(lease.cid))
        # the header carries the POST-payload residual norm; the ledger is
        # committed only after the send succeeds, so a transport failure
        # leaves submit() all-or-nothing.  The norm accumulates in f64
        # and rounds once to f32; the reference's jnp.linalg.norm sums in
        # f32 in XLA's order, so the two may differ in the last bit or
        # two, which moves the header's 4-byte field and the crc, never
        # a frame's length.
        norm = (C.residual_norm(new_res)
                if new_res is not None else self.residual_norm(lease.cid))
        frame = wire.encode(payload, round=lease.round, residual_norm=norm)
        lease.msg_id = self.transport.send(frame)
        if new_res is not None:
            self._residuals[lease.cid] = new_res
            self._res_norm_total += norm - self._res_norms.get(lease.cid, 0.0)
            self._res_norms[lease.cid] = norm
        lease.frame_bytes = len(frame)
        lease.status = LEASE_IN_FLIGHT
        return lease

    def deliver(self, lease: Lease):
        """Take delivery of the lease's frame: recv (exactly once) +
        decode (magic/version/length/crc validated, so a torn transfer
        raises WireError and is never assimilated).  The payload — a
        dense buffer, or a sparse payload's three arrays — comes back on
        the server bus's device."""
        if self._live(lease).status != LEASE_IN_FLIGHT:
            raise LeaseError(f"nothing in flight for lease {lease.key} "
                             f"({lease.status})")
        msg = wire.decode(self.transport.recv(lease.msg_id))
        self.frames[msg.kind] += 1
        dev = self.state.params.buf.device
        if msg.kind == wire.KIND_SPARSE:
            p = msg.payload
            return p._replace(values=p.values.to(dev),
                              scales=p.scales.to(dev),
                              indices=p.indices.to(dev))
        return msg.payload.to(dev)

    def assimilate(self, lease: Lease, payload, *, server_version: int,
                   t_arrival: float = 0.0,
                   params_override: Optional[F.FlatParams] = None
                   ) -> SchemeState:
        """Fold one result into the server state and CONSUME the lease.
        ``params_override`` is the consistency-store snapshot the
        processing parameter server read."""
        self._live(lease)
        meta = ResultMeta(cid=lease.cid, unit_uid=lease.uid,
                          epoch=lease.round, shard=lease.shard,
                          read_version=lease.read_version,
                          server_version=server_version,
                          t_arrival=t_arrival, base=lease.base)
        if params_override is not None:
            self.state.params = params_override
        self.state = self.scheme.assimilate(self.state, payload, meta)
        self._unregister(lease)
        lease._release(LEASE_ASSIMILATED)
        self.assimilated += 1
        return self.state

    def _unregister(self, lease: Lease) -> None:
        del self.leases[lease.key]
        cid_map = self._cid_leases.get(lease.cid)
        if cid_map is not None:
            cid_map.pop(lease.key, None)

    def _terminate(self, lease: Lease, status: str) -> None:
        """The single discard path (drop and expire both end here)."""
        if lease.msg_id is not None:
            self.transport.drop(lease.msg_id)
        if self.leases.get(lease.key) is lease:
            self._unregister(lease)
            lease._release(status)
            if status == LEASE_EXPIRED:
                self.expired += 1
            else:
                self.dropped += 1

    def drop(self, lease: Lease) -> None:
        """Discard an in-flight result.  Idempotent."""
        self._terminate(lease, LEASE_DROPPED)

    def expire(self, now: float) -> List[Lease]:
        """Release every live lease past its deadline (BOINC timeout), in
        issue order.  O(1) per call when nothing is due."""
        heap = self._lease_heap
        out: List[Lease] = []
        while heap and heap[0][0] <= now:
            _, seq, key = heapq.heappop(heap)
            lease = self.leases.get(key)
            if lease is not None and getattr(lease, "_dl_seq", -1) == seq:
                out.append(lease)
        if out:
            out.sort(key=lambda l: l._issue_seq)
            for lease in out:
                self._terminate(lease, LEASE_EXPIRED)
        return out

    def drop_client(self, cid: int) -> None:
        """Preemption: scheme-local state is dropped, every lease held by
        the client is released, and the residual ledger forgets the
        client (the residual lived on the dead instance) — running norm
        total updated, never rescanned."""
        self.scheme.drop_client(self.state, cid)
        for key in list(self._cid_leases.get(cid, ())):
            self.drop(self.leases[key])
        if cid in self._res_norms:
            self._res_norm_total -= self._res_norms.pop(cid)
            self._residuals.pop(cid, None)

    def _live(self, lease: Lease) -> Lease:
        if self.leases.get(lease.key) is not lease:
            raise LeaseError(
                f"lease {lease.key} is not live (status={lease.status}): "
                f"assimilated/expired/dropped leases are consumed exactly "
                f"once")
        return lease

    # -- error-feedback ledger (O(1) reads) ----------------------------------

    def residual_norm(self, cid: int) -> float:
        """l2 norm of the residual ``cid`` carries after its latest
        payload (0.0 for uncompressed schemes)."""
        return self._res_norms.get(cid, 0.0)

    def residual_mass(self) -> float:
        """Running total of per-client residual norms — how much update
        mass is still in flight client-side across the fleet."""
        return self._res_norm_total

    @property
    def wire_stats(self):
        return self.transport.stats

    @property
    def in_flight(self) -> int:
        return len(self.leases)
