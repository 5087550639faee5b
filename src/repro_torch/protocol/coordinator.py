"""The Coordinator: one object that owns the VC protocol's state (port of
``repro/protocol/coordinator.py``).

* **Lease lifecycle** — ``issue`` / ``renew`` / ``expire`` / ``drop`` /
  ``assimilate``; every terminal transition consumes a lease exactly once
  and clears its reconstruction-base ref (``LeaseError`` on a double).
* **Error-feedback residual ledger** — per-client residual buffers on
  the bus's device plus running l2-norm totals, updated at submit and
  drop time, so ``residual_norm(cid)`` and ``residual_mass()`` are O(1)
  reads.
* **The wire, both legs** — every handout is encoded to real frames out
  of the content-addressed ``HandoutCache``, pushed through the
  ``Transport`` and decoded client-side, and the lease's base is rebuilt
  from the DECODED bytes, moved back to the bus's device.  A plain bus
  ships one full-model dense frame; a ``ShardedTreeSpec`` bus ships one
  frame per segment whose write version moved past the client's version
  vector (delta handouts).  Frames are f32, or bf16 with
  ``handout_dtype="bfloat16"`` (f32 masters; the client holds the bf16
  image).  Every result is encoded (dense, sparse for a compressed
  payload, or an aggregator's merged frame), sent, and decoded
  (magic/version/length/crc validated) before assimilation.
* **Checkpoint hooks** — the server copy is the only state that must
  survive (clients are disposable by design): ``save_checkpoint`` /
  ``restore_checkpoint`` snapshot (params, version) through the
  checkpoint manager's one-pass flat record.

The bus's write-version ledger lives on the host: a new bus buffer costs
one device->host copy, and a buffer seen before (identity check on
``_bus_src``) costs none, however many handouts or subscriber pulls read
it.
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

# download-leg frame dtypes: f32 masters always; "bfloat16" ships
# half-width frames and the client holds the bf16 image of the master
_HANDOUT_DTYPES = {"float32": "float32", "f32": "float32",
                   "bfloat16": "bfloat16", "bf16": "bfloat16"}


class Coordinator:
    """Owns leases, the wire boundary, and the scheme state."""

    def __init__(self, scheme: ServerScheme, params0, *,
                 transport: Optional[Transport] = None,
                 timeout_s: float = math.inf,
                 handout_dtype: str = "float32"):
        self.scheme = scheme
        self.state: SchemeState = scheme.init_state(as_flat(params0))
        self.transport: Transport = transport or LoopbackTransport()
        self.timeout_s = timeout_s
        try:
            self.handout_dtype = _HANDOUT_DTYPES[handout_dtype]
        except KeyError:
            raise ValueError(f"handout_dtype {handout_dtype!r} not in "
                             f"{sorted(_HANDOUT_DTYPES)}") from None
        self.leases: Dict[tuple, Lease] = {}        # (cid, uid) -> live lease
        # lease-deadline heap (deadline, dl_seq, key), validated lazily
        self._lease_heap: List = []
        self._seq = 0
        self._cid_leases: Dict[int, Dict[tuple, None]] = {}
        # error-feedback ledger: per-client residual buffer + running norms
        self._residuals: Dict[int, torch.Tensor] = {}
        self._res_norms: Dict[int, float] = {}
        self._res_norm_total = 0.0
        # download-leg ledger (version vector): one monotone u32 write
        # version per bus chunk (`_bus_versions`, bumped when the chunk's
        # bytes change vs the host copy `_bus_cache`); each client holds
        # the vector of its last handout (`_client_vec`, shared by
        # reference: the ledger copies on write).  `_bus_src` is the last
        # buffer seen, so a handout of the SAME buffer skips the copy and
        # the compare.  A content revert (A->B->A) costs a spurious
        # re-send, never a missed one.
        self._bus_versions: Optional[np.ndarray] = None
        self._bus_cache: Optional[np.ndarray] = None
        self._bus_src = None
        self._chunk_len = 0
        self._client_vec: Dict[int, np.ndarray] = {}
        self.handout_cache = HandoutCache()
        self.handout_frames = 0
        self.handout_bytes = 0
        # upload-leg frame kinds, measured at delivery; also the allow-list
        # of the upload leg (a handout kind there is refused by deliver)
        self.frames = {wire.KIND_DENSE: 0, wire.KIND_SPARSE: 0,
                       wire.KIND_AGG: 0}
        self.assimilated = 0
        self.dropped = 0
        self.expired = 0
        # extra dict of the checkpoint restore_checkpoint() last loaded
        self.restored_extra: Dict = {}

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
        """Put the handout on the wire and take client-side delivery; the
        returned FlatParams is rebuilt from the DECODED bytes on ``fp``'s
        device.

        A plain bus ships one full-model dense frame, always (no delta
        rule at chunk count 1).  Over a ``ShardedTreeSpec`` bus only the
        segments whose write version moved past the client's version
        vector are sent (a fresh client gets all of them), and the client
        patches them into its held copy.  Invariant: ``client_vec[i] ==
        bus_versions[i]`` iff the client's held segment ``i`` equals the
        cached bus segment, so the unchanged segments ARE the cache's (or
        its bf16 image's) bytes.  Every frame comes out of
        ``handout_cache``: encoded at most once per (round, chunk,
        write version)."""
        spec = fp.spec
        n = self._refresh_bus(fp)
        bf16 = self.handout_dtype == "bfloat16"
        dev = fp.buf.device
        if n == 1:
            frame, _ = self._chunk_frame(0, lease.round)
            msg = wire.decode(self.transport.recv(self.transport.send(frame)))
            lease.handout_frames += 1
            lease.handout_bytes += len(frame)
            self.handout_frames += 1
            self.handout_bytes += len(frame)
            return F.FlatParams(msg.payload.to(torch.float32).to(dev), spec)
        vec = self._client_vec.get(lease.cid)
        if vec is None:
            changed = range(n)                  # fresh client: full download
        else:
            changed = np.flatnonzero(self._bus_versions != vec).tolist()
        held = torch.from_numpy(self._bus_cache.copy())
        if bf16:
            held = held.to(torch.bfloat16).to(torch.float32)
        for i in changed:
            lo, hi = spec.shard_bounds(i)
            frame, _ = self._chunk_frame(i, lease.round)
            msg = wire.decode(self.transport.recv(self.transport.send(frame)))
            held[lo:hi] = msg.payload.to(torch.float32)
            lease.handout_frames += 1
            lease.handout_bytes += len(frame)
        self.handout_frames += lease.handout_frames
        self.handout_bytes += lease.handout_bytes
        self._client_vec[lease.cid] = self._bus_versions
        return F.FlatParams(held.to(dev), spec)

    def _refresh_bus(self, fp: F.FlatParams) -> int:
        """Sync the write-version ledger to the handout buffer's content
        and return the chunk count: the bus shards over a
        ``ShardedTreeSpec`` bus, else ONE chunk (versioned the same way,
        so subscribers get the delta rule even then).  A new buffer costs
        one device->host copy and one vectorized per-chunk compare; the
        buffer seen last costs nothing.  The bump is content-driven, so
        WHEN this runs never changes which frames anyone is sent."""
        spec = fp.spec
        sharded = (isinstance(spec, F.ShardedTreeSpec) and spec.n_shards > 1)
        n = spec.n_shards if sharded else 1
        length = spec.shard_len if sharded else int(fp.buf.shape[0])
        if (self._bus_versions is None or len(self._bus_versions) != n
                or self._chunk_len != length):
            self._bus_versions = np.ones(n, np.uint32)
            self._bus_cache = fp.buf.detach().to("cpu").numpy().copy()
            self._bus_src = fp.buf
            self._chunk_len = length
            self._client_vec.clear()            # stale vectors: wrong shape
            self.handout_cache.reset()          # chunk meaning changed
        elif fp.buf is not self._bus_src:
            buf = fp.buf.detach().to("cpu").numpy()
            cache2d = self._bus_cache.reshape(n, length)
            buf2d = buf.reshape(n, length)
            moved = np.any(buf2d != cache2d, axis=1)
            if moved.any():
                # copy on write: vectors already handed out stay intact
                self._bus_versions = self._bus_versions.copy()
                self._bus_versions[moved] += 1
                cache2d[moved] = buf2d[moved]
            self._bus_src = fp.buf
        return n

    def _chunk_frame(self, i: int, round: int):
        """Chunk ``i``'s frame out of the content-addressed cache —
        ``(frame, fresh)``, encoded iff (round, chunk, write version) was
        never served before.  Must follow ``_refresh_bus``."""
        n = len(self._bus_versions)
        lo, hi = i * self._chunk_len, (i + 1) * self._chunk_len
        seg = self._bus_cache[lo:hi]

        def encode() -> bytes:
            out = torch.from_numpy(seg)
            if self.handout_dtype == "bfloat16":
                out = out.to(torch.bfloat16)
            if n == 1:
                return wire.encode_dense(out, round=round)
            return wire.encode_shard(out, shard=i, n_shards=n, round=round)

        return self.handout_cache.get(round=round, chunk=i,
                                      version=int(self._bus_versions[i]),
                                      data=seg, encode=encode)

    def renew(self, lease: Lease, deadline: float) -> Lease:
        """Extend a live lease's deadline (client asked for more time).
        The old heap entry dies lazily: its seq no longer matches the
        lease's ``_dl_seq``.  An infinite deadline needs no entry."""
        self._live(lease)
        lease.deadline = deadline
        self._seq += 1
        lease._dl_seq = self._seq
        if deadline != math.inf:
            heapq.heappush(self._lease_heap, (deadline, self._seq, lease.key))
        return lease

    def submit(self, lease: Lease, trained_buf: torch.Tensor) -> Lease:
        """Client finished local training: encode the payload (applying
        error feedback), push the frame through the transport, and record
        the wire stats on the lease.  The upload duration is the frame's
        REAL length."""
        if self._live(lease).status != LEASE_ISSUED:
            raise LeaseError(f"lease {lease.key} already submitted "
                             f"({lease.status})")
        if isinstance(trained_buf, wire.AggregatePayload):
            # aggregation tier: the payload is already assimilated — the
            # edge ran the scheme's encode and the residual ledger on its
            # own downward leg
            payload, new_res = trained_buf, None
        else:
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
        dense buffer, a sparse payload's three arrays, or an aggregate's
        merged buffer and weight — comes back on the server bus's device.
        A handout kind (KIND_SHARD) is never valid here: the lease is
        dropped (the recv consumed its frame) and WireError raised."""
        if self._live(lease).status != LEASE_IN_FLIGHT:
            raise LeaseError(f"nothing in flight for lease {lease.key} "
                             f"({lease.status})")
        msg = wire.decode(self.transport.recv(lease.msg_id))
        if msg.kind not in self.frames:
            self._unregister(lease)
            lease._release(LEASE_DROPPED)
            self.dropped += 1
            raise wire.WireError(
                f"frame kind {msg.kind} invalid on the upload leg "
                f"(lease {lease.key} dropped)")
        self.frames[msg.kind] += 1
        dev = self.state.params.buf.device
        if msg.kind == wire.KIND_AGG:
            return wire.AggregatePayload(msg.payload.to(dev), msg.weight)
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
        if isinstance(payload, wire.AggregatePayload):
            # an edge aggregator's merged frame: W' = M + (1-w)(W - B),
            # B the lease base (already on the meta)
            self.state = self.scheme.assimilate_aggregate(
                self.state, payload, meta)
        else:
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
        the client is released, and the residual and version-vector
        ledgers forget the client (both lived on the dead instance: a
        respawned client re-downloads in full) — running norm total
        updated, never rescanned."""
        self.scheme.drop_client(self.state, cid)
        for key in list(self._cid_leases.get(cid, ())):
            self.drop(self.leases[key])
        if cid in self._res_norms:
            self._res_norm_total -= self._res_norms.pop(cid)
            self._residuals.pop(cid, None)
        self._client_vec.pop(cid, None)

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

    # -- checkpoint hooks ----------------------------------------------------

    def save_checkpoint(self, manager, step: int,
                        extra: Optional[Dict] = None) -> None:
        """Snapshot (server params, version) through the manager's
        one-pass flat record.  Leases and residuals are not persisted:
        in-flight work is disposable, and a restarted coordinator
        reissues it."""
        manager.save_server(step, self.state.params, self.state.version,
                            extra=extra)

    def restore_checkpoint(self, manager) -> Optional[int]:
        """Resume (params, version) from the newest server checkpoint, on
        the bus's device.  Returns its step, or None (state untouched)
        when there is none.  Every live lease is dropped and the residual
        ledger cleared (mass gathered after the checkpoint must not enter
        the restored params); the scheme state is rebuilt by
        ``init_state`` from the restored params, never patched, so a
        replica scheme tiles its replicas from the restored center.  The
        checkpoint's ``extra`` lands in ``restored_extra``."""
        step = manager.latest_step()
        if step is None:
            return None
        for lease in list(self.leases.values()):
            self.drop(lease)
        self._lease_heap.clear()
        self._residuals.clear()
        self._res_norms.clear()
        self._res_norm_total = 0.0
        params, version, extra, _ = manager.restore_server_or_init(
            self.state.params, lambda: None)
        self.state = self.scheme.init_state(params)
        self.state.version = version
        self.restored_extra = dict(extra)
        # every client re-downloads in full (bus versions stay monotone)
        self._client_vec.clear()
        # frames embed their round; a resumed server may reissue rounds
        self.handout_cache.reset()
        return step

    @property
    def wire_stats(self):
        return self.transport.stats

    @property
    def in_flight(self) -> int:
        return len(self.leases)
