"""The edge aggregator (port of ``repro/protocol/aggregator.py``): the
hierarchical tier that breaks the single-coordinator ceiling.

An ``Aggregator`` speaks the Lease/Coordinator protocol in BOTH
directions:

* **downward** it IS a Coordinator — it issues leases to its clients with
  the same wire frames on both legs (per-shard delta handouts, dense /
  sparse result uploads), the same residual ledger, the same lifecycle
  (issue / renew / submit / deliver / expire / drop / drop_client) — all
  inherited, not reimplemented;
* **upward** it is a CLIENT of the hub: it holds ONE lease per flush
  window, pre-assimilates its clients' payloads into a transient fold
  state, and at flush submits that merged state plus the summed client
  weight upstream as ONE ``KIND_AGG`` v3 frame.

Bit-identity is by construction, not by algebra: the fold state is seeded
from the upstream lease's DECODED base (bit-identical to the hub copy at
issue) and each arriving payload is folded with the scheme's own
per-arrival ``assimilate`` — the identical float op sequence a flat hub
would execute on the same arrivals.  The merged frame's ``weight`` is
``1 - prod(retention_i)`` (``ServerScheme.assimilation_retention``); the
hub folds the frame with ``assimilate_aggregate``:
``W' = M + (1 - w) * (W - B)``, which reduces to adopting M exactly when
the hub hasn't moved since the window opened (W == B), and otherwise
scales the hub's interim progress by the merge's retained server mass.

On the card each per-arrival fold is the scheme's own kernel (B1 for
VC-ASGD), and the merged frame's body crosses to the host once, at
flush.

Failure model: the aggregator owns NO durable scheme state — only the
per-window fold.  Losing an entire aggregator (``fail()``) therefore
releases its clients' leases, its residual ledger, and its upstream
lease; the hub reissues the window and nothing leaks.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

from repro_torch.protocol.coordinator import Coordinator
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import Lease, LeaseError, ResultMeta
from repro_torch.transfer import wire
from repro_torch.transfer.transport import Transport


class Aggregator(Coordinator):
    """A Coordinator whose scheme state is a transient per-window fold,
    with an upstream client face toward a hub Coordinator."""

    def __init__(self, scheme: ServerScheme, hub: Coordinator, *,
                 agg_id: int, transport: Optional[Transport] = None,
                 timeout_s: float = math.inf,
                 handout_dtype: str = "float32"):
        if scheme.requires_all_clients:
            raise ValueError(
                f"scheme {scheme.name!r} requires every client each round "
                f"(barrier/persistent-replica semantics) — partial edge "
                f"merges cannot represent it")
        # the downward face is a full Coordinator over the EDGE transport;
        # the construction-time state is a placeholder — every window
        # reseeds it from the upstream lease's decoded base.  The edge
        # inherits the whole download leg: content-addressed frame cache
        # and the (optional) bf16 handout dtype included.
        super().__init__(scheme, hub.state.params, transport=transport,
                         timeout_s=timeout_s, handout_dtype=handout_dtype)
        self.hub = hub
        self.agg_id = agg_id
        self.up_lease: Optional[Lease] = None
        self.window_retention = 1.0     # prod of per-fold retentions
        self.window_merged = 0          # results folded this window
        self.flushes = 0                # merged frames shipped upstream
        self._window_uid = itertools.count()

    # -- upstream face -------------------------------------------------------

    def open_window(self, *, round: int, now: float = 0.0, base=None,
                    read_version: Optional[int] = None,
                    deadline: Optional[float] = None) -> Lease:
        """Take a fresh upstream lease from the hub and seed the window's
        fold state from its DECODED base — the bit-exact hub copy the
        flush will be corrected against.  ``base`` defaults to the hub's
        live params (a caller with a consistency store passes its
        snapshot)."""
        if self.up_lease is not None:
            raise LeaseError(
                f"aggregator {self.agg_id} already holds upstream lease "
                f"{self.up_lease.key} — flush or fail first")
        if base is None:
            base = self.hub.state.params
        rv = self.hub.state.version if read_version is None else read_version
        self.up_lease = self.hub.issue(
            cid=self.agg_id, uid=next(self._window_uid), round=round,
            read_version=rv, base=base, now=now, deadline=deadline)
        try:
            # transient fold state: the aggregator owns no durable scheme
            # state, so a lost window costs exactly one window of results
            self.state = self.scheme.init_state(self.up_lease.base)
        except BaseException:
            # a failed seed must not wedge the aggregator holding a live
            # upstream lease no open_window() could ever replace
            lease, self.up_lease = self.up_lease, None
            self.hub.drop(lease)
            raise
        self.window_retention = 1.0
        self.window_merged = 0
        return self.up_lease

    def assimilate(self, lease: Lease, payload, *, server_version: int,
                   t_arrival: float = 0.0, params_override=None):
        """Fold one downstream result into the window — the scheme's own
        per-arrival ``assimilate`` (inherited), plus the retention
        product that becomes the merged frame's summed weight."""
        if self.up_lease is None:
            raise LeaseError(
                f"aggregator {self.agg_id} has no open window "
                f"(open_window before folding)")
        meta = ResultMeta(cid=lease.cid, unit_uid=lease.uid,
                          epoch=lease.round, shard=lease.shard,
                          read_version=lease.read_version,
                          server_version=server_version)
        retention = self.scheme.assimilation_retention(meta)
        state = super().assimilate(lease, payload,
                                   server_version=server_version,
                                   t_arrival=t_arrival,
                                   params_override=params_override)
        self.window_retention *= retention
        self.window_merged += 1
        return state

    def flush(self, now: float = 0.0) -> Optional[Lease]:
        """Close the window: submit the fold state M plus the summed
        client weight ``1 - prod(retention)`` upstream as ONE v3
        aggregate frame under the window's lease, leaving it IN_FLIGHT
        for the hub to deliver/assimilate.  A window that folded nothing
        drops its upstream lease instead (an empty merge must never count
        as a result) and returns None."""
        up, self.up_lease = self.up_lease, None
        if up is None:
            raise LeaseError(f"aggregator {self.agg_id} has no open window")
        if self.window_merged == 0:
            self.hub.drop(up)
            return None
        weight = 1.0 - self.window_retention
        self.hub.submit(up, wire.AggregatePayload(self.state.params.buf,
                                                  weight))
        self.flushes += 1
        return up

    def fail(self) -> None:
        """The whole edge dies (spot reclaim of the aggregator node):
        every downstream client's leases AND residual release, and the
        hub reclaims the upstream lease exactly as it would any client's
        — the no-leak guarantee one level up."""
        for cid in list(self._cid_leases):
            self.drop_client(cid)
        # residuals of clients with no live lease still die with the node
        for cid in list(self._res_norms):
            self.drop_client(cid)
        self._client_vec.clear()
        self.hub.drop_client(self.agg_id)
        self.up_lease = None

    # -- introspection -------------------------------------------------------

    @property
    def window_open(self) -> bool:
        return self.up_lease is not None
