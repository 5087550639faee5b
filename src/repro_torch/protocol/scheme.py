"""The ServerScheme contract (port of ``repro/protocol/scheme.py``): the
scheme is algorithm only — fold a payload into ``SchemeState`` — while
the Coordinator owns leases, the wire and the transport.  ``assimilate``
may mutate ``state`` in place but must return it; callers rebind."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.protocol.types import Lease, ResultMeta, SchemeState, as_flat


class ServerScheme:
    """Stateless-client contract: a client downloads the lease's base
    params, trains on its shard, uploads a payload; the server
    assimilates payloads in arrival order.  Dropping any subset of leases
    leaves the server state valid."""

    name = "base"
    # descriptive metadata (not read by the Coordinator — handout() is
    # always consulted): schemes that assume every client reports each
    # round are not fault tolerant, and schemes with client-local
    # replicas substitute them for the server snapshot at handout
    requires_all_clients = False    # True -> not fault tolerant (BSP/EASGD-p)
    has_local_replicas = False      # True -> handout substitutes local state

    # -- server-side core ---------------------------------------------------
    def init_state(self, params0) -> SchemeState:
        return SchemeState(params=as_flat(params0))

    def handout(self, state: SchemeState, cid: int,
                default: F.FlatParams) -> F.FlatParams:
        """Params for a new lease to ``cid`` (``default`` is the store
        snapshot the client would download)."""
        return default

    def on_issue(self, state: SchemeState, lease: Lease) -> None:
        """Hook: a lease was issued."""

    def params_for_client(self, state: SchemeState,
                          cid: Optional[int] = None) -> F.FlatParams:
        """What ``cid`` would be handed without a Coordinator: the server
        params, or ``handout``'s substitute for a replica scheme."""
        if cid is None:
            return state.params
        return self.handout(state, cid, state.params)

    def assimilate(self, state: SchemeState, payload,
                   meta: ResultMeta) -> SchemeState:
        raise NotImplementedError

    def on_epoch(self, state: SchemeState, epoch: int) -> None:
        pass

    # -- aggregation tier (protocol/aggregator.py) --------------------------
    def assimilation_retention(self, meta: ResultMeta) -> float:
        """Fraction of the pre-update server mass ``assimilate`` RETAINS
        when folding ONE result (VC-ASGD: its effective alpha).  The tier
        multiplies it across a flush window: the merged frame's summed
        client weight is ``1 - prod(retention_i)``.  Default 1.0: a
        pure-delta scheme adds to the server copy without discounting it."""
        return 1.0

    def assimilate_aggregate(self, state: SchemeState, payload,
                             meta: ResultMeta) -> SchemeState:
        """Fold ONE merged aggregate frame from an edge aggregator:
        ``payload`` is a ``wire.AggregatePayload`` whose buf M is the
        edge's fold state (seeded from the upstream lease base B,
        ``meta.base``) and whose weight w is ``1 - prod(retention)``::

            W' = M + (1 - w) * (W - B)

        When the hub has not moved since the window opened (W == B
        bitwise) the correction is exactly zero and the hub adopts M bit
        for bit.  ``keep`` is formed once in f32, and the multiply and the
        add are separate ops (no FMA), as the reference's numpy and jnp
        forms compute it."""
        fp = state.params
        base = meta.base.buf if meta.base is not None else fp.buf
        m = self._payload_buf(fp, payload.buf)
        keep = float(np.float32(1.0) - np.float32(payload.weight))
        f32 = torch.float32
        out = m.to(f32) + keep * (fp.buf.to(f32) - base.to(f32))
        state.params = fp.with_buf(out.to(fp.buf.dtype))
        state.version += 1
        return state

    def drop_client(self, state: SchemeState, cid: int) -> None:
        """Preemption hook: schemes with client-local state lose it here."""

    # -- client-side core ---------------------------------------------------
    def encode_payload(self, trained_buf: torch.Tensor, base: F.FlatParams,
                       residual: Optional[torch.Tensor]
                       ) -> Tuple[Any, Optional[torch.Tensor]]:
        """What travels client -> server: ``(payload, new_residual)``, a
        pure function of the trained buffer, the lease base and the
        error-feedback residual the Coordinator carries for the client.
        A buffer ships as a dense frame, a ``CompressedDelta`` as a
        sparse one.  Default: the full trained buffer, no error
        feedback."""
        return trained_buf, None

    # -- shared helper ------------------------------------------------------
    @staticmethod
    def _payload_buf(fp: F.FlatParams, payload) -> torch.Tensor:
        """A payload still in tree form is flattened exactly once here;
        flat payloads pass through untouched."""
        if isinstance(payload, F.FlatParams):
            return payload.buf
        if isinstance(payload, torch.Tensor):
            return payload
        return F.flatten_like(payload, fp.spec)
