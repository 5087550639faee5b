"""The ServerScheme contract (port of ``repro/protocol/scheme.py``): the
scheme is algorithm only — fold a payload into ``SchemeState`` — while
the Coordinator owns leases, the wire and the transport.  ``assimilate``
may mutate ``state`` in place but must return it; callers rebind."""
from __future__ import annotations

from typing import Any, Optional, Tuple

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
