"""Typed vocabulary of the VC protocol (port of ``repro/protocol/types.py``):
``Lease`` (one explicit handout and its lifecycle), ``ResultMeta`` (the
assimilation context a scheme sees) and ``SchemeState`` (params on the
flat bus + version counter), plus the tree<->bus boundary coercions."""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional

from repro_torch.core import flat as F


def as_flat(params) -> F.FlatParams:
    """Coerce a tree onto the flat bus (no-op for FlatParams)."""
    return params if isinstance(params, F.FlatParams) else F.flatten(params)


def as_tree(params):
    """Inverse boundary: what clients/evaluators consume."""
    return F.unflatten(params) if isinstance(params, F.FlatParams) else params


class LeaseError(RuntimeError):
    """Protocol violation: acting on a lease that is not live (double
    assimilation, submit after expiry, duplicate issue)."""


# lease lifecycle: ISSUED -> IN_FLIGHT -> {ASSIMILATED | DROPPED | EXPIRED}
LEASE_ISSUED = "issued"            # handed out, client training
LEASE_IN_FLIGHT = "in-flight"      # result encoded and on the wire
LEASE_ASSIMILATED = "assimilated"  # consumed by the scheme (terminal)
LEASE_DROPPED = "dropped"          # result discarded (terminal)
LEASE_EXPIRED = "expired"          # deadline passed (terminal)

_TERMINAL = frozenset({LEASE_ASSIMILATED, LEASE_DROPPED, LEASE_EXPIRED})


@dataclass
class Lease:
    """One explicit parameter handout (cid, uid) with its full lifecycle.
    ``base`` (the exact FlatParams handed out, rebuilt from the decoded
    frame) is held while the lease is live; every terminal transition
    clears it."""

    cid: int
    uid: int
    round: int                        # work epoch; rides the wire header
    shard: int
    read_version: int                 # server version the client started from
    base: Optional[F.FlatParams]      # reconstruction-base ref
    issued_at: float
    deadline: float = math.inf
    status: str = LEASE_ISSUED
    # UPLOAD-leg wire stats, filled at submit time
    msg_id: Optional[int] = None
    frame_bytes: int = 0
    # DOWNLOAD-leg wire stats, filled at issue time
    handout_frames: int = 0
    handout_bytes: int = 0

    @property
    def key(self) -> tuple:
        return (self.cid, self.uid)

    @property
    def terminal(self) -> bool:
        return self.status in _TERMINAL

    @property
    def released(self) -> bool:
        return self.base is None

    def _release(self, status: str) -> None:
        self.status = status
        self.base = None


@dataclass
class ResultMeta:
    """Assimilation context for one arrived result (built by the
    Coordinator from the lease plus arrival-time facts)."""

    cid: int
    unit_uid: int
    epoch: int
    shard: int
    read_version: int          # server version the client started from
    server_version: int        # server version at assimilation time
    t_arrival: float = 0.0
    base: Optional[F.FlatParams] = None

    @property
    def staleness(self) -> int:
        return max(0, self.server_version - self.read_version)


@dataclass
class SchemeState:
    """Server state: params on the FlatParams bus + version counter."""

    params: F.FlatParams
    version: int = 0


def scheme_state(cls):
    """Register a SchemeState dataclass as a torch pytree node (as the
    reference registers its states with jax).  Fields named in
    ``cls._tree_fields`` (default: ``params``) are children; every other
    field is carried as context by reference (version counters, slot
    maps)."""
    import torch.utils._pytree as pytree
    tree_names = tuple(getattr(cls, "_tree_fields", ("params",)))
    aux_names = tuple(f.name for f in fields(cls) if f.name not in tree_names)

    def _flatten(s):
        return ([getattr(s, n) for n in tree_names],
                tuple(getattr(s, n) for n in aux_names))

    def _unflatten(children, aux):
        obj = object.__new__(cls)
        for n, v in zip(tree_names, children):
            object.__setattr__(obj, n, v)
        for n, v in zip(aux_names, aux):
            object.__setattr__(obj, n, v)
        return obj

    pytree.register_pytree_node(cls, _flatten, _unflatten)
    return cls
