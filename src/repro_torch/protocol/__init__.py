"""VC protocol: the typed coordinator <-> scheme <-> transport boundary
(port of ``repro.protocol``).  ``Lease`` makes every handout explicit;
``Coordinator`` owns the lease lifecycle, the residual and version-vector
ledgers, the wire and the checkpoint hooks; ``Aggregator`` is the edge
tier in front of a hub Coordinator; ``HandoutService`` serves read-only
subscribers from a Coordinator's frame cache; ``ServerScheme`` is the
pure algorithm folded over typed ``SchemeState``."""
from repro_torch.protocol.aggregator import Aggregator
from repro_torch.protocol.coordinator import Coordinator
from repro_torch.protocol.handout import HandoutService, PullStats
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import (LEASE_ASSIMILATED, LEASE_DROPPED,
                                        LEASE_EXPIRED, LEASE_IN_FLIGHT,
                                        LEASE_ISSUED, Lease, LeaseError,
                                        ResultMeta, SchemeState, as_flat,
                                        as_tree, scheme_state)

__all__ = [
    "Aggregator", "Coordinator", "ServerScheme", "HandoutService",
    "PullStats", "Lease", "LeaseError", "ResultMeta",
    "SchemeState", "as_flat", "as_tree", "scheme_state",
    "LEASE_ISSUED", "LEASE_IN_FLIGHT", "LEASE_ASSIMILATED",
    "LEASE_DROPPED", "LEASE_EXPIRED",
]
