"""VC protocol: the typed coordinator <-> scheme <-> transport boundary
(port of ``repro.protocol``'s plain-bus path)."""
from repro_torch.protocol.coordinator import Coordinator
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import (LEASE_ASSIMILATED, LEASE_DROPPED,
                                        LEASE_EXPIRED, LEASE_IN_FLIGHT,
                                        LEASE_ISSUED, Lease, LeaseError,
                                        ResultMeta, SchemeState, as_flat,
                                        as_tree)

__all__ = [
    "Coordinator", "ServerScheme", "Lease", "LeaseError", "ResultMeta",
    "SchemeState", "as_flat", "as_tree",
    "LEASE_ISSUED", "LEASE_IN_FLIGHT", "LEASE_ASSIMILATED",
    "LEASE_DROPPED", "LEASE_EXPIRED",
]
