"""Execution plan of the models (port of ``repro/models/plan.py``).

``NullPlan`` carries the reference's fields.  Its forms that change what
is computed, not only where, run on one device: contiguous-chunk context
parallelism (``attn_mode="cp"``, ``cp`` chunks, the SWA layers gathering
only neighbour kv chunks when ``window_gather``) and the expert-parallel
MoE dispatch (``moe_ep``, ``ep`` source groups with a capacity each).
``"head_tp"`` computes what ``"local"`` computes on one device.  ``act``
is the identity: the layouts of the mesh plans (``MeshPlan``: parameter,
activation and cache specs over several cards) are not ported, and the
port's entry points refuse any plan that is not a ``NullPlan``
(``require_one_card_plan``).
"""
from __future__ import annotations

from dataclasses import dataclass

ATTN_MODES = ("local", "head_tp", "cp")


@dataclass
class NullPlan:
    # attention execution mode: "local" (replicated heads), "head_tp"
    # (heads sharded over the model axis: "local" on one device), "cp"
    # (contiguous-chunk context parallelism)
    attn_mode: str = "local"
    cp: int = 1                 # CP chunk count
    cache_chunks: int = 1       # decode-cache old-tier chunk count
    window_gather: bool = True  # SWA layers gather only neighbour kv chunks
    moe_ep: bool = False        # expert-parallel MoE dispatch (train/prefill)
    ep: int = 1                 # EP degree: source groups of the batch

    def __post_init__(self):
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, got "
                             f"{self.attn_mode!r}")
        for name in ("cp", "cache_chunks", "ep"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")

    def act(self, x, kind: str):
        """Sharding-constraint hook: the identity on one device."""
        return x


NULL_PLAN = NullPlan()


def require_one_card_plan(plan) -> None:
    """Raise unless ``plan`` is a ``NullPlan``: the one-card forms are
    ported, the mesh plans' layouts over several cards are not (ROADMAP
    queue A item 2b)."""
    if not isinstance(plan, NullPlan):
        raise NotImplementedError(
            f"{type(plan).__name__}: only the one-card plans (NullPlan: "
            f"local, head_tp, cp, moe_ep) are ported; the mesh plans' "
            f"layouts over several cards wait in ROADMAP queue A item 2b")
