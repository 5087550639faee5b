"""Execution plan of the models: the port runs on one card, so only the
reference's ``NullPlan`` in ``"local"`` mode exists here.  The mesh plans
(head-sharded or context-parallel attention, expert parallelism) wait for
the pod runtime's slice; asking for one raises."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NullPlan:
    attn_mode: str = "local"
    cp: int = 1                 # CP chunk count
    cache_chunks: int = 1       # decode-cache old-tier chunk count

    def __post_init__(self):
        if self.attn_mode != "local" or self.cp != 1:
            raise NotImplementedError(
                f"only the single-card plan (attn_mode='local', cp=1) is "
                f"ported, got {self}; the mesh plans wait in ROADMAP "
                f"queue A ('Mesh plans and the sharded forms')")
        if self.cache_chunks < 1:
            raise ValueError(f"cache_chunks must be >= 1, got "
                             f"{self.cache_chunks}")


NULL_PLAN = NullPlan()
