"""Execution plan of the models (port of ``repro/models/plan.py``).

``NullPlan`` carries the reference's fields.  Its forms that change what
is computed, not only where, run on one device: contiguous-chunk context
parallelism (``attn_mode="cp"``, ``cp`` chunks, the SWA layers gathering
only neighbour kv chunks when ``window_gather``) and the expert-parallel
MoE dispatch (``moe_ep``, ``ep`` source groups with a capacity each).
``"head_tp"`` computes what ``"local"`` computes on one device.  ``act``
is the identity.  The mesh plan (``runtime/sharding.py::MeshPlan``, a
``NullPlan`` with a mesh and its parameter, activation and cache specs)
is ported as data; the models take one whose mesh has one position, and
``require_one_card_plan`` refuses one over several (its layouts across
cards wait in ROADMAP queue A item 2b).
"""
from __future__ import annotations

import math
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
    """Raise unless ``plan`` runs on one device: a ``NullPlan``, or a mesh
    plan (a ``NullPlan`` with a ``mesh``) whose mesh has one position.  A
    mesh plan over several positions needs its layouts applied across
    cards, which is not ported (ROADMAP queue A item 2b); its computing
    fields run on one card as ``plan.one_card_plan()``."""
    if not isinstance(plan, NullPlan):
        raise NotImplementedError(
            f"{type(plan).__name__}: the models take a NullPlan (local, "
            f"head_tp, cp, moe_ep), or one of the mesh plans over one mesh "
            f"position")
    mesh = getattr(plan, "mesh", None)
    if mesh is not None:
        n = math.prod(mesh.axis_sizes)
        if n != 1:
            raise NotImplementedError(
                f"{type(plan).__name__} over a mesh of {n} positions "
                f"{dict(mesh.shape)}: the mesh plans' layouts across cards "
                f"are not ported (ROADMAP queue A item 2b); run its computing "
                f"fields on one card with plan.one_card_plan()")
