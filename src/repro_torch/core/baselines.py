"""Server parameter-update schemes (port of ``repro/core/baselines.py``):
VC-ASGD plus every baseline the paper discusses (§II-B, §III-C), on the
typed protocol API.  ``state.params`` rides the flat bus, so every
update is one pass over the whole model.  Each scheme keeps the
reference's operation order, so the CPU path is bit-identical to the
reference's jnp path and the card is bit-identical to the CPU.

* VC-ASGD    — Eq. 1 lerp per arriving result; alpha schedule per epoch
               (one B1 launch on the card).
* CompressedVCASGD — VC-ASGD whose upload is the ``compress_flat`` sparse
               delta with error feedback (B9/B10 quantize/dequantize, B12
               packs the sparse frame).
* Downpour   — the server adds each client's delta (Dean et al.).
* DC-ASGD    — Downpour + diagonal-Hessian delay compensation (Zheng).
* EASGD      — elastic averaging: persistent per-client replicas, or the
               pod form with all replicas in one matrix and one fused
               elastic round per barrier (B5).
* SyncBSP    — barriered weight averaging per round.

Downpour, DC-ASGD, persistent EASGD and the SyncBSP mean stay PyTorch
elementwise ops, as the reference leaves them to XLA outside any Pallas
kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import flat as F
from repro_torch.core import vc_asgd as V
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import f32
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import Lease, ResultMeta, SchemeState, as_flat

__all__ = [
    "VCASGD", "CompressedVCASGD", "Downpour", "DCASGD", "EASGDPersistent",
    "EASGDFlatPod", "SyncBSP", "easgd_elastic_update",
    "DCASGDState", "EASGDState", "PodState", "BSPState",
]


def easgd_elastic_update(center_buf: torch.Tensor,
                         replicas_buf: torch.Tensor, beta: float):
    """One fused elastic round over the whole pod: center [N] and replicas
    [n, N] move toward each other in a single pass — one kernel launch on
    the card, the plain version on the CPU."""
    return K.fused_easgd_flat(center_buf, replicas_buf, beta)


def _reconstruct(payload, meta: ResultMeta, fp: F.FlatParams):
    """A sparse payload becomes the client's weights: the lease's
    reconstruction base plus the dequantized delta."""
    if isinstance(payload, C.CompressedDelta):
        base = meta.base.buf if meta.base is not None else fp.buf
        return base + C.decompress_flat(payload)
    return payload


class VCASGD(ServerScheme):
    def __init__(self, alpha: float | Callable[[int], float] = 0.95,
                 staleness_gamma: Optional[float] = None):
        self.alpha = alpha if callable(alpha) else V.const_alpha(alpha)
        self.staleness_gamma = staleness_gamma
        self.name = "vc-asgd"

    def assimilate(self, state, payload, meta: ResultMeta):
        a = self.alpha(meta.epoch)
        if self.staleness_gamma is not None:
            a = V.staleness_alpha(a, meta.staleness, self.staleness_gamma)
        fp = state.params
        c_buf = self._payload_buf(fp, payload)
        state.params = V.vc_asgd_update_flat(fp, c_buf, a)
        state.version += 1
        return state


class CompressedVCASGD(VCASGD):
    """VC-ASGD whose client -> server payload is the ``compress_flat``
    sparse delta (global top-k + int8 with error feedback) that rides the
    wire as a SPARSE frame.  ``encode_payload`` compresses
    (trained - base) with the residual the Coordinator carries; the
    server rebuilds W_c = base + dequantized delta from the lease's base
    and folds it by Eq. 1.  A preempted client loses its residual."""

    def __init__(self, alpha=0.95, density: float = 0.05,
                 staleness_gamma: Optional[float] = None):
        super().__init__(alpha, staleness_gamma)
        self.density = density
        self.name = "vc-asgd-compressed"

    def encode_payload(self, trained_buf, base: F.FlatParams, residual):
        return C.compress_flat(trained_buf - base.buf, density=self.density,
                               logical_n=base.spec.n, residual=residual)

    def assimilate(self, state, payload, meta: ResultMeta):
        return super().assimilate(
            state, _reconstruct(payload, meta, state.params), meta)


class Downpour(ServerScheme):
    """Client sends delta = trained - base (the accumulated update of its
    local steps); the server adds it, Hogwild-style."""

    def __init__(self, server_lr: float = 1.0):
        self.server_lr = server_lr
        self.name = "downpour"

    def encode_payload(self, trained_buf, base: F.FlatParams, residual):
        return trained_buf - base.buf, None

    def assimilate(self, state, payload, meta: ResultMeta):
        fp = state.params
        d_buf = self._payload_buf(fp, payload)
        state.params = fp.with_buf(fp.buf + f32(self.server_lr) * d_buf)
        state.version += 1
        return state


@dataclass
class DCASGDState(SchemeState):
    """Downpour state + the per-client delay-compensation backups (the
    LATEST handout per client, not per lease)."""

    backups: Dict[int, F.FlatParams] = field(default_factory=dict)


class DCASGD(Downpour):
    """Delay-compensated Downpour: the backup of the latest handed-out
    params is recorded at lease issue (``on_issue``); the compensation
    term uses (W_now - W_backup)."""

    def __init__(self, server_lr: float = 1.0, lam: float = 0.1):
        super().__init__(server_lr)
        self.lam = lam
        self.name = "dc-asgd"

    def init_state(self, params0) -> DCASGDState:
        return DCASGDState(params=as_flat(params0))

    def on_issue(self, state: DCASGDState, lease: Lease) -> None:
        state.backups[lease.cid] = lease.base

    def assimilate(self, state: DCASGDState, payload, meta: ResultMeta):
        fp = state.params
        backup = state.backups.get(meta.cid, fp)
        d = self._payload_buf(fp, payload)
        # left to right, as the reference writes it (baselines.py:179):
        # d + (((lam*d)*d)*sign(d))*(W - backup)
        comp = d + f32(self.lam) * d * d * torch.sign(d) * (fp.buf
                                                            - backup.buf)
        state.params = fp.with_buf(fp.buf + f32(self.server_lr) * comp)
        state.version += 1
        return state


@dataclass
class EASGDState(SchemeState):
    """Elastic center (``params``) + persistent per-client replicas."""

    replicas: Dict[int, F.FlatParams] = field(default_factory=dict)


class EASGDPersistent(ServerScheme):
    """Elastic averaging with persistent client replicas (Zhang et al.).
    Both sides move toward each other with moving rate beta.  NOT fault
    tolerant: a preempted client loses its replica and restarts from the
    center."""

    requires_all_clients = True
    has_local_replicas = True

    def __init__(self, beta: float = 0.001):
        self.beta = beta
        self.name = "easgd-persistent"

    def init_state(self, params0) -> EASGDState:
        return EASGDState(params=as_flat(params0))

    def handout(self, state: EASGDState, cid: int, default):
        return state.replicas.get(cid, state.params)

    def assimilate(self, state: EASGDState, payload, meta: ResultMeta):
        center = state.params
        x_buf = self._payload_buf(center, payload)
        diff = x_buf - center.buf
        b = f32(self.beta)
        state.params = center.with_buf(center.buf + b * diff)
        state.replicas[meta.cid] = center.with_buf(x_buf - b * diff)
        state.version += 1
        return state

    def drop_client(self, state: EASGDState, cid: int) -> None:
        state.replicas.pop(cid, None)      # preemption loses the replica


@dataclass
class PodState(SchemeState):
    """Pod-scale elastic state: center (``params``), ALL replicas as one
    [n_replicas, padded] matrix, and the round barrier's bookkeeping.
    ``pending`` buffers rows arriving mid-round (one per slot) and stacks
    them ONCE at the barrier."""

    replicas: Optional[torch.Tensor] = None         # [n_replicas, padded]
    pending: Dict[int, torch.Tensor] = field(default_factory=dict)
    lost: Set[int] = field(default_factory=set)     # restart from center
    slot_owner: Dict[int, int] = field(default_factory=dict)


class EASGDFlatPod(ServerScheme):
    """EASGD at pod scale on the flat bus: the elastic center is ONE
    buffer and all replicas live in one [n_replicas, N] matrix; when every
    slot of the round has reported, ONE fused elastic round (B5) moves
    the center and all replicas.  The round is synchronous, so it is NOT
    fault tolerant: a preempted client's replica resets to the center and
    the barrier re-waits for it.

    One client per replica slot (slot = cid % n_replicas); a slot claimed
    by one cid rejects another.  With ``compress_density`` set the
    replica payload rides the wire as a ``compress_flat`` SPARSE frame
    with per-client error feedback."""

    requires_all_clients = True
    has_local_replicas = True

    def __init__(self, n_replicas: int, beta: float = 0.05,
                 compress_density: Optional[float] = None):
        self.n_replicas = n_replicas
        self.beta = beta
        self.compress_density = compress_density
        self.name = "easgd-flat-pod"

    def _slot(self, state: PodState, cid: int) -> int:
        slot = cid % self.n_replicas
        owner = state.slot_owner.setdefault(slot, cid)
        if owner != cid:
            raise ValueError(
                f"EASGDFlatPod needs one client per replica slot "
                f"(n_replicas={self.n_replicas}): cid {cid} collides with "
                f"cid {owner} on slot {slot}")
        return slot

    def init_state(self, params0) -> PodState:
        fp = as_flat(params0)
        return PodState(params=fp,
                        replicas=fp.buf[None, :].repeat(self.n_replicas, 1))

    def handout(self, state: PodState, cid: int, default):
        fp = state.params
        if state.replicas is None or self._slot(state, cid) in state.lost:
            return fp
        return fp.with_buf(state.replicas[self._slot(state, cid)])

    def encode_payload(self, trained_buf, base: F.FlatParams, residual):
        if self.compress_density is None:
            return trained_buf, None
        return C.compress_flat(trained_buf - base.buf,
                               density=self.compress_density,
                               logical_n=base.spec.n, residual=residual)

    def assimilate(self, state: PodState, payload, meta: ResultMeta):
        fp = state.params
        slot = self._slot(state, meta.cid)
        payload = _reconstruct(payload, meta, fp)
        state.pending[slot] = self._payload_buf(fp, payload)
        state.lost.discard(slot)
        if len(state.pending) == self.n_replicas:
            # replicas stacked in slot order (baselines.py:320-321)
            stacked = torch.stack([state.pending[s]
                                   for s in range(self.n_replicas)])
            center, state.replicas = easgd_elastic_update(fp.buf, stacked,
                                                          self.beta)
            state.params = fp.with_buf(center)
            state.version += 1
            state.pending.clear()
        return state

    def drop_client(self, state: PodState, cid: int) -> None:
        if state.replicas is None:
            return
        slot = self._slot(state, cid)
        state.pending.pop(slot, None)      # the barrier re-waits for it
        state.lost.add(slot)


@dataclass
class BSPState(SchemeState):
    """Synchronous barrier buffer: weights per shard until the round is
    complete."""

    pending: Dict[int, torch.Tensor] = field(default_factory=dict)


class SyncBSP(ServerScheme):
    """Bulk-synchronous: buffer weights until EVERY shard of the round has
    reported, then average them.  Under preemption the barrier stalls
    until timeout reassignment refills the missing shards."""

    requires_all_clients = True

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.name = "sync-bsp"

    def init_state(self, params0) -> BSPState:
        return BSPState(params=as_flat(params0))

    def assimilate(self, state: BSPState, payload, meta: ResultMeta):
        fp = state.params
        state.pending[meta.shard] = self._payload_buf(fp, payload)
        if len(state.pending) == self.n_shards:
            # the reference's stack(...).mean(axis=0) as XLA computes it:
            # a sum from zero in arrival (dict) order, then ONE multiply by
            # the f32 reciprocal of the count
            acc = torch.zeros_like(fp.buf, dtype=torch.float32)
            for buf in state.pending.values():
                acc = acc + buf
            inv = float(np.float32(1.0) / np.float32(len(state.pending)))
            state.params = fp.with_buf((acc * inv).to(fp.buf.dtype))
            state.version += 1
            state.pending.clear()
        return state
