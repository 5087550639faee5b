"""The sharded flat bus (port of the flat half of
``repro/runtime/sharding.py``: ``flat_sharding`` ... ``ep_tune``).

The FlatParams bus (``core/flat.py``) partitioned along a mesh axis: with
a ``ShardedTreeSpec`` layout (or any bus whose length the axis divides
into BLOCK multiples) shard i is one contiguous segment on the axis's
i-th device (``launch/mesh.py``).  The flat kernels — Eq. 1 (B1), Eq. 2
(B2), Adam (B3), the elastic EASGD round (B5) — are elementwise over the
bus, so each runs once a shard on that shard's segment, with no gather,
and its result is bit-equal to the whole-bus call at every shard count.
On the card each shard launches the hand-written kernel; on the CPU the
plain version runs (``kernels/ops.py`` routes by the tensor's device).

A partitioned buffer is a ``ShardedBuf``: one contiguous tensor a shard.
A 1-D bus [N] splits into views of itself where the shards share its
device; a stream matrix [k, N] (clients, replicas, islands) splits by
columns, each shard's [k, N / n] block copied to a contiguous tensor,
because B2 and B5 read contiguous [k, n] rows.  Results stay sharded;
``gather_flat`` puts a whole buffer back on one device.

``ep_tune`` picks the MoE's virtual-expert factor for an expert-parallel
degree (``models/layers.py::apply_moe_ep``).

The layouts of the mesh plans (``MeshPlan``: parameter, activation and
cache specs, FSDP, head-TP) are not ported: they need collectives across
cards.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import flat as F
from repro_torch.kernels import ops as K
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class FlatSharding:
    """A 1-D flat buffer laid out as contiguous per-device segments along
    ``axis`` of ``mesh`` (the reference's ``NamedSharding(mesh,
    P(axis))``)."""
    mesh: Mesh
    axis: str

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def devices(self) -> list:
        return self.mesh.axis_devices(self.axis)


class ShardedBuf:
    """A flat buffer [N] or stream matrix [k, N] partitioned along its
    last dim: ``shards[i]`` is the contiguous [..., N / n] segment i on
    ``sharding.devices[i]``."""

    def __init__(self, shards: Sequence[torch.Tensor], sharding: FlatSharding):
        if len(shards) != sharding.n_shards:
            raise ValueError(f"{len(shards)} shards for a "
                             f"{sharding.n_shards}-way axis")
        self.shards: List[torch.Tensor] = list(shards)
        self.sharding = sharding

    @property
    def shape(self) -> tuple:
        lead = tuple(self.shards[0].shape[:-1])
        return lead + (sum(int(s.shape[-1]) for s in self.shards),)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """Shard 0's device (where ``gather`` puts the whole buffer)."""
        return self.shards[0].device

    def __repr__(self) -> str:
        return (f"ShardedBuf(shape={self.shape}, dtype={self.dtype}, "
                f"{self.sharding.n_shards} shards along "
                f"{self.sharding.axis!r})")


def flat_sharding(mesh: Mesh, axis: str = "pod") -> FlatSharding:
    """The sharding placing a 1-D flat buffer as contiguous per-device
    segments along ``axis`` (replicated over any other mesh axes)."""
    mesh.axis_devices(axis)                       # the axis must exist
    return FlatSharding(mesh, axis)


def _check_shardable(buf_len: int, mesh: Mesh, axis: str) -> int:
    a = mesh.shape[axis]
    if buf_len % a:
        raise ValueError(
            f"flat buffer of {buf_len} elements does not divide the "
            f"{a}-way mesh axis {axis!r}; lay it out with "
            f"flat.shard_spec/flatten_sharded(n_shards={a})")
    return a


def _split(x, sharding: FlatSharding) -> List[torch.Tensor]:
    """``x``'s per-shard segments: a ``ShardedBuf`` on ``sharding`` as it
    is, a whole tensor cut along its last dim (a 1-D segment is a view
    when it stays on its device; a [k, N] column block is copied to a
    contiguous tensor)."""
    if isinstance(x, ShardedBuf):
        if x.sharding != sharding:
            raise ValueError(f"{x} is not laid out along "
                             f"{sharding.axis!r} of this mesh")
        return x.shards
    n_shards = _check_shardable(int(x.shape[-1]), sharding.mesh,
                                sharding.axis)
    seg = int(x.shape[-1]) // n_shards
    return [x[..., i * seg:(i + 1) * seg].to(dev).contiguous()
            for i, dev in enumerate(sharding.devices)]


def shard_buf(x: torch.Tensor, mesh: Mesh, axis: str = "pod"
              ) -> ShardedBuf:
    """Place a bus [N] or a stream matrix [k, N] on the mesh: shard i
    gets the contiguous segment i of the last dim on its device."""
    sharding = flat_sharding(mesh, axis)
    return ShardedBuf(_split(x, sharding), sharding)


def shard_flat(fp: F.FlatParams, mesh: Mesh, axis: Optional[str] = None
               ) -> F.FlatParams:
    """Place a FlatParams' buffer on the mesh: each device gets its own
    contiguous segment.  ``axis`` defaults to the ShardedTreeSpec's
    axis, else "pod"."""
    if axis is None:
        axis = (fp.spec.axis if isinstance(fp.spec, F.ShardedTreeSpec)
                else "pod")
    return fp.with_buf(shard_buf(fp.buf, mesh, axis))


def gather_flat(x, device=None) -> torch.Tensor:
    """The whole buffer of ``x`` on one device: a ``ShardedBuf``'s
    segments concatenated along the last dim on ``device`` (default:
    shard 0's device); a tensor is returned as it is."""
    if not isinstance(x, ShardedBuf):
        return x
    dev = torch.device(device) if device is not None else \
        x.shards[0].device
    return torch.cat([s.to(dev) for s in x.shards], dim=-1)


def _weights(weights) -> List[float]:
    if isinstance(weights, torch.Tensor):
        return [float(w) for w in weights.detach().cpu().reshape(-1).tolist()]
    return [float(w) for w in weights]


def sharded_lerp_flat(server_buf, client_buf, alpha, mesh: Mesh,
                      axis: str = "pod") -> ShardedBuf:
    """Eq. 1 a shard: every segment lerped on its device (B1 once a
    shard on the card)."""
    sh = flat_sharding(mesh, axis)
    return ShardedBuf([K.fused_lerp_flat(s, c, alpha) for s, c in
                       zip(_split(server_buf, sh), _split(client_buf, sh))],
                      sh)


def sharded_assimilate_flat(server_buf, clients_buf, weights, mesh: Mesh,
                            axis: str = "pod") -> ShardedBuf:
    """Eq. 2 a shard: server [N] + clients [n, N] -> [N], each segment
    reducing all n client streams in arrival order (``w0 * s`` first,
    then each client): the kernel's fold, so the result is bit-equal to
    the whole-bus pass (B2 once a shard on the card)."""
    n = int(clients_buf.shape[0])
    w = _weights(weights)
    if len(w) != n + 1:
        raise ValueError(f"need {n + 1} weights, got {len(w)}")
    sh = flat_sharding(mesh, axis)
    return ShardedBuf([K.fused_assimilate_flat(s, c, w) for s, c in
                       zip(_split(server_buf, sh), _split(clients_buf, sh))],
                      sh)


def sharded_adam_update_flat(p_buf, g_buf, m_buf, v_buf, lr, b1, b2, eps,
                             weight_decay, c1, c2, mesh: Mesh,
                             axis: str = "pod"):
    """Fused Adam a shard: each device updates the (p, m, v) lanes of its
    own segment, the scalars shared (B3 once a shard on the card).
    Returns (p', m', v') as ``ShardedBuf``s."""
    sh = flat_sharding(mesh, axis)
    outs = [K.fused_adam_flat(p, g, m, v, lr, b1, b2, eps, weight_decay,
                              c1, c2)
            for p, g, m, v in zip(*(_split(t, sh) for t in
                                    (p_buf, g_buf, m_buf, v_buf)))]
    return tuple(ShardedBuf([o[i] for o in outs], sh) for i in range(3))


def sharded_broadcast_flat(server_buf, n_pods: int, mesh: Mesh,
                           axis: str = "pod") -> ShardedBuf:
    """The redistribution leg a shard: server [N] -> islands [n_pods, N],
    every device copying only its own segment into its [n_pods, N / n]
    block (no gather; the values are copies, so the result is bit-equal
    to the whole-bus broadcast)."""
    sh = flat_sharding(mesh, axis)
    return ShardedBuf([s.repeat(n_pods, 1) for s in _split(server_buf, sh)],
                      sh)


def sharded_easgd_flat(center_buf, replicas_buf, beta, mesh: Mesh,
                       axis: str = "pod"):
    """The elastic EASGD round a shard: center [N] + replicas [n, N]
    updated segment by segment, no gather (B5 once a shard on the
    card).  Returns (center', replicas') as ``ShardedBuf``s."""
    sh = flat_sharding(mesh, axis)
    outs = [K.fused_easgd_flat(c, x, beta) for c, x in
            zip(_split(center_buf, sh), _split(replicas_buf, sh))]
    return (ShardedBuf([o[0] for o in outs], sh),
            ShardedBuf([o[1] for o in outs], sh))


def ep_tune(cfg: ModelConfig, dp: int) -> ModelConfig:
    """Set moe.ep_virtual so n_experts * v divides the dp-way EP axis and
    the per-expert f dim splits evenly."""
    if cfg.moe is None:
        return cfg
    e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    v = 1
    while (e * v) % dp != 0 or f % v != 0:
        v += 1
        if v > dp:
            raise ValueError(f"no virtual factor for e={e}, f={f}, dp={dp}")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, ep_virtual=v))
