"""The sharding planner as data, and the sharded flat bus (port of
``repro/runtime/sharding.py``).

``MeshPlan`` decides, for a config on a mesh (``launch/mesh.py``), how
every parameter, batch input, decode cache and named activation is laid
out, as ``PartitionSpec``s over the mesh's axes, by the reference's rules:
head-TP attention where the heads divide the model axis, else
context-parallel (local below d_model 1024); FFNs TP over the model axis;
vocab over the model axis; FSDP of the other dim over data where it
divides; decode caches by kv head, else in sequence chunks.  The plan is
data: no process group, and no layout applied to a tensor.  Its
computing fields run on one card as a ``NullPlan`` (``one_card_plan``),
and the models take a plan whose mesh has one position.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import flat as F
from repro_torch.kernels import ops as K
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import DecodeCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.plan import NullPlan, require_one_card_plan
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.whisper import CrossCache, WhisperDecCache


# ---------------------------------------------------------------------------
# MeshPlan: the sharding planner, as data (what it chooses and its specs)
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One mesh-axis entry a tensor dim: None (replicated), an axis name,
    or a tuple of axis names (the dim split over their product), as the
    reference's ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout: ``spec`` over the axes of ``mesh`` (the
    reference's ``NamedSharding``).  A record only: nothing is placed."""
    mesh: Mesh
    spec: PartitionSpec


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _tup(x) -> tuple:
    if x is None:
        return ()
    return x if isinstance(x, tuple) else (x,)


def _map_with_path(fn, node, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples (``path`` the keys, indices and field names down to the
    leaf), keeping the tree's structure."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(node))
    return fn(path, node)


@dataclasses.dataclass
class MeshPlan(NullPlan):
    """The plan of ``cfg`` on ``mesh`` (the reference's ``MeshPlan``): the
    computing fields of a ``NullPlan`` chosen for the mesh (``build``),
    and the layouts of every parameter (``param_shardings``), batch input
    (``batch_shardings``), decode cache (``cache_shardings``) and named
    activation (``act_spec``) as ``PartitionSpec``s over its axes.

    Data only: no process group, and no layout is applied to a tensor.
    The models take a plan whose mesh has one position (``act`` is the
    identity there); one over several positions is refused
    (``models/plan.py::require_one_card_plan``), and its computing fields
    run on one card as ``one_card_plan()``."""
    mesh: Mesh = None
    cfg: ModelConfig = None
    data_axis: Any = "data"          # ("pod", "data") for multi-pod DP
    model_axis: Any = "model"
    tp: int = 1
    dp: int = 1
    fsdp: bool = True
    kv_sharded: bool = False         # kv heads divide tp
    cache_mode: str = "seq"          # "heads" | "seq"

    @classmethod
    def build(cls, cfg: ModelConfig, mesh: Mesh, data_axis="data",
              model_axis="model", attn_mode: Optional[str] = None,
              decode_batch: Optional[int] = None, moe_ep: bool = False,
              zero_dp: bool = False) -> "MeshPlan":
        """Attention: replicated below d_model 1024 ("local"), head-TP
        where the heads divide the model axis, else context-parallel over
        it; the kv heads sharded when they divide too.  Decode caches: by
        kv head when sharded, else the old tier in ``tp`` sequence chunks
        (``tp * dp`` for a decode batch the data axis does not divide).
        ``moe_ep``: experts over the data axis (``ep_tune`` first).
        ``zero_dp``: the model axis folded into data (pure DP with fully
        sharded parameters, attention local)."""
        if zero_dp:
            data_axis = (*_tup(data_axis), *_tup(model_axis))
            model_axis = None
            attn_mode = attn_mode or "local"
        tp = math.prod(mesh.shape[a] for a in _tup(model_axis))
        dp = math.prod(mesh.shape[a] for a in _tup(data_axis))
        if moe_ep and (cfg.moe is None or cfg.moe.n_virtual % dp):
            raise ValueError("set cfg.moe.ep_virtual so n_virtual divides "
                             "the data axis (use ep_tune)")
        if attn_mode is None:
            if cfg.d_model < 1024:
                attn_mode = "local"
            elif _divides(cfg.n_heads, tp):
                attn_mode = "head_tp"
            else:
                attn_mode = "cp"
        kv_sharded = attn_mode == "head_tp" and _divides(cfg.n_kv_heads, tp)
        cache_mode = "heads" if kv_sharded else "seq"
        chunks = tp if cache_mode == "seq" else 1
        # batch-1 long-context decode: nothing to shard over data, so the
        # cache chunk dim takes both axes
        if (decode_batch is not None and not _divides(decode_batch, dp)
                and cache_mode == "seq"):
            chunks = tp * dp
        return cls(mesh=mesh, cfg=cfg, data_axis=data_axis,
                   model_axis=model_axis, tp=tp, dp=dp,
                   attn_mode=attn_mode, cp=(tp if attn_mode == "cp" else 1),
                   kv_sharded=kv_sharded, cache_mode=cache_mode,
                   cache_chunks=chunks, moe_ep=moe_ep,
                   ep=(dp if moe_ep else 1))

    def one_card_plan(self) -> NullPlan:
        """The computing fields as a ``NullPlan``: what this plan computes,
        run on one device through the one-card forms (CP chunks, the
        chunked decode cache, the expert-parallel dispatch)."""
        return NullPlan(attn_mode=self.attn_mode, cp=self.cp,
                        cache_chunks=self.cache_chunks,
                        window_gather=self.window_gather,
                        moe_ep=self.moe_ep, ep=self.ep)

    def _axis_size(self, a) -> int:
        return math.prod(self.mesh.shape[x] for x in _tup(a))

    def _fit(self, spec: PartitionSpec, shape) -> PartitionSpec:
        """Drop the sharding of any dim the shape does not divide (a
        batch of 1)."""
        out = []
        for i, a in enumerate(spec):
            if a is None or i >= len(shape):
                out.append(a)
                continue
            out.append(a if shape[i] % self._axis_size(a) == 0 else None)
        return P(*out)

    @property
    def chunk_axes(self):
        """The mesh axes carrying the decode cache's chunk dim."""
        if self.cache_chunks > self.tp:
            return (*_tup(self.data_axis), *_tup(self.model_axis))
        return self.model_axis

    def _ns(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def act(self, x, kind: str):
        """The identity on a mesh of one position; over several it raises
        (``require_one_card_plan``: the layouts across cards are not
        ported)."""
        require_one_card_plan(self)
        return x

    def act_spec(self, kind: str, ndim: Optional[int] = None
                 ) -> Optional[PartitionSpec]:
        D, M = self.data_axis, self.model_axis
        table = {
            "bsd": P(D, None, None),
            "enc_bsd": P(D, None, None),
            "cp_bpsd": P(D, M, None, None),
            "q_bshd": P(D, None, M if self.attn_mode == "head_tp" else None,
                        None),
            "kv_bshd": P(D, None, M if self.kv_sharded else None, None),
            "q_bpshd": P(D, M, None, None, None),
            "kv_rep": P(D, None, None, None),
            "kv_gather": P(D, M, None, None, None, None),
            "logits": P(D, None, M),
            "dec_x": P(D, None),
            "dec_q": P(D, M if self.kv_sharded else None, None),
            "dec_logits": P(D, M),
            "cache_old": (P(D, M, None, None, None)
                          if self.cache_mode == "heads"
                          else P(D, None, M, None, None)),
            "cache_old_L": (P(None, D, M, None, None, None)
                            if self.cache_mode == "heads"
                            else P(None, D, None, M, None, None)),
            # expert-parallel MoE layouts
            "ep_tokens": P(D, None, None),
            "ep_dispatched": P(D, None, None, None, None),
            "ep_returned": P(D, None, None, None),
            "ep_w_in": P(D, None, None, M),
            "ep_w_out": P(D, None, M, None),
        }
        return table.get(kind)

    def param_spec(self, path: str, shape: Tuple[int, ...]) -> PartitionSpec:
        """The spec of the parameter at ``path`` ("blocks/3/attn/wq"), by
        its leaf name and the block kind in its path, as the reference's
        rules read its own paths: TP over the model axis, FSDP of the
        other dim over data where it divides (leaves of 65,536 elements
        and more)."""
        D, M = self.data_axis, self.model_axis
        tp, dp = self.tp, self.dp
        name = path.split("/")[-1]

        def fsdp_ok(dim: int) -> bool:
            return (self.fsdp and _divides(shape[dim], dp)
                    and math.prod(shape) >= 65536)

        def with_fsdp(spec: Tuple, free_dim: int) -> PartitionSpec:
            s = list(spec)
            if s[free_dim] is None and fsdp_ok(free_dim):
                s[free_dim] = D
            return P(*s)

        if len(shape) <= 1:
            return P(*([None] * len(shape)))           # 1D: replicated
        attn_tp = self.attn_mode == "head_tp"
        # embeddings
        if name == "table":                            # [Vp, d]
            return (with_fsdp((M, None), 1) if _divides(shape[0], tp)
                    else with_fsdp((None, None), 1))
        if name == "unembed":                          # [d, Vp]
            return with_fsdp((None, M), 0)
        if name == "pos_table":
            return P(None, None)
        # attention
        if name == "wq":                               # [d, h*hd]
            return (with_fsdp((None, M), 0) if attn_tp
                    else with_fsdp((None, None), 0))
        # (read before the rwkv rules, as in the reference: an rwkv
        # block's wk / wv take this rule too)
        if name in ("wk", "wv"):                       # [d, kv*hd]
            return (with_fsdp((None, M), 0) if self.kv_sharded
                    else with_fsdp((None, None), 0))
        if name == "wo" and "attn" in path:            # [h*hd, d]
            return (with_fsdp((M, None), 1) if attn_tp
                    else with_fsdp((None, None), 1))
        # rwkv time mix (head-TP always: rwkv6's heads divide)
        if "rwkv_tm" in path:
            if name in ("wr", "wk", "wv", "wg"):       # [d, d]
                return with_fsdp((None, M), 0)
            if name == "wo":                           # [d, d]
                return with_fsdp((M, None), 1)
            if name in ("lora_a", "w_a"):
                return with_fsdp((None, None), 0)
            if name in ("lora_b", "w_b"):
                return P(*([None] * len(shape)))
            if name == "u":
                return P(M, None) if _divides(shape[0], tp) else P(None, None)
            return P(*([None] * len(shape)))
        if "rwkv_cm" in path:
            if name == "wk":                           # [d, f]
                return with_fsdp((None, M), 0)
            if name == "wv":                           # [f, d]
                return with_fsdp((M, None), 1)
            if name == "wr":
                return with_fsdp((None, None), 0)
        # mamba
        if "mamba" in path:
            if name == "in_proj":                      # [d, 2*di]
                return with_fsdp((None, M), 0)
            if name == "conv_w":                       # [dc, di]
                return P(None, M)
            if name == "x_proj":                       # [di, dtr+2ds]
                return P(M, None)
            if name == "dt_proj":                      # [dtr, di]
                return P(None, M)
            if name == "a_log":                        # [di, ds]
                return P(M, None)
            if name == "out_proj":                     # [di, d]
                return with_fsdp((M, None), 1)
        # MoE
        if name == "router":                           # [d, e]
            return with_fsdp((None, None), 0)
        if "moe" in path and name in ("wi", "wg"):     # [E, d, fv]
            if self.moe_ep:
                return P(D, None, M)                   # experts over data
            s = [None, None, M]
            if fsdp_ok(1):
                s[1] = D
            return P(*s)
        if "moe" in path and name == "wo":             # [E, fv, d]
            if self.moe_ep:
                return P(D, M, None)
            s = [None, M, None]
            if fsdp_ok(2):
                s[2] = D
            return P(*s)
        # dense mlp
        if name in ("wi", "wg"):                       # [d, f]
            return with_fsdp((None, M), 0)
        if name == "wo":                               # [f, d]
            return with_fsdp((M, None), 1)
        if name in ("w1", "w2"):                       # vis_proj
            return with_fsdp((None, None), 0)
        return P(*([None] * len(shape)))

    def param_shardings(self, params_tree) -> Any:
        """A ``NamedSharding`` for every leaf of ``params_tree`` (the
        port's init tree, or ``Model.param_specs()``), in its structure.
        The port's leaves are one a layer: the reference's stacked
        leaves carry a leading repeats dim that takes None before the
        same inner spec."""
        def spec_for(path, leaf):
            pstr = "/".join(str(k) for k in path)
            return self._ns(self.param_spec(pstr, tuple(leaf.shape)))
        return _map_with_path(spec_for, params_tree)

    def batch_shardings(self, batch_tree, lead_dims: int = 0) -> Any:
        """Every leaf's dim ``lead_dims`` over the data axis, where it
        divides (``lead_dims`` 1 for [accum, b, ...] microbatches)."""
        D = self.data_axis

        def spec_for(_, leaf):
            nd = len(leaf.shape)
            spec = P(*([None] * lead_dims), D,
                     *([None] * (nd - 1 - lead_dims)))
            return self._ns(self._fit(spec, tuple(leaf.shape)))
        return _map_with_path(spec_for, batch_tree)

    def cache_shardings(self, cache_tree) -> Any:
        """The decode states' shardings, by state type: the attention
        cache's old tier by kv head ("heads") or by chunk over
        ``chunk_axes`` ("seq"), its ring over data; mamba and rwkv states
        over data and, where the heads divide, the model axis; whisper's
        cross K/V over data."""
        D, M = self.data_axis, self.model_axis

        def pad(leaf, spec):
            nd = len(leaf.shape)
            full = (*([None] * (nd - len(spec))), *spec)[-nd:]
            return self._ns(self._fit(P(*full), tuple(leaf.shape)))

        CH = self.chunk_axes

        def walk(node):
            if isinstance(node, DecodeCache):
                old = ((D, M, None, None, None) if self.cache_mode == "heads"
                       else (D, None, CH, None, None))
                return DecodeCache(
                    k_old=pad(node.k_old, old), v_old=pad(node.v_old, old),
                    old_pos=pad(node.old_pos, (None, None)),
                    k_rec=pad(node.k_rec, (D, None, None, None)),
                    v_rec=pad(node.v_rec, (D, None, None, None)),
                    rec_pos=pad(node.rec_pos, (None,)))
            if isinstance(node, MambaState):
                return MambaState(conv=pad(node.conv, (D, M, None)),
                                  ssm=pad(node.ssm, (D, M, None)))
            if isinstance(node, RWKVState):
                hs = (self.cfg.rwkv is not None and
                      _divides(self.cfg.d_model // self.cfg.rwkv.head_dim,
                               self.tp))
                wkv = (D, M, None, None) if hs else (D, None, None, None)
                return RWKVState(wkv=pad(node.wkv, wkv),
                                 tm_prev=pad(node.tm_prev, (D, None)),
                                 cm_prev=pad(node.cm_prev, (D, None)))
            if isinstance(node, CrossCache):
                return CrossCache(k=pad(node.k, (D, None, None, None)),
                                  v=pad(node.v, (D, None, None, None)))
            if isinstance(node, WhisperDecCache):
                return WhisperDecCache(self_cache=walk(node.self_cache),
                                       cross=walk(node.cross))
            if isinstance(node, (tuple, list)):
                return type(node)(walk(c) for c in node)
            raise TypeError(f"unknown cache node {type(node)}")

        return walk(cache_tree)


# ---------------------------------------------------------------------------
# the sharded flat bus
# ---------------------------------------------------------------------------

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
