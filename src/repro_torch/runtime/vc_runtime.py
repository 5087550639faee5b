"""VC-ASGD at pod scale: client islands = pods (port of the flat-bus forms
of ``repro/runtime/vc_runtime.py``).

Each island holds its own full parameter replica; a round's assimilation
is Eq. 2 over the islands with a survivor mask (a dead island gets weight
zero), and redistribution hands every island the server snapshot.  The
compressed cross-pod round, ``compressed_assimilate``, ships each
island's delta as ONE global top-k + int8 payload with error feedback,
through a real wire frame when a ``Transport`` is given.

On the card a compressed round launches, per island, B6 and B7 (the
blocked top-k, on the 2^20-element and larger buses that hold its
sampled bracket), B9 and B10 (quantize, and dequantize for the error
feedback), B12 (the frame body, with a transport) and B10 again
(decompress).  On the CPU every kernel is its plain version; the results
are bit-identical either way, and to the reference's.

``compressed_assimilate_per_leaf`` is the reference's bench and test
baseline: a top-k per leaf and island (``compress_delta``), worse
compression at equal density.

``make_vc_round`` is the pod-scale island round (the paper's VC-ASGD at
LLM scale), laid out on the flat bus: the islands are the rows of one
[n_pods, padded] f32 matrix, each with its Adam moments on
``FlatOptState`` lanes.  A local step differentiates the loss w.r.t. the
island's row (the gradient lands in one flat buffer), clips it, and runs
B3 (``Adam.update_flat``: ONE launch); the assimilation is B2 over the
island matrix in place (ONE launch a round) and the redistribution a copy
of the server back into every row.

The sharded forms (the reference's ``mesh=`` / ``shard_axis=``): the
masked Eq. 2 and the redistribution run once a contiguous shard of the
bus on a pod mesh (``launch/mesh.py``, ``runtime/sharding.py``: B2 once
a shard on the card), bit-equal to the whole-bus pass; ``make_vc_round``
takes ``flat_shard_axis`` with the mesh beside it, and any one-card plan
(``models/plan.py``: context-parallel attention, expert-parallel MoE).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import flat as F
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.models.plan import NULL_PLAN, require_one_card_plan
from repro_torch.optim.optimizers import Adam, clip_by_global_norm
from repro_torch.runtime import sharding as S
from repro_torch.transfer import wire
from repro_torch.transfer.transport import Transport

_F32 = torch.float32


def _host_island_weights(n_pods: int, alpha: float, survivors
                         ) -> Tuple[np.ndarray, np.float32]:
    """``island_weights``' values on the host: (w f32 [n_pods], w_server
    f32), the only device work a read of ``survivors`` when it lies on
    the card."""
    alive = np.asarray(survivors.cpu() if isinstance(survivors, torch.Tensor)
                       else survivors).astype(np.float32).reshape(n_pods)
    f32 = np.float32
    j = np.arange(n_pods, dtype=f32)
    expo = f32(n_pods) - f32(1.0) - j
    pw = np.power(np.float64(f32(alpha)), expo.astype(np.float64)).astype(f32)
    w = f32(1.0 - alpha) * pw * alive
    total = f32(0.0)
    for v in w:
        total = f32(total + v)
    return w, f32(f32(1.0) - total)


def island_weights(n_pods: int, alpha: float, survivors
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 weights [w_0..w_{n-1}] (island order = arrival order) with
    dead islands zeroed; returns (w f32 [n_pods], w_server f32 0-dim), on
    ``survivors``' device when it is a tensor, else on the CPU.

    Computed on the host in f32 exactly as the reference's jnp ops round:
    ``(1 - alpha) * alpha^(n-1-j)`` with the power taken in f64 and
    rounded to f32 (XLA's f32 pow on the CPU), ``w_server = 1 - sum(w)``
    summed left to right from 0 (XLA's reduction of a short vector)."""
    dev = survivors.device if isinstance(survivors, torch.Tensor) else "cpu"
    w, w_s = _host_island_weights(n_pods, alpha, survivors)
    return (torch.from_numpy(w).to(dev),
            torch.tensor(w_s, dtype=_F32, device=dev))


def assimilate_flat(server_buf, islands_buf: torch.Tensor, w, w_s, *,
                    in_place: bool = False, mesh=None, shard_axis=None):
    """Eq. 2 over the FLAT bus with survivor masking: server [N] + islands
    [n_pods, N] -> [N], stored in the server's dtype.  ``w`` [n_pods] and
    ``w_s`` are ``island_weights``' results, best on the host (a CPU
    tensor, an array or floats): B2 takes its weights by value, and
    weights on the card cost a read back.

    Select-before-multiply: a dead island may hold inf/nan (it crashed
    mid-step) and ``0 * inf`` would poison the server, so dead streams are
    zeroed BEFORE the weighted reduction, which is B2
    (``ops.fused_assimilate_flat``: ONE launch on the card, its plain
    version on the CPU), in f32: a bf16 server is widened (exactly) and
    the f32 result rounded once to its dtype, what the reference's fold
    of f32 islands onto a bf16 server gives.  It folds ``w_s * server``
    first and the islands after it in island order: the reference's
    ``use_kernel=True`` order, not its jnp path's (which sums the weighted
    islands first).  ``in_place``: an f32 ``islands_buf`` has its dead
    rows zeroed where it lies (the caller overwrites them next) instead
    of in a copy of the whole matrix.

    With ``mesh`` / ``shard_axis`` the reduction runs once a contiguous
    shard (``sharding.sharded_assimilate_flat``: B2 a shard on the card;
    the server may be a ``ShardedBuf`` already) and returns a
    ``ShardedBuf``, bit-equal to the whole-bus pass."""
    wl = [float(v) for v in (w.tolist() if isinstance(w, torch.Tensor)
                             else w)]
    islands = islands_buf.to(_F32)
    dead = [j for j, v in enumerate(wl) if not v > 0.0]
    if dead:
        if islands is islands_buf and not in_place:
            islands = islands.clone()
        for j in dead:
            islands[j].zero_()
    weights = [float(w_s)] + wl
    if mesh is not None:
        if isinstance(server_buf, S.ShardedBuf):
            if server_buf.dtype != _F32:
                raise ValueError(f"a sharded server bus must be f32, got "
                                 f"{server_buf.dtype}")
            s32 = server_buf
        else:
            s32 = server_buf.to(_F32)
        out = S.sharded_assimilate_flat(s32, islands, weights, mesh,
                                        shard_axis)
        return S.ShardedBuf([o.to(server_buf.dtype) for o in out.shards],
                            out.sharding)
    out = K.fused_assimilate_flat(server_buf.to(_F32), islands, weights)
    return out.to(server_buf.dtype)


def redistribute_flat(server_buf, n_pods: int, *, mesh=None,
                      shard_axis=None):
    """Step-3 redistribution on the bus: server [N] -> islands [n_pods, N],
    every island restarting from the server snapshot (a copy each, so an
    island trained in place never writes into the server: one island
    too, where a contiguous view would be the server's own storage).
    With ``mesh`` / ``shard_axis`` each shard broadcasts only its own
    segment (``sharding.sharded_broadcast_flat``) into a ``ShardedBuf``
    of [n_pods, N / n] blocks — copies, bit-equal to the whole
    broadcast."""
    if mesh is not None:
        return S.sharded_broadcast_flat(server_buf, n_pods, mesh, shard_axis)
    return server_buf.repeat(n_pods, 1)


def islands_leading_dim(islands) -> int:
    return int(F.tree_flatten(islands)[0][0].shape[0])


def compressed_assimilate(server, islands, alpha: float, survivors, *,
                          density: float = 0.05, residuals=None,
                          transport: Optional[Transport] = None,
                          device="cuda"):
    """Delta-form Eq. 2 with GLOBAL (whole-model) top-k + int8 compression
    and error feedback — what crosses the network between pods.

    The server and every island are flattened once onto ``device`` (the
    card unless the caller passes ``"cpu"``); each island ships ONE
    globally sparsified delta buffer and the weighted Eq. 2 sum runs on
    the contiguous bus, in the reference's order: ``out = w_s * s``, then
    per island ``out = out + w_j * (s + deq_j)``.  A dead island is
    compressed (its residual carries) but weighs zero.  With ``transport``
    each payload really crosses the wire: encoded (its header carrying the
    residual's norm), sent, received and decoded before assimilation.

    Returns (server', residuals'): the server tree in its leaves' dtypes
    and the residual tree island-major in f32 (the error-feedback carry
    must not be truncated to the params' storage dtype)."""
    dev = resolve_device(device)
    n = islands_leading_dim(islands)
    w, w_s = _host_island_weights(n, alpha, survivors)
    w, w_s = w.tolist(), float(w_s)
    fp = F.flatten(server)
    s32 = fp.buf.to(dev)
    isl_buf, spec = F.flatten_batched(islands)
    if spec.shapes != fp.spec.shapes:
        raise ValueError("island layout does not match server layout")
    isl_buf = isl_buf.to(dev)
    res_buf = (F.flatten_batched(residuals)[0].to(dev)
               if residuals is not None else None)

    out = w_s * s32
    new_res = []
    for j in range(n):
        delta = isl_buf[j] - s32
        payload, r = C.compress_flat(
            delta, density=density, logical_n=spec.n,
            residual=None if res_buf is None else res_buf[j])
        if transport is not None:
            mid = transport.send(wire.encode_sparse(
                payload, residual_norm=C.residual_norm(r)))
            p = wire.decode(transport.recv(mid)).payload
            payload = p._replace(values=p.values.to(dev),
                                 scales=p.scales.to(dev),
                                 indices=p.indices.to(dev))
        deq = C.decompress_flat(payload)
        out = out + w[j] * (s32 + deq)
        new_res.append(r)
    server_out = F.unflatten(F.FlatParams(out, fp.spec))
    residuals_out = F.unflatten_batched(torch.stack(new_res), spec,
                                        dtype=_F32)
    return server_out, residuals_out


def compressed_assimilate_per_leaf(server, islands, alpha: float, survivors,
                                   *, density: float = 0.05, residuals=None,
                                   device="cuda"):
    """The per-leaf baseline of ``compressed_assimilate`` (a bench and test
    oracle, on no runtime path): a top-k per leaf and island in a Python
    loop, ``out = w_s * s`` then per island ``out = out + w_j * (s +
    deq_j)`` on each leaf, on ``device`` (the card unless the caller
    passes ``"cpu"``).  Returns (server', residuals') as trees: each leaf
    in its dtype, the residuals island-major in f32."""
    dev = resolve_device(device)
    n = islands_leading_dim(islands)
    w, w_s = _host_island_weights(n, alpha, survivors)
    w, w_s = w.tolist(), float(w_s)

    def one_leaf(s, isl, res):
        s32 = s.to(device=dev, dtype=_F32)
        out = w_s * s32
        new_res = []
        for j in range(n):
            delta = isl[j].to(device=dev, dtype=_F32) - s32
            if res is not None:
                delta = delta + res[j].to(device=dev, dtype=_F32)
            payload, r = C.compress_delta(delta, density=density)
            out = out + w[j] * (s32 + C.decompress_delta(payload))
            new_res.append(r)
        return out.to(s.dtype), torch.stack(new_res)

    flat_s, treedef = F.tree_flatten(server)
    flat_i = F.tree_flatten(islands)[0]
    flat_r = (F.tree_flatten(residuals)[0] if residuals is not None
              else [None] * len(flat_s))
    merged = [one_leaf(s, i, r) for s, i, r in zip(flat_s, flat_i, flat_r)]
    return (F.tree_unflatten(treedef, [m for m, _ in merged]),
            F.tree_unflatten(treedef, [r for _, r in merged]))


def init_islands(server: F.FlatParams, n_pods: int, optimizer
                 ) -> Tuple[torch.Tensor, list]:
    """Round state for ``make_vc_round`` from the server bus: the island
    matrix [n_pods, padded] (every row the server snapshot) and one fresh
    ``FlatOptState`` an island, on the server's device."""
    return (redistribute_flat(server.buf, n_pods),
            [optimizer.init_flat(server) for _ in range(n_pods)])


def _lane_loss_and_grad(model, spec: F.TreeSpec, lane: torch.Tensor, batch,
                        plan):
    """(loss, d loss / d lane): the tree the model sees is views of the
    f32 row ``lane`` (cast to each leaf's recorded dtype), and each leaf's
    ``.grad`` is preset to its slice of one zeroed flat buffer, so
    autograd accumulates the gradient into the bus layout in place (the
    tail stays zero) without a full-length gradient per leaf."""
    gbuf = torch.zeros_like(lane)
    leaves = []
    for o, n, shape, dt in zip(spec.offsets, spec.sizes, spec.shapes,
                               spec.dtypes):
        leaf = lane[o:o + n].view(shape).detach().requires_grad_(True)
        leaf.grad = gbuf[o:o + n].view(shape)
        leaves.append(leaf.to(F.torch_dtype(dt)))
    loss, _ = model.loss(F.tree_unflatten(spec.treedef, leaves), batch,
                         plan=plan)
    loss.backward()
    return loss.detach(), gbuf


def make_vc_round(model, n_pods: int, local_steps: int = 4, optimizer=None,
                  clip_norm: float = 1.0, plan=NULL_PLAN,
                  flat_shard_axis: Optional[str] = None, mesh=None):
    """Returns ``vc_round(server, islands, opts, batches, alpha, survivors)
    -> (server', islands, opts', metrics)``.

    ``server`` is the ``FlatParams`` bus (f32), ``islands`` the
    [n_pods, padded] f32 matrix of the island replicas on its layout and
    ``opts`` a list of one ``FlatOptState`` an island, both updated in
    place (a state is replaced as soon as its step has made the next, so
    no island's old moments outlive it) and returned; ``batches`` holds
    every key of ``make_batch_for``'s batch stacked ``[n_pods,
    local_steps, ...]`` (``tokens`` [n_pods, local_steps, b, s], and
    whisper's ``frame_embeds`` or the VLM's ``patch_embeds``), ``alpha``
    a float and ``survivors`` [n_pods] bools (host or device).

    1. ``local_steps`` steps on each island in turn (no cross-island sync):
       loss and flat gradient, ``clip_by_global_norm`` on the flat
       gradient, B3; a preempted island trains too (only its assimilation
       is masked), and every island's optimizer state carries to the next
       round.
    2. Eq. 2: ``island_weights`` and B2 over the island matrix in place
       (dead rows zeroed first).
    3. redistribution: the server copied back into every row.

    ``plan``: any one-card plan (``NullPlan``; its context-parallel and
    expert-parallel forms change the loss the islands train on); a mesh
    plan raises.  ``flat_shard_axis``: steps 2 and 3 run once a
    contiguous shard of the bus along that axis of ``mesh`` (the
    reference takes the mesh from ``plan.mesh``; until the port has a
    ``MeshPlan`` it takes ``mesh`` here): B2 a shard, the per-shard
    broadcast copied back into the island rows, the server gathered from
    its shards — bit-equal to the unsharded round on the same layout.
    The bus must divide into BLOCK-multiple shards (the reference pads
    it to BLOCK x shards: ``flat.flatten(tree, pad_to=BLOCK * n)`` or
    ``flat.flatten_sharded``).

    ``metrics["loss"]``: the mean over islands of each island's mean loss
    over its steps (f32 0-dim).  The arithmetic is the reference's (its
    tree Adam is bit-equal to the flat one) but for the clip norm's
    summation order and B2's order of the Eq. 2 sum."""
    require_one_card_plan(plan)
    if (flat_shard_axis is None) != (mesh is None):
        raise ValueError("flat_shard_axis and mesh go together")
    n_shards = 1
    if mesh is not None:
        n_shards = S.flat_sharding(mesh, flat_shard_axis).n_shards
    optimizer = optimizer or Adam(lr=3e-4)

    def vc_round(server: F.FlatParams, islands: torch.Tensor, opts: list,
                 batches, alpha: float, survivors):
        spec = server.spec
        if tuple(islands.shape) != (n_pods, spec.padded):
            raise ValueError(f"islands must be [{n_pods}, {spec.padded}], "
                             f"got {tuple(islands.shape)}")
        if spec.padded % (F.BLOCK * n_shards):
            raise ValueError(f"a bus of {spec.padded} does not divide into "
                             f"{n_shards} BLOCK-multiple shards: pad it to "
                             f"BLOCK x {n_shards}")
        dev = islands.device
        island_losses = []
        for j in range(n_pods):
            lane, losses = islands[j], []
            for t in range(local_steps):
                batch = {k: v[j, t].to(dev) for k, v in batches.items()}
                loss, gbuf = _lane_loss_and_grad(model, spec, lane, batch,
                                                 plan)
                gbuf, _ = clip_by_global_norm(gbuf, clip_norm)
                fp, opts[j] = optimizer.update_flat(gbuf, opts[j],
                                                    F.FlatParams(lane, spec))
                lane.copy_(fp.buf)
                del fp, gbuf
                losses.append(loss)
            island_losses.append(torch.stack(losses).mean())
        w, w_s = _host_island_weights(n_pods, alpha, survivors)
        out = assimilate_flat(server.buf, islands, w, w_s, in_place=True,
                              mesh=mesh, shard_axis=flat_shard_axis)
        if mesh is None:
            islands.copy_(out.unsqueeze(0).expand_as(islands))
        else:
            seg = spec.padded // n_shards
            back = redistribute_flat(out, n_pods, mesh=mesh,
                                     shard_axis=flat_shard_axis)
            for i, blk in enumerate(back.shards):
                islands[:, i * seg:(i + 1) * seg].copy_(blk)
            del back
            out = S.gather_flat(out, dev)
        return (F.FlatParams(out, spec), islands, opts,
                {"loss": torch.stack(island_losses).mean()})

    return vc_round
