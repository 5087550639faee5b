"""Train and serve steps (port of ``repro/runtime/train.py``):
``make_train_step`` over a parameter tree, with gradient accumulation,
under any one-card plan (``models/plan.py``: local, context-parallel or
expert-parallel forms, or a mesh plan over one position);
``make_flat_train_step`` over the flat bus, whole or sharded over a pod
mesh; ``make_prefill_step`` / ``make_decode_step``, the serving steps;
``microbatch_specs`` and ``padded_vocab_of``, the dry run's shapes."""
from __future__ import annotations

import torch

from repro_torch.core import flat as F
from repro_torch.models.layers import meta_spec, padded_vocab
from repro_torch.models.plan import NULL_PLAN, require_one_card_plan
from repro_torch.optim.optimizers import Adam, clip_by_global_norm
from repro_torch.runtime.sharding import gather_flat


def make_train_step(model, plan=NULL_PLAN, optimizer=None,
                    clip_norm: float = 1.0, remat: bool = True,
                    accum: int = 1):
    """(params, opt_state, batch) -> (params', opt_state', metrics) for a
    parameter tree and a tree ``OptState``.

    ``accum > 1``: every batch tensor carries a leading microbatch dim
    [accum, b / accum, ...]; the microbatches run one after another, their
    gradients summed in f32 and divided by ``accum`` (bounds the
    activation working set).  Then the gradients are clipped to global
    norm ``clip_norm`` and the optimizer steps.  ``metrics``: "loss"
    (the mean over microbatches), "grad_norm" (before clipping), "ce" and
    "aux", each an f32 0-dim tensor on the params' device."""
    require_one_card_plan(plan)
    optimizer = optimizer or Adam(lr=3e-4)

    def grads_of(params, mbatch):
        leaves, treedef = F.tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = model.loss(F.tree_unflatten(treedef, req), mbatch,
                                   plan=plan, remat=remat)
        grads = torch.autograd.grad(loss, req)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads), treedef)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads, treedef = grads_of(params, batch)
        else:
            acc, losses, ms = None, [], []
            for i in range(accum):
                loss_i, m_i, g, treedef = grads_of(
                    params, {k: v[i] for k, v in batch.items()})
                g32 = [x.to(torch.float32) for x in g]
                acc = g32 if acc is None else [a + x for a, x in zip(acc, g32)]
                losses.append(loss_i)
                ms.append(m_i)
            grads = [a / accum for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(F.tree_unflatten(treedef, grads),
                                           clip_norm)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step


def make_flat_train_step(loss_fn, optimizer, *, mesh=None,
                         shard_axis: str = "pod"):
    """(FlatParams, FlatOptState, batch) -> (FlatParams', FlatOptState',
    loss).

    ``loss_fn(tree, batch)`` is differentiated w.r.t. the BUFFER: the tree
    it sees is views of the buffer (``F.unflatten``), so autograd returns
    the gradient lane directly, with an exactly-zero padding tail.  The
    optimizer then updates all three lanes in one pass (one fused kernel
    launch on the card).

    With ``mesh`` (``launch/mesh.py``) the (p, g, m, v) lanes are cut into
    contiguous per-device segments along ``shard_axis`` (lay the bus out
    with ``flat.flatten_sharded`` so the length divides) and the update
    runs once a shard (``Adam.update_flat_sharded``) — bit-equal to the
    whole-bus step.  The params and moments come back as ``ShardedBuf``s
    and may be passed back in as they are: the loss reads the params
    gathered onto shard 0's device."""

    def step(fp: F.FlatParams, fos: F.FlatOptState, batch):
        buf = gather_flat(fp.buf).detach().requires_grad_(True)
        loss = loss_fn(F.unflatten(fp.with_buf(buf)), batch)
        (gbuf,) = torch.autograd.grad(loss, buf)
        if mesh is not None:
            new_fp, new_fos = optimizer.update_flat_sharded(
                gbuf, fos, fp, mesh=mesh, axis=shard_axis)
        else:
            new_fp, new_fos = optimizer.update_flat(gbuf, fos, fp)
        return new_fp, new_fos, loss.detach()

    return step


def microbatch_specs(batch_specs, accum: int):
    """[b, ...] specs (meta tensors) -> [accum, b / accum, ...]."""
    def split(s):
        if s.shape[0] % accum:
            raise ValueError(f"batch {s.shape[0]} does not split into "
                             f"{accum} microbatches")
        return meta_spec((accum, s.shape[0] // accum, *s.shape[1:]),
                         s.dtype)
    return F.tree_map(split, batch_specs)


def make_prefill_step(model, plan=NULL_PLAN):
    """(params, batch) -> (last-position logits, decode states)."""
    require_one_card_plan(plan)

    def prefill_step(params, batch):
        return model.prefill(params, batch, plan=plan)
    return prefill_step


def make_decode_step(model, plan=NULL_PLAN):
    """(params, caches, token, pos) -> (logits, decode states)."""
    require_one_card_plan(plan)

    def decode_step(params, caches, token, pos):
        return model.decode_step(params, caches, token, pos, plan=plan)
    return decode_step


def padded_vocab_of(model) -> int:
    return padded_vocab(model.cfg)
