"""Adam and SGD (port of ``repro/optim/optimizers.py``).  On the flat bus
params, m and v are three lanes of one layout, updated by ONE fused kernel
launch per step on the card; the tree form updates leaf by leaf with the
same arithmetic (the plain version of that kernel), so the two are
bit-identical.  ``flat_opt_from_tree`` lifts a tree state onto the bus
and ``flat_opt_to_tree`` views the lanes as trees again.

``clip_by_global_norm`` scales a gradient tree (or one flat gradient
buffer) to a global norm; ``linear_warmup`` and ``cosine_schedule`` are
learning-rate schedules of the step ``t`` that return the f32 value the
reference's jnp schedule computes, which Adam hands its kernel."""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.flat import (FlatOptState, FlatParams, TreeSpec,
                                   flatten_like, init_opt_state, tree_flatten,
                                   tree_map, tree_unflatten)
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R


class OptState(NamedTuple):
    """A tree state: the step as a host int, m and v as f32 trees shaped
    like the params."""
    step: int
    m: Any
    v: Any


# the row width of a leaf's two-level norm (see ``_leaf_norm``)
_NORM_ROW = 4096


def _leaf_norm(g: torch.Tensor) -> torch.Tensor:
    """The f32 L2 norm of ``g``: the norms of rows of _NORM_ROW elements,
    then the norm of those (no squared copy).  One ``vector_norm`` over a
    large leaf is not enough on the CPU: its kernel accumulates f32
    serially, and the norm of a full-width model's flat gradient (5e8
    elements) came out 1.4% low."""
    f = torch.float32
    x = g.reshape(-1)
    m = x.numel() // _NORM_ROW * _NORM_ROW
    parts = [torch.linalg.vector_norm(x[m:], dtype=f).reshape(1)]
    if m:
        parts.append(torch.linalg.vector_norm(x[:m].view(-1, _NORM_ROW),
                                              dim=1, dtype=f))
    return torch.linalg.vector_norm(torch.cat(parts))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / max(gnorm, 1e-9))``, gnorm):
    gnorm the f32 L2 norm over every leaf (a tree, or one tensor such as
    a flat gradient buffer, whose zero tail adds nothing).  Each leaf's
    norm is ``_leaf_norm`` on its device, so the sum's order is not the
    reference's; the scale and the product are its f32 ops, and a scale
    of 1 leaves the bits as they are.  Everything stays on the device:
    nothing is read back."""
    leaves, _ = tree_flatten(grads)
    f = torch.float32
    sq = None
    for g in leaves:
        n = _leaf_norm(g)
        sq = n * n if sq is None else sq + n * n
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(f) * scale).to(g.dtype), grads), gn


def linear_warmup(base_lr: float, warmup: int) -> Callable[[int], float]:
    """``base_lr * min(1, t / warmup)`` in f32, as the reference's jnp
    schedule rounds it; returns a Python float of that f32 value."""
    b, w = np.float32(base_lr), np.float32(warmup)

    def f(t: int) -> float:
        return float(b * np.minimum(np.float32(1.0), np.float32(t) / w))
    return f


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then a cosine decay to ``min_frac *
    base_lr`` at ``total``; each op in f32 in the reference's order (its
    cos of an f32 argument taken in f64 and rounded, which XLA's f32 cos
    matches on the CPU within an ulp); returns a Python float."""
    f32 = np.float32
    b, w, mf = f32(base_lr), f32(warmup), f32(min_frac)
    half = f32((1 - min_frac) * 0.5)      # Python floats, then one rounding
    span = f32(max(total - warmup, 1))
    pi = f32(math.pi)

    def f(t: int) -> float:
        tt = f32(t)
        if tt < w:
            return float(b * np.minimum(f32(1.0), tt / w))
        prog = np.clip((tt - w) / span, f32(0.0), f32(1.0))
        cos = f32(np.cos(np.float64(pi * prog)))
        return float(b * (mf + half * (f32(1.0) + cos)))
    return f


@functools.lru_cache(maxsize=4096)
def _bias_corrections(b1: float, b2: float, t: int):
    """``(1 - b1^t, 1 - b2^t)`` in f32 numpy scalars, cached: Adam forms
    them once per step of every client, and the same steps recur."""
    one, tt = np.float32(1.0), np.float32(t)
    return one - np.float32(b1) ** tt, one - np.float32(b2) ** tt


@dataclass(frozen=True)
class Adam:
    lr: float | Callable[[int], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def _scalars(self, step: int):
        """(t, lr, c1, c2) of the step after ``step``: the bias corrections
        ``1 - b^t`` taken in f32 on the host, as the reference does."""
        t = step + 1
        lr = self.lr(t) if callable(self.lr) else self.lr
        return (t, lr, *_bias_corrections(self.b1, self.b2, t))

    def init(self, params) -> OptState:
        """Zero f32 moments shaped like every leaf, on its device."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=0, m=tree_map(zeros, params),
                        v=tree_map(zeros, params))

    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        """One Adam step leaf by leaf, in the flat kernel's arithmetic."""
        t, lr, c1, c2 = self._scalars(state.step)
        leaves, treedef = tree_flatten(params)
        out = [R.adam_update(p, g, m, v, lr=lr, b1=self.b1, b2=self.b2,
                             eps=self.eps, c1=c1, c2=c2,
                             weight_decay=self.weight_decay)
               for p, g, m, v in zip(leaves, tree_flatten(grads)[0],
                                     tree_flatten(state.m)[0],
                                     tree_flatten(state.v)[0])]
        return (tree_unflatten(treedef, [o[0] for o in out]),
                OptState(step=t,
                         m=tree_unflatten(treedef, [o[1] for o in out]),
                         v=tree_unflatten(treedef, [o[2] for o in out])))

    def init_flat(self, fp: FlatParams) -> FlatOptState:
        """Zero moments sharing ``fp``'s TreeSpec, on ``fp``'s device."""
        return init_opt_state(fp.spec, fp.buf.device)

    def update_flat(self, grad_buf, state: FlatOptState, fp: FlatParams
                    ) -> Tuple[FlatParams, FlatOptState]:
        """Adam over the whole model as ONE pass over the flat bus.  The
        step count is a host int, and the bias corrections
        ``c1 = 1 - b1^t``, ``c2 = 1 - b2^t`` are taken in float32 on the
        host, as the reference does — no device scalar is ever read."""
        t, lr, c1, c2 = self._scalars(state.step)
        new_buf, m, v = K.fused_adam_flat(
            fp.buf, grad_buf, state.m, state.v, lr, self.b1, self.b2,
            self.eps, self.weight_decay, c1, c2)
        return fp.with_buf(new_buf), FlatOptState(m=m, v=v, step=t,
                                                  spec=state.spec)

    def update_flat_sharded(self, grad_buf, state: FlatOptState,
                            fp: FlatParams, *, mesh, axis: str = "pod"
                            ) -> Tuple[FlatParams, FlatOptState]:
        """``update_flat`` on the pod mesh: the (p, g, m, v) lanes are cut
        into contiguous per-device segments (a ``ShardedTreeSpec``
        layout, or any bus the axis divides) and the fused update runs
        once a shard (``runtime/sharding.py``; B3 a shard on the card),
        with the same host scalars — no gather, and bit-equal to the
        whole-bus pass.  The new params and moments are ``ShardedBuf``s
        (``sharding.gather_flat`` joins them)."""
        from repro_torch.runtime.sharding import sharded_adam_update_flat
        t, lr, c1, c2 = self._scalars(state.step)
        new_buf, m, v = sharded_adam_update_flat(
            fp.buf, grad_buf, state.m, state.v, lr, self.b1, self.b2,
            self.eps, self.weight_decay, c1, c2, mesh, axis)
        return fp.with_buf(new_buf), FlatOptState(m=m, v=v, step=t,
                                                  spec=state.spec)


def flat_opt_from_tree(state: OptState, spec: TreeSpec) -> FlatOptState:
    """Lift a tree OptState onto the bus layout ``spec`` (m and v share
    the params' tree structure)."""
    return FlatOptState(m=flatten_like(state.m, spec),
                        v=flatten_like(state.v, spec),
                        step=int(state.step), spec=spec)


def flat_opt_to_tree(fos: FlatOptState) -> OptState:
    """Inverse boundary: the tree OptState whose leaves are views of the
    flat lanes."""
    return OptState(step=fos.step, m=fos.leaf_m(), v=fos.leaf_v())


@dataclass(frozen=True)
class Sgd:
    """Plain SGD, or heavy-ball momentum (``m = momentum * m + g``) when
    ``momentum`` is non-zero; arithmetic in f32, results stored in each
    leaf's dtype, scalars rounded to f32 as JAX rounds a Python float
    against an f32 array."""
    lr: float | Callable[[int], float] = 1e-2
    momentum: float = 0.0

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        m = tree_map(zeros, params) if self.momentum else None
        return OptState(step=0, m=m, v=None)

    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        t = state.step + 1
        lr = R.f32(self.lr(t) if callable(self.lr) else self.lr)
        f = torch.float32
        if self.momentum:
            mu = R.f32(self.momentum)
            m = tree_map(lambda mm, g: mu * mm + g.to(f), state.m, grads)
            new = tree_map(lambda p, mm: (p.to(f) - lr * mm).to(p.dtype),
                           params, m)
            return new, OptState(step=t, m=m, v=None)
        new = tree_map(lambda p, g: (p.to(f) - lr * g.to(f)).to(p.dtype),
                       params, grads)
        return new, OptState(step=t, m=None, v=None)
