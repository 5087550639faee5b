"""VC-ASGD — the paper's parameter-update scheme (§III-C, Eq. 1/2).  Port
of ``repro/core/vc_asgd.py``.

    W_s <- alpha * W_s + (1 - alpha) * W_{c_i,j}            (Eq. 1)
    W_{s,e} = alpha^{n_t} W_{s,e-1} + (1-alpha) sum_j alpha^{n_t-j} W_{c,j}
                                                            (Eq. 2)

The flat forms run through ``kernels/ops``: one CUDA kernel launch for
the whole model on the card, the plain PyTorch version on the CPU.  The
tree forms (a dict / list tree of tensors, leaf by leaf) are the
reference semantics; ``vc_asgd_update`` goes through ``ops`` too, one
launch of the per-tensor Eq. 1 entry a leaf.  Either way the result is
bit-identical to the reference's eager jnp and numpy paths (separate f32
multiply and add, f32-rounded scalars).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flat import (FlatParams, stack_flats, tree_flatten,
                                   tree_map)
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Eq. 1 and Eq. 2 on a parameter tree, leaf by leaf
# ---------------------------------------------------------------------------

def vc_asgd_update(server, client, alpha: float):
    """Eq. 1 on every leaf: one launch of the per-tensor lerp
    (``ops.fused_lerp``) a leaf on the card, its plain version on the
    CPU."""
    return tree_map(lambda s, c: K.fused_lerp(s, c, alpha), server, client)


def _delta_lerp(s: torch.Tensor, d: torch.Tensor, alpha) -> torch.Tensor:
    oma = np.float32(1.0) - np.float32(alpha)
    return (s.to(_F32) + float(oma) * d.to(_F32)).to(s.dtype)


def vc_asgd_update_delta(server, delta, alpha: float):
    """Delta form of Eq. 1 on every leaf: ``W_s + (1-alpha) * delta`` (the
    delta taken against the same server copy)."""
    return tree_map(lambda s, d: _delta_lerp(s, d, alpha), server, delta)


def vc_asgd_update_delta_flat(server: FlatParams, delta, alpha: float
                              ) -> FlatParams:
    """Delta form on the flat bus; ``delta`` a FlatParams or a buffer."""
    d = delta.buf if isinstance(delta, FlatParams) else delta
    return server.with_buf(_delta_lerp(server.buf, d, alpha))


def assimilate_many(server, clients: Sequence, alpha: float):
    """Eq. 2 on every leaf as one weighted sum over [server, client_0, ...]
    in arrival order: exactly the fold of Eq. 1."""
    n = len(clients)
    if n == 0:
        return server
    w = assimilation_weights(n, alpha)
    return tree_map(lambda s, *cs: R.assimilate(s, torch.stack(cs), w),
                    server, *clients)


# ---------------------------------------------------------------------------
# Eq. 1 and Eq. 2 on the flat bus
# ---------------------------------------------------------------------------

def vc_asgd_update_flat(server: FlatParams, client, alpha: float
                        ) -> FlatParams:
    """Eq. 1: one lerp over the whole model.  ``client`` is a FlatParams
    or a raw buffer with the same layout."""
    c = client.buf if isinstance(client, FlatParams) else client
    return server.with_buf(K.fused_lerp_flat(server.buf, c, alpha))


def assimilation_weights(n: int, alpha: float) -> List[float]:
    """[w_server, w_0, ..., w_{n-1}] with w_server = alpha^n and
    w_j = (1-alpha) * alpha^{n-1-j}; sums to 1."""
    return [alpha ** n] + [(1.0 - alpha) * alpha ** (n - 1 - j)
                           for j in range(n)]


def assimilate_many_flat(server: FlatParams, clients, alpha: float,
                         weights: Optional[Sequence[float]] = None
                         ) -> FlatParams:
    """Eq. 2: ONE fused weighted reduction over a stacked [n, padded]
    client matrix (or a list of FlatParams / buffers), accumulated in
    arrival order.  ``weights`` overrides the Eq. 2 weights (the
    staleness-damped variant rides the same pass)."""
    if isinstance(clients, (list, tuple)):
        if len(clients) == 0:
            return server
        clients = (stack_flats(clients) if isinstance(clients[0], FlatParams)
                   else torch.stack(clients))
    n = clients.shape[0]
    if n == 0:
        return server
    w = list(weights) if weights is not None else assimilation_weights(n, alpha)
    if len(w) != n + 1:
        raise ValueError(f"need {n + 1} weights, got {len(w)}")
    return server.with_buf(K.fused_assimilate_flat(server.buf, clients, w))


def staleness_weights(n: int, alpha: float, staleness, gamma: float = 0.7
                      ) -> List[float]:
    """Per-client Eq. 2 weights with staleness damping folded in (the exact
    fold of Eq. 1 with each client's effective alpha)."""
    alphas = [staleness_alpha(alpha, float(s), gamma) for s in staleness]
    cw: List[float] = []
    for j in range(n):
        w = 1.0 - alphas[j]
        for a in alphas[j + 1:]:
            w *= a
        cw.append(w)
    return [math.prod(alphas)] + cw


# ---------------------------------------------------------------------------
# alpha schedules
# ---------------------------------------------------------------------------

AlphaSchedule = Callable[[int], float]


def const_alpha(alpha: float) -> AlphaSchedule:
    return lambda e: alpha


def var_alpha() -> AlphaSchedule:
    """The paper's §III-C schedule: alpha_e = e/(e+1), rising 0.5 -> ~1."""
    return lambda e: e / (e + 1.0)


def power_alpha(alpha_min: float = 0.5, alpha_max: float = 0.99,
                tau: float = 10.0) -> AlphaSchedule:
    """Beyond paper: exponential approach to alpha_max with time-scale tau."""
    return lambda e: alpha_max - (alpha_max - alpha_min) * math.exp(-e / tau)


def staleness_alpha(alpha: float, staleness: float, gamma: float = 0.7) -> float:
    """Beyond paper: effective alpha for a result ``staleness`` versions
    old; the client weight decays geometrically, 1-a_eff = (1-a)*gamma^s."""
    return 1.0 - (1.0 - alpha) * (gamma ** staleness)


# ---------------------------------------------------------------------------
# delay compensation (DC-ASGD, Zheng et al. [18]) and invariants
# ---------------------------------------------------------------------------

def dc_asgd_gradient(grad, w_now, w_backup, lam: float = 0.04):
    """``g + lam * g * g * (W_now - W_backup)`` on every leaf, in the
    gradient's dtype: a diagonal Hessian approximation compensating for
    gradient delay."""
    return tree_map(lambda g, wn, wb: g + lam * g * g * (wn.to(g.dtype)
                                                         - wb.to(g.dtype)),
                    grad, w_now, w_backup)


def is_convex_combination(n: int, alpha: float, atol=1e-9) -> bool:
    w = assimilation_weights(n, alpha)
    return (abs(sum(w) - 1.0) < atol) and all(x >= -atol for x in w)


def tree_norm(tree) -> torch.Tensor:
    """l2 norm over every leaf, in f32 (0-dim)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tree_flatten(tree)[0]))


def tree_max_abs(tree) -> torch.Tensor:
    """max |x| over every leaf, in f32 (0-dim)."""
    return max(torch.max(torch.abs(x.to(_F32))) for x in tree_flatten(tree)[0])
