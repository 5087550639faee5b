"""VC-ASGD — the paper's parameter-update scheme (§III-C, Eq. 1/2), on the
flat bus.  Port of the flat forms of ``repro/core/vc_asgd.py``.

    W_s <- alpha * W_s + (1 - alpha) * W_{c_i,j}            (Eq. 1)
    W_{s,e} = alpha^{n_t} W_{s,e-1} + (1-alpha) sum_j alpha^{n_t-j} W_{c,j}
                                                            (Eq. 2)

Both run through ``kernels/ops``: one CUDA kernel launch for the whole
model on the card, the plain PyTorch version on the CPU.  Either way the
result is bit-identical to the reference's eager jnp and numpy paths
(separate f32 multiply and add, f32-rounded scalars).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.flat import FlatParams, stack_flats
from repro_torch.kernels import ops as K


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
