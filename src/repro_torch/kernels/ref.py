"""Plain PyTorch versions of the flat-bus kernels: what ``ops`` runs for
CPU tensors and what ``chip_smoke.py`` holds each CUDA kernel against.

Each mirrors the reference's arithmetic operation by operation — separate
f32 multiplies and adds (eager PyTorch fuses nothing, so there is no FMA),
scalars rounded to f32 exactly as JAX rounds a Python float against an f32
array — so the CPU path is bit-identical to the reference's eager jnp and
numpy paths, and the CUDA kernels (which spell every operation out with
``__fmul_rn``/``__fadd_rn``) are bit-identical to these.

Scalar divisors are 0-dim tensors on the operand's device: on CUDA,
PyTorch turns a division by a host scalar into a multiplication by its
reciprocal, which is not the IEEE quotient.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_F32 = torch.float32


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(x))


def vc_asgd_lerp(server: torch.Tensor, client: torch.Tensor, alpha
                 ) -> torch.Tensor:
    """Eq. 1: ``a*s + (1-a)*c`` in f32, stored in the server's dtype.
    ``1-a`` is taken in f32 (vc_asgd.py:124/:129 of the reference)."""
    a = np.float32(alpha)
    oma = np.float32(1.0) - a
    return (float(a) * server.to(_F32)
            + float(oma) * client.to(_F32)).to(server.dtype)


def assimilate(server: torch.Tensor, clients: torch.Tensor,
               weights: Sequence[float]) -> torch.Tensor:
    """Eq. 2: ``w0*s + sum_j w_{j+1}*c_j`` accumulated in arrival order,
    each weight rounded to f32 — the jnp branch of the reference's
    ``assimilate_many_flat``."""
    acc = f32(weights[0]) * server.to(_F32)
    for j in range(clients.shape[0]):
        acc = acc + f32(weights[j + 1]) * clients[j].to(_F32)
    return acc.to(server.dtype)


def adam_update(p, g, m, v, *, lr, b1, b2, eps, c1, c2, weight_decay=0.0):
    """One Adam step (bias-corrected; ``c1 = 1-b1^t``, ``c2 = 1-b2^t``
    precomputed).  Returns (p', m', v') with m/v in f32 and p' in p's
    dtype.  Python-float scalars combine in double before rounding to
    f32, as they do in the reference's ``ref.adam_update``."""
    dev = p.device
    g = g.to(_F32)
    m = f32(b1) * m.to(_F32) + f32(1 - b1) * g
    v = f32(b2) * v.to(_F32) + f32(1 - b2) * g * g
    c1t = torch.tensor(f32(c1), dtype=_F32, device=dev)
    c2t = torch.tensor(f32(c2), dtype=_F32, device=dev)
    step = f32(lr) * (m / c1t) / (torch.sqrt(v / c2t) + f32(eps))
    if weight_decay:
        step = step + f32(lr * weight_decay) * p.to(_F32)
    return (p.to(_F32) - step).to(p.dtype), m, v
