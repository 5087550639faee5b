"""Plain PyTorch versions of the port's kernels (the flat-bus updates, the
int8 codec, the sparse-body pack, attention, the WKV6 recurrence and the
selective scan): what ``ops`` runs for CPU tensors
and what ``chip_smoke.py`` holds each CUDA kernel against.

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

import math
from typing import Optional, Sequence

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


def easgd_elastic(center: torch.Tensor, replicas: torch.Tensor, beta):
    """One elastic round for the whole pod (Zhang et al.):
    ``c' = c + beta * sum_j (x_j - c)`` and ``x_j' = x_j - beta * (x_j - c)``
    for center [N] and replicas [n, N], in f32, stored in the inputs'
    dtypes.  The sum is accumulated from zero in replica order — the
    order of the Pallas ``_easgd_kernel`` — and ``beta`` is rounded to f32
    as JAX rounds a Python float against an f32 array."""
    b = f32(beta)
    c = center.to(_F32)
    x = replicas.to(_F32)
    diff = x - c[None, :]
    acc = torch.zeros_like(c)
    for j in range(x.shape[0]):
        acc = acc + diff[j]
    return (c + b * acc).to(center.dtype), (x - b * diff).to(replicas.dtype)


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Symmetric per-block int8: ``x`` (any shape, n elements) ->
    (q int8 [n], scales f32 [ceil(n/block)]).  Per block,
    ``scale = max(max|x| / 127, 1e-12)`` and
    ``q = clip(round_half_even(x / scale), -127, 127)``; the last block is
    zero-padded.  The scale divides as a 0-dim tensor (IEEE quotient on
    every device, see the module note)."""
    n = x.numel()
    pad = (-n) % block
    xf = torch.nn.functional.pad(x.reshape(-1).to(_F32), (0, pad))
    xf = xf.reshape(-1, block)
    scale = xf.abs().amax(dim=1, keepdim=True) / torch.tensor(
        127.0, dtype=_F32, device=x.device)
    scale = torch.maximum(scale, torch.tensor(f32(1e-12), dtype=_F32,
                                              device=x.device))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.reshape(-1)[:n], scale[:, 0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int,
                    block: int = 256) -> torch.Tensor:
    """``q * scale`` per block, in f32 -> [n]."""
    pad = (-n) % block
    qf = torch.nn.functional.pad(q.reshape(-1).to(_F32), (0, pad))
    return (qf.reshape(-1, block) * scales.to(_F32)[:, None]).reshape(-1)[:n]


def pack_body(q: torch.Tensor, scales: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """Sparse wire-frame body: values int8 [k] || scales f32 [ng] ||
    indices int32 [k] as one uint8 buffer — the arrays' own bytes
    (little-endian), no arithmetic."""
    return torch.cat([q.to(torch.int8).reshape(-1).view(torch.uint8),
                      scales.to(_F32).reshape(-1).view(torch.uint8),
                      idx.to(torch.int32).reshape(-1).view(torch.uint8)])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, h, sq, hd]; k / v [b, kvh, skv, hd] (each kv head repeated
    for its h / kvh query heads) -> [b, h, sq, hd] in q's dtype: the
    reference's ``ref.attention``, all in f32, masked scores at -1e30,
    positions counted from 0 for queries and keys alike."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_F32), k.to(_F32)) / math.sqrt(hd)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.to(_F32)).to(q.dtype)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor):
    """The WKV6 recurrence, step by step from S = 0, all in f32 — the
    reference's ``ref.wkv6`` in the same sum order.  r/k/v/w [b, h, T, hd]
    (w the decay in (0, 1)), u [h, hd].  Returns (out [b, h, T, hd] in r's
    dtype, the final state S_T [b, h, hd, hd] in f32)."""
    b, h, T, hd = r.shape
    S = torch.zeros(b, h, hd, hd, dtype=_F32, device=r.device)
    rf, kf, vf, wf = (t.to(_F32) for t in (r, k, v, w))
    uf = u.to(_F32)
    outs = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(((S + uf[None, :, :, None] * kv)
                     * rf[:, :, t, :, None]).sum(dim=2))
        S = wf[:, :, t, :, None] * S + kv
    return torch.stack(outs, dim=2).to(r.dtype), S


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, D: torch.Tensor):
    """The selective scan, step by step from h = 0, all in f32 — the
    reference's ``ref.mamba_scan`` in the same operation order.  u / dt
    [b, T, di], B / C [b, T, ds] (any strides), A [di, ds], D [di].
    Returns (y [b, T, di] in u's dtype, the final state h_T [b, di, ds]
    in f32)."""
    b, T, di = u.shape
    A, D = A.to(_F32), D.to(_F32)
    h = torch.zeros(b, di, A.shape[1], dtype=_F32, device=u.device)
    uf, dtf, Bf, Cf = (t.to(_F32) for t in (u, dt, B, C))
    outs = []
    for t in range(T):
        a_bar = torch.exp(dtf[:, t, :, None] * A)
        h = a_bar * h + (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        outs.append((h * Cf[:, t, None, :]).sum(-1) + D * uf[:, t])
    return torch.stack(outs, dim=1).to(u.dtype), h
