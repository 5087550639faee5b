"""Plain PyTorch versions of the port's kernels (the flat-bus updates and
DC-ASGD's corrected lerp, the two passes of the blocked top-k and the
threshold pass, the int8 codec, the sparse-body pack and the fused
quantize + pack, attention, the WKV6 recurrence and the selective scan,
and the backwards of attention and of the two scans): what ``ops`` runs
for CPU tensors and what ``chip_smoke.py`` holds each CUDA kernel
against.

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


def vc_asgd_dc_lerp(server: torch.Tensor, client: torch.Tensor,
                    grad: torch.Tensor, backup: torch.Tensor, alpha,
                    lam=0.04) -> torch.Tensor:
    """DC-ASGD's corrected Eq. 1 (the Pallas ``_dc_lerp_kernel``):
    ``c' = c + ((lam*g)*g)*(s - b)``, then ``a*s + (1-a)*c'``, in f32,
    stored in the server's dtype; ``alpha`` and ``lam`` rounded to f32 and
    ``1-a`` taken in f32."""
    a = np.float32(alpha)
    oma = np.float32(1.0) - a
    s = server.to(_F32)
    g = grad.to(_F32)
    cc = client.to(_F32) + f32(lam) * g * g * (s - backup.to(_F32))
    return (float(a) * s + float(oma) * cc).to(server.dtype)


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
    f32, as they do in the reference's ``ref.adam_update``.  The square
    root is the correctly rounded f32 one (B3's ``__fsqrt_rn``, XLA's):
    taken in f64 and rounded once, since ``torch.sqrt`` of f32 on the CPU
    (MKL's vector math) is 1 ulp off on ~0.7% of elements."""
    dev = p.device
    g = g.to(_F32)
    m = f32(b1) * m.to(_F32) + f32(1 - b1) * g
    v = f32(b2) * v.to(_F32) + f32(1 - b2) * g * g
    c1t = torch.tensor(f32(c1), dtype=_F32, device=dev)
    c2t = torch.tensor(f32(c2), dtype=_F32, device=dev)
    root = torch.sqrt((v / c2t).double()).to(_F32)
    step = f32(lr) * (m / c1t) / (root + f32(eps))
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


TOPK_BLOCK = 8 * 1024                  # tile of the blocked top-k passes


def _tiles(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` as f32 [nb, block], the tail zero-padded."""
    n = x.numel()
    nb = -(-n // block)
    return torch.nn.functional.pad(x.reshape(-1).to(_F32),
                                   (0, nb * block - n)).reshape(nb, block)


def blocked_topk_stats(x: torch.Tensor, lo, block: int = TOPK_BLOCK):
    """Per tile of ``block`` elements, the packed candidate words (bit i
    of word w set where ``bits(|x[32 w + i]|) >= lo``) and the count of
    candidates.  ``lo`` is a magnitude-bits bracket (an int or a one-element
    int32 tensor; the bits of a non-negative float are monotone as int32).
    Returns (words int32 [nb, block // 32] holding the u32 bit patterns,
    counts int32 [nb])."""
    xf = _tiles(x, block)
    nb = xf.shape[0]
    lo = torch.as_tensor(lo, device=x.device).reshape(-1)[:1].to(torch.int32)
    keep = (xf.abs().view(torch.int32) >= lo).reshape(nb, block // 32, 32)
    lanes = torch.arange(32, device=x.device, dtype=torch.int64)
    words = (keep.to(torch.int64) << lanes).sum(dim=2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (words.to(torch.int32),
            keep.reshape(nb, -1).sum(dim=1).to(torch.int32))


def threshold_sparsify_exact(x: torch.Tensor, tau, tie_start, tie_budget,
                             block: int = TOPK_BLOCK):
    """Exact-k emit: ``|x| > tau`` is kept always, ``|x| == tau`` while the
    global tie rank (``tie_start[tile]`` plus the exclusive rank inside
    the tile) is below ``tie_budget``.  ``tau`` f32 and ``tie_budget``
    int32, each a number or a one-element tensor.  Returns (kept,
    residual) f32 shaped like ``x``: kept = x or 0.0, residual = x - kept,
    so kept + residual == x exactly."""
    n = x.numel()
    dev = x.device
    xf = _tiles(x, block)
    tau = torch.as_tensor(tau, dtype=_F32, device=dev).reshape(-1)[:1]
    budget = torch.as_tensor(tie_budget, dtype=torch.int32,
                             device=dev).reshape(-1)[:1]
    mag = xf.abs()
    tie = mag == tau
    tie_i = tie.to(torch.int32)
    rank = (torch.as_tensor(tie_start, dtype=torch.int32,
                            device=dev).reshape(-1, 1)
            + torch.cumsum(tie_i, dim=1, dtype=torch.int32) - tie_i)
    keep = (mag > tau) | (tie & (rank < budget))
    kept = torch.where(keep, xf, torch.zeros((), dtype=_F32, device=dev))
    unpad = lambda t: t.reshape(-1)[:n].reshape(x.shape)
    return unpad(kept), unpad(xf - kept)


def threshold_sparsify(x: torch.Tensor, tau):
    """The threshold pass (the Pallas ``_mask_kernel``; not exact-k under
    ties): ``kept = |x| >= tau ? x : 0`` and ``residual = x - kept`` in
    f32, both stored in x's dtype, so ``kept + residual == x``.  ``tau``
    (a number or a one-element tensor) is an f32 compared in f32, as the
    kernel compares it; the reference's jnp oracle compares bf16 ``x``
    against ``tau`` rounded to bf16 instead."""
    xf = x.to(_F32)
    tau = torch.as_tensor(tau, dtype=_F32, device=x.device).reshape(-1)[:1]
    kept = torch.where(xf.abs() >= tau, xf,
                       torch.zeros((), dtype=_F32, device=x.device))
    return kept.to(x.dtype), (xf - kept).to(x.dtype)


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


def quantize_pack(sel: torch.Tensor, idx: torch.Tensor, block: int = 256):
    """Quantize + pack (the Pallas ``_pack_kernel``): ``quantize_int8``
    then ``pack_body``.  Returns (body uint8 [5k + 4ng], q int8
    [ng * block] zero-padded, scales f32 [ng])."""
    k = sel.numel()
    ng = -(-k // block)
    q, scales = quantize_int8(sel, block)
    qpad = torch.nn.functional.pad(q, (0, ng * block - k))
    return pack_body(q, scales, idx), qpad, scales


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


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None):
    """The gradients of ``attention`` (no softcap) by the explicit formula
    the backward kernel computes, all in f32: p the masked softmax of the
    scaled scores, delta = rowsum(do * o), ds = p (do v^T - delta),
    dq = ds k / sqrt(hd), dk = ds^T q / sqrt(hd), dv = p^T do, dk and dv
    summed over each kv head's h / kvh query heads.  Returns (dq, dk, dv)
    in q's dtype."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    qf, of, dof = q.to(_F32), o.to(_F32), do.to(_F32)
    kf = k.to(_F32).repeat_interleave(rep, dim=1)
    vf = v.to(_F32).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(hd)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & (kp > qp - window)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) / math.sqrt(hd)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) / math.sqrt(hd)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, kvh, rep, skv, hd).sum(2)
    dv = dv.reshape(b, kvh, rep, skv, hd).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, do: torch.Tensor):
    """The gradients of ``wkv6``'s out (not of its final state) against
    ``do`` [b, h, T, hd], by the explicit reverse recurrence the backward
    kernel computes, all in f32.  With S_{t-1} the state before step t
    and G_t the gradient w.r.t. S_t (G_{T-1} = 0,
    G_{t-1} = w_t G_t + r_t do_t^T, row-scaled):

        dr_t = (S_{t-1} + u k_t v_t^T) do_t
        dk_t = (G_t + u r_t do_t^T) v_t
        dv_t = (G_t + u r_t do_t^T)^T k_t
        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        du = sum_{b,t} r_t k_t (v_t . do_t)

    The states are stepped forward, never recovered by dividing by w (a
    decay of 0 leaves nothing to divide).  Returns (dr, dk, dv, dw
    [b, h, T, hd] in r's dtype, du [h, hd] f32)."""
    b, h, T, hd = r.shape
    rf, kf, vf, wf, dof = (t.to(_F32) for t in (r, k, v, w, do))
    uf = u.to(_F32)[None, :, :, None]                   # [1, h, hd, 1]
    S = torch.zeros(b, h, hd, hd, dtype=_F32, device=r.device)
    prev = []
    for t in range(T):
        prev.append(S)
        S = (wf[:, :, t, :, None] * S
             + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    G = torch.zeros_like(S)
    grads = [torch.empty(b, h, T, hd, dtype=_F32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros(b, h, hd, dtype=_F32, device=r.device)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, dot = (x[:, :, t] for x in (rf, kf, vf, dof))
        s_hat = prev[t] + uf * (kt[..., :, None] * vt[..., None, :])
        g_hat = G + uf * (rt[..., :, None] * dot[..., None, :])
        dr[:, :, t] = (s_hat * dot[..., None, :]).sum(-1)
        dk[:, :, t] = (g_hat * vt[..., None, :]).sum(-1)
        dv[:, :, t] = (g_hat * kt[..., :, None]).sum(-2)
        dw[:, :, t] = (G * prev[t]).sum(-1)
        du = du + rt * kt * (vt * dot).sum(-1, keepdim=True)
        G = wf[:, :, t, :, None] * G + rt[..., :, None] * dot[..., None, :]
    return (*(g.to(r.dtype) for g in grads), du.sum(0))


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


def mamba_scan_bwd(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor):
    """The gradients of ``mamba_scan``'s y (not of its final state)
    against ``dy`` [b, T, di], by the explicit reverse recurrence the
    backward kernel computes, all in f32.  With a_t = exp(dt_t A), h_{t-1}
    the state before step t and g_t the gradient w.r.t. h_t
    (g_t = C_t dy_t + a_{t+1} g_{t+1}, g_T = 0):

        du_t  = D dy_t + dt_t sum_s g_t B_t
        ddt_t = u_t sum_s g_t B_t + sum_s g_t A a_t h_{t-1}
        dA    = sum_{b,t} g_t dt_t a_t h_{t-1}
        dB_t  = sum_d g_t dt_t u_t,   dC_t = sum_d dy_t h_t
        dD    = sum_{b,t} dy_t u_t

    Returns (du in u's dtype, ddt [b, T, di], dB, dC [b, T, ds], dA
    [di, ds], dD [di], all f32)."""
    b, T, di = u.shape
    A, D = A.to(_F32), D.to(_F32)
    uf, dtf, Bf, Cf, dyf = (t.to(_F32) for t in (u, dt, B, C, dy))
    h = torch.zeros(b, di, A.shape[1], dtype=_F32, device=u.device)
    prev = []
    for t in range(T):
        prev.append(h)
        h = (torch.exp(dtf[:, t, :, None] * A) * h
             + (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :])
    du = torch.empty(b, T, di, dtype=_F32, device=u.device)
    ddt = torch.empty_like(du)
    dB = torch.empty(b, T, A.shape[1], dtype=_F32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros(b, di, A.shape[1], dtype=_F32, device=u.device)
    carry = torch.zeros_like(h)                         # a_{t+1} g_{t+1}
    for t in range(T - 1, -1, -1):
        a = torch.exp(dtf[:, t, :, None] * A)
        ht = (a * prev[t]
              + (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :])
        g = Cf[:, t, None, :] * dyf[:, t, :, None] + carry
        gB = (g * Bf[:, t, None, :]).sum(-1)
        gah = g * a * prev[t]
        du[:, t] = D * dyf[:, t] + dtf[:, t] * gB
        ddt[:, t] = uf[:, t] * gB + (gah * A).sum(-1)
        dA = dA + gah * dtf[:, t, :, None]
        dB[:, t] = (g * (dtf[:, t] * uf[:, t])[:, :, None]).sum(1)
        dC[:, t] = (ht * dyf[:, t, :, None]).sum(1)
        carry = a * g
    dD = (dyf * uf).sum((0, 1))
    return du.to(u.dtype), ddt, dB, dC, dA.sum(0), dD
