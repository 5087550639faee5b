"""Device routing for the port's kernels.

A CUDA tensor goes to the hand-written kernel (which raises on anything
it does not take); a CPU tensor goes to the plain PyTorch version in
``ref``.  Nothing else: no fallback from one to the other.  The CPU route
never touches the kernel build.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import sparse_pack as _sp
from repro_torch.kernels import vc_asgd_update as _vc


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on cuda or cpu, got {t.device}")


def fused_lerp_flat(server_buf, client_buf, alpha):
    """Eq. 1 over the whole flat bus — ONE launch on the card."""
    if _on_cuda(server_buf):
        return _vc.vc_asgd_lerp_flat(server_buf, client_buf, alpha)
    return R.vc_asgd_lerp(server_buf, client_buf, alpha)


def fused_assimilate_flat(server_buf, clients_buf, weights: Sequence[float]):
    """Eq. 2 over [n_clients, N] stacked flat buffers — ONE launch."""
    if _on_cuda(server_buf):
        return _vc.assimilate_flat(server_buf, clients_buf, weights)
    return R.assimilate(server_buf, clients_buf, weights)


def fused_adam_flat(p_buf, g_buf, m_buf, v_buf, lr, b1, b2, eps,
                    weight_decay, c1, c2):
    """Whole-model Adam (params + m/v lanes of the flat bus) — ONE launch."""
    if _on_cuda(p_buf):
        return _vc.adam_update_flat(p_buf, g_buf, m_buf, v_buf, lr, b1, b2,
                                    eps, weight_decay, c1, c2)
    return R.adam_update(p_buf, g_buf, m_buf, v_buf, lr=lr, b1=b1, b2=b2,
                         eps=eps, c1=c1, c2=c2, weight_decay=weight_decay)


def fused_easgd_flat(center_buf, replicas_buf, beta):
    """Elastic EASGD round: center [N] + replicas [n, N] — ONE launch."""
    if _on_cuda(center_buf):
        return _vc.easgd_elastic_flat(center_buf, replicas_buf, beta)
    return R.easgd_elastic(center_buf, replicas_buf, beta)


def quantize_int8(x, block: int = 256):
    """Per-block int8 of a 1-D f32 buffer -> (q, scales) — ONE launch."""
    if _on_cuda(x):
        return _qz.quantize_int8(x, block)
    return R.quantize_int8(x, block)


def dequantize_int8(q, scales, n: int, block: int = 256):
    """``q * scale`` back to f32 [n] — ONE launch."""
    if _on_cuda(q):
        return _qz.dequantize_int8(q, scales, n, block)
    return R.dequantize_int8(q, scales, n, block)


def pack_body(q, scales, idx):
    """Sparse wire-frame body bytes of an existing payload — ONE launch,
    byte copies only."""
    if _on_cuda(q):
        return _sp.pack_body(q, scales, idx)
    return R.pack_body(q, scales, idx)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None):
    """q [b, h, sq, hd], k / v [b, kvh, skv, hd] -> [b, h, sq, hd]:
    online-softmax attention with GQA, causal mask, window, softcap —
    ONE launch."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return R.attention(q, k, v, causal=causal, window=window,
                       softcap=softcap)


def wkv6(r, k, v, w, u):
    """r / k / v / w [b, h, T, hd], u [h, hd] -> (out [b, h, T, hd] in r's
    dtype, final state [b, h, hd, hd] f32): the WKV6 recurrence from a
    zero state — ONE launch."""
    if _on_cuda(r):
        return _rw.wkv6(r, k, v, w, u)
    return R.wkv6(r, k, v, w, u)


def mamba_scan(u, dt, B, C, A, D):
    """u / dt [b, T, di], B / C [b, T, ds], A [di, ds], D [di] -> (y
    [b, T, di] in u's dtype, final state h_T [b, di, ds] f32): the
    selective scan from a zero state — ONE launch."""
    if _on_cuda(u):
        return _ms.mamba_scan(u, dt, B, C, A, D)
    return R.mamba_scan(u, dt, B, C, A, D)
