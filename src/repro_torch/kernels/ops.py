"""Device routing for the port's kernels.

A CUDA tensor goes to the hand-written kernel (which raises on anything
it does not take); a CPU tensor goes to the plain PyTorch version in
``ref``.  Nothing else: no fallback from one to the other.  The CPU route
never touches the kernel build.

Under autograd (grad mode on and an input that requires grad) on the
card, attention, WKV6 and the selective scan go through their autograd
Functions (``FlashAttention``, ``WKV6``, ``MambaScan``): the forward
kernel, then the hand-written backward kernel.  On the CPU the plain
versions are differentiated by autograd.

Inside ``with meta_route():`` attention, WKV6 and the selective scan
also take meta tensors, for a shape-only run the caller names
(``Model.param_specs`` and a prefill over them): a call whose inputs are
all meta tensors returns empty outputs of the right shapes and dtypes and
runs neither a kernel nor a plain version.  A cuda or cpu input never
takes the route, a mix of meta and other inputs raises, and outside the
block a meta tensor raises as any other device does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import sparse_pack as _sp
from repro_torch.kernels import topk_mask as _tm
from repro_torch.kernels import vc_asgd_update as _vc


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on cuda or cpu, got {t.device}")


def fused_lerp(server, client, alpha):
    """Eq. 1 on one tensor of any shape — ONE launch on the card."""
    if _on_cuda(server):
        return _vc.vc_asgd_lerp(server, client, alpha)
    return R.vc_asgd_lerp(server, client, alpha)


def fused_dc_lerp(server, client, grad, backup, alpha, lam=0.04):
    """DC-ASGD's corrected Eq. 1 on one tensor of any shape — ONE launch."""
    if _on_cuda(server):
        return _vc.vc_asgd_dc_lerp(server, client, grad, backup, alpha, lam)
    return R.vc_asgd_dc_lerp(server, client, grad, backup, alpha, lam)


def fused_dc_lerp_flat(server_buf, client_buf, grad_buf, backup_buf, alpha,
                       lam=0.04):
    """DC-ASGD's corrected Eq. 1 over the whole flat bus — ONE launch."""
    if _on_cuda(server_buf):
        return _vc.vc_asgd_dc_lerp_flat(server_buf, client_buf, grad_buf,
                                        backup_buf, alpha, lam)
    return R.vc_asgd_dc_lerp(server_buf, client_buf, grad_buf, backup_buf,
                             alpha, lam)


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


def blocked_topk_stats(x, lo):
    """ONE memory-bound pass: per-tile packed candidate words + counts."""
    if _on_cuda(x):
        return _tm.blocked_topk_stats(x, lo)
    return R.blocked_topk_stats(x, lo)


def threshold_sparsify_exact(x, tau, tie_start, tie_budget):
    """Exact-k kept/residual emit (deterministic under ties at tau) —
    ONE launch."""
    if _on_cuda(x):
        return _tm.threshold_sparsify_exact(x, tau, tie_start, tie_budget)
    return R.threshold_sparsify_exact(x, tau, tie_start, tie_budget)


def threshold_sparsify(x, tau):
    """``|x| >= tau`` kept / residual (not exact-k under ties), tau
    compared in f32 — ONE launch."""
    if _on_cuda(x):
        return _tm.threshold_sparsify(x, tau)
    return R.threshold_sparsify(x, tau)


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


def fused_quantize_pack(sel, idx, block: int = 256):
    """Quantize + pack the sparse wire-frame body -> (body, q padded to
    ng * block, scales) — ONE launch."""
    if _on_cuda(sel):
        return _sp.quantize_pack(sel, idx, block)
    return R.quantize_pack(sel, idx, block)


_META = threading.local()


@contextlib.contextmanager
def meta_route():
    """Within the block (on this thread), attention, WKV6 and the scan
    give meta outputs for all-meta inputs."""
    prev = getattr(_META, "on", False)
    _META.on = True
    try:
        yield
    finally:
        _META.on = prev


def _on_meta(*tensors: torch.Tensor) -> bool:
    """True when the meta route is on and every input is a meta tensor;
    False when it is off or none is; a mix raises."""
    if not getattr(_META, "on", False):
        return False
    kinds = {t.device.type == "meta" for t in tensors}
    if len(kinds) > 1:
        raise ValueError(f"meta and non-meta inputs mixed: "
                         f"{[str(t.device) for t in tensors]}")
    return kinds.pop()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None):
    """q [b, h, sq, hd], k / v [b, kvh, skv, hd] -> [b, h, sq, hd]:
    online-softmax attention with GQA, causal mask, window, softcap —
    ONE launch.  Under autograd on the card: ``FlashAttention`` (the same
    launch, and the backward kernel in backward; no softcap)."""
    if _on_meta(q, k, v):
        if q.dim() != 4 or k.shape != v.shape or q.shape[1] % k.shape[1]:
            raise ValueError(f"attention of q {tuple(q.shape)} over k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)}")
        return _meta(q.shape, q.dtype)
    if _on_cuda(q):
        if _needs_grad(q, k, v):
            if softcap is not None:
                raise ValueError("the attention backward kernel takes no "
                                 "softcap (no config the port trains sets "
                                 "one)")
            return _fa.FlashAttention.apply(q, k, v, causal, window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return R.attention(q, k, v, causal=causal, window=window,
                       softcap=softcap)


def wkv6(r, k, v, w, u):
    """r / k / v / w [b, h, T, hd], u [h, hd] -> (out [b, h, T, hd] in r's
    dtype, final state [b, h, hd, hd] f32): the WKV6 recurrence from a
    zero state — ONE launch.  Under autograd on the card: ``WKV6`` (the
    same launch, also writing the chunk states; the backward kernel in
    backward; f32 only)."""
    if _on_meta(r, k, v, w, u):
        b, h, _, hd = r.shape
        return _meta(r.shape, r.dtype), _meta((b, h, hd, hd), torch.float32)
    if _on_cuda(r):
        if _needs_grad(r, k, v, w, u):
            return _rw.WKV6.apply(r, k, v, w, u)
        return _rw.wkv6(r, k, v, w, u)
    return R.wkv6(r, k, v, w, u)


def mamba_scan(u, dt, B, C, A, D):
    """u / dt [b, T, di], B / C [b, T, ds], A [di, ds], D [di] -> (y
    [b, T, di] in u's dtype, final state h_T [b, di, ds] f32): the
    selective scan from a zero state — ONE launch.  Under autograd on the
    card: ``MambaScan`` (the same launch, also writing the chunk states;
    the backward kernel in backward)."""
    if _on_meta(u, dt, B, C, A, D):
        b, _, di = u.shape
        return (_meta(u.shape, u.dtype),
                _meta((b, di, A.shape[1]), torch.float32))
    if _on_cuda(u):
        if _needs_grad(u, dt, B, C, A, D):
            return _ms.MambaScan.apply(u, dt, B, C, A, D)
        return _ms.mamba_scan(u, dt, B, C, A, D)
    return R.mamba_scan(u, dt, B, C, A, D)
