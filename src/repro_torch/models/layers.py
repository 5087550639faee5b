"""Building blocks of the transformer (port of ``repro/models/layers.py``:
the dense path, the MoE with its dense and expert-parallel dispatches,
and blocked attention over context-parallel chunks).

Plain functions over parameter dicts, in the reference's layouts:
activations [b, s, d], attention heads [b, s, h, hd], decode caches in
the two-tier layout.  Arithmetic follows the reference operation by
operation: norms in f32 cast back, rope angles in f32, matmuls in the
compute dtype (``cfg.cdtype``), decode-attention scores and the softmax
in f32.  Prefill attention goes through ``ops.flash_attention`` (the
hand-written kernel on the card, ``ref.attention`` on the CPU).

Initialisers draw on the CPU from an explicit ``torch.Generator`` with
the reference's distributions (they cannot give JAX's bits);
``transformer.init_lm`` moves each layer to the target device.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig

NEG_INF = -1e30  # large-negative for masking (bf16-safe after cast)
RECENT_RING = 64
_F32 = torch.float32


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, dtype, std: float):
    return torch.randn(shape, generator=gen, dtype=_F32).mul_(std).to(dtype)


def he_normal(gen, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, dtype, math.sqrt(2.0 / fan_in))


def lecun_normal(gen, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, dtype, math.sqrt(1.0 / fan_in))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    p = {"scale": torch.ones(dim, dtype=cfg.pdtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=cfg.pdtype)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x32 = x.to(_F32)
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(_F32) + p["bias"].to(_F32)
    else:
        var = (x32 ** 2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(_F32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)      # one entry per (rot, theta, device)
def _freqs(rot: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=_F32,
                                         device=device) / rot))


def rope_freqs(cfg: ModelConfig, theta: float, device="cpu") -> torch.Tensor:
    rot = int(cfg.hd * cfg.rope_pct)
    rot -= rot % 2
    return _freqs(rot, float(theta), torch.device(device))


def apply_rope(x: torch.Tensor, positions: Union[torch.Tensor, int],
               cfg: ModelConfig, theta: Optional[float] = None
               ) -> torch.Tensor:
    """x: [..., s, h, hd]; positions: an int tensor broadcastable to
    x[..., s] (prefill), or one position as a Python number (decode, the
    reference's f32 position)."""
    if cfg.pos_emb != "rope":
        return x
    theta = theta if theta is not None else cfg.rope_theta
    freqs = rope_freqs(cfg, theta, x.device)              # [rot/2]
    rot = freqs.shape[0] * 2
    if isinstance(positions, torch.Tensor):
        ang = positions[..., None].to(_F32) * freqs       # [..., s, rot/2]
    else:
        ang = (freqs * float(positions))[None]            # [1, rot/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), xp], dim=-1)


@functools.lru_cache(maxsize=8)       # one entry per (seq, dim)
def _sinusoidal_cpu(seq: int, dim: int) -> torch.Tensor:
    pos = torch.arange(seq, dtype=_F32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=_F32)
                    * torch.tensor(-math.log(10000.0) / dim, dtype=_F32))
    pe = torch.zeros(seq, dim, dtype=_F32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def sinusoidal_pos(seq: int, dim: int, device="cpu") -> torch.Tensor:
    """[seq, dim] f32 sinusoidal positions, the reference's ops in f32
    (the scale constant rounded to f32 first, as JAX's weak float is),
    computed on the CPU once per shape and copied to ``device``, so the
    card and the CPU add the same bits."""
    return _sinusoidal_cpu(int(seq), int(dim)).to(device)


# ---------------------------------------------------------------------------
# attention parameters
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.pdtype
    p = {
        "wq": he_normal(gen, (d, h * hd), pd),
        "wk": he_normal(gen, (d, kv * hd), pd),
        "wv": he_normal(gen, (d, kv * hd), pd),
        "wo": he_normal(gen, (h * hd, d), pd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=pd)
        p["bk"] = torch.zeros(kv * hd, dtype=pd)
        p["bv"] = torch.zeros(kv * hd, dtype=pd)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=pd)
        p["k_norm"] = torch.ones(hd, dtype=pd)
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    x32 = x.to(_F32)
    y = x32 * torch.rsqrt((x32 ** 2).mean(-1, keepdim=True) + eps)
    return (y * scale.to(_F32)).to(x.dtype)


def qkv_proj(p, x: torch.Tensor, cfg: ModelConfig):
    """x: [..., s, d] -> q [..., s, h, hd], k/v [..., s, kv, hd]."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.cdtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(*q.shape[:-1], h, hd)
    k = k.reshape(*k.shape[:-1], kv, hd)
    v = v.reshape(*v.shape[:-1], kv, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., s, kv, hd] -> [..., s, h, hd] by repeating each kv head."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=-2)


# ---------------------------------------------------------------------------
# attention (train / prefill)
# ---------------------------------------------------------------------------

def _positions(pos, n: int) -> np.ndarray:
    """``pos`` (numpy, a tensor or a sequence) as an int64 numpy array,
    or ``arange(n)`` when it is None: the reference's trace-time-constant
    positions."""
    if pos is None:
        return np.arange(n, dtype=np.int64)
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    return np.asarray(pos, dtype=np.int64)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      q_positions=None, kv_positions=None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Attention in the reference's layout, with its position masks.

    q:   [b, P, sq, h, hd]  (P = the CP chunk dim; 1 when not chunked)
    k,v: [b, skv, kvh, hd]
    q_positions: [P, sq] global query positions (default: the arange of
    sq, P = 1); kv_positions: [skv] (default: the arange).  A query sees
    the keys at or before it (``causal``) and within ``window``.  Returns
    [b, P, sq, h, hd].

    When the query positions are the contiguous chunk layout (chunk p
    holds p*sq ... p*sq + sq - 1) and the keys the arange, this is one
    call of ``ops.flash_attention`` on the [b, h, P*sq, hd] views (no
    copy on the card; the kernel's forward and, under autograd, its
    backward).  Other positions (the strided CP layout, masked
    duplicates) run the plain masked softmax on the CPU and raise on the
    card, which has no kernel for them."""
    b, P, sq, h, hd = q.shape
    skv = k.shape[1]
    if q_positions is None and P != 1:
        raise ValueError(f"{P} query chunks need q_positions")
    qpos = _positions(q_positions, sq).reshape(P, sq)
    kpos = _positions(kv_positions, skv).reshape(skv)
    if (np.array_equal(qpos.reshape(-1), np.arange(P * sq))
            and np.array_equal(kpos, np.arange(skv))):
        o = ops.flash_attention(q.reshape(b, P * sq, h, hd).transpose(1, 2),
                                k.transpose(1, 2), v.transpose(1, 2),
                                causal=causal, window=window,
                                softcap=softcap)
        return o.transpose(1, 2).reshape(b, P, sq, h, hd)
    if q.is_cuda:
        raise NotImplementedError(
            f"attention at query positions {qpos.tolist()[:2]}... (not the "
            f"contiguous chunk layout) or key positions other than the "
            f"arange has no kernel on the card: only the contiguous CP "
            f"layout runs B13")
    return _masked_attention(q, k, v, torch.from_numpy(qpos),
                             torch.from_numpy(kpos), causal=causal,
                             window=window, softcap=softcap)


def _masked_attention(q, k, v, qpos, kpos, *, causal: bool, window,
                      softcap) -> torch.Tensor:
    """The plain attention of ``blocked_attention`` at arbitrary
    positions: scores in f32, masked at -1e30, softmax, all in f32."""
    h, hd = q.shape[3], q.shape[4]
    kh = repeat_kv(k, h).to(_F32)
    vh = repeat_kv(v, h).to(_F32)
    s = torch.einsum("bpqhd,bkhd->bphqk", q.to(_F32), kh) / math.sqrt(hd)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.ones(qpos.shape + kpos.shape, dtype=torch.bool)
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos[None, None, :])
    if window is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    s = s.masked_fill(~mask[None, :, None].to(s.device), NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bphqk,bkhd->bpqhd", w, vh)
    return o.to(q.dtype)


def strided_positions(P: int, sq_local: int) -> np.ndarray:
    """Strided CP layout: chunk p owns global positions p, p+P, p+2P, ..."""
    return (np.arange(P, dtype=np.int32)[:, None]
            + P * np.arange(sq_local, dtype=np.int32)[None, :])


# ---------------------------------------------------------------------------
# two-tier decode KV cache
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-attention-layer decode cache.

    k_old/v_old: [b, kv, C, L, hd]  the old tier (prompt, then compacted)
    old_pos:     [C, L] int32       global position of every old slot (-1: empty)
    k_rec/v_rec: [b, kv, R, hd]     the recent ring, written every step
    rec_pos:     [R] int32          global position per recent slot (-1: empty)
    """
    k_old: torch.Tensor
    v_old: torch.Tensor
    old_pos: torch.Tensor
    k_rec: torch.Tensor
    v_rec: torch.Tensor
    rec_pos: torch.Tensor


def make_decode_cache(b: int, kv: int, chunks: int, chunk_len: int, hd: int,
                      dtype, prefilled: int = 0, recent: int = RECENT_RING,
                      device="cpu") -> DecodeCache:
    """Empty (or logically-prefilled) cache; old_pos marks validity."""
    pos = torch.arange(chunks * chunk_len, dtype=torch.int32,
                       device=device).reshape(chunks, chunk_len)
    old_pos = torch.where(pos < prefilled, pos, torch.full_like(pos, -1))
    return DecodeCache(
        k_old=torch.zeros(b, kv, chunks, chunk_len, hd, dtype=dtype,
                          device=device),
        v_old=torch.zeros(b, kv, chunks, chunk_len, hd, dtype=dtype,
                          device=device),
        old_pos=old_pos,
        k_rec=torch.zeros(b, kv, recent, hd, dtype=dtype, device=device),
        v_rec=torch.zeros(b, kv, recent, hd, dtype=dtype, device=device),
        rec_pos=torch.full((recent,), -1, dtype=torch.int32, device=device),
    )


def meta_spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (the reference's ``ShapeDtypeStruct``):
    a tensor on the meta device, which allocates nothing."""
    return torch.empty(tuple(int(n) for n in shape), dtype=dtype,
                       device="meta")


def cache_specs(b: int, kv: int, chunks: int, chunk_len: int, hd: int,
                dtype, recent: int = RECENT_RING) -> DecodeCache:
    """Meta tensors mirroring ``make_decode_cache`` (the dry-run's and the
    mesh plans' cache shapes)."""
    i32 = torch.int32
    return DecodeCache(
        k_old=meta_spec((b, kv, chunks, chunk_len, hd), dtype),
        v_old=meta_spec((b, kv, chunks, chunk_len, hd), dtype),
        old_pos=meta_spec((chunks, chunk_len), i32),
        k_rec=meta_spec((b, kv, recent, hd), dtype),
        v_rec=meta_spec((b, kv, recent, hd), dtype),
        rec_pos=meta_spec((recent,), i32),
    )


def decode_attention(q: torch.Tensor, cache: DecodeCache, pos: int, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a two-tier cache.

    q: [b, h, hd]; pos: the current position.  Scores, softmax and the
    weighted sum in f32 over the compute-dtype operands (the reference's
    ``preferred_element_type=f32``: the products of bf16 values are exact
    in f32), p cast to q's dtype before the product with V, as there.
    """
    b, h, hd = q.shape
    _, kv, C, L, _ = cache.k_old.shape
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kv, h // kv, hd).to(_F32)

    def f32(t):
        return t.to(q.dtype).to(_F32)

    k_old = f32(cache.k_old).reshape(b, kv, C * L, hd)
    v_old = f32(cache.v_old).reshape(b, kv, C * L, hd)
    s_old = (qg @ k_old.transpose(-1, -2)) * scale       # [b, kv, g, C*L]
    s_rec = (qg @ f32(cache.k_rec).transpose(-1, -2)) * scale
    if softcap is not None:
        s_old = torch.tanh(s_old / softcap) * softcap
        s_rec = torch.tanh(s_rec / softcap) * softcap

    old_pos, rec_pos = cache.old_pos.reshape(C * L), cache.rec_pos
    ok_old = (old_pos >= 0) & (old_pos <= pos)
    ok_rec = (rec_pos >= 0) & (rec_pos <= pos)
    if window is not None:
        ok_old = ok_old & (old_pos > pos - window)
        ok_rec = ok_rec & (rec_pos > pos - window)
    s_old = s_old.masked_fill(~ok_old, NEG_INF)
    s_rec = s_rec.masked_fill(~ok_rec, NEG_INF)

    m = torch.maximum(s_old.amax(-1), s_rec.amax(-1))[..., None]
    p_old = torch.exp(s_old - m)
    p_rec = torch.exp(s_rec - m)
    denom = p_old.sum(-1) + p_rec.sum(-1)
    o = (f32(p_old) @ v_old) + (f32(p_rec) @ f32(cache.v_rec))
    o = o / torch.clamp(denom[..., None], min=1e-30)
    return o.reshape(b, h, hd).to(q.dtype)


def cache_append_recent(cache: DecodeCache, k_new: torch.Tensor,
                        v_new: torch.Tensor, pos: int) -> DecodeCache:
    """Write this step's K/V [b, kv, hd] into ring slot ``pos mod R``.
    In place (the reference returns a new cache; the port updates the
    ring it holds, so a decode step allocates no cache), and returns the
    cache."""
    slot = pos % cache.k_rec.shape[2]
    cache.k_rec[:, :, slot] = k_new.to(cache.k_rec.dtype)
    cache.v_rec[:, :, slot] = v_new.to(cache.v_rec.dtype)
    cache.rec_pos[slot] = pos
    return cache


def compact_cache(cache: DecodeCache, pos: int) -> DecodeCache:
    """Fold the recent ring into the old tier (every RECENT_RING steps):
    ring slot r lands at old slot ``rec_pos[r] mod (C*L)``, as in the
    reference — so a full-attention layer's old tier, which holds exactly
    the prompt, keeps a rolling window of the prompt's length.  Written as
    the reference writes it (a one-hot product over the ring), so ring
    slots that map to one old slot (C*L < R) sum there as they do in the
    reference.  Returns a new cache with an empty ring."""
    b, kvh, C, L, hd = cache.k_old.shape
    R = cache.k_rec.shape[2]
    dev = cache.k_old.device
    tgt = torch.remainder(cache.rec_pos, C * L)
    onehot = (torch.arange(C * L, dtype=torch.int32, device=dev)[None, :]
              == tgt[:, None])
    onehot = onehot & (cache.rec_pos >= 0)[:, None]            # [R, C*L]
    sel = onehot.any(0)                                         # [C*L]
    kr = torch.einsum("rl,bkrd->bkld", onehot.to(cache.k_rec.dtype),
                      cache.k_rec)
    vr = torch.einsum("rl,bkrd->bkld", onehot.to(cache.v_rec.dtype),
                      cache.v_rec)
    new_pos = (onehot.to(torch.int32) * cache.rec_pos[:, None]).sum(0)
    k_old = torch.where(sel[None, None, :, None], kr,
                        cache.k_old.reshape(b, kvh, C * L, hd))
    v_old = torch.where(sel[None, None, :, None], vr,
                        cache.v_old.reshape(b, kvh, C * L, hd))
    old_pos = torch.where(sel, new_pos.to(torch.int32),
                          cache.old_pos.reshape(C * L))
    return DecodeCache(
        k_old=k_old.reshape(b, kvh, C, L, hd),
        v_old=v_old.reshape(b, kvh, C, L, hd),
        old_pos=old_pos.reshape(C, L),
        k_rec=torch.zeros_like(cache.k_rec),
        v_rec=torch.zeros_like(cache.v_rec),
        rec_pos=torch.full((R,), -1, dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.pdtype
    p = {"wi": he_normal(gen, (d, f), pd)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["wg"] = he_normal(gen, (d, f), pd)
    p["wo"] = he_normal(gen, (f, d), pd)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.cdtype
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    elif cfg.mlp_act == "geglu":
        h = F.gelu(x @ p["wg"].to(dt), approximate="tanh") * (x @ p["wi"].to(dt))
    else:
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-bounded, local dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig):
    """SwiGLU expert weights (every MoE config of the repo is swiglu) in
    the reference's virtual layout [e*v, d, f/v] (v = 1 without expert
    parallelism: the published [e, d, f])."""
    m = cfg.moe
    d, f, ev, pd = cfg.d_model, m.d_ff_virtual, m.n_virtual, cfg.pdtype
    return {"router": lecun_normal(gen, (d, m.n_experts), pd),
            "wi": he_normal(gen, (ev, d, f), pd, fan_in=d),
            "wg": he_normal(gen, (ev, d, f), pd, fan_in=d),
            "wo": he_normal(gen, (ev, f, d), pd, fan_in=f)}


def _virtual_assignments(top_i: torch.Tensor, top_p: torch.Tensor, v: int):
    """[..., k] expert assignments -> [..., k*v] virtual assignments (each
    expert's v f-slices all receive the token; the gates repeat)."""
    if v == 1:
        return top_i, top_p
    vt = (top_i[..., None] * v + torch.arange(v, dtype=top_i.dtype,
                                               device=top_i.device))
    return vt.flatten(-2), top_p.repeat_interleave(v, dim=-1)


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, min(n_tokens, -(-c // 8) * 8))   # round up to 8, clamp


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """The router: x [..., d] -> (probs [..., e] f32, top_p [..., k] f32
    renormalised, top_i [..., k] int64).  Logits are rounded to the compute
    dtype before the f32 softmax, as in the reference; the top k come from
    a stable descending sort, so tied probabilities go to the lowest
    expert index, as ``lax.top_k`` gives them."""
    logits = (x @ p["router"].to(cfg.cdtype)).to(_F32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.moe.top_k], top_i[..., :cfg.moe.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def moe_dispatch(flat_e: torch.Tensor, n_slots: int, cap: int):
    """Capacity slots of the assignments ``flat_e`` [b, T*kv] (token-major,
    per batch row): ``pos`` [b, T*kv], the assignment's place in its
    expert's queue (the count of earlier assignments to that expert in
    its row), and ``valid = pos < cap``; over-capacity assignments are
    dropped, as in the reference."""
    oh = F.one_hot(flat_e, n_slots).to(torch.int32)            # [b, n, E]
    pos = (torch.cumsum(oh, dim=1) - oh).gather(
        -1, flat_e[..., None])[..., 0]
    return pos, pos < cap


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """x: [b, T, d], each batch row dispatched on its own (the reference
    vmaps ``apply_moe`` over the rows) -> (out [b, T, d], aux [b], the
    Switch load-balance term of each row).  Capacity-overflow assignments
    are dropped (their expert output is zero).  The expert products run
    for all rows at once: one batched matmul per weight over
    [E, b * cap, d] (row by row the reference's products)."""
    m = cfg.moe
    b, T, d = x.shape
    e, kv, E = m.n_experts, m.top_k * m.ep_virtual, m.n_virtual
    dt = cfg.cdtype
    cap = moe_capacity(T, cfg)

    probs, top_p, top_i = route(p, x, cfg)                     # [b, T, k]
    vt_i, vt_p = _virtual_assignments(top_i, top_p, m.ep_virtual)
    flat_e = vt_i.reshape(b, T * kv)
    pos, valid = moe_dispatch(flat_e, E, cap)

    # slot table [b, E*cap (+1 dump slot)] of source-token ids (T: the
    # zero row appended to x); dropped assignments write the dump slot
    tok = torch.arange(T, device=x.device).repeat_interleave(kv)
    slot = torch.where(valid, flat_e * cap + pos, E * cap)
    slot_tok = torch.full((b, E * cap + 1), T, dtype=torch.long,
                          device=x.device)
    slot_tok.scatter_(1, slot, tok.expand(b, -1))
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xe = x_pad.gather(1, slot_tok[:, :E * cap, None].expand(-1, -1, d))
    xe = xe.reshape(b, E, cap, d).transpose(0, 1).reshape(E, b * cap, d)

    h = F.silu(torch.bmm(xe, p["wg"].to(dt))) * torch.bmm(xe, p["wi"].to(dt))
    ye = torch.bmm(h, p["wo"].to(dt))                          # [E, b*cap, d]
    ye = ye.reshape(E, b, cap, d).transpose(0, 1).reshape(b, E * cap, d)

    # combine: gather each (t, k*v) output back, gated; dropped ones are 0
    src = flat_e * cap + torch.clamp(pos, max=cap - 1)
    gath = ye.gather(1, src[..., None].expand(-1, -1, d))      # [b, T*kv, d]
    gath = torch.where(valid[..., None], gath, gath.new_zeros(()))
    w = vt_p.reshape(b, T * kv, 1).to(gath.dtype)
    out = (gath * w).reshape(b, T, kv, d).sum(2)

    frac_tok = F.one_hot(top_i[..., 0], e).to(_F32).mean(1)    # [b, e]
    aux = e * (frac_tok * probs.mean(1)).sum(-1)
    return out.to(x.dtype), aux


def _ep_groups(x: torch.Tensor, cfg: ModelConfig, ep: int):
    """x [b, s, d] as the EP layout's ``ep`` source groups [D, T_l, d]
    (consecutive batch rows), and each group's capacity."""
    m = cfg.moe
    b, s, d = x.shape
    if m.n_virtual % ep:
        raise ValueError(f"{m.n_virtual} (virtual) experts do not divide "
                         f"the {ep}-way EP axis: see sharding.ep_tune")
    if b % ep:
        raise ValueError(f"batch {b} does not divide the {ep}-way EP axis")
    xl = x.reshape(ep, (b // ep) * s, d)
    return xl, moe_capacity(xl.shape[1], cfg)


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig, plan):
    """Expert-parallel MoE for train / prefill, on one device.

    The batch is cut into ``plan.ep`` source groups of consecutive rows
    (the data shards of the reference's layout), each routed on its own
    with a capacity of ``moe_capacity(T_l)`` for its T_l = (b / ep) * s
    tokens, so it drops other assignments than the dense dispatch's
    per-row capacity does.  The groups' capacity buffers [D, E, cap, d]
    are permuted to the experts' home groups (the reference's dispatch
    all-to-all: expert E = home * E / D + local), the experts apply to
    [E, D * cap, d] as one batched matmul a weight, and the outputs are
    permuted back and combined with the gates (the return all-to-all).
    Virtual experts (``ep_virtual``) split each expert's f dim; their
    partial outputs sum in the combine.

    x: [b, s, d] -> (out [b, s, d], the Switch aux loss averaged over the
    groups)."""
    m = cfg.moe
    D = plan.ep
    E, kv, e = m.n_virtual, m.top_k * m.ep_virtual, m.n_experts
    b, s, d = x.shape
    dt = cfg.cdtype
    xl, cap = _ep_groups(x, cfg, D)
    Tl = xl.shape[1]

    probs, top_p, top_i = route(p, xl, cfg)                    # [D, Tl, k]
    vt_i, vt_p = _virtual_assignments(top_i, top_p, m.ep_virtual)
    flat_e = vt_i.reshape(D, Tl * kv)
    pos, valid = moe_dispatch(flat_e, E, cap)

    tok = torch.arange(Tl, device=x.device).repeat_interleave(kv)
    slot = torch.where(valid, flat_e * cap + pos, E * cap)
    slot_tok = torch.full((D, E * cap + 1), Tl, dtype=torch.long,
                          device=x.device)
    slot_tok.scatter_(1, slot, tok.expand(D, -1))
    x_pad = torch.cat([xl, xl.new_zeros(D, 1, d)], dim=1)
    xe = x_pad.gather(1, slot_tok[:, :E * cap, None].expand(-1, -1, d))

    # dispatch: [D_src, D_home, e_loc, cap, d] -> [D_home, e_loc, D_src, ...]
    y = (xe.reshape(D, D, E // D, cap, d).permute(1, 2, 0, 3, 4)
         .reshape(E, D * cap, d))
    h = F.silu(torch.bmm(y, p["wg"].to(dt))) * torch.bmm(y, p["wi"].to(dt))
    ye = torch.bmm(h, p["wo"].to(dt))                          # [E, D*cap, d]
    # return: [D_home, e_loc, D_src, cap, d] -> [D_src, E * cap, d]
    back = (ye.reshape(D, E // D, D, cap, d).permute(2, 0, 1, 3, 4)
            .reshape(D, E * cap, d))

    src = flat_e * cap + torch.clamp(pos, max=cap - 1)
    gath = back.gather(1, src[..., None].expand(-1, -1, d))    # [D, Tl*kv, d]
    gath = torch.where(valid[..., None], gath, gath.new_zeros(()))
    w = vt_p.reshape(D, Tl * kv, 1).to(gath.dtype)
    out = (gath * w).reshape(D, Tl, kv, d).sum(2)

    frac_tok = F.one_hot(top_i[..., 0], e).to(_F32).mean(1)    # [D, e]
    aux = e * (frac_tok * probs.mean(1)).sum(-1)
    return out.reshape(b, s, d).to(x.dtype), aux.mean()


def moe_kept(p, x: torch.Tensor, cfg: ModelConfig, ep: Optional[int] = None
             ) -> torch.Tensor:
    """The kept (token, choice) assignments of a dispatch, [groups,
    T * k * v] bools in token-major order: the dense dispatch's (each
    batch row a group, ``ep`` None) or the expert-parallel one's (``ep``
    source groups); the others are dropped by capacity."""
    m = cfg.moe
    if ep is None:
        xg, cap = x, moe_capacity(x.shape[1], cfg)
    else:
        xg, cap = _ep_groups(x, cfg, ep)
    _, top_p, top_i = route(p, xg, cfg)
    vt_i, _ = _virtual_assignments(top_i, top_p, m.ep_virtual)
    return moe_dispatch(vt_i.reshape(xg.shape[0], -1), m.n_virtual, cap)[1]


def moe_decode_gathered(p, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Decode-time MoE: each token's top-k experts' weights gathered and
    applied densely — exactly k expert-FFNs of products, no capacity.
    x: [b, d] -> [b, d]."""
    m = cfg.moe
    dt = cfg.cdtype
    _, top_p, top_i = route(p, x, cfg)                         # [b, k]
    top_i, top_p = _virtual_assignments(top_i, top_p, m.ep_virtual)
    xr = x[:, None, None, :]                                   # [b, 1, 1, d]
    h = (F.silu(xr @ p["wg"].to(dt)[top_i])                    # [b, kv, 1, f]
         * (xr @ p["wi"].to(dt)[top_i]))
    y = (h @ p["wo"].to(dt)[top_i])[:, :, 0]                   # [b, kv, d]
    return (y * top_p[..., None].to(dt)).sum(1)


# ---------------------------------------------------------------------------
# embedding / logits (padded vocab)
# ---------------------------------------------------------------------------

def padded_vocab(cfg: ModelConfig, multiple: int = 16) -> int:
    return -(-cfg.vocab_size // multiple) * multiple


def init_embedding(gen, cfg: ModelConfig):
    vp = padded_vocab(cfg)
    p = {"table": lecun_normal(gen, (vp, cfg.d_model), cfg.pdtype,
                               fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = lecun_normal(gen, (cfg.d_model, vp), cfg.pdtype)
    return p


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table in the compute dtype (gathered, then cast: the
    same bits as the reference's cast-then-gather)."""
    table = p["table"]
    return table[tokens.to(table.device, torch.long)].to(cfg.cdtype)


def logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = x @ p["table"].to(cfg.cdtype).T
    else:
        out = x @ p["unembed"].to(cfg.cdtype)
    if cfg.logit_softcap is not None:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    vp, v = out.shape[-1], cfg.vocab_size
    if vp != v:
        pad = torch.arange(vp, device=out.device) >= v
        out = out.masked_fill(pad, NEG_INF)
    return out
