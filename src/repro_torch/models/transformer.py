"""Decoder-only LM for the dense transformer family (port of
``repro/models/transformer.py``): init, forward, prefill into the two-tier
decode cache, and one decode step.

Parameters are a plain dict: ``{"embed", "final_norm", "blocks": [one
dict per layer, in cfg.all_blocks order]}`` — the reference stacks each
layer group's repeats for ``lax.scan``; the port loops over layers
(``convert.lm_params_from_reference`` unstacks).  Caches are a list with
one decode state per layer: a ``DecodeCache`` for an attention block, an
``RWKVState`` for an rwkv block.  Attention mixers with dense (or no)
FFNs and rwkv blocks (time mix + channel mix) are ported; the MoE and
mamba blocks raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models.common import BlockSpec, ModelConfig
from repro_torch.models.plan import NULL_PLAN

# the weights that enter matmuls (cast to the compute dtype on every use,
# as the reference does; compute_params casts them once).  rwkv's decay
# bias w0 stays f32, and u and ln_x are read in f32.
_MATMUL_WEIGHTS = frozenset(("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                             "wi", "wg", "table", "unembed",
                             "wr", "lora_a", "lora_b", "w_a", "w_b"))


def _ported(spec: BlockSpec) -> bool:
    if spec.mixer == "attn":
        return spec.ffn in ("dense", "none")
    return spec.mixer == "rwkv" and spec.ffn == "dense"   # + channel mix


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer is an attention block with a dense (or
    no) FFN or an rwkv block (time mix + channel mix), and the inputs are
    tokens only: what the port runs so far."""
    for spec in cfg.all_blocks:
        if not _ported(spec):
            raise NotImplementedError(
                f"{cfg.arch}: block {spec} is not ported (the port runs "
                f"attention blocks with dense FFNs and rwkv blocks; "
                f"ROADMAP.md queue A)")
    if cfg.is_enc_dec or cfg.vision is not None:
        raise NotImplementedError(f"{cfg.arch}: encoder/vision inputs are "
                                  f"not ported")
    if cfg.pos_emb not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.arch}: pos_emb {cfg.pos_emb!r} is "
                                  f"not ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, spec: BlockSpec, device="cpu"
               ) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, device=device)}
    if spec.mixer == "rwkv":
        p["rwkv_tm"] = R.init_time_mix(gen, cfg, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, device)
    if spec.ffn != "none":
        p["norm2"] = L.init_norm(cfg, device=device)
        if spec.mixer == "rwkv":
            p["rwkv_cm"] = R.init_channel_mix(gen, cfg, device)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, device=device)
    return p


def init_lm(seed: int, cfg: ModelConfig, device="cpu") -> Dict[str, Any]:
    """Random parameters from a CPU ``torch.Generator`` seeded with
    ``seed`` (so every device gets the same draws), each leaf moved to
    ``device`` as it is drawn."""
    check_ported(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    return {
        "embed": L.init_embedding(gen, cfg, device),
        "final_norm": L.init_norm(cfg, device=device),
        "blocks": [init_block(gen, cfg, spec, device)
                   for spec in cfg.all_blocks],
    }


def compute_params(params, cfg: ModelConfig):
    """The parameters with every matmul weight cast to the compute dtype
    once (the reference casts on every use: the same bits); norm scales
    and biases stay in the parameter dtype (the norms read them in f32)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(cfg.cdtype) if key in _MATMUL_WEIGHTS else node
    return walk(params)


# ---------------------------------------------------------------------------
# one block (forward / prefill)
# ---------------------------------------------------------------------------

def _rope_theta_for(cfg: ModelConfig, spec: BlockSpec) -> float:
    if spec.attn_kind == "swa" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _window(spec: BlockSpec) -> Optional[int]:
    return spec.window if spec.attn_kind == "swa" else None


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
                 plan=NULL_PLAN, return_kv: bool = False):
    """x: [b, s, d] -> (out [b, s, d], (k, v) [b, s, kv, hd] or None)."""
    b, s, _ = x.shape
    theta = _rope_theta_for(cfg, spec)
    q, k, v = L.qkv_proj(p, x, cfg)                       # [b,s,h/kv,hd]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, cfg, theta)
    k = L.apply_rope(k, pos, cfg, theta)
    o = L.blocked_attention(q[:, None], k, v, causal=True,
                            window=_window(spec))
    o = o[:, 0].reshape(b, s, cfg.n_heads * cfg.hd)
    out = o @ p["wo"].to(cfg.cdtype)
    return out, ((k, v) if return_kv else None)


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
                  plan=NULL_PLAN, return_kv: bool = False):
    """Returns (x_out, the state for decode or None): (k, v) for an
    attention block, (S, x_last, cm_last) for an rwkv block."""
    h = L.apply_norm(p["norm1"], x, cfg)
    if spec.mixer == "rwkv":
        o, S, xl = R.time_mix_forward(p["rwkv_tm"], h, cfg)
        kv = (S, xl) if return_kv else None
    else:
        o, kv = attn_forward(p["attn"], h, cfg, spec, plan, return_kv)
    x = x + o
    if spec.ffn == "none":
        return x, kv
    h = L.apply_norm(p["norm2"], x, cfg)
    if spec.mixer == "rwkv":
        prev = torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]),
                          h[:, :-1]], dim=1)
        x = x + R.channel_mix(p["rwkv_cm"], h, prev, cfg)
        if kv is not None:
            kv = (*kv, h[:, -1])                          # cm_prev for decode
    else:
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    return x, kv


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """tokens -> x [b, s, d]."""
    return L.embed(params["embed"], batch["tokens"], cfg)


def lm_forward(params, cfg: ModelConfig, batch, plan=NULL_PLAN):
    """Returns (logits [b, s, vocab_pad], aux loss 0.0: the ported blocks
    have no auxiliary loss)."""
    x = _embed_inputs(params, cfg, batch)
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        x, _ = block_forward(p, x, cfg, spec, plan)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits(params["embed"], x, cfg), 0.0


# ---------------------------------------------------------------------------
# prefill: forward + emit decode caches
# ---------------------------------------------------------------------------

def lm_prefill(params, cfg: ModelConfig, batch, plan=NULL_PLAN
               ) -> Tuple[torch.Tensor, List[Any]]:
    """Returns (logits [b, vocab_pad] of the last position, one decode
    state per layer).  The final norm and the unembedding run on the last
    position only (the reference computes them for every position and
    keeps the last row: row for row the same product)."""
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    caches = []
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        x, kv = block_forward(p, x, cfg, spec, plan, return_kv=True)
        caches.append(_to_decode_state(kv, spec, cfg, s, plan))
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return L.logits(params["embed"], x, cfg), caches


def _to_decode_state(kv, spec: BlockSpec, cfg: ModelConfig, s: int, plan):
    if spec.mixer == "rwkv":
        S, xl, cm_last = kv
        return R.RWKVState(wkv=S, tm_prev=xl, cm_prev=cm_last)
    k, v = kv                                             # [b, s, kv, hd]
    b, dev, dt = k.shape[0], k.device, cfg.cdtype
    C = plan.cache_chunks
    cache_len = _cache_len(cfg, spec, s, plan)
    ln = cache_len // C
    kc = k.transpose(1, 2)[:, :, -cache_len:].to(dt)      # [b, kv, S, hd]
    vc = v.transpose(1, 2)[:, :, -cache_len:].to(dt)
    pos0 = s - cache_len
    return L.DecodeCache(
        k_old=kc.reshape(b, cfg.n_kv_heads, C, ln, cfg.hd).contiguous(),
        v_old=vc.reshape(b, cfg.n_kv_heads, C, ln, cfg.hd).contiguous(),
        old_pos=(pos0 + torch.arange(cache_len, dtype=torch.int32,
                                     device=dev)).reshape(C, ln),
        k_rec=torch.zeros(b, cfg.n_kv_heads, L.RECENT_RING, cfg.hd,
                          dtype=dt, device=dev),
        v_rec=torch.zeros(b, cfg.n_kv_heads, L.RECENT_RING, cfg.hd,
                          dtype=dt, device=dev),
        rec_pos=torch.full((L.RECENT_RING,), -1, dtype=torch.int32,
                           device=dev))


def _cache_len(cfg: ModelConfig, spec: BlockSpec, total: int, plan) -> int:
    """Old-tier length: the whole prompt, or the SWA window (rolling),
    rounded up to whole chunks."""
    C = plan.cache_chunks
    n = min(total, spec.window) if (spec.attn_kind == "swa"
                                    and spec.window is not None) else total
    return -(-n // C) * C


# ---------------------------------------------------------------------------
# decode: one token through all layers, threading caches
# ---------------------------------------------------------------------------

def lm_decode_step(params, cfg: ModelConfig, caches, token: torch.Tensor,
                   pos: int, plan=NULL_PLAN):
    """token: [b] int; pos: the position of ``token``.  Returns (logits
    [b, vocab_pad], the decode states: each attention cache's ring
    written in place, each rwkv state replaced)."""
    pos = int(pos)
    x = L.embed(params["embed"], token, cfg)              # [b, d]
    new_caches = []
    for p, spec, cache in zip(params["blocks"], cfg.all_blocks, caches):
        x, cache = block_decode(p, x, cache, cfg, spec, pos, plan)
        new_caches.append(cache)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits(params["embed"], x, cfg), new_caches


def block_decode(p, x: torch.Tensor, cache, cfg: ModelConfig,
                 spec: BlockSpec, pos: int, plan=NULL_PLAN):
    """x: [b, d]; returns (x, cache)."""
    if spec.mixer == "rwkv":
        return _rwkv_block_decode(p, x, cache, cfg)
    h = L.apply_norm(p["norm1"], x, cfg)
    theta = _rope_theta_for(cfg, spec)
    q, k, v = L.qkv_proj(p["attn"], h[:, None], cfg)      # [b,1,h/kv,hd]
    q = L.apply_rope(q, pos, cfg, theta)[:, 0]
    k = L.apply_rope(k, pos, cfg, theta)[:, 0]
    cache = L.cache_append_recent(cache, k, v[:, 0], pos)
    o = L.decode_attention(q, cache, pos, window=_window(spec))
    o = o.reshape(x.shape[0], cfg.n_heads * cfg.hd)
    x = x + o @ p["attn"]["wo"].to(cfg.cdtype)
    if spec.ffn != "none":
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg)
    return x, cache


def _rwkv_block_decode(p, x: torch.Tensor, state: R.RWKVState,
                       cfg: ModelConfig):
    """One token through an rwkv block: the time mix's one-step
    recurrence from ``state.wkv`` and ``tm_prev``, then the channel mix
    shifted against ``cm_prev``.  Returns (x, the new state)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    o, S, xl = R.time_mix_decode(p["rwkv_tm"], h, state, cfg)
    x = x + o
    h = L.apply_norm(p["norm2"], x, cfg)
    x = x + R.channel_mix(p["rwkv_cm"], h, state.cm_prev, cfg)
    return x, R.RWKVState(wkv=S, tm_prev=xl, cm_prev=h)
