"""Decoder-only LM (port of ``repro/models/transformer.py``): init,
forward, prefill into the per-layer decode states, and one decode step,
for heterogeneous stacks of attention, mamba and rwkv mixers with dense
or MoE FFNs.

Parameters are a plain dict: ``{"embed", "final_norm", "blocks": [one
dict per layer, in cfg.all_blocks order]}`` — the reference stacks each
layer group's repeats for ``lax.scan``; the port loops over layers
(``convert.lm_params_from_reference`` unstacks).  Caches are a list with
one decode state per layer: a ``DecodeCache`` for an attention block, a
``MambaState`` for a mamba block, an ``RWKVState`` for an rwkv block.
Attention and mamba mixers with dense, MoE or no FFN, and rwkv blocks
(time mix + channel mix) are ported; other blocks raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models.common import BlockSpec, ModelConfig
from repro_torch.models.plan import NULL_PLAN

# the weights that enter matmuls (cast to the compute dtype on every use,
# as the reference does; compute_params casts them once).  rwkv's decay
# bias w0 stays f32, and u and ln_x are read in f32; mamba's a_log,
# dt_bias and d_skip are read in f32, its conv_w / conv_b cast on use.
# The MoE's wi / wg / wo are [e, d, f] stacks of expert weights.
_MATMUL_WEIGHTS = frozenset(("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                             "wi", "wg", "table", "unembed",
                             "wr", "lora_a", "lora_b", "w_a", "w_b",
                             "in_proj", "x_proj", "dt_proj", "out_proj",
                             "router"))


def _ported(spec: BlockSpec) -> bool:
    if spec.mixer in ("attn", "mamba"):
        return spec.ffn in ("dense", "moe", "none")
    return spec.mixer == "rwkv" and spec.ffn == "dense"   # + channel mix


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer is an attention or mamba block with a
    dense, MoE or no FFN, or an rwkv block (time mix + channel mix), and
    the inputs are tokens only: what the port runs so far."""
    for spec in cfg.all_blocks:
        if not _ported(spec):
            raise NotImplementedError(
                f"{cfg.arch}: block {spec} is not ported (the port runs "
                f"attention and mamba blocks with dense or MoE FFNs, and "
                f"rwkv blocks with their channel mix; ROADMAP.md queue A)")
    if cfg.is_enc_dec or cfg.vision is not None:
        raise NotImplementedError(f"{cfg.arch}: encoder/vision inputs are "
                                  f"not ported")
    if (any(s.ffn == "moe" for s in cfg.all_blocks)
            and cfg.mlp_act != "swiglu"):
        raise NotImplementedError(f"{cfg.arch}: a {cfg.mlp_act} MoE is not "
                                  f"ported (every MoE config is swiglu)")
    if cfg.pos_emb not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.arch}: pos_emb {cfg.pos_emb!r} is "
                                  f"not ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, spec: BlockSpec) -> Dict[str, Any]:
    """One layer's parameters, drawn on the CPU."""
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg)}
    if spec.mixer == "rwkv":
        p["rwkv_tm"] = R.init_time_mix(gen, cfg)
    elif spec.mixer == "mamba":
        p["mamba"] = M.init_mamba(gen, cfg)
    else:
        p["attn"] = L.init_attention(gen, cfg)
    if spec.ffn != "none":
        p["norm2"] = L.init_norm(cfg)
        if spec.ffn == "moe":
            p["moe"] = L.init_moe(gen, cfg)
        elif spec.mixer == "rwkv":
            p["rwkv_cm"] = R.init_channel_mix(gen, cfg)
        else:
            p["mlp"] = L.init_mlp(gen, cfg)
    return p


def _place(node, cfg: ModelConfig, device, cast: bool, key=None):
    """``node`` (a tree of dicts and lists) with every leaf on ``device``
    (None: where it is) and, when ``cast``, every matmul weight in the
    compute dtype."""
    if isinstance(node, dict):
        return {k: _place(v, cfg, device, cast, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_place(v, cfg, device, cast) for v in node]
    dtype = cfg.cdtype if cast and key in _MATMUL_WEIGHTS else node.dtype
    return node.to(device=device or node.device, dtype=dtype)


def init_lm(seed: int, cfg: ModelConfig, device="cpu", cast: bool = False
            ) -> Dict[str, Any]:
    """Random parameters from a CPU ``torch.Generator`` seeded with
    ``seed`` (so every device gets the same draws), drawn one layer at a
    time on the CPU and moved to ``device``.  ``cast``: every matmul
    weight is cast to the compute dtype as its layer is moved, which is
    ``compute_params(init_lm(...))`` without the parameter-dtype copies
    on ``device`` (a 13B-parameter layer group fits one card)."""
    check_ported(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    place = lambda tree: _place(tree, cfg, torch.device(device), cast)
    return {
        "embed": place(L.init_embedding(gen, cfg)),
        "final_norm": place(L.init_norm(cfg)),
        "blocks": [place(init_block(gen, cfg, spec))
                   for spec in cfg.all_blocks],
    }


def compute_params(params, cfg: ModelConfig):
    """The parameters with every matmul weight cast to the compute dtype
    once (the reference casts on every use: the same bits); norm scales
    and biases stay in the parameter dtype (the norms read them in f32)."""
    return _place(params, cfg, None, True)


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
    """Returns (x_out, the MoE aux loss (0.0 without an MoE), the state
    for decode or None): (k, v) for an attention block, a ``MambaState``
    for a mamba block, (S, x_last, cm_last) for an rwkv block."""
    aux = 0.0
    h = L.apply_norm(p["norm1"], x, cfg)
    if spec.mixer == "rwkv":
        o, S, xl = R.time_mix_forward(p["rwkv_tm"], h, cfg)
        kv = (S, xl) if return_kv else None
    elif spec.mixer == "mamba":
        o, mstate = M.mamba_forward(p["mamba"], h, cfg)
        kv = mstate if return_kv else None
    else:
        o, kv = attn_forward(p["attn"], h, cfg, spec, plan, return_kv)
    x = x + o
    if spec.ffn == "none":
        return x, aux, kv
    h = L.apply_norm(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        out, aux_rows = L.apply_moe(p["moe"], h, cfg)
        x = x + out
        aux = aux_rows.mean()
    elif spec.mixer == "rwkv":
        prev = torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]),
                          h[:, :-1]], dim=1)
        x = x + R.channel_mix(p["rwkv_cm"], h, prev, cfg)
        if kv is not None:
            kv = (*kv, h[:, -1])                          # cm_prev for decode
    else:
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    return x, aux, kv


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """tokens -> x [b, s, d]."""
    return L.embed(params["embed"], batch["tokens"], cfg)


def lm_forward(params, cfg: ModelConfig, batch, plan=NULL_PLAN):
    """Returns (logits [b, s, vocab_pad], the MoE aux loss summed over
    layers: 0.0 without MoE layers)."""
    x = _embed_inputs(params, cfg, batch)
    aux_total = 0.0
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        x, aux, _ = block_forward(p, x, cfg, spec, plan)
        aux_total = aux_total + aux
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits(params["embed"], x, cfg), aux_total


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
        x, _, kv = block_forward(p, x, cfg, spec, plan, return_kv=True)
        caches.append(_to_decode_state(kv, spec, cfg, s, plan))
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return L.logits(params["embed"], x, cfg), caches


def _to_decode_state(kv, spec: BlockSpec, cfg: ModelConfig, s: int, plan):
    if spec.mixer == "mamba":
        return kv                                         # MambaState
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
    written in place, each mamba and rwkv state replaced)."""
    pos = int(pos)
    x = L.embed(params["embed"], token, cfg)              # [b, d]
    new_caches = []
    for p, spec, cache in zip(params["blocks"], cfg.all_blocks, caches):
        x, cache = block_decode(p, x, cache, cfg, spec, pos, plan)
        new_caches.append(cache)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits(params["embed"], x, cfg), new_caches


def _attn_decode(p, h: torch.Tensor, cache: L.DecodeCache,
                 cfg: ModelConfig, spec: BlockSpec, pos: int):
    """One token's attention against the two-tier cache (its ring written
    in place).  h: [b, d] -> (o [b, d], cache)."""
    theta = _rope_theta_for(cfg, spec)
    q, k, v = L.qkv_proj(p, h[:, None], cfg)              # [b,1,h/kv,hd]
    q = L.apply_rope(q, pos, cfg, theta)[:, 0]
    k = L.apply_rope(k, pos, cfg, theta)[:, 0]
    cache = L.cache_append_recent(cache, k, v[:, 0], pos)
    o = L.decode_attention(q, cache, pos, window=_window(spec))
    o = o.reshape(h.shape[0], cfg.n_heads * cfg.hd)
    return o @ p["wo"].to(cfg.cdtype), cache


def block_decode(p, x: torch.Tensor, cache, cfg: ModelConfig,
                 spec: BlockSpec, pos: int, plan=NULL_PLAN):
    """x: [b, d]; returns (x, the layer's new decode state).  An MoE FFN
    decodes through the gathered-weights path (exactly top-k expert
    products a token, no capacity); rwkv's channel mix is shifted against
    ``cm_prev``."""
    h = L.apply_norm(p["norm1"], x, cfg)
    if spec.mixer == "rwkv":
        o, S, xl = R.time_mix_decode(p["rwkv_tm"], h, cache, cfg)
        cache = cache._replace(wkv=S, tm_prev=xl)
    elif spec.mixer == "mamba":
        o, cache = M.mamba_decode(p["mamba"], h, cache, cfg)
    else:
        o, cache = _attn_decode(p["attn"], h, cache, cfg, spec, pos)
    x = x + o
    if spec.ffn == "none":
        return x, cache
    h = L.apply_norm(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        x = x + L.moe_decode_gathered(p["moe"], h, cfg)
    elif spec.mixer == "rwkv":
        x = x + R.channel_mix(p["rwkv_cm"], h, cache.cm_prev, cfg)
        cache = cache._replace(cm_prev=h)
    else:
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    return x, cache
