"""Whisper-style encoder-decoder (port of ``repro/models/whisper.py``, the
whisper-tiny backbone).

The conv1d audio frontend is a stub, as in the reference: the batch
carries precomputed frame embeddings ``frame_embeds`` [b, n_frames,
d_enc] (post-conv), to which the encoder adds sinusoidal positions.  The
decoder uses a learned position table, causal self-attention (the
two-tier decode cache) and cross-attention into the encoder states (a
static K/V cache at decode time).

Parameters are a plain dict: ``{"embed", "pos_table", "enc": [one dict an
encoder layer], "dec": [one dict a decoder layer], "enc_norm",
"final_norm"}`` — the reference stacks each list for ``lax.scan``
(``convert.lm_params_from_reference`` unstacks).  The encoder's
attention, the decoder's causal self-attention and its cross-attention
go through ``L.blocked_attention`` -> ``ops.flash_attention`` in prefill
and training (B13; under autograd on the card ``FlashAttention``, so
B13's backward kernel runs); decode attends to the caches with PyTorch
ops, as the reference does with jnp.  Under grad each layer runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` around
each scanned layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.plan import NULL_PLAN

_F32 = torch.float32


class CrossCache(NamedTuple):
    k: torch.Tensor   # [b, kv, nf, hd]
    v: torch.Tensor


class WhisperDecCache(NamedTuple):
    """The decode state: per decoder layer a ``DecodeCache`` of its
    self-attention (its ring written in place every step) and a
    ``CrossCache`` of the encoder's K/V."""
    self_cache: List[L.DecodeCache]
    cross: List[CrossCache]


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    e = cfg.encoder
    return cfg.replace(d_model=e.d_model, n_heads=e.n_heads,
                       n_kv_heads=e.n_heads, d_ff=e.d_ff, head_dim=None)


def init_whisper(seed: int, cfg: ModelConfig, device="cpu",
                 cast: bool = False) -> Dict[str, Any]:
    """Random parameters from a CPU ``torch.Generator`` seeded with
    ``seed``, the reference's distributions (``pos_table`` N(0, 0.01^2)),
    drawn one layer at a time on the CPU and moved to ``device``;
    ``cast`` as ``transformer.init_lm``."""
    T.check_ported(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    ecfg = _enc_cfg(cfg)
    place = lambda tree: T._place(tree, cfg, torch.device(device), cast)

    def enc_layer():
        return {"norm1": L.init_norm(ecfg),
                "attn": L.init_attention(gen, ecfg),
                "norm2": L.init_norm(ecfg), "mlp": L.init_mlp(gen, ecfg)}

    def dec_layer():
        return {"norm1": L.init_norm(cfg), "attn": L.init_attention(gen, cfg),
                "norm_x": L.init_norm(cfg),
                "xattn": L.init_attention(gen, cfg),
                "norm2": L.init_norm(cfg), "mlp": L.init_mlp(gen, cfg)}

    return {
        "embed": place(L.init_embedding(gen, cfg)),
        "pos_table": place(L._normal(gen, (cfg.max_seq, cfg.d_model),
                                     cfg.pdtype, 0.01)),
        "enc": [place(enc_layer()) for _ in range(cfg.encoder.n_layers)],
        "dec": [place(dec_layer()) for _ in range(cfg.n_layers)],
        "enc_norm": place(L.init_norm(ecfg)),
        "final_norm": place(L.init_norm(cfg)),
    }


def _layer(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_layer(p, x: torch.Tensor, ecfg: ModelConfig) -> torch.Tensor:
    h = L.apply_norm(p["norm1"], x, ecfg)
    q, k, v = L.qkv_proj(p["attn"], h, ecfg)
    o = L.blocked_attention(q[:, None], k, v, causal=False)[:, 0]
    x = x + o.reshape(*x.shape[:-1], -1) @ p["attn"]["wo"].to(ecfg.cdtype)
    h = L.apply_norm(p["norm2"], x, ecfg)
    return x + L.apply_mlp(p["mlp"], h, ecfg)


def encode(params, cfg: ModelConfig, frame_embeds: torch.Tensor,
           plan=NULL_PLAN, remat: bool = True) -> torch.Tensor:
    """frame_embeds [b, nf, d_enc] -> encoder states [b, nf, d_enc] in the
    compute dtype: sinusoidal positions, then non-causal self-attention
    layers."""
    ecfg = _enc_cfg(cfg)
    dev = params["enc_norm"]["scale"].device
    x = frame_embeds.to(device=dev, dtype=cfg.cdtype)
    x = x + L.sinusoidal_pos(x.shape[1], ecfg.d_model, dev).to(x.dtype)
    for p in params["enc"]:
        x = _layer(remat, _enc_layer, p, x, ecfg)
    return L.apply_norm(params["enc_norm"], x, ecfg)


# ---------------------------------------------------------------------------
# decoder (teacher-forced / prefill path)
# ---------------------------------------------------------------------------

def _enc_kv(p, enc_states: torch.Tensor, cfg: ModelConfig):
    """Encoder K/V for cross attention (projected once a layer):
    [b, nf, kv, hd] each."""
    dt = cfg.cdtype
    shape = (*enc_states.shape[:-1], cfg.n_kv_heads, cfg.hd)
    return ((enc_states @ p["wk"].to(dt)).reshape(shape),
            (enc_states @ p["wv"].to(dt)).reshape(shape))


def _xattn(p, h: torch.Tensor, enc_kv, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention. h: [b, s, d]; enc_kv: (k, v) [b, nf, kv, hd]."""
    dt = cfg.cdtype
    q = (h @ p["wq"].to(dt)).reshape(*h.shape[:-1], cfg.n_heads, cfg.hd)
    k, v = enc_kv
    o = L.blocked_attention(q[:, None], k, v, causal=False)[:, 0]
    return o.reshape(*h.shape[:-1], -1) @ p["wo"].to(dt)


def _dec_layer(p, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig):
    """One decoder layer: (x, self k, self v [b, s, kv, hd], the encoder's
    (k, v))."""
    b, s, _ = x.shape
    h = L.apply_norm(p["norm1"], x, cfg)
    q, k, v = L.qkv_proj(p["attn"], h, cfg)
    o = L.blocked_attention(q[:, None], k, v, causal=True)[:, 0]
    x = x + o.reshape(b, s, -1) @ p["attn"]["wo"].to(cfg.cdtype)
    ekv = _enc_kv(p["xattn"], enc, cfg)
    h = L.apply_norm(p["norm_x"], x, cfg)
    x = x + _xattn(p["xattn"], h, ekv, cfg)
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg), k, v, ekv


def _decoder_stack(params, cfg: ModelConfig, tokens, enc_states,
                   remat: bool = True, return_caches: bool = False):
    """The decoder's layers before the final norm: (x [b, s, d], per layer
    (k, v, (ek, ev)) when ``return_caches``, else [])."""
    x = L.embed(params["embed"], tokens, cfg)
    x = x + params["pos_table"][:x.shape[1]].to(x.dtype)
    ys = []
    for p in params["dec"]:
        if return_caches:
            x, k, v, ekv = _dec_layer(p, x, enc_states, cfg)
            ys.append((k, v, ekv))
        else:
            x = _layer(remat, _dec_layer, p, x, enc_states, cfg)[0]
    return x, ys


def decoder_hidden(params, cfg: ModelConfig, tokens, enc_states,
                   plan=NULL_PLAN, remat: bool = True) -> torch.Tensor:
    """tokens [b, s], encoder states -> final-norm hidden states [b, s, d]."""
    x, _ = _decoder_stack(params, cfg, tokens, enc_states, remat)
    return L.apply_norm(params["final_norm"], x, cfg)


def decoder_forward(params, cfg: ModelConfig, tokens, enc_states,
                    plan=NULL_PLAN) -> torch.Tensor:
    """tokens [b, s], encoder states -> logits [b, s, vocab_pad]."""
    return L.logits(params["embed"],
                    decoder_hidden(params, cfg, tokens, enc_states, plan),
                    cfg)


def whisper_forward(params, cfg: ModelConfig, batch, plan=NULL_PLAN):
    enc = encode(params, cfg, batch["frame_embeds"], plan)
    return decoder_forward(params, cfg, batch["tokens"], enc, plan)


def whisper_loss(params, cfg: ModelConfig, batch, plan=NULL_PLAN,
                 remat: bool = True, ce_chunks: int = 8):
    """Next-token cross-entropy of the decoder's tokens given the frames
    (``transformer.chunked_ce``).  Returns (loss, {"ce", "aux"}), f32
    0-dim tensors, aux 0 (no MoE)."""
    enc = encode(params, cfg, batch["frame_embeds"], plan, remat)
    x = decoder_hidden(params, cfg, batch["tokens"], enc, plan, remat)
    tokens = batch["tokens"].to(device=x.device, dtype=torch.long)
    tgt = tokens[:, 1:]
    nll = T.chunked_ce(params["embed"], cfg, x[:, :-1], tgt, plan, ce_chunks)
    loss = nll / float(tgt.numel())
    return loss, {"ce": loss,
                  "aux": torch.zeros((), dtype=_F32, device=x.device)}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def whisper_prefill(params, cfg: ModelConfig, batch, plan=NULL_PLAN):
    """Returns (logits [b, vocab_pad] of the last position, a
    ``WhisperDecCache``): each layer's self K/V padded to
    ``plan.cache_chunks`` whole chunks in the old tier (padding slots at
    position -1), an empty ring, and the encoder's K/V.  The final norm
    and the unembedding run on the last position only."""
    enc = encode(params, cfg, batch["frame_embeds"], plan, remat=False)
    x, ys = _decoder_stack(params, cfg, batch["tokens"], enc,
                           return_caches=True)
    b, s = x.shape[:2]
    dev, dt = x.device, cfg.cdtype
    kvh, hd, R = cfg.n_kv_heads, cfg.hd, L.RECENT_RING
    C = plan.cache_chunks
    ln = -(-s // C)

    def to_old(t):  # [b, s, kv, hd] -> [b, kv, C, ln, hd]
        t = torch.nn.functional.pad(t.transpose(1, 2), (0, 0, 0, C * ln - s))
        return t.reshape(b, kvh, C, ln, hd).to(dt).contiguous()

    pos = torch.arange(C * ln, dtype=torch.int32, device=dev)
    old_pos = torch.where(pos < s, pos, torch.full_like(pos, -1))
    self_cache, cross = [], []
    for k, v, (ek, ev) in ys:
        self_cache.append(L.DecodeCache(
            k_old=to_old(k), v_old=to_old(v),
            old_pos=old_pos.reshape(C, ln).clone(),
            k_rec=torch.zeros(b, kvh, R, hd, dtype=dt, device=dev),
            v_rec=torch.zeros(b, kvh, R, hd, dtype=dt, device=dev),
            rec_pos=torch.full((R,), -1, dtype=torch.int32, device=dev)))
        cross.append(CrossCache(k=ek.transpose(1, 2).contiguous(),
                                v=ev.transpose(1, 2).contiguous()))
    x = L.apply_norm(params["final_norm"], x[:, -1], cfg)
    return L.logits(params["embed"], x, cfg), WhisperDecCache(self_cache,
                                                             cross)


def whisper_cache_specs(cfg: ModelConfig, b: int, seq_len: int,
                        plan=NULL_PLAN) -> WhisperDecCache:
    """Meta tensors of the ``WhisperDecCache`` ``whisper_prefill`` emits
    for ``b`` prompts of ``seq_len`` tokens: per decoder layer the
    self-attention cache (``ceil(seq_len / cache_chunks)`` slots a chunk)
    and the encoder's K/V.  Nothing is allocated."""
    C = plan.cache_chunks
    ln = -(-seq_len // C)
    kvh, hd, dt = cfg.n_kv_heads, cfg.hd, cfg.cdtype
    nf = cfg.encoder.n_frames
    return WhisperDecCache(
        [L.cache_specs(b, kvh, C, ln, hd, dt) for _ in range(cfg.n_layers)],
        [CrossCache(k=L.meta_spec((b, kvh, nf, hd), dt),
                    v=L.meta_spec((b, kvh, nf, hd), dt))
         for _ in range(cfg.n_layers)])


def _xattn_decode(p, h: torch.Tensor, cross: CrossCache, cfg: ModelConfig):
    """One token's cross attention against the encoder's K/V, h: [b, d]:
    scores in f32 over the compute-dtype operands, the softmax in f32,
    the weights cast to the compute dtype for the product with V, as the
    reference's einsums."""
    dt, b = cfg.cdtype, h.shape[0]
    kvh = cfg.n_kv_heads
    q = (h @ p["wq"].to(dt)).reshape(b, kvh, cfg.n_heads // kvh, cfg.hd)
    s = (q.to(_F32) @ cross.k.to(dt).to(_F32).transpose(-1, -2)
         ) / math.sqrt(cfg.hd)                          # [b, kv, g, nf]
    w = torch.softmax(s, dim=-1)
    o = w.to(dt) @ cross.v.to(dt)                       # [b, kv, g, hd]
    return o.reshape(b, -1) @ p["wo"].to(dt)


def whisper_decode_step(params, cfg: ModelConfig, caches: WhisperDecCache,
                        token: torch.Tensor, pos: int, plan=NULL_PLAN):
    """token [b]; pos: the position of ``token``.  Returns (logits [b,
    vocab_pad], the caches: each layer's ring written in place).  No
    compaction folds the ring into the old tier (the reference's serve
    loop compacts no encoder-decoder), so from step 64 on each step
    overwrites the oldest ring slot."""
    pos = int(pos)
    dt = cfg.cdtype
    x = L.embed(params["embed"], token, cfg)               # [b, d]
    x = x + params["pos_table"][pos].to(x.dtype)
    b = x.shape[0]
    for p, sc, cross in zip(params["dec"], caches.self_cache, caches.cross):
        h = L.apply_norm(p["norm1"], x, cfg)
        q, k, v = L.qkv_proj(p["attn"], h[:, None], cfg)
        L.cache_append_recent(sc, k[:, 0], v[:, 0], pos)
        o = L.decode_attention(q[:, 0], sc, pos)
        x = x + o.reshape(b, -1) @ p["attn"]["wo"].to(dt)
        h = L.apply_norm(p["norm_x"], x, cfg)
        x = x + _xattn_decode(p["xattn"], h, cross, cfg)
        h = L.apply_norm(p["norm2"], x, cfg)
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits(params["embed"], x, cfg), caches
