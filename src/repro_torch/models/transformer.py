"""Decoder-only LM (port of ``repro/models/transformer.py``): init,
forward, the training loss (``lm_hidden``, ``chunked_ce``, ``lm_loss``:
each layer and each cross-entropy chunk under ``torch.utils.checkpoint``,
so the [b, s, vocab] logits never exist whole), prefill into the
per-layer decode states, and one decode step, for heterogeneous stacks of
attention, mamba and rwkv mixers with dense or MoE FFNs.

Parameters are a plain dict: ``{"embed", "final_norm", "blocks": [one
dict per layer, in cfg.all_blocks order]}`` — the reference stacks each
layer group's repeats for ``lax.scan``; the port loops over layers
(``convert.lm_params_from_reference`` unstacks).  Caches are a list with
one decode state per layer: a ``DecodeCache`` for an attention block, a
``MambaState`` for a mamba block, an ``RWKVState`` for an rwkv block.
Attention and mamba mixers with dense, MoE or no FFN, and rwkv blocks
(time mix + channel mix) are ported; other blocks raise.  A config with a
vision stub (internvl2) prepends its projected patch embeddings to the
token embeddings (``vis_proj``; the loss skips them); the encoder-decoder
(whisper) is ``models/whisper.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
                             "router", "w1", "w2"))


def _ported(spec: BlockSpec) -> bool:
    if spec.mixer in ("attn", "mamba"):
        return spec.ffn in ("dense", "moe", "none")
    return spec.mixer == "rwkv" and spec.ffn == "dense"   # + channel mix


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer is an attention or mamba block with a
    dense, MoE or no FFN, or an rwkv block (time mix + channel mix), and
    the positions are rope or none — or, for an encoder-decoder, every
    decoder layer an attention block with a dense FFN and the positions
    the learned table: what the port runs."""
    for spec in cfg.all_blocks:
        if not _ported(spec):
            raise NotImplementedError(
                f"{cfg.arch}: block {spec} is not ported (the port runs "
                f"attention and mamba blocks with dense or MoE FFNs, and "
                f"rwkv blocks with their channel mix)")
    if cfg.is_enc_dec:
        if (any(s != BlockSpec() for s in cfg.all_blocks)
                or cfg.pos_emb != "learned" or cfg.vision is not None):
            raise NotImplementedError(
                f"{cfg.arch}: an encoder-decoder is ported with full "
                f"attention and dense FFNs in every decoder layer, a learned "
                f"position table and no vision stub (models/whisper.py)")
        return
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
    params = {"embed": place(L.init_embedding(gen, cfg)),
              "final_norm": place(L.init_norm(cfg))}
    if cfg.vision is not None:
        vd, d, pd = cfg.vision.vit_dim, cfg.d_model, cfg.pdtype
        params["vis_proj"] = place({"w1": L.he_normal(gen, (vd, d), pd),
                                    "w2": L.he_normal(gen, (d, d), pd)})
    params["blocks"] = [place(init_block(gen, cfg, spec))
                        for spec in cfg.all_blocks]
    return params


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
    """x: [b, s, d] ("local" / "head_tp") or [b, P, sl, d] ("cp") -> (out
    in x's layout, (k, v) in the natural [b, s, kv, hd] layout or None).

    Context parallelism (contiguous chunks: chunk p holds positions
    p*sl ... p*sl + sl - 1): the projections and rope run on the chunked
    layout; a global layer, or a local one without ``window_gather``,
    attends over the whole key sequence (``blocked_attention`` at the
    contiguous positions: one B13 call on the card); a sliding-window
    layer with ``window_gather`` gives each query chunk only its
    neighbour key chunks (``_attn_per_chunk``)."""
    theta = _rope_theta_for(cfg, spec)
    window = _window(spec)
    if x.dim() == 3:
        b, s, _ = x.shape
        q, k, v = L.qkv_proj(p, x, cfg)                   # [b,s,h/kv,hd]
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        q = L.apply_rope(q, pos, cfg, theta)
        k = L.apply_rope(k, pos, cfg, theta)
        o = L.blocked_attention(q[:, None], k, v, causal=True, window=window)
        o = o[:, 0].reshape(b, s, cfg.n_heads * cfg.hd)
        out = o @ p["wo"].to(cfg.cdtype)
        return out, ((k, v) if return_kv else None)

    b, P, sl, _ = x.shape
    s, kvh, hd = P * sl, cfg.n_kv_heads, cfg.hd
    q, k, v = L.qkv_proj(p, x, cfg)                       # [b,P,sl,*,hd]
    pos = (np.arange(P, dtype=np.int64)[:, None] * sl
           + np.arange(sl, dtype=np.int64)[None, :])      # [P, sl]
    pos_t = torch.from_numpy(pos).to(x.device)
    q = L.apply_rope(q, pos_t, cfg, theta)
    k = L.apply_rope(k, pos_t, cfg, theta)
    if window is not None and plan.window_gather and P > 1:
        # each query chunk gathers only the key chunks it can see
        nw = min(P, int(math.ceil(window / sl)) + 1)
        idx = np.arange(P)[:, None] - (nw - 1) + np.arange(nw)[None, :]
        valid = idx >= 0                                  # [P, nw]
        idxc = np.clip(idx, 0, P - 1)
        sel = torch.from_numpy(idxc.reshape(-1)).to(x.device)
        kg = k.index_select(1, sel).reshape(b, P, nw * sl, kvh, hd)
        vg = v.index_select(1, sel).reshape(b, P, nw * sl, kvh, hd)
        kpos = idxc[:, :, None] * sl + np.arange(sl)[None, None, :]
        kpos = np.where(valid[:, :, None], kpos, -10 ** 9)   # clipped dups
        o = _attn_per_chunk(q, kg, vg, pos, kpos.reshape(P, nw * sl), cfg,
                            window=window)
    else:
        o = L.blocked_attention(q, k.reshape(b, s, kvh, hd),
                                v.reshape(b, s, kvh, hd), causal=True,
                                window=window, q_positions=pos,
                                kv_positions=np.arange(s))
    out = o.reshape(b, P, sl, cfg.n_heads * hd) @ p["wo"].to(cfg.cdtype)
    if return_kv:
        return out, (k.reshape(b, s, kvh, hd), v.reshape(b, s, kvh, hd))
    return out, None


def _attn_per_chunk(q, kg, vg, qpos, kpos, cfg: ModelConfig, window):
    """Attention where each query chunk has its own key set, as the
    reference computes it (plain PyTorch on the card too: the reference
    runs it in jnp, outside any Pallas kernel).  q: [b, P, sl, h, hd];
    kg / vg: [b, P, skv, kv, hd]; qpos [P, sl], kpos [P, skv] numpy.
    Products of compute-dtype operands accumulate in f32 (the
    reference's ``preferred_element_type``), the softmax in f32 with its
    weights rounded to the compute dtype for the product with v."""
    h, hd = q.shape[3], q.shape[4]
    f32 = torch.float32
    kh = L.repeat_kv(kg, h).to(f32)
    vh = L.repeat_kv(vg, h)
    sc = torch.einsum("bpqhd,bpkhd->bphqk", q.to(f32), kh) / math.sqrt(hd)
    qp = torch.from_numpy(np.asarray(qpos)).to(q.device)
    kp = torch.from_numpy(np.asarray(kpos)).to(q.device)
    mask = qp[:, None, :, None] >= kp[:, None, None, :]
    if window is not None:
        mask = mask & (kp[:, None, None, :] > qp[:, None, :, None] - window)
    sc = sc.masked_fill(~mask[None], L.NEG_INF)
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bphqk,bpkhd->bpqhd", w.to(vh.dtype).to(f32),
                     vh.to(f32))
    return o.to(q.dtype)


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
                  plan=NULL_PLAN, return_kv: bool = False):
    """Returns (x_out, the MoE aux loss (0.0 without an MoE), the state
    for decode or None): (k, v) for an attention block, a ``MambaState``
    for a mamba block, (S, x_last, cm_last) for an rwkv block.  ``x`` is
    [b, s, d], or [b, P, sl, d] under context parallelism (attention
    blocks only).  An MoE FFN takes the expert-parallel dispatch under
    ``plan.moe_ep`` on a 3-D ``x``, else the dense one over each batch
    row's tokens (all chunks of a row together)."""
    if x.dim() == 4 and spec.mixer != "attn":
        raise NotImplementedError(
            f"{cfg.arch}: a {spec.mixer} block under context parallelism "
            f"(the reference's CP form runs attention blocks only)")
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
        if plan.moe_ep and x.dim() == 3:
            out, aux = L.apply_moe_ep(p["moe"], h, cfg, plan)
        else:
            out, aux_rows = L.apply_moe(
                p["moe"], h.reshape(h.shape[0], -1, h.shape[-1]), cfg)
            out, aux = out.reshape(x.shape), aux_rows.mean()
        x = x + out
    elif spec.mixer == "rwkv":
        prev = torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]),
                          h[:, :-1]], dim=1)
        x = x + R.channel_mix(p["rwkv_cm"], h, prev, cfg)
        if kv is not None:
            kv = (*kv, h[:, -1])                          # cm_prev for decode
    else:
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    return x, aux, kv


def _to_chunks(x: torch.Tensor, plan) -> torch.Tensor:
    """[b, s, d] -> [b, cp, s / cp, d] under ``attn_mode="cp"``, else x."""
    if plan.attn_mode != "cp":
        return x
    b, s, d = x.shape
    if s % plan.cp:
        raise ValueError(f"sequence {s} does not divide into {plan.cp} CP "
                         f"chunks")
    return x.reshape(b, plan.cp, s // plan.cp, d)


def _from_chunks(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1]) if x.dim() == 4 else x


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """tokens (+ the vision stub's patch embeddings) -> x [b, s, d]: with
    a vision stub, ``patch_embeds`` [b, n_patches, vit_dim] through
    ``vis_proj`` (w1, tanh-GELU, w2, in the compute dtype) come first."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.vision is None:
        return x
    dt, vp = cfg.cdtype, params["vis_proj"]
    pe = batch["patch_embeds"].to(device=x.device, dtype=dt)
    v = F.gelu(pe @ vp["w1"].to(dt), approximate="tanh") @ vp["w2"].to(dt)
    return torch.cat([v, x], dim=1)                      # image-first


def lm_forward(params, cfg: ModelConfig, batch, plan=NULL_PLAN):
    """Returns (logits [b, s, vocab_pad], the MoE aux loss summed over
    layers: 0.0 without MoE layers)."""
    x = _to_chunks(_embed_inputs(params, cfg, batch), plan)
    aux_total = 0.0
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        x, aux, _ = block_forward(p, x, cfg, spec, plan)
        aux_total = aux_total + aux
    x = L.apply_norm(params["final_norm"], _from_chunks(x), cfg)
    return L.logits(params["embed"], x, cfg), aux_total


# ---------------------------------------------------------------------------
# training loss: remat per layer, cross-entropy in checkpointed chunks
# ---------------------------------------------------------------------------

def _block_train(p, x, cfg: ModelConfig, spec: BlockSpec, plan):
    x, aux, _ = block_forward(p, x, cfg, spec, plan)
    return x, aux


def lm_hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
              plan=NULL_PLAN, remat: bool = True):
    """Embeddings -> final-norm hidden states [b, s, d], and the MoE aux
    loss summed over layers (an f32 0-dim tensor).  ``remat``: each layer
    runs under ``torch.utils.checkpoint`` (``use_reentrant=False``), its
    activations recomputed in backward, as the reference's
    ``jax.checkpoint`` around each scanned superblock does."""
    x = _to_chunks(_embed_inputs(params, cfg, batch), plan)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        if remat:
            x, aux = checkpoint(_block_train, p, x, cfg, spec, plan,
                                use_reentrant=False)
        else:
            x, aux = _block_train(p, x, cfg, spec, plan)
        aux_total = aux_total + aux
    return (L.apply_norm(params["final_norm"], _from_chunks(x), cfg),
            aux_total)


def _chunk_nll(embed_params, h, t, cfg: ModelConfig):
    lg = L.logits(embed_params, h, cfg).to(torch.float32)    # [b, cs, Vp]
    logz = torch.logsumexp(lg, dim=-1)
    tgt = lg.gather(-1, t[..., None])[..., 0]
    return (logz - tgt).sum()


def chunked_ce(embed_params, cfg: ModelConfig, hidden: torch.Tensor,
               targets: torch.Tensor, plan=NULL_PLAN, n_chunks: int = 8
               ) -> torch.Tensor:
    """Sum of next-token NLL over [b, s] in ``n_chunks`` sequence chunks
    (the largest count <= n_chunks that divides s, as the reference picks
    it), each under ``torch.utils.checkpoint``: one chunk's f32 logits at
    a time, recomputed in backward.  The padded vocab columns are -1e30
    (``L.logits``), so they weigh nothing in the logsumexp and get no
    gradient, as in the reference."""
    s = hidden.shape[1]
    n_chunks = max(1, min(n_chunks, s))
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(_chunk_nll, embed_params, hidden[:, sl],
                                   targets[:, sl], cfg, use_reentrant=False)
    return total


def lm_loss(params, cfg: ModelConfig, batch, plan=NULL_PLAN,
            aux_weight: float = 0.01, remat: bool = True,
            ce_chunks: int = 8):
    """Next-token cross-entropy (labels = tokens shifted by one; a vision
    prefix is excluded) plus ``aux_weight`` times the MoE aux loss.
    Returns (loss, {"ce", "aux"}), f32 0-dim tensors."""
    x, aux = lm_hidden(params, cfg, batch, plan, remat=remat)
    tokens = batch["tokens"].to(device=x.device, dtype=torch.long)
    prefix = x.shape[1] - tokens.shape[1]        # the vision prefix (or 0)
    h = x[:, prefix: prefix + tokens.shape[1] - 1]           # predicts t+1
    tgt = tokens[:, 1:]
    nll_sum = chunked_ce(params["embed"], cfg, h, tgt, plan, ce_chunks)
    loss = nll_sum / float(tgt.numel())
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


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
    x = _to_chunks(x, plan)
    caches = []
    for p, spec in zip(params["blocks"], cfg.all_blocks):
        x, _, kv = block_forward(p, x, cfg, spec, plan, return_kv=True)
        caches.append(_to_decode_state(kv, spec, cfg, s, plan))
    x = L.apply_norm(params["final_norm"], _from_chunks(x)[:, -1], cfg)
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
    if cache_len > s:
        raise ValueError(
            f"{cfg.arch}: a {s}-token prompt at cache_chunks={C}: the old "
            f"tier rounds up to {cache_len} positions, more than the prompt "
            f"holds (the reference fails on it too, and padding would "
            f"compute something else); give a prompt length that {C} "
            f"divides")
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


def decode_cache_specs(cfg: ModelConfig, b: int, seq_len: int,
                       plan=NULL_PLAN) -> List[Any]:
    """Meta tensors of the decode states ``lm_prefill`` emits for ``b``
    prompts of ``seq_len`` positions under ``plan``: one state a layer, in
    ``cfg.all_blocks`` order (the reference stacks each layer group's
    repeats; ``convert.caches_from_reference`` unstacks).  Nothing is
    allocated."""
    out = []
    for spec in cfg.all_blocks:
        if spec.mixer == "attn":
            C = plan.cache_chunks
            ln = _cache_len(cfg, spec, seq_len, plan) // C
            out.append(L.cache_specs(b, cfg.n_kv_heads, C, ln, cfg.hd,
                                     cfg.cdtype))
        elif spec.mixer == "mamba":
            out.append(M.mamba_state_specs(b, cfg, cfg.cdtype))
        else:
            out.append(R.rwkv_state_specs(b, cfg))
    return out


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
