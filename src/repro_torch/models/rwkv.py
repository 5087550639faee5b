"""RWKV-6 "Finch" (arXiv:2404.05892) time mix and channel mix (port of
``repro/models/rwkv.py``): attention-free, data-dependent decay.

Time-mix (WKV6) recurrence per head (k-dim i, v-dim j):

    out_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

with per-channel, per-timestep decay ``w_t = exp(-exp(w0 + lora_w(x)))``.

Prefill (``time_mix_forward``) computes r, k, v, g and the log decay as
the reference does, then runs the recurrence over the whole sequence in
ONE ``ops.wkv6`` call (the hand-written kernel on the card, the plain
step loop on the CPU): the reference's chunked log-space form computes
the same recurrence.  Decode (``time_mix_decode``) is the exact one-step
recurrence in PyTorch ops, as it is jnp in the reference.  Every cast
to the compute dtype sits where the reference puts it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import he_normal, lecun_normal, meta_spec

_F32 = torch.float32


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # [b, h, hd, hd]  (f32) matrix state
    tm_prev: torch.Tensor  # [b, d]  last token input of time-mix (normed)
    cm_prev: torch.Tensor  # [b, d]  last token input of channel-mix (normed)


MIX = ("w", "k", "v", "r", "g")


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the "
                         f"rwkv head dim {hd}")
    return cfg.d_model // hd, hd


def _randn(gen, shape, scale: float, cfg: ModelConfig):
    return (torch.randn(shape, generator=gen, dtype=_F32) * scale).to(
        cfg.pdtype)


def init_time_mix(gen, cfg: ModelConfig):
    """The reference's shapes and distributions (drawn from ``gen``)."""
    d = cfg.d_model
    h, hd = _dims(cfg)
    r, pd = cfg.rwkv, cfg.pdtype
    p = {
        "mu_x": torch.full((d,), 0.5, dtype=pd),
        "lora_a": lecun_normal(gen, (d, r.lora_dim_mix * 5), pd),
        "lora_b": _randn(gen, (5, r.lora_dim_mix, d), 0.01, cfg),
        # the decay bias stays f32 (exp-sensitive), as in the reference
        "w0": torch.full((d,), -5.0, dtype=_F32),
        "w_a": lecun_normal(gen, (d, r.lora_dim_w), pd),
        "w_b": _randn(gen, (r.lora_dim_w, d), 0.01, cfg),
        "u": _randn(gen, (h, hd), 0.1, cfg),
        "wr": he_normal(gen, (d, d), pd),
        "wk": he_normal(gen, (d, d), pd),
        "wv": he_normal(gen, (d, d), pd),
        "wg": he_normal(gen, (d, d), pd),
        "wo": he_normal(gen, (d, d), pd),
        "ln_x": torch.ones(d, dtype=pd),  # per-head norm
    }
    for i, m in enumerate(MIX):
        p[f"mu_{m}"] = torch.full((d,), 0.3 + 0.1 * i, dtype=pd)
    return p


def init_channel_mix(gen, cfg: ModelConfig):
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {
        "mu_k": torch.full((d,), 0.5, dtype=pd),
        "mu_r": torch.full((d,), 0.5, dtype=pd),
        "wk": he_normal(gen, (d, f), pd),
        "wv": he_normal(gen, (f, d), pd),
        "wr": he_normal(gen, (d, d), pd),
    }


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """Data-dependent token-shift interpolation -> dict of five mixed
    inputs, all in the compute dtype."""
    dt = cfg.cdtype
    dx = x_prev - x
    base = x + dx * p["mu_x"].to(dt)
    lora = torch.tanh(base @ p["lora_a"].to(dt))
    lora = lora.reshape(*lora.shape[:-1], 5, cfg.rwkv.lora_dim_mix)
    mods = torch.einsum("...ml,mld->...md", lora, p["lora_b"].to(dt))
    return {m: x + dx * (p[f"mu_{m}"].to(dt) + mods[..., i, :])
            for i, m in enumerate(MIX)}


def _time_mix_proj(p, x: torch.Tensor, x_prev: torch.Tensor,
                   cfg: ModelConfig):
    """x: [..., d] -> r, k, v [..., h, hd] and g [..., d] in the compute
    dtype, logw [..., h, hd] in f32 (<= 0).  The decay LoRA's product
    rounds to the compute dtype before the f32 add of ``w0``, as in the
    reference."""
    h, hd = _dims(cfg)
    dt = cfg.cdtype
    mix = _ddlerp(p, x, x_prev, cfg)
    lead = x.shape[:-1]
    r = (mix["r"] @ p["wr"].to(dt)).reshape(*lead, h, hd)
    k = (mix["k"] @ p["wk"].to(dt)).reshape(*lead, h, hd)
    v = (mix["v"] @ p["wv"].to(dt)).reshape(*lead, h, hd)
    g = F.silu(mix["g"] @ p["wg"].to(dt))
    ww = p["w0"] + (torch.tanh(mix["w"] @ p["w_a"].to(dt))
                    @ p["w_b"].to(dt)).to(_F32)
    logw = -torch.exp(ww)                                 # log decay, <= 0
    return r, k, v, g, logw.reshape(*lead, h, hd)


def _head_groupnorm(p, x: torch.Tensor, cfg: ModelConfig, eps=64e-5):
    """Per-head LayerNorm over hd (RWKV's ln_x) in f32, then flatten the
    heads: [..., h, hd] -> [..., d] f32."""
    h, hd = _dims(cfg)
    x32 = x.to(_F32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.reshape(*x.shape[:-2], h * hd) * p["ln_x"].to(_F32)


def time_mix_forward(p, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill time mix from a zero state (the reference's
    ``time_mix_chunked`` without a carried state).  x: [b, s, d] ->
    (out [b, s, d], final wkv state [b, h, hd, hd] f32, x_last [b, d]).
    The recurrence is ONE ``ops.wkv6`` call on [b, h, s, hd] views of
    the f32 [b, s, h, hd] projections (no copy on the card)."""
    b, s, d = x.shape
    h, hd = _dims(cfg)
    x_prev = torch.cat([x.new_zeros(b, 1, d), x[:, :-1]], dim=1)
    r, k, v, g, logw = _time_mix_proj(p, x, x_prev, cfg)
    view = lambda t: t.to(_F32).transpose(1, 2)         # [b, h, s, hd]
    o, S = ops.wkv6(view(r), view(k), view(v), view(torch.exp(logw)),
                    p["u"].to(_F32))
    o = _head_groupnorm(p, o.transpose(1, 2), cfg)      # [b, s, d]
    o = (o.to(cfg.cdtype) * g) @ p["wo"].to(cfg.cdtype)
    return o, S, x[:, -1]


def time_mix_decode(p, x: torch.Tensor, state: RWKVState, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step.  x: [b, d] -> (out [b, d], new wkv state, x)."""
    r, k, v, g, logw = _time_mix_proj(p, x, state.tm_prev, cfg)
    r32, k32, v32 = (t.to(_F32) for t in (r, k, v))
    u = p["u"].to(_F32)
    kv = k32[..., :, None] * v32[..., None, :]           # [b, h, hd, hd]
    out = torch.einsum("bhi,bhij->bhj", r32, state.wkv + u[..., None] * kv)
    S = torch.exp(logw)[..., None] * state.wkv + kv
    o = _head_groupnorm(p, out, cfg)
    o = (o.to(cfg.cdtype) * g) @ p["wo"].to(cfg.cdtype)
    return o, S, x


def channel_mix(p, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """x: [..., d]; x_prev the same shape (token-shifted)."""
    dt = cfg.cdtype
    dx = x_prev - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    return torch.sigmoid(xr @ p["wr"].to(dt)) * (kk @ p["wv"].to(dt))


def rwkv_state_init(b: int, cfg: ModelConfig, device="cpu") -> RWKVState:
    h, hd = _dims(cfg)
    return RWKVState(
        wkv=torch.zeros(b, h, hd, hd, dtype=_F32, device=device),
        tm_prev=torch.zeros(b, cfg.d_model, dtype=cfg.cdtype, device=device),
        cm_prev=torch.zeros(b, cfg.d_model, dtype=cfg.cdtype, device=device))


def rwkv_state_specs(b: int, cfg: ModelConfig) -> RWKVState:
    """Meta tensors of ``rwkv_state_init``'s shapes."""
    h, hd = _dims(cfg)
    return RWKVState(wkv=meta_spec((b, h, hd, hd), _F32),
                     tm_prev=meta_spec((b, cfg.d_model), cfg.cdtype),
                     cm_prev=meta_spec((b, cfg.d_model), cfg.cdtype))


def time_mix_recurrent_ref(p, x: torch.Tensor, cfg: ModelConfig
                           ) -> torch.Tensor:
    """Token-by-token oracle for tests (a Python loop over time)."""
    st = rwkv_state_init(x.shape[0], cfg, x.device)
    outs = []
    for t in range(x.shape[1]):
        o, S, xl = time_mix_decode(p, x[:, t], st, cfg)
        st = st._replace(wkv=S, tm_prev=xl)
        outs.append(o)
    return torch.stack(outs, dim=1)
