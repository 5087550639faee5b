"""Mamba (selective SSM) block (port of ``repro/models/mamba.py``), used by
jamba-v0.1 (mamba and attention layers 7:1 in one stack).

Per channel d and state s:

    h_t[d, s] = exp(dt_t[d] * A[d, s]) * h_{t-1}[d, s] + dt_t[d] u_t[d] B_t[s]
    y_t[d]    = sum_s C_t[s] h_t[d, s] + D[d] u_t[d]

Prefill (``mamba_forward``) computes the projections, the depthwise
causal conv, ``dt = softplus(dt_r @ dt_proj + dt_bias)`` and
``A = -exp(a_log)`` as the reference does, then runs the recurrence over
the whole sequence in ONE ``ops.mamba_scan`` call (the hand-written
kernel on the card, the plain step loop on the CPU): the reference's
``mamba_chunked`` computes the same recurrence as an associative scan
over chunks of ``scan_chunk`` steps.  Decode (``mamba_decode``) is the
exact one-step recurrence in PyTorch ops, as it is jnp in the reference.
Every cast to the compute dtype sits where the reference puts it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import he_normal

_F32 = torch.float32


class MambaState(NamedTuple):
    conv: torch.Tensor     # [b, d_inner, d_conv - 1]  pre-conv inputs
    ssm: torch.Tensor      # [b, d_inner, d_state]  (f32)


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_inner, m.d_state, m.d_conv, dt_rank


def init_mamba(gen, cfg: ModelConfig):
    """The reference's shapes and distributions (drawn from ``gen``, on
    the CPU): S4D-real ``a_log`` = log(1..ds) in f32, ``dt_bias`` the
    inverse softplus of a log-uniform dt in [0.001, 0.1]."""
    d, pd = cfg.d_model, cfg.pdtype
    di, ds, dc, dtr = _dims(cfg)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=_F32)).expand(di, ds)
    dt = torch.exp(torch.rand(di, generator=gen, dtype=_F32)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = torch.log(torch.exp(dt) - 1.0 + 1e-9)
    return {
        "in_proj": he_normal(gen, (d, 2 * di), pd),
        "conv_w": he_normal(gen, (dc, di), pd, fan_in=dc),
        "conv_b": torch.zeros(di, dtype=pd),
        "x_proj": he_normal(gen, (di, dtr + 2 * ds), pd),
        "dt_proj": he_normal(gen, (dtr, di), pd, fan_in=dtr),
        "dt_bias": dt_bias.to(pd),
        "a_log": a_log.contiguous(),          # keep f32: exp-sensitive
        "d_skip": torch.ones(di, dtype=pd),
        "out_proj": he_normal(gen, (di, d), pd),
    }


def _ssm_inputs(p, x: torch.Tensor, cfg: ModelConfig):
    """x: [b, s, d] -> (u, u_pre, z, dt_r, B, C): u [b, s, di] conv'd and
    silu'd, u_pre its pre-conv input, z the gate, dt_r [b, s, dtr], B / C
    [b, s, ds] in f32 (column views of the x_proj output in f32 compute,
    copies in bf16).  The depthwise causal conv sums the dc shifted
    products in the compute dtype, in the reference's order."""
    di, ds, dc, dtr = _dims(cfg)
    dt_ = cfg.cdtype
    s = x.shape[1]
    xz = x @ p["in_proj"].to(dt_)                     # [b, s, 2di]
    u_pre, z = xz[..., :di], xz[..., di:]
    pad = F.pad(u_pre, (0, 0, dc - 1, 0))             # zeros before t = 0
    w = p["conv_w"].to(dt_)
    conv = sum(pad[:, i: i + s] * w[i] for i in range(dc))
    u = F.silu(conv + p["conv_b"].to(dt_))
    xdbc = u @ p["x_proj"].to(dt_)                    # [b, s, dtr + 2ds]
    dt_r, B, C = xdbc[..., :dtr], xdbc[..., dtr:dtr + ds], xdbc[..., dtr + ds:]
    return u, u_pre, z, dt_r, B.to(_F32), C.to(_F32)


def _dt(p, dt_r: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """softplus(dt_r @ dt_proj + dt_bias) in f32."""
    return F.softplus((dt_r @ p["dt_proj"].to(cfg.cdtype)).to(_F32)
                      + p["dt_bias"].to(_F32))


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Prefill from a zero state (the reference's ``mamba_chunked``).
    x: [b, s, d] -> (out [b, s, d], MambaState(conv, ssm)): the pre-conv
    tail ``u_pre[:, -(dc-1):]`` [b, di, dc-1] and the final state h_T
    [b, di, ds] f32.  The recurrence, its skip term and the one rounding
    to the compute dtype are ONE ``ops.mamba_scan`` call."""
    b, s, _ = x.shape
    di, ds, dc, dtr = _dims(cfg)
    u, u_pre, z, dt_r, B, C = _ssm_inputs(p, x, cfg)
    A = -torch.exp(p["a_log"].to(_F32))
    y, h = ops.mamba_scan(u, _dt(p, dt_r, cfg), B, C, A.contiguous(),
                          p["d_skip"].to(_F32).contiguous())
    out = (y * F.silu(z)) @ p["out_proj"].to(cfg.cdtype)
    conv = (u_pre[:, -(dc - 1):].transpose(1, 2).contiguous() if dc > 1
            else x.new_zeros(b, di, 0))
    return out, MambaState(conv=conv, ssm=h)


def mamba_decode_state(b: int, cfg: ModelConfig, device="cpu") -> MambaState:
    di, ds, dc, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros(b, di, dc - 1, dtype=cfg.cdtype, device=device),
        ssm=torch.zeros(b, di, ds, dtype=_F32, device=device))


def mamba_decode(p, x: torch.Tensor, state: MambaState, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One decode step.  x: [b, d] -> (y [b, d], the new state)."""
    di, ds, dc, dtr = _dims(cfg)
    dt_ = cfg.cdtype
    xz = x @ p["in_proj"].to(dt_)
    u, z = xz[:, :di], xz[:, di:]                     # [b, di]
    conv_in = torch.cat([state.conv.to(dt_), u[:, :, None]], dim=-1)
    u = F.silu(torch.einsum("bdc,cd->bd", conv_in, p["conv_w"].to(dt_))
               + p["conv_b"].to(dt_))
    xdbc = u @ p["x_proj"].to(dt_)
    dt_r, B, C = xdbc[:, :dtr], xdbc[:, dtr:dtr + ds], xdbc[:, dtr + ds:]
    dt = _dt(p, dt_r, cfg)                            # [b, di]
    A = -torch.exp(p["a_log"].to(_F32))
    a_bar = torch.exp(dt[..., None] * A)              # [b, di, ds]
    bx = (dt * u.to(_F32))[..., None] * B.to(_F32)[:, None, :]
    h = a_bar * state.ssm + bx
    y = torch.einsum("bds,bs->bd", h, C.to(_F32))
    y = y + u.to(_F32) * p["d_skip"].to(_F32)
    y = y.to(dt_) * F.silu(z)
    return (y @ p["out_proj"].to(dt_),
            MambaState(conv=conv_in[:, :, 1:].contiguous(), ssm=h))


def mamba_recurrent_ref(p, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Token-by-token oracle for tests (a Python loop of decode steps)."""
    state = mamba_decode_state(x.shape[0], cfg, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, state = mamba_decode(p, x[:, t], state, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)
