"""Wrapper of the WKV6 recurrence CUDA kernel (csrc/wkv6.cu).

Port of ``repro/kernels/rwkv6_scan.py::wkv6`` (replaces ``_wkv6_kernel``):
per (batch, head), from a zero state,

    out_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
    S[i,j]  <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

in f32, ``out`` stored in r's dtype.  The kernel also returns the final
state ``S_T`` [b, h, hd, hd] in f32, which the model's prefill hands to
decode (the Pallas kernel drops it).  It computes the recurrence in
chunks of C steps (the chunked form: running products of the decays,
an inter product with the chunk's starting state, the intra matrix with
the bonus on its diagonal, one state update a chunk), one block a
(b, h).

Under autograd ``WKV6`` adds the backward: its forward is the same launch
that also writes the state at the start of each chunk of ``CHUNK`` steps
(``chunk_states``), its backward one launch of the hand-written backward
kernel (csrc/wkv6_bwd.cu, ``wkv6_bwd``), which steps the states forward
from those checkpoints and walks each chunk in reverse.

It takes CUDA tensors only (``ops`` routes CPU tensors to ``ref.wkv6``):
r / k / v / w [b, h, T, hd] of one dtype, f32 or bf16, any strides with a
unit stride on hd (so a transposed view of the model's [b, T, h, hd]
projections is read in place), hd in ``HEAD_DIMS``, any T >= 1; u
[h, hd] contiguous f32.  ``out`` is [b, h, T, hd], a view of a fresh
[b, T, h, hd] buffer: the layout the model's group norm reads.  ONE
launch on the current stream, no synchronise.  A non-zero
``cudaGetLastError`` raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, launch

HEAD_DIMS = (16, 64)             # rwkv6's reduced and published configs
CHUNK = 16                       # steps between the forward's checkpoints
_DTYPES = (torch.float32, torch.bfloat16)
_F32 = torch.float32
_MAX_BLOCKS = 2 ** 31 - 1        # b * h blocks along the grid's x axis

_libs: dict = {}


def _library(name: str = "wkv6") -> ctypes.CDLL:
    """The loaded library of the forward ("wkv6") or the backward
    ("wkv6_bwd"), its entry's argtypes bound."""
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        P, I = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_int64)
        if name == "wkv6":
            fn, err = lib.wkv6_forward_states, lib.wkv6_error_string
            fn.argtypes = [P] * 8 + [strides] + [I] * 5 + [P]
        else:
            fn, err = lib.wkv6_backward, lib.wkv6_bwd_error_string
            fn.argtypes = [P] * 12 + [strides] + [I] * 4 + [P]
        fn.restype = ctypes.c_int
        bind_error_string(err)
        _libs[name] = lib
    return lib


def validate(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor) -> None:
    """Raise ``ValueError`` for anything the kernel does not take (device
    aside): shapes, dtypes, head dims and strides."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor, got "
                             f"{getattr(t, 'shape', type(t))}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not in {list(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last (head) "
                             f"dim, got strides {t.stride()}")
        if t.dtype != r.dtype:
            raise ValueError(f"r, k, v, w dtypes differ: {r.dtype}, "
                             f"{k.dtype}, {v.dtype}, {w.dtype}")
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"need r, k, v, w of one shape [b,h,T,hd]; got "
                             f"{tuple(r.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, h, T, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, h, T) < 1:
        raise ValueError(f"need non-empty shapes, got b={b}, h={h}, T={T}")
    if b * h > _MAX_BLOCKS:
        raise ValueError(f"b * h = {b * h} exceeds {_MAX_BLOCKS}")
    if not isinstance(u, torch.Tensor) or tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be [h, hd] = {(h, hd)}, got "
                         f"{getattr(u, 'shape', type(u))}")
    if u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError(f"u must be contiguous float32, got {u.dtype}, "
                         f"strides {u.stride()}")


def _on_card(**tensors) -> None:
    r = tensors["r"]
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.device != r.device:
            raise ValueError(f"r and {name} on different devices: "
                             f"{r.device}, {t.device}")


def chunk_states(r: torch.Tensor) -> torch.Tensor:
    """A buffer for the forward's state at the start of each chunk of
    ``CHUNK`` steps (what the backward takes): [b * h, ceil(T / CHUNK),
    hd, hd] f32 on r's device."""
    b, h, T, hd = r.shape
    return torch.empty(b * h, -(-T // CHUNK), hd, hd, dtype=_F32,
                       device=r.device)


def _check_states(states: torch.Tensor, r: torch.Tensor) -> None:
    b, h, T, hd = r.shape
    shape = (b * h, -(-T // CHUNK), hd, hd)
    if (not isinstance(states, torch.Tensor) or states.dtype != _F32
            or tuple(states.shape) != shape or not states.is_contiguous()
            or states.device != r.device or states.data_ptr() % 16):
        raise ValueError(f"states must be a contiguous, 16-byte aligned f32 "
                         f"tensor {shape} on {r.device} (chunk_states)")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, states: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r / k / v / w [b, h, T, hd], u [h, hd] on one CUDA device -> (out
    [b, h, T, hd] in r's dtype, S_T [b, h, hd, hd] f32), in ONE launch.
    ``states`` (a ``chunk_states(r)`` buffer): the launch also fills it
    with the state at the start of each chunk, for the backward."""
    _on_card(r=r, k=k, v=v, w=w, u=u)
    validate(r, k, v, w, u)
    if states is not None:
        _check_states(states, r)
    b, h, T, hd = r.shape
    out = torch.empty(b, T, h, hd, dtype=r.dtype,
                      device=r.device).permute(0, 2, 1, 3)
    s_out = torch.empty(b, h, hd, hd, dtype=_F32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(s for t in (r, k, v, w, out)
                                      for s in t.stride()[:3]))
    lib = _library()
    launch("wkv6", lib.wkv6_error_string, lib.wkv6_forward_states,
           r.get_device(), r.data_ptr(), k.data_ptr(), v.data_ptr(),
           w.data_ptr(), u.data_ptr(), out.data_ptr(), s_out.data_ptr(),
           None if states is None else states.data_ptr(), strides,
           int(r.dtype == torch.bfloat16), b, h, T, hd)
    return out, s_out


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
             states: torch.Tensor):
    """The gradients of ``wkv6``'s out (not of its final state) against
    ``do`` [b, h, T, hd], given the forward's ``states``: (dr, dk, dv, dw
    [b, h, T, hd] f32, each a view of a fresh [b, T, h, hd] buffer, du
    [h, hd] f32), in ONE launch of csrc/wkv6_bwd.cu; du is the sum over b
    of the kernel's per-(b, h) partials, taken in a fixed order.  Every
    input f32 (the model casts r, k, v and w to f32 before B14), each
    with a unit stride on hd."""
    _on_card(r=r, k=k, v=v, w=w, u=u, do=do, states=states)
    validate(r, k, v, w, u)
    if r.dtype != _F32:
        raise ValueError(f"the WKV6 backward kernel takes float32 r, k, v, "
                         f"w and do, got {r.dtype}")
    if tuple(do.shape) != tuple(r.shape) or do.dtype != _F32:
        raise ValueError(f"do must be {tuple(r.shape)} float32, got "
                         f"{tuple(do.shape)} {do.dtype}")
    if do.stride(-1) != 1:
        raise ValueError(f"do needs a unit stride on its last (head) dim, "
                         f"got strides {do.stride()}")
    _check_states(states, r)
    b, h, T, hd = r.shape
    grads = [torch.empty(b, T, h, hd, dtype=_F32,
                         device=r.device).permute(0, 2, 1, 3)
             for _ in range(4)]
    dr, dk, dw, dv = grads
    du_part = torch.empty(b, h, hd, dtype=_F32, device=r.device)
    strides = (ctypes.c_int64 * 27)(*(s for t in (r, k, w, v, do, *grads)
                                      for s in t.stride()[:3]))
    lib = _library("wkv6_bwd")
    launch("wkv6_bwd", lib.wkv6_bwd_error_string, lib.wkv6_backward,
           r.get_device(), r.data_ptr(), k.data_ptr(), w.data_ptr(),
           v.data_ptr(), do.data_ptr(), u.data_ptr(), states.data_ptr(),
           dr.data_ptr(), dk.data_ptr(), dw.data_ptr(), dv.data_ptr(),
           du_part.data_ptr(), strides, b, h, T, hd)
    return dr, dk, dv, dw, du_part.sum(0)


class WKV6(torch.autograd.Function):
    """B14 under autograd on the card: the forward is one launch of
    ``wkv6`` that also fills ``chunk_states``, the backward one launch of
    ``wkv6_bwd``.  The final state is not differentiable (no training
    loss reads it).  f32 only (the model casts to f32 before B14)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        if r.dtype != _F32:
            raise ValueError(f"the WKV6 backward kernel takes float32, got "
                             f"{r.dtype}")
        states = chunk_states(r)
        out, s_out = wkv6(r, k, v, w, u, states=states)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.mark_non_differentiable(s_out)
        ctx.set_materialize_grads(False)
        return out, s_out

    @staticmethod
    def backward(ctx, dout, _ds):
        if dout is None:
            return None, None, None, None, None
        r, k, v, w, u, states = ctx.saved_tensors
        if dout.stride(-1) != 1 or dout.dtype != _F32:
            dout = dout.to(_F32).contiguous()
        return wkv6_bwd(r, k, v, w, u, dout, states)
