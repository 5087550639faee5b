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
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BLOCKS = 2 ** 31 - 1        # b * h blocks along the grid's x axis

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("wkv6")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_forward.argtypes = [P, P, P, P, P, P, P,
                                     ctypes.POINTER(ctypes.c_int64),
                                     I, I, I, I, I, P]
        lib.wkv6_forward.restype = ctypes.c_int
        bind_error_string(lib.wkv6_error_string)
        _lib = lib
    return _lib


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


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r / k / v / w [b, h, T, hd], u [h, hd] on one CUDA device -> (out
    [b, h, T, hd] in r's dtype, S_T [b, h, hd, hd] f32), in ONE launch."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError(f"r, k, v, w, u on different devices: {r.device}, "
                         f"{k.device}, {v.device}, {w.device}, {u.device}")
    validate(r, k, v, w, u)
    b, h, T, hd = r.shape
    out = torch.empty(b, T, h, hd, dtype=r.dtype,
                      device=r.device).permute(0, 2, 1, 3)
    s_out = torch.empty(b, h, hd, hd, dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(s for t in (r, k, v, w, out)
                                      for s in t.stride()[:3]))
    lib = _library()
    launch("wkv6", lib.wkv6_error_string, lib.wkv6_forward, r.get_device(),
           r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
           u.data_ptr(), out.data_ptr(), s_out.data_ptr(), strides,
           int(r.dtype == torch.bfloat16), b, h, T, hd)
    return out, s_out
