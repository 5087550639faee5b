"""Wrapper of the flash-attention CUDA kernel (csrc/flash_attention.cu).

Port of ``repro/kernels/flash_attention.py::flash_attention`` (replaces
``_attn_kernel``): blocked online-softmax attention forward with GQA,
causal masking, an optional sliding window and an optional tanh softcap,
f32 statistics and accumulator, output in q's dtype.

It takes CUDA tensors only (``ops`` routes CPU tensors to
``ref.attention``): q [b, h, sq, hd] and k / v [b, kvh, skv, hd], f32 or
bf16, any strides with a unit stride on hd (so a transposed view of the
model's [b, s, h, hd] projections is read in place), hd in
``HEAD_DIMS``, any sq and skv.  The output is [b, h, sq, hd], a view of a
fresh [b, sq, h, hd] buffer: the layout the model's output projection
reads.  ONE launch on the current stream, no synchronise.  A non-zero
``cudaGetLastError`` raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, launch

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535              # b * h blocks along the grid's y axis

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fa_forward.argtypes = [P, P, P, P, ctypes.POINTER(ctypes.c_int64),
                                   I, I, I, I, I, I, I, I, I, F, F, P]
        lib.fa_forward.restype = ctypes.c_int
        bind_error_string(lib.fa_error_string)
        _lib = lib
    return _lib


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: Optional[int], softcap: Optional[float]) -> None:
    """Raise ``ValueError`` for anything the kernel does not take (device
    aside): shapes, dtypes, head dims, strides, window and softcap."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor, got "
                             f"{getattr(t, 'shape', type(t))}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not in {list(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last (head) "
                             f"dim, got strides {t.stride()}")
    b, h, sq, hd = q.shape
    kb, kvh, skv, khd = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if tuple(v.shape) != tuple(k.shape) or kb != b or khd != hd:
        raise ValueError(f"need q [b,h,sq,hd], k and v [b,kvh,skv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, h, kvh, sq, skv) < 1 or h % kvh:
        raise ValueError(f"need non-empty shapes and h % kvh == 0, got "
                         f"h={h}, kvh={kvh}, b={b}, sq={sq}, skv={skv}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds {_MAX_GRID_Y}")
    if window is not None:
        if int(window) != window or window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        if sq >= skv + window:
            raise ValueError(f"with window {window}, query rows at or past "
                             f"skv + window = {skv + window} see no key "
                             f"(sq = {sq})")
    if softcap is not None and not (0.0 < softcap < math.inf):
        raise ValueError(f"softcap must be positive and finite, got "
                         f"{softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, h, sq, hd], k / v [b, kvh, skv, hd] on one CUDA device ->
    [b, h, sq, hd] in q's dtype, in ONE launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    validate(q, k, v, window, softcap)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, h, hd, dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    lib = _library()
    launch("flash_attention", lib.fa_error_string, lib.fa_forward, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
           int(q.dtype == torch.bfloat16), b, h, kvh, sq, skv, hd,
           int(bool(causal)), int(window or 0), float(softcap or 0.0),
           1.0 / math.sqrt(hd))
    return out
