"""Wrapper of the flash-attention CUDA kernels (B13).

Port of ``repro/kernels/flash_attention.py::flash_attention`` (replaces
``_attn_kernel``): blocked online-softmax attention forward with GQA,
causal masking, an optional sliding window and an optional tanh softcap,
f32 statistics and accumulator, output in q's dtype.

Two hand-written kernels compute it; ``route`` picks one from the dtype
and the head dim alone, never by trying:

- ``"wgmma"`` (csrc/flash_attention_sm90.cu): bf16 at hd 128, the serving
  prefills' attention.  Tensor cores fed by TMA; P is rounded to bf16
  for the P.V product.  Its inputs must be addressable by TMA: 16-byte
  aligned bases, and batch / head / seq strides that are positive
  multiples of 8 elements (16 bytes) where the dim has more than one
  entry; anything else raises ``ValueError``.
- ``"simt"`` (csrc/flash_attention.cu): f32, and every other head dim.

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
BWD_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535              # simt: b * h blocks along the grid's y axis
WGMMA_HEAD_DIM = 128
WGMMA_TILE = 128                 # wgmma: query rows a CTA, keys a kv tile
_TMA_ALIGN = 8                   # bf16 elements in 16 bytes

_libs: dict = {}


def _library(kernel: str) -> ctypes.CDLL:
    """The loaded library of ``kernel``: a forward route ("wgmma",
    "simt") or the backward ("bwd"), its entry's argtypes bound."""
    lib = _libs.get(kernel)
    if lib is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_int64)
        if kernel == "bwd":
            lib = build.load("flash_attention_bwd")
            fn, err = lib.fa_backward, lib.fa_bwd_error_string
            fn.argtypes = [P] * 9 + [strides] + [I] * 9 + [F, P]
        elif kernel == "wgmma":
            lib = build.load("flash_attention_sm90")
            fn, err = lib.fa90_forward, lib.fa90_error_string
            fn.argtypes = [P] * 4 + [strides] + [I] * 7 + [F, F, P]
        else:
            lib = build.load("flash_attention")
            fn, err = lib.fa_forward, lib.fa_error_string
            fn.argtypes = [P] * 4 + [strides] + [I] * 9 + [F, F, P]
        fn.restype = ctypes.c_int
        bind_error_string(err)
        _libs[kernel] = lib
    return lib


def route(q: torch.Tensor) -> str:
    """The kernel that takes ``q``'s attention: ``"wgmma"`` for bf16 at
    hd 128, ``"simt"`` for everything else."""
    if q.dtype == torch.bfloat16 and q.shape[-1] == WGMMA_HEAD_DIM:
        return "wgmma"
    return "simt"


def validate_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """The wgmma route's tensor-map strides: q's, k's and v's (batch,
    head, seq) strides in elements, a dim of one entry given the tensor's
    extent instead (TMA never steps it, but its encoder checks every
    stride).  Raises ``ValueError`` where the maps cannot address an
    input: a base not 16-byte aligned, or a batch / head / seq stride (of
    a dim with more than one entry) that is not a positive multiple of 16
    bytes."""
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned base for TMA "
                             f"(bf16 at hd 128)")
        shape, st = t.shape, t.stride()
        extent = None
        for i in range(3):
            n, s = shape[i], st[i]
            if n > 1:
                if s <= 0 or s % _TMA_ALIGN:
                    raise ValueError(
                        f"{name} needs batch / head / seq strides that are "
                        f"positive multiples of 16 bytes for TMA (bf16 at "
                        f"hd 128), got strides {st}")
            else:
                if extent is None:
                    extent = 1 + sum((m - 1) * d for m, d in zip(shape, st))
                    extent = -(-extent // _TMA_ALIGN) * _TMA_ALIGN
                s = extent
            strides.append(s)
    n_qtiles = -(-q.shape[2] // WGMMA_TILE)
    if n_qtiles > _MAX_GRID_Y:
        raise ValueError(f"sq = {q.shape[2]} needs {n_qtiles} query tiles "
                         f"> {_MAX_GRID_Y}")
    return strides


def tile_walk(sq: int, skv: int, causal: bool, window: Optional[int]):
    """The wgmma kernel's walk, in launch order: ``(q_tile, t_lo, t_hi)``
    per query tile of ``WGMMA_TILE`` rows, heaviest (bottom) first, with
    the kv tiles ``[t_lo, t_hi)`` of ``WGMMA_TILE`` keys that its rows can
    see (csrc/flash_attention_sm90.cu computes the same range)."""
    tile = WGMMA_TILE
    n_qtiles = -(-sq // tile)
    walk = []
    for y in range(n_qtiles):
        qt = n_qtiles - 1 - y
        q0 = qt * tile
        q_last = min(q0 + tile, sq) - 1
        kv_hi = min(skv, q_last + 1) if causal else skv
        kv_lo = max(0, q0 - window + 1) if window else 0
        t_lo = kv_lo // tile
        walk.append((qt, t_lo, max(-(-kv_hi // tile), t_lo)))
    return walk


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
    if b * h > _MAX_GRID_Y and route(q) == "simt":
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
    which = route(q)
    if which == "wgmma":
        strides = validate_tma(q, k, v)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, h, hd, dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    flags = (int(bool(causal)), int(window or 0), float(softcap or 0.0),
             1.0 / math.sqrt(hd))
    lib = _library(which)
    if which == "wgmma":
        strides = (ctypes.c_int64 * 12)(*strides, *out.stride()[:3])
        launch("flash_attention", lib.fa90_error_string, lib.fa90_forward,
               q.get_device(), *ptrs, strides, b, h, kvh, sq, skv, *flags,
               route=which)
    else:
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                          for s in t.stride()[:3]))
        launch("flash_attention", lib.fa_error_string, lib.fa_forward,
               q.get_device(), *ptrs, strides,
               int(q.dtype == torch.bfloat16), b, h, kvh, sq, skv, hd, *flags,
               route=which)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None):
    """The gradients of ``flash_attention(q, k, v)`` (its output ``o``)
    against the output gradient ``do`` [b, h, sq, hd]: (dq [b, h, sq, hd],
    dk, dv [b, kvh, skv, hd]) in q's dtype, in ONE call of the backward
    kernel (its dq pass and its dk / dv pass on the current stream).  dq
    is a view of a fresh [b, sq, h, hd] buffer and dk / dv of fresh
    [b, skv, kvh, hd] buffers: the layouts of the model's projections."""
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.device != q.device:
            raise ValueError(f"q and {name} on different devices: "
                             f"{q.device}, {t.device}")
    validate(q, k, v, window, None)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last (head) "
                             f"dim, got strides {t.stride()}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, got {hd}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds {_MAX_GRID_Y}")
    dev, dt = q.device, q.dtype
    dq = torch.empty(b, sq, h, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty(b, skv, kvh, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    dv = torch.empty(b, skv, kvh, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    lib = _library("bwd")
    launch("flash_attention_bwd", lib.fa_bwd_error_string, lib.fa_backward,
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), stats.data_ptr(), strides,
           int(dt == torch.bfloat16), b, h, kvh, sq, skv, hd,
           int(bool(causal)), int(window or 0), 1.0 / math.sqrt(hd))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """B13 under autograd on the card: the forward is one launch of
    ``flash_attention`` (wgmma or SIMT route), the backward one call of
    ``flash_attention_bwd`` on the saved q, k, v and o.  No softcap (no
    config the port trains sets one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
