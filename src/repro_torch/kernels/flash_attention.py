"""Wrapper of the flash-attention CUDA kernels (B13) and of its backward.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (replaces
``_attn_kernel``): blocked online-softmax attention forward with GQA,
causal masking, an optional sliding window and an optional tanh softcap,
f32 statistics and accumulator, output in q's dtype.

Two hand-written kernels compute the forward, and two the backward;
``route`` and ``bwd_route`` pick one from the dtype and the head dim
alone, never by trying:

- ``"wgmma"``: bf16 at hd 64, 80, 128 and 256, the serving prefills' and
  bf16 training's attention.  Tensor cores fed by TMA: the forward
  csrc/flash_attention_sm90.cu (P rounded to bf16 for the P.V product),
  the backward csrc/flash_attention_bwd_sm90.cu (P and dS rounded to bf16
  for the products they feed).  Their inputs must be addressable by TMA:
  16-byte aligned bases, and batch / head / seq strides that are
  positive multiples of 8 elements (16 bytes) where the dim has more
  than one entry; anything else raises ``ValueError``.
- ``"simt"``: f32, and hd 16 and 32: csrc/flash_attention.cu and
  csrc/flash_attention_bwd.cu.  ``kernel="simt"`` also times the SIMT
  forward on the bf16 inputs it is built for beside the wgmma route
  (every head dim but 128).

Each head dim's wgmma geometry (``fwd_keys``, ``bwd_tiles``) sets the
walks ``tile_walk``, ``bwd_dq_walk`` and ``bwd_dkv_walk`` describe: hd
256 streams 64-key tiles in the forward and 32-row tiles in the
backward, whose dk / dv pass keeps 64 keys a CTA; hd 80 runs hd 128's
geometry on tiles that TMA zero-fills past column 80.

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
BWD_HEAD_DIMS = HEAD_DIMS        # every forward head dim has a backward
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535              # simt: b * h blocks along the grid's y axis
WGMMA_HEAD_DIMS = (64, 80, 128, 256)   # the wgmma routes' head dims (bf16)
WGMMA_TILE = 128                 # wgmma forward: query rows a CTA (and keys
                                 # a tile but at hd 256: ``fwd_keys``)
BWD_ROWS = 128                   # wgmma backward: resident rows a dq CTA
BWD_TILE = 64                    # wgmma backward: rows a streamed tile (32
                                 # at hd 256: ``bwd_tiles``)
_TMA_ALIGN = 8                   # bf16 elements in 16 bytes
_TMA_WHAT = "bf16 at hd 64, 80, 128 or 256"

_libs: dict = {}


def _library(kernel: str) -> ctypes.CDLL:
    """The loaded library of ``kernel``: a forward route ("wgmma",
    "simt") or a backward route ("bwd_wgmma", "bwd_simt"), its entry's
    argtypes bound."""
    lib = _libs.get(kernel)
    if lib is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_int64)
        if kernel == "bwd_wgmma":
            lib = build.load("flash_attention_bwd_sm90")
            fn, err = lib.fa90_backward, lib.fa90_bwd_error_string
            fn.argtypes = [P] * 10 + [strides] + [I] * 9 + [F, P]
        elif kernel == "bwd_simt":
            lib = build.load("flash_attention_bwd")
            fn, err = lib.fa_backward, lib.fa_bwd_error_string
            fn.argtypes = [P] * 9 + [strides] + [I] * 9 + [F, P]
        elif kernel == "wgmma":
            lib = build.load("flash_attention_sm90")
            fn, err = lib.fa90_forward, lib.fa90_error_string
            fn.argtypes = [P] * 5 + [strides] + [I] * 9 + [F, F, P]
        else:
            lib = build.load("flash_attention")
            fn, err = lib.fa_forward, lib.fa_error_string
            fn.argtypes = [P] * 4 + [strides] + [I] * 9 + [F, F, P]
        fn.restype = ctypes.c_int
        bind_error_string(err)
        _libs[kernel] = lib
    return lib


def _wgmma_takes(q: torch.Tensor) -> bool:
    return q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS


def route(q: torch.Tensor) -> str:
    """The kernel that takes ``q``'s attention: ``"wgmma"`` for bf16 at
    hd 64, 80, 128 and 256, ``"simt"`` for everything else."""
    return "wgmma" if _wgmma_takes(q) else "simt"


def bwd_route(q: torch.Tensor) -> str:
    """The kernel that takes the backward of ``q``'s attention:
    ``"wgmma"`` (csrc/flash_attention_bwd_sm90.cu) for bf16 at hd 64, 80,
    128 and 256, ``"simt"`` (csrc/flash_attention_bwd.cu) for everything
    else."""
    return "wgmma" if _wgmma_takes(q) else "simt"


def fwd_keys(hd: int) -> int:
    """Keys a kv tile of the wgmma forward at head dim ``hd`` (``Geo<HD>
    ::kBN`` in csrc/flash_attention_sm90.cu)."""
    return 64 if hd == 256 else WGMMA_TILE


def bwd_tiles(hd: int) -> tuple:
    """The wgmma backward's geometry at head dim ``hd`` (``Geo<HD>`` in
    csrc/flash_attention_bwd_sm90.cu): (resident query rows a dq CTA,
    rows a streamed tile, keys a dk / dv CTA)."""
    return (BWD_ROWS, 32, 64) if hd == 256 else (BWD_ROWS, BWD_TILE,
                                                 BWD_ROWS)


def _tma_addressable(t: torch.Tensor) -> bool:
    """Whether a tensor map can address ``t``: a 16-byte aligned base and
    batch / head / seq strides (of dims with more than one entry) that
    are positive multiples of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    return all(s > 0 and s % _TMA_ALIGN == 0
               for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _tma_strides(name: str, t: torch.Tensor) -> list:
    """``t``'s (batch, head, seq) strides in elements for its tensor map,
    a dim of one entry given the tensor's extent instead (TMA never steps
    it, but its encoder checks every stride); raises ``ValueError`` where
    no map can address ``t``."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned base for TMA "
                         f"({_TMA_WHAT})")
    if not _tma_addressable(t):
        raise ValueError(f"{name} needs batch / head / seq strides that are "
                         f"positive multiples of 16 bytes for TMA "
                         f"({_TMA_WHAT}), got strides {t.stride()}")
    shape, st = t.shape, t.stride()
    extent = 1 + sum((m - 1) * d for m, d in zip(shape, st))
    extent = -(-extent // _TMA_ALIGN) * _TMA_ALIGN
    return [s if n > 1 else extent for n, s in zip(shape[:3], st[:3])]


def validate_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """The wgmma forward's tensor-map strides: q's, k's and v's (batch,
    head, seq) strides in elements, a dim of one entry given the tensor's
    extent instead.  Raises ``ValueError`` where the maps cannot address
    an input: a base not 16-byte aligned, or a batch / head / seq stride
    (of a dim with more than one entry) that is not a positive multiple
    of 16 bytes."""
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides += _tma_strides(name, t)
    n_qtiles = -(-q.shape[2] // WGMMA_TILE)
    if n_qtiles > _MAX_GRID_Y:
        raise ValueError(f"sq = {q.shape[2]} needs {n_qtiles} query tiles "
                         f"> {_MAX_GRID_Y}")
    return strides


def tile_walk(sq: int, skv: int, causal: bool, window: Optional[int],
              hd: int = 128):
    """The wgmma forward's walk at head dim ``hd``, in launch order:
    ``(q_tile, t_lo, t_hi)`` per query tile of ``WGMMA_TILE`` rows,
    heaviest (bottom) first, with the kv tiles ``[t_lo, t_hi)`` of
    ``fwd_keys(hd)`` keys that its rows can see
    (csrc/flash_attention_sm90.cu computes the same range)."""
    return _walk(sq, skv, causal, window, WGMMA_TILE, fwd_keys(hd))


def _walk(sq, skv, causal, window, rows, keys):
    n_qtiles = -(-sq // rows)
    walk = []
    for y in range(n_qtiles):
        qt = n_qtiles - 1 - y
        q0 = qt * rows
        q_last = min(q0 + rows, sq) - 1
        kv_hi = min(skv, q_last + 1) if causal else skv
        kv_lo = max(0, q0 - window + 1) if window else 0
        t_lo = kv_lo // keys
        walk.append((qt, t_lo, max(-(-kv_hi // keys), t_lo)))
    return walk


def bwd_dq_walk(sq: int, skv: int, causal: bool, window: Optional[int],
                hd: int = 128):
    """The wgmma backward's dq pass at head dim ``hd``, in launch order:
    ``(q_tile, t_lo, t_hi)`` per query tile of ``bwd_tiles(hd)[0]`` rows,
    heaviest first, with the key tiles ``[t_lo, t_hi)`` of
    ``bwd_tiles(hd)[1]`` keys its rows can see
    (csrc/flash_attention_bwd_sm90.cu computes the same range)."""
    rows, tile, _ = bwd_tiles(hd)
    return _walk(sq, skv, causal, window, rows, tile)


def bwd_dkv_walk(sq: int, skv: int, group: int, causal: bool,
                 window: Optional[int], hd: int = 128):
    """The wgmma backward's dk / dv pass at head dim ``hd``, in launch
    order: ``(k_tile, steps)`` per key tile of ``bwd_tiles(hd)[2]`` keys,
    with ``steps`` the ``(g, q_tile)`` it walks — for each query head g of
    the GQA group in order, the query tiles of ``bwd_tiles(hd)[1]`` rows
    that see one of its keys (csrc/flash_attention_bwd_sm90.cu computes
    the same range)."""
    _, tile, keys = bwd_tiles(hd)
    walk = []
    for kt in range(-(-skv // keys)):
        k0 = kt * keys
        k_last = min(k0 + keys, skv) - 1
        q_lo = k0 if causal else 0
        q_hi = min(sq, k_last + window) if window else sq
        t_lo = q_lo // tile
        n_qt = max(-(-q_hi // tile) - t_lo, 0)
        walk.append((kt, [(g, t_lo + j) for g in range(group)
                          for j in range(n_qt)]))
    return walk


def lse_buffer(q: torch.Tensor) -> torch.Tensor:
    """A buffer for the wgmma forward's base-2 log-sum-exp of each row
    (what the wgmma backward takes): [b * h] rows of ``lse_ld(sq)`` f32."""
    b, h, sq = q.shape[:3]
    return torch.empty(b * h * lse_ld(sq), dtype=torch.float32,
                       device=q.device)


def lse_ld(sq: int) -> int:
    """The row stride of an lse buffer: sq rounded up to ``BWD_ROWS``, so
    that every tile the backward reads lies inside it."""
    return -(-sq // BWD_ROWS) * BWD_ROWS


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


def _on_card(**tensors) -> None:
    q = tensors["q"]
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.device != q.device:
            raise ValueError(f"q and {name} on different devices: "
                             f"{q.device}, {t.device}")


def _chosen(kernel: Optional[str], q: torch.Tensor, default: str) -> str:
    """``kernel`` (a route a caller names to time it) or ``default``."""
    if kernel is None:
        return default
    if kernel not in ("wgmma", "simt"):
        raise ValueError(f"kernel must be 'wgmma' or 'simt', got {kernel!r}")
    if kernel == "wgmma" and not _wgmma_takes(q):
        raise ValueError(f"the wgmma route takes {_TMA_WHAT}, got "
                         f"{q.dtype} at hd {q.shape[-1]}")
    return kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    lse: Optional[torch.Tensor] = None,
                    kernel: Optional[str] = None) -> torch.Tensor:
    """q [b, h, sq, hd], k / v [b, kvh, skv, hd] on one CUDA device ->
    [b, h, sq, hd] in q's dtype, in ONE launch.  ``lse`` (the wgmma route
    only): a ``lse_buffer(q)`` that the launch also fills with each row's
    base-2 log-sum-exp, for the backward.  ``kernel`` names the route to
    launch instead of ``route(q)`` (a benchmark times the SIMT kernel on
    inputs the wgmma route takes)."""
    _on_card(q=q, k=k, v=v)
    validate(q, k, v, window, softcap)
    which = _chosen(kernel, q, route(q))
    b, h, sq, hd = q.shape
    if which == "simt" and q.dtype == torch.bfloat16 and hd == 128:
        raise ValueError("the SIMT forward is not built for bf16 at hd 128 "
                         "(the wgmma route takes it)")
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, h, hd, dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    flags = (int(bool(causal)), int(window or 0), float(softcap or 0.0),
             1.0 / math.sqrt(hd))
    lib = _library(which)
    if which == "wgmma":
        strides = (ctypes.c_int64 * 12)(*validate_tma(q, k, v),
                                        *out.stride()[:3])
        if lse is not None:
            _check_stats("lse", lse, q)
        launch("flash_attention", lib.fa90_error_string, lib.fa90_forward,
               q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), None if lse is None else lse.data_ptr(),
               strides, b, h, kvh, sq, skv, hd, lse_ld(sq), *flags,
               route=which)
    else:
        if lse is not None:
            raise ValueError("only the wgmma route writes lse")
        if b * h > _MAX_GRID_Y:
            raise ValueError(f"b * h = {b * h} exceeds {_MAX_GRID_Y}")
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                          for s in t.stride()[:3]))
        launch("flash_attention", lib.fa_error_string, lib.fa_forward,
               q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), strides, int(q.dtype == torch.bfloat16), b,
               h, kvh, sq, skv, hd, *flags, route=which)
    return out


def _check_stats(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, h, sq = q.shape[:3]
    n = b * h * lse_ld(sq)
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.device != q.device or t.numel() != n
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned f32 "
                         f"tensor of {n} elements on {q.device} (lse_buffer)")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        lse: Optional[torch.Tensor] = None,
                        kernel: Optional[str] = None):
    """The gradients of ``flash_attention(q, k, v)`` (its output ``o``)
    against the output gradient ``do`` [b, h, sq, hd]: (dq [b, h, sq, hd],
    dk, dv [b, kvh, skv, hd]) in q's dtype, by the route ``bwd_route(q)``
    (or ``kernel``), each a dq pass and a dk / dv pass on the current
    stream.  dq is a view of a fresh [b, sq, h, hd] buffer and dk / dv of
    fresh [b, skv, kvh, hd] buffers: the layouts of the model's
    projections.  The wgmma route takes the forward's ``lse`` (what
    ``FlashAttention`` saves); without it, it first runs the wgmma
    forward once more for it (one more B13 launch)."""
    _on_card(q=q, k=k, v=v, o=o, do=do)
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
    which = _chosen(kernel, q, bwd_route(q))
    dev, dt = q.device, q.dtype
    dq = torch.empty(b, sq, h, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty(b, skv, kvh, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    dv = torch.empty(b, skv, kvh, hd, dtype=dt, device=dev).permute(0, 2, 1, 3)
    if which == "wgmma":
        tma = []
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            tma += _tma_strides(name, t)
        rows, _, keys = bwd_tiles(hd)
        for n, per in ((sq, rows), (skv, keys)):
            if -(-n // per) > _MAX_GRID_Y:
                raise ValueError(f"{n} rows need more than {_MAX_GRID_Y} "
                                 f"tiles of {per}")
        if lse is None:
            lse = lse_buffer(q)
            flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        _check_stats("lse", lse, q)
        delta = torch.empty_like(lse)
        strides = (ctypes.c_int64 * 24)(*tma, *(s for t in (dq, dk, dv)
                                                for s in t.stride()[:3]))
        lib = _library("bwd_wgmma")
        launch("flash_attention_bwd", lib.fa90_bwd_error_string,
               lib.fa90_backward, q.get_device(), q.data_ptr(),
               k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), strides, b, h, kvh, sq, skv, hd, lse_ld(sq),
               int(bool(causal)), int(window or 0), 1.0 / math.sqrt(hd),
               route=which)
        return dq, dk, dv
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds {_MAX_GRID_Y}")
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    lib = _library("bwd_simt")
    launch("flash_attention_bwd", lib.fa_bwd_error_string, lib.fa_backward,
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), stats.data_ptr(), strides,
           int(dt == torch.bfloat16), b, h, kvh, sq, skv, hd,
           int(bool(causal)), int(window or 0), 1.0 / math.sqrt(hd),
           route=which)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """B13 under autograd on the card: the forward is one launch of
    ``flash_attention`` (on the wgmma route it also writes each row's
    log-sum-exp, saved for the backward), the backward one call of
    ``flash_attention_bwd`` on the saved q, k, v, o (and lse).  No
    softcap (no config the port trains sets one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        lse = lse_buffer(q) if bwd_route(q) == "wgmma" else None
        o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (lse is not None
                                  and not _tma_addressable(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window, lse=lse)
        return dq, dk, dv, None, None
