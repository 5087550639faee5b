"""Wrappers of the three CUDA kernels of csrc/topk_mask.cu, ports of
``repro/kernels/topk_mask.py``: the blocked exact top-k's two passes and
the plain threshold pass.

* ``blocked_topk_stats`` (B6, replaces ``_stats_kernel``): ONE pass packs
  the ``bits(|x|) >= lo`` candidate mask into u32 words, 256 a tile of
  8,192 elements, and counts each tile's candidates;
* ``threshold_sparsify_exact`` (B7, replaces ``_exact_kernel``): ONE pass
  emits kept and residual, exact-k under ties (lowest index wins,
  ``lax.top_k``'s rule);
* ``threshold_sparsify`` (B8, replaces ``_mask_kernel``): ONE pass keeps
  every ``|x| >= tau`` (not exact-k under ties), f32 or bf16 storage,
  ``tau`` compared in f32 as the Pallas kernel compares it.

The selection around them (the sampled bracket, the refinement between
the two passes, the sort on a missed bracket) is in
``core/compression.py``.

The wrappers take contiguous CUDA tensors only (1-D f32 for B6 and B7;
any shape, f32 or bf16, for B8; ``ops`` routes CPU tensors to the plain
versions in ``ref``), allocate their outputs and
launch ONE kernel each on the current stream without synchronising.  A
non-zero ``cudaGetLastError`` raises.

B6 and B7 run once an island a round on the selection path, where at
the bench bus a call costs about its host path, so that path is lean:
each piece of metadata is read once, devices are compared as indices,
the C entries are resolved once, when the library loads, and each scalar
(B6's ``lo``, B7's ``tau`` and budget, B8's ``tau``) goes to the kernel
as the caller's one-element device tensor (read there) or, a number, by
value: no copy to the card.
"""
from __future__ import annotations

import ctypes
import operator
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import (STORAGE, bind_error_string,
                                          check_cuda, check_pack_aligned,
                                          launch, operand)

BLOCK = 8 * 1024            # elements of a tile
WORDS = BLOCK // 32         # packed u32 candidate words a tile

_I32 = torch.int32
_F32 = torch.float32
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# each C entry's argtypes: a number passed as c_float is rounded once to
# nearest f32 by ctypes (B7's and B8's tau), as c_int32 / c_uint32 taken
# as it is (the wrappers check its range)
SIGNATURES = {
    "tk_stats": [_P, _P, ctypes.c_uint32, _P, _P, _I64, _P],
    "tk_exact": [_P, _P, ctypes.c_float, _P, ctypes.c_int32, _P, _P, _P,
                 _I64, _P],
    "tk_threshold_f32": [_P, _P, ctypes.c_float, _P, _P, _I64, _P],
    "tk_threshold_bf16": [_P, _P, ctypes.c_float, _P, _P, _I64, _P],
}
_lib: Optional[ctypes.CDLL] = None
_error_string = None
_stats = None                # tk_stats, resolved when the library loads
_exact = None                # tk_exact, likewise


def _library() -> ctypes.CDLL:
    global _lib, _error_string, _stats, _exact
    if _lib is None:
        lib = build.load("topk_mask")
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        bind_error_string(lib.tk_error_string)
        _error_string = lib.tk_error_string
        _stats, _exact = lib.tk_stats, lib.tk_exact
        _lib = lib
    return _lib


def _bus_checks(x) -> Tuple[int, int, int]:
    """``(n, x ptr, device)`` of a B6 or B7 bus: x f32 [n] with 1 <= n <
    2^31, 4-byte aligned."""
    n, xp, dev = operand("x", x, _F32)
    if n >= 1 << 31 or xp % 4:
        raise ValueError(f"x must be 4-byte aligned with fewer than 2^31 "
                         f"elements, got {n}")
    return n, xp, dev


def _ptr_or_value(name: str, t, dtype: torch.dtype, dev: int
                  ) -> Tuple[Optional[int], object]:
    """``(pointer, value)`` of a scalar operand: one ``dtype`` element on
    CUDA device ``dev`` (its pointer; the kernel reads it, value 0) or a
    number (no pointer; passed by value: an f32 as the Python float that
    ctypes rounds once to nearest, an int32 as the int, range-checked)."""
    if isinstance(t, torch.Tensor):
        if t.get_device() != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype} on cuda:{dev}, got "
                             f"{t.numel()} {t.dtype} on {t.device}")
        return t.data_ptr(), 0
    if dtype == _F32:
        return None, float(t)
    t = operator.index(t)
    if not -(1 << 31) <= t < 1 << 31:
        raise ValueError(f"{name} must be an int32, got {t}")
    return None, t


def _stats_checks(x, lo) -> Tuple[int, int, int, Optional[int], int]:
    """``(n, x ptr, device, lo ptr, lo value)`` of a stats call: a bus as
    ``_bus_checks`` takes it; ``lo`` one int32 on x's device (its
    pointer; the kernel reads it) or an int32 number (its u32 bits by
    value, no pointer)."""
    n, xp, dev = _bus_checks(x)
    lo_p, lo_v = _ptr_or_value("lo", lo, _I32, dev)
    return n, xp, dev, lo_p, lo_v & 0xFFFFFFFF


def blocked_topk_stats(x: torch.Tensor, lo) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """x f32 [n], ``lo`` magnitude bits (int or int32 [1] on x's device)
    -> (words int32 [nb, 256] holding u32 bit patterns, counts int32
    [nb]) in ONE launch, bit-identical to ``ref.blocked_topk_stats``."""
    n, xp, dev, lo_p, lo_v = _stats_checks(x, lo)
    nb = -(-n // BLOCK)
    words = torch.empty((nb, WORDS), dtype=_I32, device=dev)
    counts = torch.empty(nb, dtype=_I32, device=dev)
    if _lib is None:
        _library()
    launch("blocked_topk_stats", _error_string, _stats, dev, xp, lo_p, lo_v,
           words.data_ptr(), counts.data_ptr(), n)
    return words, counts


def _exact_checks(x, tau, tie_start, tie_budget):
    """``(n, x ptr, device, tau ptr, tau value, budget ptr, budget value,
    tie_start ptr)`` of an exact-k emit: a bus as ``_bus_checks`` takes
    it; ``tau`` one f32 on x's device (its pointer) or a number (by value);
    ``tie_budget`` one int32 there or an int32 number; ``tie_start`` int32
    [nb] on x's device."""
    n, xp, dev = _bus_checks(x)
    tau_p, tau_v = _ptr_or_value("tau", tau, _F32, dev)
    bud_p, bud_v = _ptr_or_value("tie_budget", tie_budget, _I32, dev)
    nb = -(-n // BLOCK)
    ts_n, ts_p, ts_dev = operand("tie_start", tie_start, _I32)
    if ts_n != nb or ts_dev != dev:
        raise ValueError(f"tie_start must be [{nb}] on cuda:{dev}, got "
                         f"[{ts_n}] on cuda:{ts_dev}")
    return n, xp, dev, tau_p, tau_v, bud_p, bud_v, ts_p


def threshold_sparsify_exact(x: torch.Tensor, tau, tie_start: torch.Tensor,
                             tie_budget) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 [n], tau (a number or f32 [1] on x's device), tie_start int32
    [nb], tie_budget (an int32 number or int32 [1]) -> (kept, residual)
    f32 [n] in ONE launch, bit-identical to
    ``ref.threshold_sparsify_exact``."""
    n, xp, dev, tau_p, tau_v, bud_p, bud_v, ts_p = _exact_checks(
        x, tau, tie_start, tie_budget)
    kept = torch.empty(n, dtype=_F32, device=dev)
    residual = torch.empty(n, dtype=_F32, device=dev)
    if _lib is None:
        _library()
    launch("threshold_sparsify_exact", _error_string, _exact, dev, xp, tau_p,
           tau_v, bud_p, bud_v, ts_p, kept.data_ptr(), residual.data_ptr(), n)
    return kept, residual


def threshold_sparsify(x: torch.Tensor, tau) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """x f32 or bf16 (any shape), tau (float or f32 [1] on x's device) ->
    (kept, residual) shaped like x in x's dtype, in ONE launch:
    ``kept = |x| >= tau ? x : 0`` and ``residual = x - kept`` in f32,
    bit-identical to ``ref.threshold_sparsify``."""
    check_cuda("x", x, tuple(STORAGE))
    n = x.numel()
    if n < 1:
        raise ValueError(f"x must be non-empty, got shape {tuple(x.shape)}")
    check_pack_aligned("x", x)
    tau_p, tau_v = _ptr_or_value("tau", tau, _F32, x.get_device())
    kept = torch.empty_like(x)
    residual = torch.empty_like(x)
    lib = _library()
    launch("threshold_sparsify", lib.tk_error_string,
           getattr(lib, f"tk_threshold_{STORAGE[x.dtype]}"),
           x.get_device(), x.data_ptr(), tau_p, tau_v, kept.data_ptr(),
           residual.data_ptr(), n)
    return kept, residual
