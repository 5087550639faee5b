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

B6 runs once an island a round on the selection path, where at the
bench bus a call costs about its host path, so that path is lean: x's
metadata is read once, devices are compared as indices, the C entry is
resolved once, when the library loads, and ``lo`` goes to the kernel as
the selection's device tensor (read there) or, a number, by value.
"""
from __future__ import annotations

import ctypes
import operator
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import (STORAGE, bind_error_string,
                                          check_cuda, check_pack_aligned,
                                          launch, operand)

BLOCK = 8 * 1024            # elements of a tile
WORDS = BLOCK // 32         # packed u32 candidate words a tile

_I32 = torch.int32
_lib: Optional[ctypes.CDLL] = None
_error_string = None
_stats = None                # tk_stats, resolved when the library loads


def _library() -> ctypes.CDLL:
    global _lib, _error_string, _stats
    if _lib is None:
        lib = build.load("topk_mask")
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.tk_stats.argtypes = [P, P, ctypes.c_uint32, P, P, I64, P]
        lib.tk_stats.restype = ctypes.c_int
        lib.tk_exact.argtypes = [P, P, P, P, P, P, I64, P]
        lib.tk_exact.restype = ctypes.c_int
        for sfx in ("f32", "bf16"):
            fn = getattr(lib, f"tk_threshold_{sfx}")
            fn.argtypes = [P, P, ctypes.c_float, P, P, I64, P]
            fn.restype = ctypes.c_int
        bind_error_string(lib.tk_error_string)
        _error_string = lib.tk_error_string
        _stats = lib.tk_stats
        _lib = lib
    return _lib


def _check_bus(x: torch.Tensor) -> int:
    check_cuda("x", x, (torch.float32,))
    n = x.numel()
    if x.dim() != 1 or not 1 <= n < 1 << 31:
        raise ValueError(f"x must be 1-D with 1 <= n < 2^31 elements, got "
                         f"shape {tuple(x.shape)}")
    if x.data_ptr() % 4:
        raise ValueError("x must be 4-byte aligned")
    return n


def _scalar(name: str, t, dtype, device) -> torch.Tensor:
    """A one-element ``dtype`` tensor on ``device``: a number is copied
    there, a tensor must already live there."""
    if not isinstance(t, torch.Tensor):
        return torch.tensor([t], dtype=dtype, device=device)
    check_cuda(name, t, (dtype,))
    if t.device != device or t.numel() != 1:
        raise ValueError(f"{name} must be one element on {device}, got "
                         f"{t.numel()} on {t.device}")
    return t


def _stats_checks(x, lo) -> Tuple[int, int, int, Optional[int], int]:
    """``(n, x ptr, device, lo ptr, lo value)`` of a stats call: x f32 [n]
    with 1 <= n < 2^31; ``lo`` one int32 on x's device (its pointer; the
    kernel reads it) or an int32 number (its u32 bits by value, no
    pointer)."""
    n, xp, dev = operand("x", x, torch.float32)
    if n >= 1 << 31 or xp % 4:
        raise ValueError(f"x must be 4-byte aligned with fewer than 2^31 "
                         f"elements, got {n}")
    if isinstance(lo, torch.Tensor):
        if lo.get_device() != dev or lo.dtype != _I32 or lo.numel() != 1:
            raise ValueError(f"lo must be one int32 on cuda:{dev}, got "
                             f"{lo.numel()} {lo.dtype} on {lo.device}")
        return n, xp, dev, lo.data_ptr(), 0
    lo = operator.index(lo)
    if not -(1 << 31) <= lo < 1 << 31:
        raise ValueError(f"lo must be an int32, got {lo}")
    return n, xp, dev, None, lo & 0xFFFFFFFF


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


def threshold_sparsify_exact(x: torch.Tensor, tau, tie_start: torch.Tensor,
                             tie_budget) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 [n], tau (float or f32 [1]), tie_start int32 [nb], tie_budget
    (int or int32 [1]) -> (kept, residual) f32 [n] in ONE launch,
    bit-identical to ``ref.threshold_sparsify_exact``."""
    n = _check_bus(x)
    tau = _scalar("tau", tau, torch.float32, x.device)
    budget = _scalar("tie_budget", tie_budget, _I32, x.device)
    check_cuda("tie_start", tie_start, (_I32,))
    nb = -(-n // BLOCK)
    if tie_start.device != x.device or tie_start.numel() != nb:
        raise ValueError(f"tie_start must be [{nb}] on {x.device}, got "
                         f"{tuple(tie_start.shape)} on {tie_start.device}")
    kept = torch.empty_like(x)
    residual = torch.empty_like(x)
    lib = _library()
    launch("threshold_sparsify_exact", lib.tk_error_string, lib.tk_exact,
           x.get_device(), x.data_ptr(), tau.data_ptr(), budget.data_ptr(),
           tie_start.data_ptr(), kept.data_ptr(), residual.data_ptr(), n)
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
    if isinstance(tau, torch.Tensor):       # read by the kernel itself
        tau_p, tau_v = _scalar("tau", tau, torch.float32,
                               x.device).data_ptr(), 0.0
    else:                                   # passed by value: no copy
        tau_p, tau_v = None, float(np.float32(tau))
    kept = torch.empty_like(x)
    residual = torch.empty_like(x)
    lib = _library()
    launch("threshold_sparsify", lib.tk_error_string,
           getattr(lib, f"tk_threshold_{STORAGE[x.dtype]}"),
           x.get_device(), x.data_ptr(), tau_p, tau_v, kept.data_ptr(),
           residual.data_ptr(), n)
    return kept, residual
