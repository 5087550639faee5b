"""Wrappers of the int8 codec CUDA kernels (csrc/quantize.cu).

Port of ``repro/kernels/quantize.py``:

* ``quantize_int8``   — per-block symmetric int8 (replaces ``_quant_kernel``)
* ``dequantize_int8`` — ``q * scale`` (replaces ``_dequant_kernel``)

Each takes contiguous 1-D CUDA tensors only (``ops`` routes CPU tensors
to the plain versions in ``ref``), allocates its outputs and launches ONE
kernel on the current stream without synchronising.  A non-zero
``cudaGetLastError`` raises.

``dequantize_int8`` runs on every compressed submit (the error
feedback) and every sparse assimilation, where at the MLP's k = 656 a
call costs its host path, so that path is lean: each operand's metadata
is read once, devices are compared as indices, and the C entry is
resolved once, when the library loads.  q may start at any byte (a view
of a larger buffer); the kernel takes the values before its first
4-byte boundary apart.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import (bind_error_string, check_cuda,
                                          launch, operand)

QBLOCK = 256                     # values per scale (the wire ships it)

_lib: Optional[ctypes.CDLL] = None
_error_string = None
_dequantize = None           # qz_dequantize, resolved when the library loads


def _library() -> ctypes.CDLL:
    global _lib, _error_string, _dequantize
    if _lib is None:
        lib = build.load("quantize")
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("qz_quantize", "qz_dequantize"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, P, I64, I, P]
            fn.restype = ctypes.c_int
        bind_error_string(lib.qz_error_string)
        _error_string = lib.qz_error_string
        _dequantize = lib.qz_dequantize
        _lib = lib
    return _lib


def _groups(k: int, block: int) -> int:
    if k < 1 or block < 1:
        raise ValueError(f"need k >= 1 values and block >= 1, got k={k}, "
                         f"block={block}")
    return -(-k // block)


def quantize_int8(x: torch.Tensor, block: int = QBLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 [k] -> (q int8 [k], scales f32 [ceil(k/block)]) in ONE
    launch, bit-identical to ``ref.quantize_int8``."""
    check_cuda("x", x, (torch.float32,))
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    k = x.numel()
    ng = _groups(k, block)
    q = torch.empty(k, dtype=torch.int8, device=x.device)
    scales = torch.empty(ng, dtype=torch.float32, device=x.device)
    lib = _library()
    launch("quantize_int8", lib.qz_error_string, lib.qz_quantize,
           x.get_device(), x.data_ptr(), q.data_ptr(), scales.data_ptr(), k,
           block)
    return q, scales


def _dequantize_checks(q, scales, n: int, block: int
                       ) -> Tuple[int, int, int]:
    """``(q ptr, scales ptr, device)`` of a dequantize call: q int8 [n],
    scales f32 [ceil(n / block)] on one device, n >= 1, block >= 1."""
    k, qp, dev = operand("q", q, torch.int8)
    ng, sp, sdev = operand("scales", scales, torch.float32)
    if sdev != dev:
        raise ValueError(f"scales on cuda:{sdev}, q on cuda:{dev}: need "
                         f"one device")
    if block < 1 or k != n or ng != -(-n // block):
        raise ValueError(f"need q [{n}] and scales [ceil({n}/{block})], got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    return qp, sp, dev


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int,
                    block: int = QBLOCK) -> torch.Tensor:
    """q int8 [n], scales f32 [ceil(n/block)] -> f32 [n] in ONE launch,
    bit-identical to ``ref.dequantize_int8``."""
    qp, sp, dev = _dequantize_checks(q, scales, n, block)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if _lib is None:
        _library()
    launch("dequantize_int8", _error_string, _dequantize, dev, qp, sp,
           out.data_ptr(), n, block)
    return out
