"""Wrappers of the sparse-body CUDA kernels (csrc/sparse_pack.cu), ports
of ``repro/kernels/sparse_pack.py``:

* ``pack_body`` (B12, replaces ``_pack_only_kernel``): an existing
  payload — q int8 [k], scales f32 [ng], indices int32 [k] — becomes the
  wire-frame body ``q || scales || indices`` as one uint8 buffer on the
  payload's device, byte copies only, so ``transfer/wire.py`` moves it to
  the host in one copy;
* ``quantize_pack`` (B11, replaces ``_pack_kernel``): the selected values
  are quantized per group of ``block`` (B9's arithmetic) and packed into
  the same body in the same launch, which also returns q (zero-padded to
  ``ng * block``) and the scales.

Contiguous 1-D CUDA tensors only (``ops`` routes CPU tensors to the plain
versions in ``ref``); ONE launch on the current stream, no synchronise.

``pack_body`` runs on every sparse frame (``transfer/wire.py``), where at
the MLP's k = 656 a call costs its host path, and ``quantize_pack`` on
the bench bus (k = 105,075), where it does too, so both paths are lean:
each operand's metadata is read once, devices are compared as indices,
and the C entries are resolved once, when the library loads.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, launch, operand

_lib: Optional[ctypes.CDLL] = None
_error_string = None
_pack_body = None            # sp_pack_body, resolved when the library loads
_quantize_pack = None        # sp_quantize_pack, likewise


def _library() -> ctypes.CDLL:
    global _lib, _error_string, _pack_body, _quantize_pack
    if _lib is None:
        lib = build.load("sparse_pack")
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.sp_pack_body.argtypes = [P, P, P, P, I64, I64, P]
        lib.sp_pack_body.restype = ctypes.c_int
        lib.sp_quantize_pack.argtypes = [P, P, P, P, P, I64, ctypes.c_int, P]
        lib.sp_quantize_pack.restype = ctypes.c_int
        bind_error_string(lib.sp_error_string)
        _error_string = lib.sp_error_string
        _pack_body = lib.sp_pack_body
        _quantize_pack = lib.sp_quantize_pack
        _lib = lib
    return _lib


def _pack_checks(q, scales, idx) -> Tuple[int, int, int, int, int, int]:
    """``(k, ng, q ptr, scales ptr, idx ptr, device)`` of a pack_body call:
    q int8 [k], scales f32 [ng], idx int32 [k] on one device.  q may start
    at any byte; scales and idx are element-aligned as PyTorch keeps
    them."""
    k, qp, dev = operand("q", q, torch.int8)
    ng, sp, sdev = operand("scales", scales, torch.float32)
    ki, ip, idev = operand("idx", idx, torch.int32)
    if sdev != dev or idev != dev:
        raise ValueError(f"q, scales and idx on cuda:{dev}, cuda:{sdev}, "
                         f"cuda:{idev}: need one device")
    if ki != k:
        raise ValueError(f"idx has {ki} entries, q has {k}")
    return k, ng, qp, sp, ip, dev


def pack_body(q: torch.Tensor, scales: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """(q int8 [k], scales f32 [ng], idx int32 [k]) -> body uint8
    [5k + 4ng], byte-identical to ``ref.pack_body``: ONE launch of the
    word-wide pack (csrc/sparse_pack.cu) into a fresh, 16-byte aligned
    body."""
    k, ng, qp, sp, ip, dev = _pack_checks(q, scales, idx)
    body = torch.empty(5 * k + 4 * ng, dtype=torch.uint8, device=dev)
    if _lib is None:
        _library()
    launch("pack_body", _error_string, _pack_body, dev, qp, sp, ip,
           body.data_ptr(), k, ng)
    return body


def _quantize_pack_checks(sel, idx, block: int) -> Tuple[int, int, int, int]:
    """``(k, sel ptr, idx ptr, device)`` of a quantize_pack call: sel f32
    [k] and idx int32 [k] on one device, block >= 1."""
    k, sp, dev = operand("sel", sel, torch.float32)
    ki, ip, idev = operand("idx", idx, torch.int32)
    if idev != dev:
        raise ValueError(f"sel and idx on cuda:{dev}, cuda:{idev}: need one "
                         f"device")
    if ki != k or block < 1:
        raise ValueError(f"need sel [k], idx [k] and block >= 1, got "
                         f"{tuple(sel.shape)}, {tuple(idx.shape)}, block "
                         f"{block}")
    return k, sp, ip, dev


def quantize_pack(sel: torch.Tensor, idx: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sel f32 [k], idx int32 [k]) -> (body uint8 [5k + 4ng], q int8
    [ng * block] zero-padded, scales f32 [ng]) in ONE launch (a warp a
    group, csrc/sparse_pack.cu), byte-identical to ``ref.quantize_pack``.
    sel and idx may start at any element."""
    k, sp, ip, dev = _quantize_pack_checks(sel, idx, block)
    ng = -(-k // block)
    body = torch.empty(5 * k + 4 * ng, dtype=torch.uint8, device=dev)
    q = torch.empty(ng * block, dtype=torch.int8, device=dev)
    scales = torch.empty(ng, dtype=torch.float32, device=dev)
    if _lib is None:
        _library()
    launch("quantize_pack", _error_string, _quantize_pack, dev, sp, ip,
           body.data_ptr(), q.data_ptr(), scales.data_ptr(), k, block)
    return body, q, scales
