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
the MLP's k = 656 a call costs its host path, so that path is lean: each
operand's metadata is read once, devices are compared as indices, and
the C entry is resolved once, when the library loads.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, check_cuda, launch

_lib: Optional[ctypes.CDLL] = None
_error_string = None
_pack_body = None            # sp_pack_body, resolved when the library loads


def _library() -> ctypes.CDLL:
    global _lib, _error_string, _pack_body
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
        _lib = lib
    return _lib


def _operand(name: str, t, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(numel, data_ptr, device index)`` of ``t``: a contiguous
    non-empty 1-D CUDA tensor of ``dtype``, each piece of metadata read
    once (``get_device()`` is -1 off the card)."""
    dev = t.get_device() if isinstance(t, torch.Tensor) else -1
    if dev < 0:
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    shape = t.shape
    if len(shape) != 1 or shape[0] < 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty 1-D tensor, "
                         f"got shape {tuple(shape)}")
    return shape[0], t.data_ptr(), dev


def _pack_checks(q, scales, idx) -> Tuple[int, int, int, int, int, int]:
    """``(k, ng, q ptr, scales ptr, idx ptr, device)`` of a pack_body call:
    q int8 [k], scales f32 [ng], idx int32 [k] on one device.  q may start
    at any byte; scales and idx are element-aligned as PyTorch keeps
    them."""
    k, qp, dev = _operand("q", q, torch.int8)
    ng, sp, sdev = _operand("scales", scales, torch.float32)
    ki, ip, idev = _operand("idx", idx, torch.int32)
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


def quantize_pack(sel: torch.Tensor, idx: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sel f32 [k], idx int32 [k]) -> (body uint8 [5k + 4ng], q int8
    [ng * block] zero-padded, scales f32 [ng]) in ONE launch,
    byte-identical to ``ref.quantize_pack``."""
    check_cuda("sel", sel, (torch.float32,))
    check_cuda("idx", idx, (torch.int32,))
    if idx.device != sel.device:
        raise ValueError(f"idx on {idx.device}, expected {sel.device}")
    k = sel.numel()
    if sel.dim() != 1 or idx.dim() != 1 or idx.numel() != k or k < 1 \
            or block < 1:
        raise ValueError(f"need sel [k], idx [k] with k >= 1 and block >= 1, "
                         f"got {tuple(sel.shape)}, {tuple(idx.shape)}, "
                         f"block {block}")
    ng = -(-k // block)
    dev = sel.device
    body = torch.empty(5 * k + 4 * ng, dtype=torch.uint8, device=dev)
    q = torch.empty(ng * block, dtype=torch.int8, device=dev)
    scales = torch.empty(ng, dtype=torch.float32, device=dev)
    lib = _library()
    launch("quantize_pack", lib.sp_error_string, lib.sp_quantize_pack,
           sel.get_device(), sel.data_ptr(), idx.data_ptr(),
           body.data_ptr(), q.data_ptr(), scales.data_ptr(), k, block)
    return body, q, scales
