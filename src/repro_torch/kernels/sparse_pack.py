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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, check_cuda, launch

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("sparse_pack")
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.sp_pack_body.argtypes = [P, P, P, P, I64, I64, P]
        lib.sp_pack_body.restype = ctypes.c_int
        lib.sp_quantize_pack.argtypes = [P, P, P, P, P, I64, ctypes.c_int, P]
        lib.sp_quantize_pack.restype = ctypes.c_int
        bind_error_string(lib.sp_error_string)
        _lib = lib
    return _lib


def pack_body(q: torch.Tensor, scales: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """(q int8 [k], scales f32 [ng], idx int32 [k]) -> body uint8
    [5k + 4ng], byte-identical to ``ref.pack_body``."""
    check_cuda("q", q, (torch.int8,))
    check_cuda("scales", scales, (torch.float32,))
    check_cuda("idx", idx, (torch.int32,))
    for name, t in (("scales", scales), ("idx", idx)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, expected {q.device}")
    k, ng = q.numel(), scales.numel()
    if (q.dim() != 1 or scales.dim() != 1 or idx.dim() != 1
            or idx.numel() != k or k < 1 or ng < 1):
        raise ValueError(f"need q [k], scales [ng], idx [k] with k, ng >= 1, "
                         f"got {tuple(q.shape)}, {tuple(scales.shape)}, "
                         f"{tuple(idx.shape)}")
    body = torch.empty(5 * k + 4 * ng, dtype=torch.uint8, device=q.device)
    lib = _library()
    launch("pack_body", lib.sp_error_string, lib.sp_pack_body,
           q.get_device(), q.data_ptr(), scales.data_ptr(), idx.data_ptr(),
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
