"""Wrapper of the sparse-body packing CUDA kernel (csrc/sparse_pack.cu).

Port of ``repro/kernels/sparse_pack.py::pack_body`` (replaces
``_pack_only_kernel``): an existing payload — q int8 [k], scales f32
[ng], indices int32 [k] — becomes the wire-frame body
``q || scales || indices`` as one uint8 buffer on the payload's device,
byte copies only, so ``transfer/wire.py`` moves it to the host in one
copy.  Contiguous 1-D CUDA tensors only (``ops`` routes CPU tensors to
``ref.pack_body``); ONE launch on the current stream, no synchronise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
    launch("pack_body", lib.sp_error_string, lib.sp_pack_body, q.device,
           q.data_ptr(), scales.data_ptr(), idx.data_ptr(), body.data_ptr(),
           k, ng)
    return body
