"""Wrapper of the selective-scan CUDA kernel (csrc/mamba_scan.cu).

Port of ``repro/kernels/mamba_scan.py::mamba_scan`` (replaces
``_mamba_kernel``): per (batch, channel d), from a zero state,

    h[s]   <- exp(dt_t[d] * A[d, s]) * h[s] + (dt_t[d] * u_t[d]) * B_t[s]
    y_t[d]  = sum_s C_t[s] * h[s] + D[d] * u_t[d]

in f32, ``y`` rounded once to u's dtype.  The kernel also returns the
final state ``h_T`` [b, di, ds] in f32, which the model's prefill hands
to decode (the Pallas kernel drops it).

It takes CUDA tensors only (``ops`` routes CPU tensors to
``ref.mamba_scan``): u [b, T, di] f32 or bf16 and dt [b, T, di] f32, each
with a unit stride on di; B / C [b, T, ds] f32 with a unit stride on ds
(any other strides, so the model's column slices of its x_proj output
are read in place), ds in ``STATE_DIMS``, any T >= 1; A [di, ds] and
D [di] contiguous f32.  ``y`` is a fresh contiguous [b, T, di].  ONE
launch on the current stream, no synchronise.  A non-zero
``cudaGetLastError`` raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import bind_error_string, launch

STATE_DIMS = (4, 16)             # jamba's reduced and published d_state
# channels a block at each state dim (csrc: kThreads / (ds / kStates))
_CHANNELS = {4: 128, 16: 64}
_MAX_BLOCKS = 2 ** 31 - 1
_F32 = torch.float32

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("mamba_scan")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_forward.argtypes = [P, P, P, P, P, P, P, P,
                                           ctypes.POINTER(ctypes.c_int64),
                                           I, I, I, I, I, P]
        lib.mamba_scan_forward.restype = ctypes.c_int
        bind_error_string(lib.mamba_scan_error_string)
        _lib = lib
    return _lib


def validate(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, D: torch.Tensor) -> None:
    """Raise ``ValueError`` for anything the kernel does not take (device
    aside): shapes, dtypes, state dims and strides."""
    for name, t in (("u", u), ("dt", dt), ("B", B), ("C", C)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-D tensor, got "
                             f"{getattr(t, 'shape', type(t))}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim, "
                             f"got strides {t.stride()}")
    if u.dtype not in (_F32, torch.bfloat16):
        raise ValueError(f"u dtype {u.dtype} not in [float32, bfloat16]")
    for name, t in (("dt", dt), ("B", B), ("C", C)):
        if t.dtype != _F32:
            raise ValueError(f"{name} dtype {t.dtype} must be float32")
    b, T, di = u.shape
    ds = B.shape[-1]
    if tuple(dt.shape) != (b, T, di):
        raise ValueError(f"u and dt need one shape [b, T, di]; got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}")
    if tuple(B.shape) != (b, T, ds) or tuple(C.shape) != (b, T, ds):
        raise ValueError(f"B and C must be [b, T, ds] = {(b, T, ds)}, got "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if ds not in STATE_DIMS:
        raise ValueError(f"state dim {ds} not in {STATE_DIMS}")
    if min(b, T, di) < 1:
        raise ValueError(f"need non-empty shapes, got b={b}, T={T}, di={di}")
    if b * -(-di // _CHANNELS[ds]) > _MAX_BLOCKS:
        raise ValueError(f"b * di = {b * di} needs more than {_MAX_BLOCKS} "
                         f"blocks")
    for name, t, shape in (("A", A, (di, ds)), ("D", D, (di,))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{getattr(t, 'shape', type(t))}")
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, strides {t.stride()}")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, D: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u / dt [b, T, di], B / C [b, T, ds], A [di, ds], D [di] on one CUDA
    device -> (y [b, T, di] in u's dtype, h_T [b, di, ds] f32), in ONE
    launch."""
    args = (("u", u), ("dt", dt), ("B", B), ("C", C), ("A", A), ("D", D))
    for name, t in args:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
    if any(t.device != u.device for _, t in args):
        raise ValueError("u, dt, B, C, A, D on different devices: "
                         + ", ".join(str(t.device) for _, t in args))
    validate(u, dt, B, C, A, D)
    b, T, di = u.shape
    ds = B.shape[-1]
    y = torch.empty(b, T, di, dtype=u.dtype, device=u.device)
    h = torch.empty(b, di, ds, dtype=_F32, device=u.device)
    strides = (ctypes.c_int64 * 8)(*(s for t in (u, dt, B, C)
                                     for s in t.stride()[:2]))
    lib = _library()
    launch("mamba_scan", lib.mamba_scan_error_string, lib.mamba_scan_forward,
           u.get_device(), u.data_ptr(), dt.data_ptr(), B.data_ptr(),
           C.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(),
           h.data_ptr(), strides, int(u.dtype == torch.bfloat16), b, T, di,
           ds)
    return y, h
