"""Wrapper of the selective-scan CUDA kernel (csrc/mamba_scan.cu).

Port of ``repro/kernels/mamba_scan.py::mamba_scan`` (replaces
``_mamba_kernel``): per (batch, channel d), from a zero state,

    h[s]   <- exp(dt_t[d] * A[d, s]) * h[s] + (dt_t[d] * u_t[d]) * B_t[s]
    y_t[d]  = sum_s C_t[s] * h[s] + D[d] * u_t[d]

in f32, ``y`` rounded once to u's dtype.  The kernel also returns the
final state ``h_T`` [b, di, ds] in f32, which the model's prefill hands
to decode (the Pallas kernel drops it).

Under autograd ``MambaScan`` adds the backward: its forward is the same
launch that also writes the state at the start of each chunk of
``CHUNK`` steps (``chunk_states``), its backward one launch of the
hand-written backward kernel (csrc/mamba_scan_bwd.cu,
``mamba_scan_bwd``), which steps the states forward from those
checkpoints and walks each chunk in reverse.

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
# channels a block of the forward at each state dim (csrc/mamba_scan.cu:
# kThreads / (ds / kStates))
_CHANNELS = {4: 128, 16: 64}
# the backward's (csrc/mamba_scan_bwd.cu): channels a CTA, CTAs a cluster
_BWD_CHANNELS = {4: 128, 16: 32}
_BWD_CLUSTER = 8
CHUNK = 16                       # steps between the forward's checkpoints
_MAX_BLOCKS = 2 ** 31 - 1
_F32 = torch.float32

_libs: dict = {}


def _library(name: str = "mamba_scan") -> ctypes.CDLL:
    """The loaded library of the forward ("mamba_scan") or the backward
    ("mamba_scan_bwd"), its entry's argtypes bound."""
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        P, I = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_int64)
        if name == "mamba_scan":
            fn, err = lib.mamba_scan_forward_ck, lib.mamba_scan_error_string
            fn.argtypes = [P] * 9 + [strides] + [I] * 5 + [P]
        else:
            fn, err = (lib.mamba_scan_backward,
                       lib.mamba_scan_bwd_error_string)
            fn.argtypes = [P] * 13 + [strides] + [I] * 5 + [P]
        fn.restype = ctypes.c_int
        bind_error_string(err)
        _libs[name] = lib
    return lib


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


def _on_card(args) -> None:
    u = args[0][1]
    for name, t in args:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
    if any(t.device != u.device for _, t in args):
        raise ValueError(", ".join(n for n, _ in args) + " on different "
                         "devices: " + ", ".join(str(t.device)
                                                 for _, t in args))


def chunk_states(u: torch.Tensor, ds: int) -> torch.Tensor:
    """A buffer for the forward's state at the start of each chunk of
    ``CHUNK`` steps (what the backward takes): [b, ceil(T / CHUNK), di,
    ds] f32 on u's device."""
    b, T, di = u.shape
    return torch.empty(b, -(-T // CHUNK), di, ds, dtype=_F32,
                       device=u.device)


def _check_states(h_ck: torch.Tensor, u: torch.Tensor, ds: int) -> None:
    b, T, di = u.shape
    shape = (b, -(-T // CHUNK), di, ds)
    if (not isinstance(h_ck, torch.Tensor) or h_ck.dtype != _F32
            or tuple(h_ck.shape) != shape or not h_ck.is_contiguous()
            or h_ck.device != u.device or h_ck.data_ptr() % 16):
        raise ValueError(f"h_ck must be a contiguous, 16-byte aligned f32 "
                         f"tensor {shape} on {u.device} (chunk_states)")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
               h_ck: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u / dt [b, T, di], B / C [b, T, ds], A [di, ds], D [di] on one CUDA
    device -> (y [b, T, di] in u's dtype, h_T [b, di, ds] f32), in ONE
    launch.  ``h_ck`` (a ``chunk_states(u, ds)`` buffer): the launch also
    fills it with the state at the start of each chunk, for the
    backward."""
    _on_card((("u", u), ("dt", dt), ("B", B), ("C", C), ("A", A),
              ("D", D)))
    validate(u, dt, B, C, A, D)
    b, T, di = u.shape
    ds = B.shape[-1]
    if h_ck is not None:
        _check_states(h_ck, u, ds)
    y = torch.empty(b, T, di, dtype=u.dtype, device=u.device)
    h = torch.empty(b, di, ds, dtype=_F32, device=u.device)
    strides = (ctypes.c_int64 * 8)(*(s for t in (u, dt, B, C)
                                     for s in t.stride()[:2]))
    lib = _library()
    launch("mamba_scan", lib.mamba_scan_error_string,
           lib.mamba_scan_forward_ck, u.get_device(), u.data_ptr(),
           dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
           D.data_ptr(), y.data_ptr(), h.data_ptr(),
           None if h_ck is None else h_ck.data_ptr(), strides,
           int(u.dtype == torch.bfloat16), b, T, di, ds)
    return y, h


def mamba_scan_bwd(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor, h_ck: torch.Tensor):
    """The gradients of ``mamba_scan``'s y (not of its final state)
    against ``dy`` [b, T, di] (contiguous, u's dtype), given the forward's
    ``h_ck``: (du [b, T, di] in u's dtype, ddt [b, T, di], dB, dC
    [b, T, ds] contiguous, dA [di, ds], dD [di], all f32), in ONE launch
    of csrc/mamba_scan_bwd.cu; dB and dC are the sums of the kernel's
    per-cluster partials over its clusters (each _BWD_CLUSTER CTAs of
    _BWD_CHANNELS[ds] channels along a batch row), dA and dD of its
    per-row partials over b, each taken in a fixed order."""
    args = (("u", u), ("dt", dt), ("B", B), ("C", C), ("A", A), ("D", D),
            ("dy", dy), ("h_ck", h_ck))
    _on_card(args)
    validate(u, dt, B, C, A, D)
    b, T, di = u.shape
    ds = B.shape[-1]
    if (tuple(dy.shape) != (b, T, di) or dy.dtype != u.dtype
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be a contiguous {(b, T, di)} {u.dtype} "
                         f"tensor, got {tuple(dy.shape)} {dy.dtype}")
    _check_states(h_ck, u, ds)
    ncl = -(-di // (_BWD_CHANNELS[ds] * _BWD_CLUSTER))
    if b * ncl * _BWD_CLUSTER > _MAX_BLOCKS:
        raise ValueError(f"b * di = {b * di} needs more than {_MAX_BLOCKS} "
                         f"blocks of the backward")
    du = torch.empty(b, T, di, dtype=u.dtype, device=u.device)
    ddt = torch.empty(b, T, di, dtype=_F32, device=u.device)
    dbc = torch.empty(b, T, ncl, 2 * ds, dtype=_F32, device=u.device)
    dA = torch.empty(b, di, ds, dtype=_F32, device=u.device)
    dD = torch.empty(b, di, dtype=_F32, device=u.device)
    strides = (ctypes.c_int64 * 8)(*(s for t in (u, dt, B, C)
                                     for s in t.stride()[:2]))
    lib = _library("mamba_scan_bwd")
    launch("mamba_scan_bwd", lib.mamba_scan_bwd_error_string,
           lib.mamba_scan_backward, u.get_device(), u.data_ptr(),
           dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
           D.data_ptr(), dy.data_ptr(), h_ck.data_ptr(), du.data_ptr(),
           ddt.data_ptr(), dbc.data_ptr(), dA.data_ptr(), dD.data_ptr(),
           strides, int(u.dtype == torch.bfloat16), b, T, di, ds)
    dbc = dbc.sum(2)
    return (du, ddt, dbc[..., :ds].contiguous(), dbc[..., ds:].contiguous(),
            dA.sum(0), dD.sum(0))


class MambaScan(torch.autograd.Function):
    """B15 under autograd on the card: the forward is one launch of
    ``mamba_scan`` that also fills ``chunk_states``, the backward one
    launch of ``mamba_scan_bwd``.  The final state is not differentiable
    (no training loss reads it)."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D):
        h_ck = chunk_states(u, B.shape[-1])
        y, h = mamba_scan(u, dt, B, C, A, D, h_ck=h_ck)
        ctx.save_for_backward(u, dt, B, C, A, D, h_ck)
        ctx.mark_non_differentiable(h)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        if dy is None:
            return None, None, None, None, None, None
        u, dt, B, C, A, D, h_ck = ctx.saved_tensors
        dy = dy.to(u.dtype).contiguous()
        return mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
