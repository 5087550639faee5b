"""Wrappers of the flat-bus CUDA kernels (csrc/vc_asgd_update.cu).

Port of ``repro/kernels/vc_asgd_update.py``'s flat entry points:

* ``vc_asgd_lerp_flat``  — Eq. 1 (replaces the Pallas ``_lerp_kernel``)
* ``vc_asgd_dc_lerp_flat`` — DC-ASGD's corrected Eq. 1 (replaces
  ``_dc_lerp_kernel``)
* ``assimilate_flat``    — Eq. 2 (replaces ``_assimilate_kernel``)
* ``adam_update_flat``   — fused Adam (replaces ``_adam_kernel``)
* ``easgd_elastic_flat`` — elastic EASGD round (replaces ``_easgd_kernel``)

and the per-tensor entries ``vc_asgd_lerp`` / ``vc_asgd_dc_lerp`` (the
reference's :146 / :153): the same two kernels on one tensor of any
shape, its ragged tail handled inside the kernel (no padded copies).

Each takes CUDA tensors only (``ops`` routes CPU tensors to the plain
versions in ``ref``), checks device, dtype, shape (the flat entries: 1-D,
a ``BLOCK`` multiple), contiguity and 16-byte alignment (of the part the
kernel reads in 16-byte packs), allocates its outputs —
never writing into an input, since the consistency store hands earlier
bus snapshots out by reference — and launches ONE kernel on the current
stream without synchronising.  A non-zero ``cudaGetLastError`` raises.

The host path is kept lean, since on the training loop's small bus a
call costs its host time, not its kernel's: each C entry is resolved once
per storage dtype when the library loads, each tensor's metadata is read
once per call, the scalars travel by value (Adam's as one
``AdamScalars``), and ``launches.launch`` reads the raw current-stream
handle.

The launch counters of every kernel of the port live in ``launches``
and are re-exported here.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.flat import BLOCK
from repro_torch.kernels import build
from repro_torch.kernels.launches import (KERNELS, STORAGE,
                                          bind_error_string, launch,
                                          launch_count, launch_counts,
                                          reset_launch_count)

__all__ = ["KERNELS", "launch_count", "launch_counts", "reset_launch_count",
           "vc_asgd_lerp_flat", "vc_asgd_lerp", "vc_asgd_dc_lerp_flat",
           "vc_asgd_dc_lerp", "assimilate_flat", "adam_update_flat",
           "easgd_elastic_flat", "AdamScalars", "adam_scalars",
           "lerp_scalars", "FixedWeights", "assimilate_weights",
           "FIXED_CLIENTS", "MAX_CLIENTS"]

_F32 = (torch.float32,)


class AdamScalars(ctypes.Structure):
    """B3's scalars, passed by value (csrc/vc_asgd_update.cu's
    ``AdamScalars``): each field an f32, set from a Python float by one
    round-to-nearest."""
    _fields_ = [(name, ctypes.c_float) for name in
                ("lr", "b1", "omb1", "b2", "omb2", "eps", "lr_wd", "c1",
                 "c2")]


def adam_scalars(lr, b1, b2, eps, weight_decay, c1, c2) -> AdamScalars:
    """The f32 scalars B3 gets, rounded the way the reference's jnp Adam
    (``repro.kernels.ref.adam_update``) rounds its Python floats:
    ``1-b1``, ``1-b2`` and ``lr*wd`` are formed in double, then each is
    rounded once to f32; ``c1``, ``c2`` are f32 already."""
    return AdamScalars(lr, b1, 1 - b1, b2, 1 - b2, eps,
                       lr * weight_decay if weight_decay else 0.0, c1, c2)


def lerp_scalars(alpha) -> Tuple[float, float]:
    """``(a, 1-a)`` of Eq. 1 as f32 values: ``alpha`` rounded to f32, and
    ``1-a`` taken from it as the reference's f32 ``1 - a`` is.  The
    double subtraction is exact, or off only where both land on the same
    f32, so its one rounding to f32 gives that f32 difference."""
    a = ctypes.c_float(alpha).value
    return a, ctypes.c_float(1.0 - a).value


# Eq. 2's client counts: up to FIXED_CLIENTS the weights ride by value
# in a FixedWeights and the kernel is instantiated for the count; above it,
# up to MAX_CLIENTS, one generic instance reads them from an f32 array
FIXED_CLIENTS = 8
MAX_CLIENTS = 511


class FixedWeights(ctypes.Structure):
    """B2's weights for 1 <= n <= FIXED_CLIENTS clients, passed by value
    (csrc/vc_asgd_update.cu's ``FixedWeights``, nine consecutive f32):
    ``w_server, w_0, ...``, each set from a Python float by one
    round-to-nearest, the unused tail zero."""
    _fields_ = [(f"w{j}", ctypes.c_float) for j in range(FIXED_CLIENTS + 1)]


_lib: Optional[ctypes.CDLL] = None
_error_string = None
# (entry, storage dtype) -> its C function, resolved when the library loads
_entries: Dict[Tuple[str, torch.dtype], Any] = {}


_P, _F, _I, _I64 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                    ctypes.c_int64)
# each C entry's argtypes: a Python float passed as _F is rounded once to
# nearest f32 by ctypes (B5's beta)
SIGNATURES = {
    "lerp": [_P, _P, _P, _F, _F, _I64, _P],
    "dc_lerp": [_P, _P, _P, _P, _P, _F, _F, _F, _I64, _P],
    "assimilate_fixed": [_P, _P, _P, FixedWeights, _I, _I64, _P],
    "assimilate": [_P, _P, _P, ctypes.POINTER(_F), _I, _I64, _P],
    "adam": [_P] * 7 + [AdamScalars, _I64, _P],
    "easgd": [_P, _P, _P, _P, _F, _I, _I64, _P],
}


def _library() -> ctypes.CDLL:
    global _lib, _error_string
    if _lib is None:
        lib = build.load("vc_asgd_update")
        for dtype, sfx in STORAGE.items():
            for entry, argtypes in SIGNATURES.items():
                fn = getattr(lib, f"vc_{entry}_{sfx}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[entry, dtype] = fn
        bind_error_string(lib.vc_error_string)
        for name, want in (("vc_fixed_clients", FIXED_CLIENTS),
                           ("vc_max_weights", MAX_CLIENTS + 1)):
            getattr(lib, name).restype = ctypes.c_int
            if getattr(lib, name)() != want:
                raise RuntimeError(f"{name}() != {want}: the library does "
                                   f"not match vc_asgd_update.py")
        _error_string = lib.vc_error_string
        _lib = lib
    return _lib


def _entry(entry: str, dtype: torch.dtype):
    """The C entry ``vc_<entry>_<dtype>``, loading the library (and
    ``_error_string``) at first use: call it before reading
    ``_error_string``."""
    if _lib is None:
        _library()
    return _entries[entry, dtype]


def _operand(name: str, t, dtypes) -> Tuple[int, int]:
    """``(numel, data_ptr)`` of ``t``: a contiguous non-empty CUDA tensor
    of ``dtypes``, 16-byte aligned where the kernel reads it in 16-byte
    packs (it holds one).  Each piece of metadata is read once."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {list(dtypes)}")
    n = t.numel()
    if n < 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous and non-empty")
    ptr = t.data_ptr()
    if ptr % 16 and n * t.element_size() >= 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return n, ptr


def _flat(name: str, t, n: int) -> None:
    """A flat-bus operand of ``n`` elements is 1-D and a BLOCK multiple."""
    if t.dim() != 1 or n % BLOCK:
        raise ValueError(f"{name} must be 1-D and a BLOCK({BLOCK}) multiple, "
                         f"got shape {tuple(t.shape)}")


def _like(name: str, t, dtypes, dev: int, shape) -> int:
    """``t``'s data pointer: an operand as ``_operand`` takes it, on CUDA
    device ``dev`` and of ``shape`` (the first operand's, read once)."""
    ptr = _operand(name, t, dtypes)[1]
    if t.get_device() != dev:
        raise ValueError(f"{name} on {t.device}, expected cuda:{dev}")
    if t.shape != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    return ptr


def _lerp(server, client, alpha, flat: bool) -> torch.Tensor:
    n, sp = _operand("server", server, STORAGE)
    if flat:
        _flat("server", server, n)
    dtype, dev = server.dtype, server.get_device()
    cp = _like("client", client, (dtype,), dev, server.shape)
    a, oma = lerp_scalars(alpha)
    out = torch.empty_like(server)
    fn = _entry("lerp", dtype)
    launch("vc_asgd_lerp_flat", _error_string, fn, dev, sp, cp,
           out.data_ptr(), a, oma, n)
    return out


def vc_asgd_lerp_flat(server: torch.Tensor, client: torch.Tensor, alpha
                      ) -> torch.Tensor:
    """Eq. 1 over the whole flat bus, one launch: ``a*s + (1-a)*c`` in f32
    math, stored in the bus dtype.  ``1-a`` is taken in f32 on the host,
    as the reference's lerp does (``lerp_scalars``)."""
    return _lerp(server, client, alpha, True)


def vc_asgd_lerp(server: torch.Tensor, client: torch.Tensor, alpha
                 ) -> torch.Tensor:
    """Eq. 1 on one tensor of any shape, one launch of B1 (counted under
    ``vc_asgd_lerp_flat``); the result has the server's shape and dtype."""
    return _lerp(server, client, alpha, False)


def _dc_lerp(server, client, grad, backup, alpha, lam, flat: bool
             ) -> torch.Tensor:
    n, sp = _operand("server", server, STORAGE)
    if flat:
        _flat("server", server, n)
    dtype, dev, shape = server.dtype, server.get_device(), server.shape
    ptrs = [_like(name, t, (dtype,), dev, shape) for name, t in
            (("client", client), ("grad", grad), ("backup", backup))]
    a, oma = lerp_scalars(alpha)
    out = torch.empty_like(server)
    fn = _entry("dc_lerp", dtype)
    launch("vc_asgd_dc_lerp_flat", _error_string, fn, dev, sp, *ptrs,
           out.data_ptr(), a, oma, float(np.float32(lam)), n)
    return out


def vc_asgd_dc_lerp_flat(server, client, grad, backup, alpha, lam=0.04
                         ) -> torch.Tensor:
    """DC-ASGD's corrected Eq. 1 over the whole flat bus, one launch:
    ``c' = c + ((lam*g)*g)*(s - b)``, then ``a*s + (1-a)*c'``, in f32
    math, stored in the bus dtype (all four streams in it).  ``1-a`` is
    taken in f32 on the host; ``alpha`` and ``lam`` are rounded to f32."""
    return _dc_lerp(server, client, grad, backup, alpha, lam, True)


def vc_asgd_dc_lerp(server, client, grad, backup, alpha, lam=0.04
                    ) -> torch.Tensor:
    """``vc_asgd_dc_lerp_flat`` on one tensor of any shape (one launch of
    B4); the result has the server's shape and dtype."""
    return _dc_lerp(server, client, grad, backup, alpha, lam, False)


def _rows(name: str, rows, dtype: torch.dtype, dev: int, n: int
          ) -> Tuple[int, int]:
    """``(k, data_ptr)`` of ``rows``: a contiguous 16-byte aligned [k, n]
    CUDA matrix (k >= 1) of ``dtype`` on device ``dev``, checked without
    building a view, each piece of metadata read once."""
    at = rows.get_device() if isinstance(rows, torch.Tensor) else -1
    if at != dev:
        raise ValueError(f"{name} on {getattr(rows, 'device', type(rows))}, "
                         f"expected cuda:{dev}")
    shape = rows.shape
    if (len(shape) != 2 or shape[0] < 1 or shape[1] != n
            or rows.dtype != dtype or not rows.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous [k, {n}] {dtype} "
                         f"matrix, got {tuple(shape)} {rows.dtype}")
    ptr = rows.data_ptr()
    if ptr % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return int(shape[0]), ptr


def assimilate_weights(weights: Sequence[float]):
    """The f32 weights B2 gets, ``[w_server, w_0, ..., w_{n-1}]`` each
    rounded once to nearest from its Python float, as the reference's
    ``jnp.asarray(w, jnp.float32)`` rounds it: a ``FixedWeights`` (by
    value) for n <= FIXED_CLIENTS, else an f32 array of n + 1."""
    if len(weights) <= FIXED_CLIENTS + 1:
        return FixedWeights(*weights)
    return (ctypes.c_float * len(weights))(*weights)


def _assimilate_checks(server, clients) -> Tuple[int, int, int, int, int]:
    """``(n, n_clients, server ptr, clients ptr, device)`` of an Eq. 2
    call: server a flat-bus operand, clients a [n_clients, n] matrix of
    its dtype on its device, 1 <= n_clients <= MAX_CLIENTS."""
    n, sp = _operand("server", server, STORAGE)
    _flat("server", server, n)
    dev = server.get_device()
    n_clients, cp = _rows("clients", clients, server.dtype, dev, n)
    if n_clients > MAX_CLIENTS:
        raise ValueError(f"assimilate_flat takes at most {MAX_CLIENTS} "
                         f"clients, got {n_clients}")
    return n, n_clients, sp, cp, dev


def assimilate_flat(server: torch.Tensor, clients: torch.Tensor,
                    weights: Sequence[float]) -> torch.Tensor:
    """Eq. 2 as ONE launch: server [N] + clients [n, N] -> [N], each output
    element reducing the n client streams in arrival order.  ``weights``
    = [w_server, w_0..w_{n-1}], rounded to f32 here
    (``assimilate_weights``)."""
    n, n_clients, sp, cp, dev = _assimilate_checks(server, clients)
    if len(weights) != n_clients + 1:
        raise ValueError(f"need {n_clients + 1} weights, got {len(weights)}")
    w = assimilate_weights(weights)
    out = torch.empty_like(server)
    if _lib is None:
        _library()
    fn = _entries["assimilate_fixed" if n_clients <= FIXED_CLIENTS
                  else "assimilate", server.dtype]
    launch("assimilate_flat", _error_string, fn, dev, sp, cp, out.data_ptr(),
           w, n_clients, n)
    return out


def adam_update_flat(p, g, m, v, lr, b1, b2, eps, weight_decay, c1, c2):
    """Fused Adam over the whole flat bus, one launch updating params and
    both moment lanes; returns (p', m', v') with p' in p's dtype and the
    moments in f32.  The scalars are rounded to f32 the way the
    reference's jnp Adam rounds its Python floats (``adam_scalars``)."""
    n, pp = _operand("p", p, STORAGE)
    _flat("p", p, n)
    dev, shape = p.get_device(), p.shape
    gp = _like("grad", g, _F32, dev, shape)
    mp = _like("m", m, _F32, dev, shape)
    vp = _like("v", v, _F32, dev, shape)
    sc = adam_scalars(lr, b1, b2, eps, weight_decay, c1, c2)
    po = torch.empty_like(p)
    mo = torch.empty_like(m)
    vo = torch.empty_like(v)
    fn = _entry("adam", p.dtype)
    launch("adam_update_flat", _error_string, fn, dev, pp, gp, mp, vp,
           po.data_ptr(), mo.data_ptr(), vo.data_ptr(), sc, n)
    return po, mo, vo


def easgd_elastic_flat(center: torch.Tensor, replicas: torch.Tensor, beta
                       ) -> tuple:
    """The elastic EASGD round as ONE launch: center [N] and replicas
    [n, N] (stacked in slot order) -> (center', replicas').  The sum over
    replicas runs in replica order from zero; ``beta`` goes to the C entry
    as a Python number, rounded once to nearest f32 there by ctypes (as
    the reference's ``jnp.asarray([beta], jnp.float32)`` rounds it)."""
    n, cp = _operand("center", center, STORAGE)
    _flat("center", center, n)
    dev = center.get_device()
    n_replicas, xp = _rows("replicas", replicas, center.dtype, dev, n)
    co = torch.empty_like(center)
    xo = torch.empty_like(replicas)
    fn = _entry("easgd", center.dtype)
    launch("easgd_elastic_flat", _error_string, fn, dev, cp, xp,
           co.data_ptr(), xo.data_ptr(), beta, n_replicas, n)
    return co, xo
