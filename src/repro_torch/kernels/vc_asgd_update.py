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

The launch counters of every kernel of the port live in ``launches``
and are re-exported here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flat import BLOCK
from repro_torch.kernels import build
from repro_torch.kernels.launches import (KERNELS, STORAGE,
                                          bind_error_string,
                                          check_pack_aligned, launch,
                                          launch_count, launch_counts,
                                          reset_launch_count)

__all__ = ["KERNELS", "launch_count", "launch_counts", "reset_launch_count",
           "vc_asgd_lerp_flat", "vc_asgd_lerp", "vc_asgd_dc_lerp_flat",
           "vc_asgd_dc_lerp", "assimilate_flat", "adam_update_flat",
           "easgd_elastic_flat"]

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("vc_asgd_update")
        P, F, I64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
        for sfx in ("f32", "bf16"):
            fn = getattr(lib, f"vc_lerp_{sfx}")
            fn.argtypes = [P, P, P, F, F, I64, P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"vc_dc_lerp_{sfx}")
            fn.argtypes = [P, P, P, P, P, F, F, F, I64, P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"vc_assimilate_{sfx}")
            fn.argtypes = [P, P, P, P, ctypes.c_int, I64, P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"vc_adam_{sfx}")
            fn.argtypes = [P] * 8 + [I64, P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"vc_easgd_{sfx}")
            fn.argtypes = [P, P, P, P, F, ctypes.c_int, I64, P]
            fn.restype = ctypes.c_int
        bind_error_string(lib.vc_error_string)
        lib.vc_max_weights.argtypes = []
        lib.vc_max_weights.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_flat(name: str, buf: torch.Tensor, dtypes=tuple(STORAGE)) -> int:
    n = _check_tensor(name, buf, dtypes)
    if buf.dim() != 1 or n % BLOCK:
        raise ValueError(f"{name} must be 1-D and a BLOCK({BLOCK}) multiple, "
                         f"got shape {tuple(buf.shape)}")
    return n


def _check_tensor(name: str, buf: torch.Tensor, dtypes=tuple(STORAGE)
                  ) -> int:
    """A contiguous non-empty CUDA tensor of ``dtypes``, 16-byte aligned
    where the kernel reads it in 16-byte packs (it holds one)."""
    if not isinstance(buf, torch.Tensor) or buf.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(buf, 'device', type(buf))}")
    if buf.dtype not in dtypes:
        raise ValueError(f"{name} dtype {buf.dtype} not in {list(dtypes)}")
    n = buf.numel()
    if n < 1 or not buf.is_contiguous():
        raise ValueError(f"{name} must be contiguous and non-empty")
    check_pack_aligned(name, buf)
    return n


def _same(name: str, buf: torch.Tensor, like: torch.Tensor) -> None:
    if buf.device != like.device:
        raise ValueError(f"{name} on {buf.device}, expected {like.device}")


def _launch(kernel: str, fn, device: torch.device, *args) -> None:
    launch(kernel, _library().vc_error_string, fn, device, *args)


def _lerp(kernel: str, server, client, alpha, check) -> torch.Tensor:
    n = check("server", server)
    check("client", client, (server.dtype,))
    _same("client", client, server)
    if client.shape != server.shape:
        raise ValueError(f"client shape {tuple(client.shape)} != server "
                         f"{tuple(server.shape)}")
    a = np.float32(alpha)
    oma = np.float32(1.0) - a
    out = torch.empty_like(server)
    fn = getattr(_library(), f"vc_lerp_{STORAGE[server.dtype]}")
    _launch(kernel, fn, server.device, server.data_ptr(), client.data_ptr(),
            out.data_ptr(), float(a), float(oma), n)
    return out


def vc_asgd_lerp_flat(server: torch.Tensor, client: torch.Tensor, alpha
                      ) -> torch.Tensor:
    """Eq. 1 over the whole flat bus, one launch: ``a*s + (1-a)*c`` in f32
    math, stored in the bus dtype.  ``1-a`` is taken in f32 on the host,
    as the reference's lerp does."""
    return _lerp("vc_asgd_lerp_flat", server, client, alpha, _check_flat)


def vc_asgd_lerp(server: torch.Tensor, client: torch.Tensor, alpha
                 ) -> torch.Tensor:
    """Eq. 1 on one tensor of any shape, one launch of B1 (counted under
    ``vc_asgd_lerp_flat``); the result has the server's shape and dtype."""
    return _lerp("vc_asgd_lerp_flat", server, client, alpha, _check_tensor)


def _dc_lerp(server, client, grad, backup, alpha, lam, check
             ) -> torch.Tensor:
    n = check("server", server)
    for name, t in (("client", client), ("grad", grad), ("backup", backup)):
        check(name, t, (server.dtype,))
        _same(name, t, server)
        if t.shape != server.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != server "
                             f"{tuple(server.shape)}")
    a = np.float32(alpha)
    oma = np.float32(1.0) - a
    out = torch.empty_like(server)
    fn = getattr(_library(), f"vc_dc_lerp_{STORAGE[server.dtype]}")
    _launch("vc_asgd_dc_lerp_flat", fn, server.device, server.data_ptr(),
            client.data_ptr(), grad.data_ptr(), backup.data_ptr(),
            out.data_ptr(), float(a), float(oma), float(np.float32(lam)), n)
    return out


def vc_asgd_dc_lerp_flat(server, client, grad, backup, alpha, lam=0.04
                         ) -> torch.Tensor:
    """DC-ASGD's corrected Eq. 1 over the whole flat bus, one launch:
    ``c' = c + ((lam*g)*g)*(s - b)``, then ``a*s + (1-a)*c'``, in f32
    math, stored in the bus dtype (all four streams in it).  ``1-a`` is
    taken in f32 on the host; ``alpha`` and ``lam`` are rounded to f32."""
    return _dc_lerp(server, client, grad, backup, alpha, lam, _check_flat)


def vc_asgd_dc_lerp(server, client, grad, backup, alpha, lam=0.04
                    ) -> torch.Tensor:
    """``vc_asgd_dc_lerp_flat`` on one tensor of any shape (one launch of
    B4); the result has the server's shape and dtype."""
    return _dc_lerp(server, client, grad, backup, alpha, lam, _check_tensor)


def assimilate_flat(server: torch.Tensor, clients: torch.Tensor,
                    weights: Sequence[float]) -> torch.Tensor:
    """Eq. 2 as ONE launch: server [N] + clients [n, N] -> [N], each output
    element reducing the n client streams in arrival order.  ``weights``
    = [w_server, w_0..w_{n-1}], rounded to f32 here."""
    n = _check_flat("server", server)
    if (clients.dim() != 2 or clients.shape[1] != n
            or clients.dtype != server.dtype or not clients.is_contiguous()):
        raise ValueError(f"clients must be a contiguous [n, {n}] "
                         f"{server.dtype} matrix, got {tuple(clients.shape)} "
                         f"{clients.dtype}")
    _check_flat("clients", clients.view(-1), (server.dtype,))
    _same("clients", clients, server)
    n_clients = int(clients.shape[0])
    if len(weights) != n_clients + 1:
        raise ValueError(f"need {n_clients + 1} weights, got {len(weights)}")
    lib = _library()
    if n_clients + 1 > lib.vc_max_weights():
        raise ValueError(f"assimilate_flat takes at most "
                         f"{lib.vc_max_weights() - 1} clients, got {n_clients}")
    w = np.asarray([np.float32(x) for x in weights], np.float32)
    out = torch.empty_like(server)
    fn = getattr(lib, f"vc_assimilate_{STORAGE[server.dtype]}")
    _launch("assimilate_flat", fn, server.device, server.data_ptr(),
            clients.data_ptr(), out.data_ptr(), w.ctypes.data, n_clients, n)
    return out


def adam_update_flat(p, g, m, v, lr, b1, b2, eps, weight_decay, c1, c2):
    """Fused Adam over the whole flat bus, one launch updating params and
    both moment lanes; returns (p', m', v') with p' in p's dtype and the
    moments in f32.  The scalars are rounded to f32 the way the
    reference's jnp Adam rounds its Python floats: ``1-b1``, ``1-b2`` and
    ``lr*wd`` are formed in double first."""
    n = _check_flat("p", p)
    for name, buf in (("grad", g), ("m", m), ("v", v)):
        _check_flat(name, buf, (torch.float32,))
        _same(name, buf, p)
        if buf.numel() != n:
            raise ValueError(f"{name} lane must match params lane [{n}], "
                             f"got {tuple(buf.shape)}")
    wd = float(weight_decay)
    scal = np.asarray([lr, b1, 1 - b1, b2, 1 - b2, eps,
                       lr * wd if wd else 0.0, c1, c2], np.float32)
    po = torch.empty_like(p)
    mo = torch.empty_like(m)
    vo = torch.empty_like(v)
    fn = getattr(_library(), f"vc_adam_{STORAGE[p.dtype]}")
    _launch("adam_update_flat", fn, p.device, p.data_ptr(), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), po.data_ptr(), mo.data_ptr(),
            vo.data_ptr(), scal.ctypes.data, n)
    return po, mo, vo


def easgd_elastic_flat(center: torch.Tensor, replicas: torch.Tensor, beta
                       ) -> tuple:
    """The elastic EASGD round as ONE launch: center [N] and replicas
    [n, N] (stacked in slot order) -> (center', replicas').  The sum over
    replicas runs in replica order from zero; ``beta`` is rounded to f32
    here."""
    n = _check_flat("center", center)
    if (replicas.dim() != 2 or replicas.shape[1] != n or replicas.shape[0] < 1
            or replicas.dtype != center.dtype or not replicas.is_contiguous()):
        raise ValueError(f"replicas must be a contiguous [n, {n}] "
                         f"{center.dtype} matrix, got {tuple(replicas.shape)} "
                         f"{replicas.dtype}")
    _check_flat("replicas", replicas.view(-1), (center.dtype,))
    _same("replicas", replicas, center)
    co = torch.empty_like(center)
    xo = torch.empty_like(replicas)
    fn = getattr(_library(), f"vc_easgd_{STORAGE[center.dtype]}")
    _launch("easgd_elastic_flat", fn, center.device, center.data_ptr(),
            replicas.data_ptr(), co.data_ptr(), xo.data_ptr(),
            float(np.float32(beta)), int(replicas.shape[0]), n)
    return co, xo
