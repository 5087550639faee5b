"""One launch counter per hand-written CUDA kernel, each kernel's source
and the Pallas kernel it replaces, and the launch helper every wrapper
goes through.  A per-tensor entry counts under its kernel's counter
(``vc_asgd_lerp`` under B1's, ``vc_asgd_dc_lerp`` under B4's).

``launch`` runs a kernel's C entry point on the current stream of the
tensors' device, raises if the entry returned a CUDA error, and only
then adds one to that kernel's count.  Nothing else touches the counts:
they are the evidence that a run went through the kernels.  A kernel
with more than one hand-written route (``ROUTES``: B13's wgmma kernels
for bf16 at hd 64 and 128 and its SIMT kernels for the rest, forward and
backward) also counts each launch under the route that ran it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

KERNELS = (
    "vc_asgd_lerp_flat",        # B1, csrc/vc_asgd_update.cu
    "assimilate_flat",          # B2, csrc/vc_asgd_update.cu
    "adam_update_flat",         # B3, csrc/vc_asgd_update.cu
    "vc_asgd_dc_lerp_flat",     # B4, csrc/vc_asgd_update.cu
    "easgd_elastic_flat",       # B5, csrc/vc_asgd_update.cu
    "blocked_topk_stats",       # B6, csrc/topk_mask.cu
    "threshold_sparsify_exact",  # B7, csrc/topk_mask.cu
    "threshold_sparsify",       # B8, csrc/topk_mask.cu
    "quantize_int8",            # B9, csrc/quantize.cu
    "dequantize_int8",          # B10, csrc/quantize.cu
    "quantize_pack",            # B11, csrc/sparse_pack.cu
    "pack_body",                # B12, csrc/sparse_pack.cu
    "flash_attention",          # B13, csrc/flash_attention.cu
    "flash_attention_bwd",      # B13's backward, csrc/flash_attention_bwd.cu
    "wkv6",                     # B14, csrc/wkv6.cu
    "wkv6_bwd",                 # B14's backward, csrc/wkv6_bwd.cu
    "mamba_scan",               # B15, csrc/mamba_scan.cu
    "mamba_scan_bwd",           # B15's backward, csrc/mamba_scan_bwd.cu
)
_CSRC = "src/repro_torch/kernels/csrc/"
# each kernel's source in the repo, and the Pallas kernel it replaces (the
# backwards of B13, B14 and B15: the reference code whose autodiff each
# replaces)
SOURCE = {
    "vc_asgd_lerp_flat": _CSRC + "vc_asgd_update.cu",
    "assimilate_flat": _CSRC + "vc_asgd_update.cu",
    "adam_update_flat": _CSRC + "vc_asgd_update.cu",
    "vc_asgd_dc_lerp_flat": _CSRC + "vc_asgd_update.cu",
    "easgd_elastic_flat": _CSRC + "vc_asgd_update.cu",
    "blocked_topk_stats": _CSRC + "topk_mask.cu",
    "threshold_sparsify_exact": _CSRC + "topk_mask.cu",
    "threshold_sparsify": _CSRC + "topk_mask.cu",
    "quantize_int8": _CSRC + "quantize.cu",
    "dequantize_int8": _CSRC + "quantize.cu",
    "quantize_pack": _CSRC + "sparse_pack.cu",
    "pack_body": _CSRC + "sparse_pack.cu",
    "flash_attention": _CSRC + "flash_attention.cu",
    "flash_attention_bwd": _CSRC + "flash_attention_bwd.cu",
    "wkv6": _CSRC + "wkv6.cu",
    "wkv6_bwd": _CSRC + "wkv6_bwd.cu",
    "mamba_scan": _CSRC + "mamba_scan.cu",
    "mamba_scan_bwd": _CSRC + "mamba_scan_bwd.cu",
}
REPLACES = {
    "vc_asgd_lerp_flat": "src/repro/kernels/vc_asgd_update.py:49",
    "assimilate_flat": "src/repro/kernels/vc_asgd_update.py:69",
    "adam_update_flat": "src/repro/kernels/vc_asgd_update.py:80",
    "vc_asgd_dc_lerp_flat": "src/repro/kernels/vc_asgd_update.py:56",
    "easgd_elastic_flat": "src/repro/kernels/vc_asgd_update.py:98",
    "blocked_topk_stats": "src/repro/kernels/topk_mask.py:78",
    "threshold_sparsify_exact": "src/repro/kernels/topk_mask.py:122",
    "threshold_sparsify": "src/repro/kernels/topk_mask.py:42",
    "quantize_int8": "src/repro/kernels/quantize.py:17",
    "dequantize_int8": "src/repro/kernels/quantize.py:26",
    "quantize_pack": "src/repro/kernels/sparse_pack.py:35",
    "pack_body": "src/repro/kernels/sparse_pack.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:23",
    # no Pallas counterpart: the reference's training differentiates the
    # jnp blocked attention with XLA; the backward replaces that autodiff
    "flash_attention_bwd": "src/repro/models/layers.py:186",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:19",
    # the reference's training differentiates its chunked time mix and
    # chunked scan (jnp) with XLA; the two backwards replace that autodiff
    "wkv6_bwd": "src/repro/models/rwkv.py:132",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:20",
    "mamba_scan_bwd": "src/repro/models/mamba.py:84",
}
# kernels with more than one hand-written route: route -> its source
ROUTES = {
    "flash_attention": {"wgmma": _CSRC + "flash_attention_sm90.cu",
                        "simt": _CSRC + "flash_attention.cu"},
    "flash_attention_bwd": {"wgmma": _CSRC + "flash_attention_bwd_sm90.cu",
                            "simt": _CSRC + "flash_attention_bwd.cu"},
}
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_route_launches = {k: dict.fromkeys(r, 0) for k, r in ROUTES.items()}
# PyTorch's current device and raw current-stream handle (what Triton's
# launcher reads); absent from a CPU-only build, where nothing launches
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_count(kernel: Optional[str] = None) -> int:
    """Launches of ``kernel`` (all kernels when None)."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def route_counts(kernel: str) -> Dict[str, int]:
    """Launches of ``kernel`` by route (a kernel of ``ROUTES``)."""
    return dict(_route_launches[kernel])


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0
    for counts in _route_launches.values():
        for r in counts:
            counts[r] = 0


def launch(kernel: str, error_string, fn, index: int, *args,
           route: Optional[str] = None) -> None:
    """Call ``fn(*args, stream)`` on the current stream of CUDA device
    ``index`` (a tensor's ``get_device()``); a non-zero return
    (``cudaGetLastError``) raises with ``error_string(rc)``.  A kernel of
    ``ROUTES`` names the ``route`` it launched.

    The stream is PyTorch's raw current-stream handle, the one
    ``torch.cuda.current_stream(index).cuda_stream`` gives, read without
    building a ``Stream`` object; the device is switched only when
    ``index`` is not the current one (the kernel launches on the current
    device)."""
    if index == _current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cuda error {rc})")
    _launches[kernel] += 1
    if route is not None:
        _route_launches[kernel][route] += 1


def bind_error_string(fn) -> None:
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p


# bus storage dtypes of the elementwise kernels -> their C entry suffix
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_pack_aligned(name: str, t: torch.Tensor) -> None:
    """A kernel that reads ``t`` in 16-byte packs needs it 16-byte aligned
    where it holds one (a shorter tensor is read element by element)."""
    if t.numel() * t.element_size() >= 16 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_cuda(name: str, t: torch.Tensor, dtypes) -> None:
    """``t`` must be a contiguous CUDA tensor of one of ``dtypes``."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {list(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def operand(name: str, t, dtype: torch.dtype) -> Tuple[int, int, int]:
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
