"""One launch counter per hand-written CUDA kernel, each kernel's source
and the Pallas kernel it replaces, and the launch helper every wrapper
goes through.

``launch`` runs a kernel's C entry point on the current stream of the
tensors' device, raises if the entry returned a CUDA error, and only
then adds one to that kernel's count.  Nothing else touches the counts:
they are the evidence that a run went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

KERNELS = (
    "vc_asgd_lerp_flat",        # B1, csrc/vc_asgd_update.cu
    "assimilate_flat",          # B2, csrc/vc_asgd_update.cu
    "adam_update_flat",         # B3, csrc/vc_asgd_update.cu
    "easgd_elastic_flat",       # B5, csrc/vc_asgd_update.cu
    "quantize_int8",            # B9, csrc/quantize.cu
    "dequantize_int8",          # B10, csrc/quantize.cu
    "pack_body",                # B12, csrc/sparse_pack.cu
    "flash_attention",          # B13, csrc/flash_attention.cu
    "wkv6",                     # B14, csrc/wkv6.cu
    "mamba_scan",               # B15, csrc/mamba_scan.cu
)
_CSRC = "src/repro_torch/kernels/csrc/"
# each kernel's source in the repo, and the Pallas kernel it replaces
SOURCE = {
    "vc_asgd_lerp_flat": _CSRC + "vc_asgd_update.cu",
    "assimilate_flat": _CSRC + "vc_asgd_update.cu",
    "adam_update_flat": _CSRC + "vc_asgd_update.cu",
    "easgd_elastic_flat": _CSRC + "vc_asgd_update.cu",
    "quantize_int8": _CSRC + "quantize.cu",
    "dequantize_int8": _CSRC + "quantize.cu",
    "pack_body": _CSRC + "sparse_pack.cu",
    "flash_attention": _CSRC + "flash_attention.cu",
    "wkv6": _CSRC + "wkv6.cu",
    "mamba_scan": _CSRC + "mamba_scan.cu",
}
REPLACES = {
    "vc_asgd_lerp_flat": "src/repro/kernels/vc_asgd_update.py:49",
    "assimilate_flat": "src/repro/kernels/vc_asgd_update.py:69",
    "adam_update_flat": "src/repro/kernels/vc_asgd_update.py:80",
    "easgd_elastic_flat": "src/repro/kernels/vc_asgd_update.py:98",
    "quantize_int8": "src/repro/kernels/quantize.py:17",
    "dequantize_int8": "src/repro/kernels/quantize.py:26",
    "pack_body": "src/repro/kernels/sparse_pack.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:23",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:19",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:20",
}
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: Optional[str] = None) -> int:
    """Launches of ``kernel`` (all kernels when None)."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def launch(kernel: str, error_string, fn, device: torch.device,
           *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; a non-zero
    return (``cudaGetLastError``) raises with ``error_string(rc)``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cuda error {rc})")
    _launches[kernel] += 1


def bind_error_string(fn) -> None:
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p


def check_cuda(name: str, t: torch.Tensor, dtypes) -> None:
    """``t`` must be a contiguous CUDA tensor of one of ``dtypes``."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {list(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
