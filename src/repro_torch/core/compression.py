"""Update compression for the upload leg (port of the flat-bus forms of
``repro/core/compression.py``).

The client's payload is the parameter DELTA (trained - base), and it is
compressible:

* exact magnitude top-k over the WHOLE model with **error feedback** (the
  residual carries into the next round, so nothing is permanently lost),
* symmetric per-block int8 quantization of the surviving values.

``quantize_int8`` / ``dequantize_int8`` go through ``kernels/ops``: one
CUDA kernel launch each on the card (B9, B10), the plain PyTorch version
on the CPU.  Every result is bit-identical to the reference's jnp path.

Top-k selection ports the reference's small-problem branch (a global
sort, compression.py:111-115).  The blocked selection it uses for buses
of 2^20 elements and more rides the Pallas kernels B6/B7, which are not
ported yet: such a call raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as K


class CompressedDelta(NamedTuple):
    values: torch.Tensor     # int8 quantized surviving values [k]
    scales: torch.Tensor     # f32 per-block scales [ceil(k / block)]
    indices: torch.Tensor    # int32 flat indices [k], ASCENDING (canonical)
    shape: tuple             # original shape
    density: float
    block: int = 256         # quantization block (the wire format ships it)


# the reference's blocked-selection thresholds (compression.py:72-74)
_SAMPLE = 1 << 16
_MARGIN = 1 << 15
_MIN_FAST_N = 16 * _SAMPLE


def select_topk(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int32, ascending) of the exact k largest-|flat| entries.

    Deterministic under magnitude ties: the lowest flat indices win, as
    with ``lax.top_k``.  ``torch.topk`` does not promise that order, so
    this takes a STABLE descending sort of ``|flat|`` (equal magnitudes
    keep their index order) and the first k of it."""
    flat = flat.reshape(-1)
    n = flat.numel()
    k = int(k)
    if not (k + _MARGIN >= n or n < _MIN_FAST_N or n % 32):
        raise NotImplementedError(
            f"select_topk over n={n} >= 2^20 elements takes the blocked "
            f"selection (Pallas B6/B7), which is not ported yet: it comes "
            f"with the slice that ports the pod runtime's compressed rounds "
            f"or the LLM stack")
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    return torch.sort(order[:k]).values.to(torch.int32)


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8: (q int8 [n], scales f32 [ceil(n/block)])."""
    return K.quantize_int8(x.reshape(-1).to(torch.float32).contiguous(),
                           block)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int,
                    block: int = 256) -> torch.Tensor:
    return K.dequantize_int8(q.reshape(-1).contiguous(), scales.contiguous(),
                             n, block)


def decompress_delta(p: CompressedDelta) -> torch.Tensor:
    """The dense f32 buffer of shape ``p.shape``: dequantized values at
    their indices, zeros elsewhere."""
    n = 1
    for s in p.shape:
        n *= int(s)
    deq = dequantize_int8(p.values, p.scales, p.values.numel(), block=p.block)
    flat = torch.zeros(n, dtype=torch.float32, device=p.values.device)
    flat[p.indices.long()] = deq
    return flat.reshape(p.shape)


def compress_flat(delta_buf: torch.Tensor, *, density: float = 0.05,
                  block: int = 256, logical_n: Optional[int] = None,
                  residual: Optional[torch.Tensor] = None
                  ) -> Tuple[CompressedDelta, torch.Tensor]:
    """Global top-k + int8 with error feedback on a flat [padded] buffer.

    ``logical_n`` (spec.n) sizes k so tail padding never inflates the
    density budget; ``residual`` is the error-feedback carry from the
    previous round (added to the delta BEFORE selection).  Returns
    (payload, new_residual [padded]); the new residual is the selected
    values minus what was transmitted, at the kept indices, and the
    unselected values elsewhere."""
    flat = delta_buf.reshape(-1).to(torch.float32)
    if residual is not None:
        flat = flat + residual.reshape(-1).to(torch.float32)
    n = int(logical_n) if logical_n is not None else flat.numel()
    k = max(1, min(n, int(n * density)))
    idx = select_topk(flat, k)          # exact top-k set, ascending indices
    at = idx.long()
    sel = flat[at]
    q, scales = quantize_int8(sel, block)
    deq = dequantize_int8(q, scales, k, block)
    # error feedback: subtract what was transmitted at the kept indices
    # (indices are unique, and IEEE a - b == a + (-b), the reference's
    # ``flat.at[idx].add(-deq)``)
    new_residual = flat.clone()
    new_residual[at] = sel - deq
    payload = CompressedDelta(values=q, scales=scales, indices=idx,
                              shape=(flat.numel(),), density=density,
                              block=block)
    return payload, new_residual


def decompress_flat(p: CompressedDelta) -> torch.Tensor:
    """Rebuild the dense flat [padded] buffer from a global payload."""
    return decompress_delta(p)


def payload_bytes(p: CompressedDelta) -> int:
    return int(p.values.numel() + p.scales.numel() * 4
               + p.indices.numel() * 4)


def compression_ratio(p: CompressedDelta, dtype_bytes: int = 4) -> float:
    n = 1
    for s in p.shape:
        n *= int(s)
    return n * dtype_bytes / payload_bytes(p)
