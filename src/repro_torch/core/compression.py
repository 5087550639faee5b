"""Update compression for the upload leg (port of
``repro/core/compression.py``).

The client's payload is the parameter DELTA (trained - base), and it is
compressible:

* exact magnitude top-k over the WHOLE model with **error feedback** (the
  residual carries into the next round, so nothing is permanently lost),
* symmetric per-block int8 quantization of the surviving values.

``quantize_int8`` / ``dequantize_int8`` go through ``kernels/ops``: one
CUDA kernel launch each on the card (B9, B10), the plain PyTorch version
on the CPU.  Every result is bit-identical to the reference's jnp path.

Top-k selection takes the reference's two branches
(compression.py:111-162), decided once, in ``exact_topk``.  Small
problems (``k + 2^15 >= n``, ``n < 2^20`` or ``n % 32``) take a global
STABLE sort.  Larger ones run the blocked exact top-k (a port of
``repro/kernels/topk_mask.py``'s pipeline).  Global magnitude top-k needs
only the k-th magnitude, and the bits of a non-negative f32 are monotone
as an int32, so it runs on magnitude bits:

  1. the sampled bracket: a strided sample of 2^16 magnitude bits is
     sorted and a conservative lower bracket ``lo`` read off it
     (:121-130);
  2. B6, ``blocked_topk_stats``: ONE pass of packed candidate words and
     per-tile counts;
  3. ``refine`` (``topk_mask.py::_refine``, :173-209): the candidate
     positions from the words (popcount cumsum, a rank search, a 5-step
     bisection inside the word), their sort, the exact k-th magnitude
     ``tau``, the indices of the k largest, the tie budget and each
     tile's tie prefix;
  4. B7, ``threshold_sparsify_exact`` (only where kept and residual are
     wanted): ONE pass emitting them, exact-k under ties.

Where the bracket misses, the sort.  Either way the set is the exact
top-k, the lowest index winning a tie, so every branch returns the
reference's indices.  The blocked branch waits on the host once, for the
bracket check (``k <= c_lo <= k + MARGIN`` and ``lo > 0``), as the
reference's selection does (``int(jnp.sum(counts))``).  Knowing ``c_lo``
there, the candidate arrays have exactly ``c_lo`` entries, so they need
neither the reference's fixed ``k + MARGIN`` shape nor its sentinel for
unused slots.  ``lo``, ``tau`` and the budget reach the kernels as
one-element device tensors, so nothing else waits.

``compress_flat`` on the blocked branch also runs B7, the exact-k emit,
and takes its residual as the new error-feedback carry, writing
``sel - deq`` at the kept indices.  That is bit-identical to the
reference's ``flat.at[idx].add(-deq)``: off the index set B7's residual
is ``x - 0.0 == x`` (-0.0 stays -0.0), and on it ``sel - deq`` is written
over B7's zero.  It replaces a copy of the bus, at the price of B7's kept
output: 4n more bytes written (8.4 MB, ~2.5 us at 3.35 TB/s, on the
2,105,344-element bus of the pod runtime's compressed round).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.kernels import ops as K
from repro_torch.kernels import topk_mask as TM


class CompressedDelta(NamedTuple):
    values: torch.Tensor     # int8 quantized surviving values [k]
    scales: torch.Tensor     # f32 per-block scales [ceil(k / block)]
    indices: torch.Tensor    # int32 flat indices [k], ASCENDING (canonical)
    shape: tuple             # original shape
    density: float
    block: int = 256         # quantization block (the wire format ships it)


# the reference's selection constants (compression.py:72-74)
SAMPLE = 1 << 16            # strided threshold sample
MARGIN = 1 << 15            # candidate headroom above k
MIN_FAST_N = 16 * SAMPLE    # below this the global sort wins

_I32, _I64 = torch.int32, torch.int64


def magnitude_bits(x: torch.Tensor) -> torch.Tensor:
    """``bits(|x|)`` as int32: monotone in the magnitude."""
    return x.abs().view(_I32)


def popcount(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 held in an int64 tensor (SWAR; torch has no
    popcount)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) >> 24) & 0xFF


def sort_topk(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int32, ascending) of the k largest ``|flat|`` by a STABLE
    descending sort (equal magnitudes keep their index order: lowest index
    wins, as ``lax.top_k``)."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    return torch.sort(order[:k]).values.to(_I32)


def bracket(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The sampled lower bracket ``lo`` (int32 [1] on flat's device): the
    strided sample of magnitude bits sorted, read ``6 sigma + 64`` places
    below the sample's own k-th largest."""
    n = flat.numel()
    stride = n // SAMPLE
    sample = torch.sort(magnitude_bits(flat[::stride][:SAMPLE])).values
    frac = k / n
    sigma = int((SAMPLE * frac * (1.0 - frac)) ** 0.5) + 1
    off = min(SAMPLE - 1, (SAMPLE * k) // n + 6 * sigma + 64)
    return sample[SAMPLE - 1 - off:SAMPLE - off]


def refine(flat: torch.Tensor, words: torch.Tensor, c_lo: int, k: int):
    """From B6's words holding ``c_lo >= k`` candidates: (idx int32 [k],
    the indices of the k largest ascending; tau f32 [1], the exact k-th
    magnitude; tie_start int32 [nb], each tile's count of the surviving
    candidates' ties before it; budget int32 [1], the ties of tau kept) —
    B7's inputs.  All on flat's device, no host sync."""
    dev = flat.device
    # 1. the c_lo candidate positions, ascending: rank search over the
    #    words' popcount cumsum, then a 5-step bisection inside the word
    fw = words.reshape(-1).to(_I64) & 0xFFFFFFFF
    pc = popcount(fw)
    cum = torch.cumsum(pc, dim=0)
    ranks = torch.arange(1, c_lo + 1, dtype=_I64, device=dev)
    widx = torch.searchsorted(cum, ranks, right=False)     # jnp side="left"
    r_in = ranks - (cum - pc)[widx]
    word = fw[widx]
    pos = torch.zeros_like(r_in)
    for shift in (16, 8, 4, 2, 1):
        trial = pos + shift
        below = popcount(word & ((1 << trial) - 1))
        pos = torch.where(below < r_in, trial, pos)
    ext = widx * 32 + pos
    # 2. the exact k-th magnitude and the ties of it that survive
    xbits = magnitude_bits(flat[ext])
    srt = torch.sort(xbits).values
    tau_bits = srt[c_lo - k:c_lo - k + 1]
    c_le = torch.searchsorted(srt, tau_bits, right=True)   # jnp side="right"
    need = k - (c_lo - c_le)
    # 3. exact-k over the candidates: lowest index wins a tie
    tie = xbits == tau_bits
    tie_i = tie.to(_I64)
    keep = (xbits > tau_bits) | (tie & (torch.cumsum(tie_i, dim=0) - tie_i
                                        < need))
    at = torch.searchsorted(torch.cumsum(keep.to(_I64), dim=0),
                            torch.arange(1, k + 1, dtype=_I64, device=dev),
                            right=False)
    # 4. each tile's tie prefix (every tie of tau is a candidate: tau >= lo)
    nb = -(-flat.numel() // TM.BLOCK)
    per_tile = torch.zeros(nb, dtype=_I32, device=dev).index_add_(
        0, ext // TM.BLOCK, tie.to(_I32))
    tie_start = torch.cumsum(per_tile, dim=0, dtype=_I32) - per_tile
    return (ext[at].to(_I32), tau_bits.view(torch.float32), tie_start,
            need.to(_I32))


def exact_topk(flat: torch.Tensor, k: int, *, emit: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
    """The one selection of a contiguous 1-D f32 bus: (idx int32 [k]
    ascending, kept, residual).  kept and residual are B7's f32 [n]
    outputs where the blocked branch ran with ``emit``, else None.

    The small branch (the reference's guard, :111) and a missed bracket
    take the stable sort; a miss is known from B6's counts, so B6 runs
    once either way on a large bus."""
    n = flat.numel()
    if not (k + MARGIN >= n or n < MIN_FAST_N or n % 32):
        lo = bracket(flat, k)
        words, counts = K.blocked_topk_stats(flat, lo)
        c_lo, lo_bits = torch.stack([counts.sum(dtype=_I64),
                                     lo[0].to(_I64)]).tolist()
        if k <= c_lo <= k + MARGIN and lo_bits > 0:
            idx, tau, tie_start, budget = refine(flat, words, c_lo, k)
            if not emit:
                return idx, None, None
            kept, residual = K.threshold_sparsify_exact(flat, tau, tie_start,
                                                        budget)
            return idx, kept, residual
    return sort_topk(flat, k), None, None


def select_topk(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int32, ascending) of the exact k largest-|flat| entries.

    Deterministic under magnitude ties: the lowest flat indices win, as
    with ``lax.top_k``.  The blocked branch launches B6 once and no B7."""
    flat = flat.reshape(-1).to(torch.float32).contiguous()
    return exact_topk(flat, int(k), emit=False)[0]


def blocked_topk_sparsify(x: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k (kept, residual) of ``x`` (any shape): B6 ->
    refine -> B7 on the blocked branch, else the sort and a scatter.
    kept + residual == x exactly."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    idx, kept, residual = exact_topk(flat, int(k), emit=True)
    if kept is None:
        at = idx.long()
        kept = torch.zeros_like(flat)
        kept[at] = flat[at]
        residual = flat - kept
    return kept.reshape(x.shape), residual.reshape(x.shape)


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest-|x| entries, shaped like ``x``:
    exactly k set, a magnitude tie going to the lowest flat index."""
    mask = torch.zeros(x.numel(), dtype=torch.bool, device=x.device)
    mask[select_topk(x, k).long()] = True
    return mask.reshape(x.shape)


def residual_norm(r: torch.Tensor) -> float:
    """l2 norm of an error-feedback residual, accumulated in f64 and
    rounded once to f32: the value a frame header carries.  Within an
    f32 ulp or two of the reference's ``jnp.linalg.norm`` at any bus size
    (an f32 accumulation drifts by ~1e-5 relative at 2^21 elements)."""
    norm64 = float(torch.linalg.vector_norm(r.reshape(-1),
                                            dtype=torch.float64))
    return float(np.float32(norm64))


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
    # on the blocked branch B7's residual: flat off the index set
    idx, _, new_residual = exact_topk(flat.contiguous(), k, emit=True)
    if new_residual is None:
        new_residual = flat.clone()
    at = idx.long()
    sel = flat[at]
    q, scales = quantize_int8(sel, block)
    deq = dequantize_int8(q, scales, k, block)
    # error feedback: what was not transmitted, at the kept indices
    # (indices are unique, and IEEE a - b == a + (-b), the reference's
    # ``flat.at[idx].add(-deq)``)
    new_residual[at] = sel - deq
    payload = CompressedDelta(values=q, scales=scales, indices=idx,
                              shape=(flat.numel(),), density=density,
                              block=block)
    return payload, new_residual


def decompress_flat(p: CompressedDelta) -> torch.Tensor:
    """Rebuild the dense flat [padded] buffer from a global payload."""
    return decompress_delta(p)


def compress_delta(delta: torch.Tensor, *, density: float = 0.05,
                   block: int = 256) -> Tuple[CompressedDelta, torch.Tensor]:
    """Top-k + int8 on one tensor: ``compress_flat`` of the raveled tensor,
    the payload's shape and the residual back in the tensor's shape."""
    payload, residual = compress_flat(delta.reshape(-1), density=density,
                                      block=block)
    return (payload._replace(shape=tuple(delta.shape)),
            residual.reshape(delta.shape))


def compress_tree_global(delta_tree, *, density: float = 0.05,
                         block: int = 256,
                         residual: Optional[torch.Tensor] = None):
    """Whole-model compression of a delta TREE through the flat bus: one
    top-k over every leaf.  Returns (payload, new_residual_buf, spec);
    decompress with ``unflatten(FlatParams(decompress_flat(p), spec))``."""
    fp = F.flatten(delta_tree)
    payload, res = compress_flat(fp.buf, density=density, block=block,
                                 logical_n=fp.spec.n, residual=residual)
    return payload, res, fp.spec


def payload_bytes(p: CompressedDelta) -> int:
    return int(p.values.numel() + p.scales.numel() * 4
               + p.indices.numel() * 4)


def compression_ratio(p: CompressedDelta, dtype_bytes: int = 4) -> float:
    n = 1
    for s in p.shape:
        n *= int(s)
    return n * dtype_bytes / payload_bytes(p)
