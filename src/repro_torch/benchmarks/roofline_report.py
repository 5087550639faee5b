"""The per-kernel roofline table of the compression hot path (the
counterpart of the reference's ``benchmarks/roofline_report.py:205-283``),
with the same inputs' shapes and the same analytic byte floors, on the
card: each entry's measured time beside the least time the card could
take to move its floor's bytes at 3.35 TB/s, and the ratio of the two
(the roofline share).  The reference's entries — ``select_topk``,
``compress_flat``, ``threshold_sparsify`` (now B8 itself), ``pack_body``
(B12) and ``decompress_flat`` — plus ``quantize_pack`` (B11) and
``dc_lerp_flat`` (B4).

There is no ratchet file yet: the card has no baseline.  On the CPU the
table times the plain versions with the host clock and gives no share
(a CPU time is not a roofline share of the card).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.kernel_bench import (DENSITY, K_BENCH,
                                                 N_LOGICAL, N_PADDED, Timer,
                                                 bound_us, quantize_pack_bytes,
                                                 row)
from repro_torch.core import compression as C
from repro_torch.kernels import ops as K

_NG = -(-K_BENCH // 256)

Entry = Tuple[Callable, float]            # (the call, its floor in bytes)


def _inputs(device):
    """The bench bus: delta 0.02 N(0, 1), residual 0.002 N(0, 1) (numpy
    seed 7), and the payload ``compress_flat`` makes of them."""
    rng = np.random.default_rng(7)
    delta = torch.from_numpy((0.02 * rng.standard_normal(N_PADDED))
                             .astype(np.float32)).to(device)
    residual = torch.from_numpy((0.002 * rng.standard_normal(N_PADDED))
                                .astype(np.float32)).to(device)
    payload, _ = C.compress_flat(delta, density=DENSITY, logical_n=N_LOGICAL,
                                 residual=residual)
    return delta, residual, payload


def entries(device) -> Dict[str, Entry]:
    """name -> (the call, its analytic floor in bytes): each input read
    once, each output written once."""
    delta, residual, p = _inputs(device)
    body = float(K_BENCH + 4 * _NG + 4 * K_BENCH)
    sel = (delta + residual)[p.indices.long()]
    rng = np.random.default_rng(8)
    s, c, g, b = (torch.from_numpy(rng.standard_normal(N_PADDED)
                                   .astype(np.float32)).to(device)
                  for _ in range(4))
    return {
        # one streaming read of the magnitudes
        "select_topk": (lambda: C.select_topk(delta, K_BENCH),
                        4.0 * N_PADDED),
        # read delta and residual, write the residual (+ the payload)
        "compress_flat": (lambda: C.compress_flat(
            delta, density=DENSITY, logical_n=N_LOGICAL, residual=residual),
            12.0 * N_PADDED + 5.0 * K_BENCH + 4.0 * _NG),
        # read x, write kept and residual
        "threshold_sparsify": (lambda: K.threshold_sparsify(delta, 0.01),
                               12.0 * N_PADDED),
        # read the three sections, write the body
        "pack_body": (lambda: K.pack_body(p.values, p.scales, p.indices),
                      2.0 * body),
        # read the payload, write the dense buffer
        "decompress_flat": (lambda: C.decompress_flat(p),
                            4.0 * N_PADDED + 5.0 * K_BENCH + 4.0 * _NG),
        # read sel and idx, write body, padded q and scales
        "quantize_pack": (lambda: K.fused_quantize_pack(sel, p.indices),
                          float(quantize_pack_bytes(K_BENCH))),
        # read s, c, g, b, write the result
        "dc_lerp_flat": (lambda: K.fused_dc_lerp_flat(s, c, g, b, 0.9, 0.05),
                         20.0 * N_PADDED),
    }


def bench_roofline(device) -> Dict[str, dict]:
    """One row an entry: the measured us, the floor's bytes and its time
    at 3.35 TB/s, and (on the card) floor / measured."""
    tm = Timer(device)
    out = {}
    for name, (fn, floor) in entries(device).items():
        us, ln = tm.run(fn, 20)
        fl = bound_us(floor)
        share = (f"share={fl / us:.4f}" if tm.cuda
                 else "share=not-measured(cpu)")
        out[name] = row(us, f"floor={floor:.0f}B floor_us={fl:.3f} {share}",
                        ln)
        out[name].update(floor_bytes=floor, floor_us=fl,
                         share=fl / us if tm.cuda else None)
    return out
