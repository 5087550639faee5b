"""B9 (the int8 quantize, csrc/quantize.cu), B6 and B7 (the blocked
top-k's stats and exact-k emit, csrc/topk_mask.cu) and B5 (the elastic
EASGD round, csrc/vc_asgd_update.cu) built as variants, each held against
its plain version (probes excepted) and timed in turns with the others
on one card, at the sizes of their paths.

    python src/repro_torch/benchmarks/codec_variants.py \\
        [--variants q-base,q-cs,t-base,x-base,x-early,e-base] [--parent DIR]

Needs one CUDA card and nvcc.  Each variant is a copy of its kernel's
source under ``build/variants/`` with one change, built into its own
library (every nvcc started together; a variant nvcc refuses is reported
and left out, exit 1), and called through its C entry on tensors the tool
allocates, on the current stream:

* ``q-base``, ``t-base``, ``x-base``, ``e-base``: the sources as they
  are (B6 also with ``lo`` by value, ``t-base int lo``; B7 also with
  ``tau`` and the budget by value, ``x-base numbers``);
* ``q-cs``: B9 loading x and storing q with the evict-first hint
  (``__ldcs`` / ``__stcs``, as B11 does);
* ``t-t512``: B6 (and B7) with 512-thread tiles, 16 words a warp, the
  lanes past them storing nothing; ``x-t512`` the same edit, B7 timed
  (16 warps of 512 elements a tile);
* ``x-early``: B7's warps holding no tie of tau storing before the
  tile's barrier (they read no rank); ``x-cs``: B7 storing kept
  evict-first (``__stcs``: the round reads only the residual again);
  ``x-pack``: B7 as a lane holding 4 consecutive floats a step (16-byte
  loads and stores where x is 16-byte aligned, 8 steps a chunk, the ties
  of a step ranked by a ``__shfl_up_sync`` scan of the lanes' counts),
  with ``x-early``'s early stores; ``x-pack-noearly`` without them;
* ``e-cs``: B5 with evict-first loads and stores (``load_stream`` /
  ``store_stream``, B2's caching); ``e-csload`` evict-first loads only,
  ``e-csstore`` stores only;
* probes, not held to the plain version: ``q-nodiv`` quantizes by a
  product with the scale, no division a value (what the 8 IEEE divisions
  a lane cost), ``t-noload`` reads no x in B6 (each
  value made from its index), ``t-noballot`` takes each lane's own
  compare for the ballot, ``t-nowords`` stores no word (a store kept
  behind a test that never holds, so nothing is dead code).

``--parent DIR`` adds the ``quantize.cu``, ``topk_mask.cu`` and
``vc_asgd_update.cu`` of another checkout's
``src/repro_torch/kernels/csrc`` as ``q-parent``, ``t-parent``,
``x-parent`` and ``e-parent`` (with their own headers; a ``tk_exact``
without the by-value ``tau`` and budget is called as that tree's wrapper
calls it).

Prints each variant's ptxas lines, the card's ``nvidia-smi`` name and
power limit, then one JSON line:

* ``event_ms``: CUDA-event ms a call, ``ITERS`` back-to-back calls a
  timing at each size, the variants of one kernel and size in turns
  (forward, then backward order, ``variants.ROUNDS`` times) after a
  second's warm-up; a raw C call, no wrapper;
* ``graph_us``: device us a call at the path sizes (B9 k = 656 and
  105,075, B6 and B7 the bench bus, B5 16,384 with 3 replicas): 100
  calls captured in one CUDA graph and replayed, the kernel and the
  launch gap only; the variants in turns (forward, then backward
  order), the mean of the two;
* ``bound_ms``: bytes at 3.35 TB/s: 5k + 4 ng for B9, 4n + n / 8 + 4 nb
  for B6, 12n + 4 nb for B7, 8 (r + 1) n for B5 over r replicas;
* ``exact``: each non-probe variant's outputs equal to ``ref``'s, bit
  for bit, at every size (B7 also on a tie-heavy ragged bus whose budget
  cuts the ties of tau, B5 also with 9 replicas, the generic instance;
  a variant that is not is reported, exit 1);
* ``compress_ms``: where ``q-base`` and ``q-cs`` both built, CUDA-event
  ms of one ``compression.compress_flat`` (density 0.05, the wrapper's C
  entry swapped for the variant's) on the bench bus and on 2^27, the two
  in turns: what the quantize's caching costs the dequantize and the
  error feedback after it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

B9_KS = (656, 105_075, 6_710_886)      # upload leg, bench bus, 2^27 at 0.05
B6_NS = (2_105_344, 1 << 27)           # the bench bus, 2^27 (B7 too)
B7_TIES_N = (1 << 20) + 4128           # B7's exactness: ties, ragged
B5_NS = (16_384, 1 << 27)              # the MLP bus, 2^27
B5_REPLICAS, B5_GENERIC, BETA = 3, 9, 0.05
GRAPHED = {"q": (656, 105_075), "t": (2_105_344,), "x": (2_105_344,),
           "e": (16_384,)}
ITERS = {656: 50, 105_075: 50, 6_710_886: 10, 2_105_344: 50, 1 << 27: 10,
         16_384: 50}
HBM_BYTES_PER_S = 3.35e12
QBLOCK, TILE = 256, 8192
SOURCE = {"q": "quantize", "t": "topk_mask", "x": "topk_mask",
          "e": "vc_asgd_update"}
PROBES = ("q-nodiv", "t-noload", "t-noballot", "t-nowords")
# q-nodiv's byte: x times the scale, rounded and narrowed, no division
_MUL_BYTE = ("static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>("
             "rintf(v[{j}] * s)))) << (8 * j)")
# 512-thread tiles: 16 warps of 512 elements, B6's lanes past its 16 words
# storing nothing
_T512 = [(r"constexpr int kTileThreads = 256;",
          "constexpr int kTileThreads = 512;", 1),
         (r"(\n  )(words\[static_cast<int64_t>\(blockIdx\.x\))",
          r"\1if (lane < kSteps) \2", 1)]
# B7's warps without a tie of tau storing before the tile's barrier
_EARLY_EMIT = """  if (ties == 0) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float k = fabsf(v[s]) > tau ? v[s] : 0.0f;
      const int64_t i = chunk + s * 32 + lane;
      if (i < n) {
        kept[i] = k;
        residual[i] = __fsub_rn(v[s], k);
      }
    }
  }
"""
# B7 as a lane holding 4 consecutive floats a step (16-byte loads and
# stores where x is 16-byte aligned, 8 steps a chunk), its warps without a
# tie of tau storing before the barrier, the others ranking their ties by
# a __shfl_up_sync scan of the lanes' tie counts
_PACK_WALK = r"""constexpr int kPack = 4;                     // floats a lane a step
constexpr int kPackSteps = kSteps / kPack;   // 8 steps a chunk
using F4 = Pack<float, kPack>;

// a lane's kPack floats at element i0: one 16-byte load where the grid
// moves packs (vec) and the pack lies below n, else value by value with
// the reference's zero padding past n
__device__ __forceinline__ void load_pack(const float* __restrict__ x,
                                          int64_t i0, int64_t n, bool vec,
                                          float (&v)[kPack]) {
  if (vec && i0 + kPack <= n) {
    const F4 p = *reinterpret_cast<const F4*>(x + i0);
#pragma unroll
    for (int j = 0; j < kPack; ++j) v[j] = p.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < kPack; ++j) v[j] = i0 + j < n ? x[i0 + j] : 0.0f;
  }
}

// kept (the values v where keep) and residual = v - kept at element i0,
// stored as load_pack reads: a 16-byte pack each, or the values below n
__device__ __forceinline__ void emit_pack(float* __restrict__ kept,
                                          float* __restrict__ residual,
                                          int64_t i0, int64_t n, bool vec,
                                          const float (&v)[kPack],
                                          const bool (&keep)[kPack]) {
  F4 kp, rp;
#pragma unroll
  for (int j = 0; j < kPack; ++j) {
    kp.v[j] = keep[j] ? v[j] : 0.0f;
    rp.v[j] = __fsub_rn(v[j], kp.v[j]);
  }
  if (vec && i0 + kPack <= n) {
    *reinterpret_cast<F4*>(kept + i0) = kp;
    *reinterpret_cast<F4*>(residual + i0) = rp;
  } else {
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      if (i0 + j < n) {
        kept[i0 + j] = kp.v[j];
        residual[i0 + j] = rp.v[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
exact_kernel(const float* __restrict__ x, const float* __restrict__ tau_p,
             float tau_v, const int32_t* __restrict__ budget_p,
             int32_t budget_v, const int32_t* __restrict__ tie_start,
             float* __restrict__ kept, float* __restrict__ residual,
             int64_t n) {
  __shared__ int warp_ties[kWarps];
  const float tau = tau_p != nullptr ? *tau_p : tau_v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(kept) |
                     reinterpret_cast<uintptr_t>(residual)) & 15) == 0;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kBlock +
                        warp * (kSteps * 32);
  // 1. the lane's packs and the chunk's ties
  float v[kPackSteps][kPack];
  int lane_ties = 0;
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    load_pack(x, chunk + (s * 32 + lane) * kPack, n, vec, v[s]);
#pragma unroll
    for (int j = 0; j < kPack; ++j) lane_ties += fabsf(v[s][j]) == tau;
  }
  const int ties = __reduce_add_sync(0xffffffffu, lane_ties);
  if (lane == 0) warp_ties[warp] = ties;
  // 2. a chunk with no tie of tau reads no rank: emit before the barrier
  if (ties == 0) {
#pragma unroll
    for (int s = 0; s < kPackSteps; ++s) {
      bool keep[kPack];
#pragma unroll
      for (int j = 0; j < kPack; ++j) keep[j] = fabsf(v[s][j]) > tau;
      emit_pack(kept, residual, chunk + (s * 32 + lane) * kPack, n, vec,
                v[s], keep);
    }
  }
  __syncthreads();
  if (ties == 0) return;
  // 3. a chunk with ties: its first tie's rank from the scan over the
  //    tile's earlier warps, then each tie's rank inside the chunk
  const int budget = budget_p != nullptr ? *budget_p : budget_v;
  int rank0 = tie_start[blockIdx.x];
  for (int w = 0; w < warp; ++w) rank0 += warp_ties[w];
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    bool tie[kPack], keep[kPack];
    int t = 0;
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      tie[j] = fabsf(v[s][j]) == tau;
      t += tie[j];
    }
    int incl = t;                      // the ties of lanes 0..lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    int rank = rank0 + incl - t;
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      keep[j] = fabsf(v[s][j]) > tau || (tie[j] && rank < budget);
      rank += tie[j];
    }
    emit_pack(kept, residual, chunk + (s * 32 + lane) * kPack, n, vec, v[s],
              keep);
    rank0 += __shfl_sync(0xffffffffu, incl, 31);
  }
}
"""
_PACK = (r"(?s)__global__ void __launch_bounds__\(kTileThreads\)\n"
         r"exact_kernel\(.*?\n\}\n", lambda m: _PACK_WALK, 1)
_NOEARLY = [(r"if \(ties == 0\) \{", "if (false) {", 1),
            (r"\n  if \(ties == 0\) return;", "", 1)]
# B5's loads (center, then the replicas on each path) and stores, each
# made evict-first (load_stream / store_stream, B2's caching)
_E_LOAD = [(r"reinterpret_cast<const P\*>\(c\)\[i\]",
            "load_stream(reinterpret_cast<const P*>(c) + i)", 1),
           (r"xv\[j\] = xp\[j \* nvec\];",
            "xv[j] = load_stream(xp + j * nvec);", 1),
           (r"easgd_replica\(xp\[j \* nvec\],",
            "easgd_replica(load_stream(xp + j * nvec),", 1)]
_E_STORE = [(r"xop\[j \* nvec\] = (easgd_replica\([^;]*\));",
             r"store_stream(xop + j * nvec, \1);", 2),
            (r"reinterpret_cast<P\*>\(co\)\[i\] = ov;",
             "store_stream(reinterpret_cast<P*>(co) + i, ov);", 1)]
# variant -> (pattern, replacement, matches) edits of its kernel's source
EDITS = {
    "q-base": [], "t-base": [], "x-base": [], "e-base": [],
    "q-cs": [(r"load_lane8<false>\(", "load_lane8<true>(", 1),
             (r"\*reinterpret_cast<uint2\*>\(q \+ i0\) = w;",
              "__stcs(reinterpret_cast<uint2*>(q + i0), w);", 1)],
    "q-nodiv": [(r"const uint2 w = lane8_bytes\(v, s\);",
                 "uint2 w = make_uint2(0u, 0u);\n"
                 "    for (int j = 0; j < 4; ++j) {\n"
                 f"      w.x |= {_MUL_BYTE.format(j='j')};\n"
                 f"      w.y |= {_MUL_BYTE.format(j='j + 4')};\n    }}", 1)],
    "t-t512": _T512,
    "x-t512": _T512,
    "x-early": [(r"(  if \(lane == 0\) warp_ties\[warp\] = ties;\n)"
                 r"(  __syncthreads\(\);\n)",
                 lambda m: m.group(1) + _EARLY_EMIT + m.group(2)
                 + "  if (ties == 0) return;\n", 1)],
    "x-cs": [(r"kept\[i\] = k;", "__stcs(kept + i, k);", 1)],
    "x-pack": [_PACK],
    "x-pack-noearly": [_PACK, *_NOEARLY],
    "e-cs": _E_LOAD + _E_STORE,
    "e-csload": _E_LOAD,
    "e-csstore": _E_STORE,
    # B7's loads change too; only B6 is timed
    "t-noload": [(r"v\[s\] = i < n \? x\[i\] : 0\.0f;",
                  "v[s] = __uint_as_float(static_cast<uint32_t>(i) * "
                  "2654435761u);", 2)],
    "t-noballot": [(r"__ballot_sync\(0xffffffffu,\s*"
                    r"\(__float_as_uint\(v\[s\]\) & 0x7fffffffu\) >= lo\)",
                    "((__float_as_uint(v[s]) & 0x7fffffffu) >= lo ? "
                    "0xffffffffu : 0u)", 1)],
    "t-nowords": [(r"(\n  )(words\[static_cast<int64_t>\(blockIdx\.x\))",
                   r"\1if (mine == 0x9e3779b9u) \2", 1)],
}


def variant_source(src: str, name: str) -> str:
    for pattern, repl, count in EDITS[name]:
        src, n = re.subn(pattern, repl, src)
        if n != count:
            raise RuntimeError(f"{name}: {pattern!r} found {n} times")
    return src


def bind(lib: ctypes.CDLL, kind: str, src: str):
    """The C entry of ``kind`` ("q", "t", "x" or "e") with its argtypes,
    and whether it takes its scalars by value (B6's ``lo``, B7's ``tau``
    and budget: this tree's form)."""
    P, I64, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    by_value = False
    if kind == "q":
        fn = lib.qz_quantize
        fn.argtypes = [P, P, P, I64, ctypes.c_int, P]
    elif kind == "t":
        fn = lib.tk_stats
        by_value = re.search(r"int tk_stats\([^)]*uint32_t lo_v",
                             src) is not None
        fn.argtypes = ([P, P, ctypes.c_uint32, P, P, I64, P] if by_value
                       else [P, P, P, P, I64, P])
    elif kind == "x":
        fn = lib.tk_exact
        by_value = re.search(r"int tk_exact\([^)]*float tau_v",
                             src) is not None
        fn.argtypes = ([P, P, F, P, ctypes.c_int32, P, P, P, I64, P]
                       if by_value else [P, P, P, P, P, P, I64, P])
    else:
        fn = lib.vc_easgd_f32
        fn.argtypes = [P, P, P, P, F, ctypes.c_int, I64, P]
    fn.restype = ctypes.c_int
    return fn, by_value


def build_all(names, parent, out_dir: Path, csrc: Path):
    from repro_torch.benchmarks import variants as V
    from repro_torch.kernels import build as B
    jobs, sources = {}, {}
    for name in names:
        text = variant_source((csrc / f"{SOURCE[name[0]]}.cu").read_text(),
                              name)
        path = out_dir / f"{SOURCE[name[0]]}-{name}.cu"
        out_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        jobs[name], sources[name] = path, text
    built, refused = V.build(jobs, out_dir, B.nvcc(), B.ARCH_FLAGS, csrc)
    if parent:
        stems = sorted(set(SOURCE.values()))
        more, bad = V.build({st: Path(parent) / f"{st}.cu" for st in stems},
                            out_dir / "parent", B.nvcc(), B.ARCH_FLAGS,
                            Path(parent))
        refused.update(bad)
        for kind, st in SOURCE.items():          # one build a source
            if st in more:
                built[f"{kind}-parent"] = more[st]
                sources[f"{kind}-parent"] = (Path(parent)
                                             / f"{st}.cu").read_text()
    return built, refused, sources


def compress_in_turns(torch, g, entries: dict) -> dict:
    """{size: {variant: ms}}: compress_flat at density 0.05 with B9's C
    entry swapped for each variant's, the variants in turns."""
    from repro_torch.benchmarks import variants as V
    from repro_torch.core import compression as C
    from repro_torch.kernels import quantize as QK
    QK._library()
    shipped = QK._quantize
    out = {}
    try:
        for n in B6_NS:
            bus = torch.randn(n, generator=g, device="cuda") * 0.02

            def run(fn, bus=bus):
                QK._quantize = fn
                C.compress_flat(bus, density=0.05)

            out[f"n={n}"] = V.event_ms(
                torch, {name: (lambda fn=fn: run(fn))
                        for name, fn in entries.items()}, 5)
            del bus
            torch.cuda.empty_cache()
    finally:
        QK._quantize = shipped
    return out


def exact_sizes(torch, g, C, R, n: int, xv: dict, record, rec: dict,
                bad: list, stream, ties: bool) -> None:
    """B7's variants at bus size n: held to the plain version on the
    selection's own tau, tie_start and budget (``ties``: a bus of N(0, 1)
    rounded to quarters, its budget cutting the ties of tau across tiles,
    exactness only), then timed in turns."""
    x = torch.randn(n, generator=g, device="cuda")
    x = torch.round(4 * x) / 4 if ties else x * 0.02
    k = int(n * 0.05)
    words, counts = R.blocked_topk_stats(x, C.bracket(x, k))
    _, tau, tie_start, budget = C.refine(x, words, int(counts.sum()), k)
    pk, pr = R.threshold_sparsify_exact(x, tau, tie_start, budget)
    tau_v, bud_v = float(tau), int(budget)
    calls = {}
    for name, (fn, by_value) in xv.items():
        kept = torch.empty_like(x)
        res = torch.empty_like(x)
        ptrs = (x.data_ptr(), tau.data_ptr(), budget.data_ptr(),
                tie_start.data_ptr(), kept.data_ptr(), res.data_ptr())
        xp, tp, bp, tsp, kp, rp = ptrs
        forms = {name: ((xp, tp, 0.0, bp, 0, tsp, kp, rp, n) if by_value
                        else (xp, tp, bp, tsp, kp, rp, n))}
        if by_value and name == "x-base":
            forms[f"{name} numbers"] = (xp, None, tau_v, None, bud_v, tsp, kp,
                                        rp, n)
        for label, a in forms.items():
            call = lambda fn=fn, a=a, kept=kept, res=res: fn(*a, stream())
            if call() != 0:
                raise RuntimeError(f"{label} n={n}: launch failed")
            torch.cuda.synchronize()
            ok = (torch.equal(kept.view(torch.int32), pk.view(torch.int32))
                  and torch.equal(res.view(torch.int32), pr.view(torch.int32)))
            rec["exact"][f"{label} n={n}{' ties' if ties else ''}"] = ok
            if not ok:
                bad.append(f"{label} n={n}")
            calls[label] = call
    if not ties:
        nb = tie_start.numel()
        rec["bound_ms"][f"B7 n={n}"] = 1e3 * (12 * n + 4 * nb) / HBM_BYTES_PER_S
        record(f"n={n}", calls, n in GRAPHED["x"], ITERS[n])


def easgd_sizes(torch, g, R, n: int, ev: dict, record, rec: dict,
                bad: list, stream) -> None:
    """B5's variants at bus size n over B5_REPLICAS replicas (and, at the
    MLP bus, B5_GENERIC, exactness only): held to the plain version, then
    timed in turns."""
    c = torch.randn(n, generator=g, device="cuda")
    counts = (B5_REPLICAS, B5_GENERIC) if n < 1 << 20 else (B5_REPLICAS,)
    for r in counts:
        x = torch.randn(r, n, generator=g, device="cuda")
        pc, px = R.easgd_elastic(c, x, BETA)
        calls = {}
        for name, fn in ev.items():
            co, xo = torch.empty_like(c), torch.empty_like(x)
            a = (c.data_ptr(), x.data_ptr(), co.data_ptr(), xo.data_ptr(),
                 BETA, r, n)
            call = lambda fn=fn, a=a, co=co, xo=xo: fn(*a, stream())
            if call() != 0:
                raise RuntimeError(f"{name} n={n} r={r}: launch failed")
            torch.cuda.synchronize()
            ok = torch.equal(co, pc) and torch.equal(xo, px)
            rec["exact"][f"{name} n={n} r={r}"] = ok
            if not ok:
                bad.append(f"{name} n={n} r={r}")
            calls[name] = call
        if r == B5_REPLICAS:
            rec["bound_ms"][f"B5 n={n} r={r}"] = (1e3 * 8 * (r + 1) * n
                                                  / HBM_BYTES_PER_S)
            record(f"n={n} r={r}", calls, n in GRAPHED["e"], ITERS[n])
        del x, pc, px, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(EDITS),
                    help="comma-separated variant names (see the module note)")
    ap.add_argument("--parent", default="",
                    help="another checkout's kernels/csrc directory")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("codec_variants needs a CUDA card")
    from repro_torch.benchmarks import variants as V
    from repro_torch.benchmarks.wrapper_cost import graph_us
    from repro_torch.core import compression as C
    from repro_torch.kernels import build as B
    from repro_torch.kernels import launches as LA
    from repro_torch.kernels import ref as R

    names = [n for n in args.variants.split(",") if n]
    for n in names:
        if n not in EDITS:
            raise SystemExit(f"unknown variant {n!r}")
    root = Path(__file__).resolve().parents[3]
    built, refused, sources = build_all(names, args.parent,
                                        root / "build" / "variants" / "codec",
                                        B.CSRC)
    V.ptxas_lines(built)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = {n: bind(ctypes.CDLL(str(lib)), n[0], sources[n])
            for n, (lib, _) in built.items()}
    stream = lambda: LA._raw_stream(0)
    g = torch.Generator(device="cuda").manual_seed(23)
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "event_ms": {}, "graph_us": {}, "bound_ms": {}, "exact": {}}
    bad = list(refused)

    def record(size_key: str, calls: dict, graphed: bool, iters: int):
        ms = V.event_ms(torch, calls, iters)
        for name, t in ms.items():
            rec["event_ms"].setdefault(name, {})[size_key] = t
        if graphed:                    # in turns: forward, then backward
            names = list(calls)
            us = {name: [] for name in names}
            for name in names + names[::-1]:
                us[name].append(graph_us(torch, calls[name]))
            for name, v in us.items():
                rec["graph_us"].setdefault(name, {})[size_key] = sum(v) / 2

    # B9
    qv = {n: fn for n, (fn, _) in libs.items() if n[0] == "q"}
    for k in B9_KS if qv else ():
        ng = -(-k // QBLOCK)
        x = torch.randn(k, generator=g, device="cuda") * 0.01
        x[k // 3] = 0.0
        pq, ps = R.quantize_int8(x)
        calls = {}
        for name, fn in qv.items():
            probe = name in PROBES
            q = torch.empty(k, dtype=torch.int8, device="cuda")
            s = torch.empty(ng, dtype=torch.float32, device="cuda")
            ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr())
            call = (lambda fn=fn, ptrs=ptrs, q=q, s=s:
                    fn(*ptrs, k, QBLOCK, stream()))
            if call() != 0:
                raise RuntimeError(f"{name} k={k}: launch failed")
            torch.cuda.synchronize()
            ok = torch.equal(q, pq) and torch.equal(s.view(torch.int32),
                                                    ps.view(torch.int32))
            if not probe:
                rec["exact"][f"{name} k={k}"] = ok
                if not ok:
                    bad.append(f"{name} k={k}")
            calls[name] = call
        rec["bound_ms"][f"B9 k={k}"] = 1e3 * (5 * k + 4 * ng) / HBM_BYTES_PER_S
        record(f"k={k}", calls, k in GRAPHED["q"], ITERS[k])
        del x, pq, ps, calls
    # B6
    tv = {n: v for n, v in libs.items() if n[0] == "t"}
    for n in B6_NS if tv else ():
        nb = -(-n // TILE)
        x = torch.randn(n, generator=g, device="cuda") * 0.02
        lo = C.bracket(x, int(n * 0.05))
        lo_v = int(lo) & 0xFFFFFFFF
        pw, pc = R.blocked_topk_stats(x, lo)
        calls = {}
        for name, (fn, by_value) in tv.items():
            w = torch.empty((nb, TILE // 32), dtype=torch.int32, device="cuda")
            c = torch.empty(nb, dtype=torch.int32, device="cuda")
            xp, lp, wp, cp = (t.data_ptr() for t in (x, lo, w, c))
            forms = {name: ((xp, lp, 0, wp, cp, n) if by_value
                            else (xp, lp, wp, cp, n))}
            if by_value and name == "t-base":
                forms[f"{name} int lo"] = (xp, None, lo_v, wp, cp, n)
            for label, a in forms.items():
                call = lambda fn=fn, a=a, w=w, c=c: fn(*a, stream())
                if call() != 0:
                    raise RuntimeError(f"{label} n={n}: launch failed")
                torch.cuda.synchronize()
                ok = torch.equal(w, pw) and torch.equal(c, pc)
                if name not in PROBES:
                    rec["exact"][f"{label} n={n}"] = ok
                    if not ok:
                        bad.append(f"{label} n={n}")
                calls[label] = call
        rec["bound_ms"][f"B6 n={n}"] = (1e3 * (4 * n + n / 8 + 4 * nb)
                                        / HBM_BYTES_PER_S)
        record(f"n={n}", calls, n in GRAPHED["t"], ITERS[n])
        del x, lo, pw, pc, calls
        torch.cuda.empty_cache()
    # B7
    xv = {n: v for n, v in libs.items() if n[0] == "x"}
    for n in (B7_TIES_N, *B6_NS) if xv else ():
        exact_sizes(torch, g, C, R, n, xv, record, rec, bad, stream,
                    ties=n == B7_TIES_N)
        torch.cuda.empty_cache()
    # B5
    ev = {n: fn for n, (fn, _) in libs.items() if n[0] == "e"}
    for n in B5_NS if ev else ():
        easgd_sizes(torch, g, R, n, ev, record, rec, bad, stream)
        torch.cuda.empty_cache()
    if "q-base" in qv and "q-cs" in qv:
        rec["compress_ms"] = compress_in_turns(
            torch, g, {n: qv[n] for n in ("q-base", "q-cs")})
    print(json.dumps(rec), flush=True)
    if bad:
        print(f"refused or not exact: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
