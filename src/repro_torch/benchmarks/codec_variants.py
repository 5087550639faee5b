"""B9 (the int8 quantize, csrc/quantize.cu) and B6 (the blocked top-k
stats, csrc/topk_mask.cu) built as variants, each held against its plain
version (probes excepted) and timed in turns with the others on one card,
at the sizes of their paths.

    python src/repro_torch/benchmarks/codec_variants.py \\
        [--variants q-base,q-cs,t-base,t-noload] [--parent DIR]

Needs one CUDA card and nvcc.  Each variant is a copy of its kernel's
source under ``build/variants/`` with one change, built into its own
library (every nvcc started together; a variant nvcc refuses is reported
and left out, exit 1), and called through its C entry on tensors the tool
allocates, on the current stream:

* ``q-base``, ``t-base``: the sources as they are (B6 also with ``lo`` by
  value, ``t-base int lo``);
* ``q-cs``: B9 loading x and storing q with the evict-first hint
  (``__ldcs`` / ``__stcs``, as B11 does);
* ``t-t512``: B6 (and B7) with 512-thread tiles, 16 words a warp, the
  lanes past them storing nothing;
* probes, not held to the plain version: ``q-nodiv`` quantizes by a
  product with the scale, no division a value (what the 8 IEEE divisions
  a lane cost), ``t-noload`` reads no x (each
  value made from its index), ``t-noballot`` takes each lane's own
  compare for the ballot, ``t-nowords`` stores no word (a store kept
  behind a test that never holds, so nothing is dead code).

``--parent DIR`` adds the ``quantize.cu`` and ``topk_mask.cu`` of another
checkout's ``src/repro_torch/kernels/csrc`` as ``q-parent`` and
``t-parent`` (with their own headers; a ``tk_stats`` without the by-value
``lo`` is called as that tree's wrapper calls it).

Prints each variant's ptxas lines, the card's ``nvidia-smi`` name and
power limit, then one JSON line:

* ``event_ms``: CUDA-event ms a call, ``ITERS`` back-to-back calls a
  timing at each size, the variants of one kernel and size in turns
  (forward, then backward order, ``variants.ROUNDS`` times) after a
  second's warm-up; a raw C call, no wrapper;
* ``graph_us``: device us a call at the path sizes (B9 k = 656 and
  105,075, B6 the bench bus): 100 calls captured in one CUDA graph and
  replayed, the kernel and the launch gap only;
* ``bound_ms``: bytes at 3.35 TB/s: 5k + 4 ng for B9, 4n + n / 8 + 4 nb
  for B6;
* ``exact``: each non-probe variant's outputs equal to ``ref``'s, bit
  for bit, at every size (a variant that is not is reported, exit 1);
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
B6_NS = (2_105_344, 1 << 27)           # the bench bus, 2^27
GRAPHED = {"q": (656, 105_075), "t": (2_105_344,)}
ITERS = {656: 50, 105_075: 50, 6_710_886: 10, 2_105_344: 50, 1 << 27: 10}
HBM_BYTES_PER_S = 3.35e12
QBLOCK, TILE = 256, 8192
SOURCE = {"q": "quantize", "t": "topk_mask"}
PROBES = ("q-nodiv", "t-noload", "t-noballot", "t-nowords")
# q-nodiv's byte: x times the scale, rounded and narrowed, no division
_MUL_BYTE = ("static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>("
             "rintf(v[{j}] * s)))) << (8 * j)")
# variant -> (pattern, replacement, matches) edits of its kernel's source
EDITS = {
    "q-base": [], "t-base": [],
    "q-cs": [(r"load_lane8<false>\(", "load_lane8<true>(", 1),
             (r"\*reinterpret_cast<uint2\*>\(q \+ i0\) = w;",
              "__stcs(reinterpret_cast<uint2*>(q + i0), w);", 1)],
    "q-nodiv": [(r"const uint2 w = lane8_bytes\(v, s\);",
                 "uint2 w = make_uint2(0u, 0u);\n"
                 "    for (int j = 0; j < 4; ++j) {\n"
                 f"      w.x |= {_MUL_BYTE.format(j='j')};\n"
                 f"      w.y |= {_MUL_BYTE.format(j='j + 4')};\n    }}", 1)],
    "t-t512": [(r"constexpr int kTileThreads = 256;",
                "constexpr int kTileThreads = 512;", 1),
               (r"(\n  )(words\[static_cast<int64_t>\(blockIdx\.x\))",
                r"\1if (lane < kSteps) \2", 1)],
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
    """The C entry of ``kind`` ("q" or "t") with its argtypes, and whether
    a tk_stats takes ``lo`` by value (this tree's form)."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    if kind == "q":
        fn = lib.qz_quantize
        fn.argtypes = [P, P, P, I64, ctypes.c_int, P]
        by_value = False
    else:
        fn = lib.tk_stats
        by_value = re.search(r"int tk_stats\([^)]*uint32_t lo_v",
                             src) is not None
        fn.argtypes = ([P, P, ctypes.c_uint32, P, P, I64, P] if by_value
                       else [P, P, P, P, I64, P])
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
        pjobs = {f"{k}-parent": Path(parent) / f"{SOURCE[k]}.cu"
                 for k in SOURCE}
        more, bad = V.build(pjobs, out_dir / "parent", B.nvcc(),
                            B.ARCH_FLAGS, Path(parent))
        built.update(more)
        refused.update(bad)
        sources.update({n: p.read_text() for n, p in pjobs.items()})
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
            if graphed:
                rec["graph_us"].setdefault(name, {})[size_key] = graph_us(
                    torch, calls[name])

    # B9
    qv = {n: fn for n, (fn, _) in libs.items() if n[0] == "q"}
    for k in B9_KS:
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
    for n in B6_NS:
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
    if "q-base" in qv and "q-cs" in qv:
        rec["compress_ms"] = compress_in_turns(
            torch, g, {n: qv[n] for n in ("q-base", "q-cs")})
    print(json.dumps(rec), flush=True)
    if bad:
        print(f"refused or not exact: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
