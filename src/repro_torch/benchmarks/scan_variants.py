"""B15 (the selective scan, csrc/mamba_scan.cu) built with other constants,
each held against the plain version and timed in turns with the others
on one card.

    python src/repro_torch/benchmarks/scan_variants.py \\
        [--variants base,s4+mb8,exp2] [--parent DIR] [--iters N] [--sass]

Needs one CUDA card and nvcc.  Each variant is a copy of
``csrc/mamba_scan.cu`` under ``build/variants/`` with its changes joined
by ``+`` (``s4+mb8``): ``mbN`` sets kMinBlocks (blocks an SM the
launch bound asks for, so 65,536 / (128 N) registers a thread), ``cN``
kChunk (steps a chunk), ``sN`` kStates (states a lane: s8 is 2 lanes a
channel at ds 16, s4 four, s16 one), ``tN`` kThreads; ``exp2`` takes
exp2f of dt * (A * log2 e) for expf of dt * A, A scaled once as it is
loaded.  A probe leaves a part out, to see what it costs: ``noexp``
takes 1 + dt * A for the exp, ``nobc`` reads no B or C from shared
memory (it takes dt and u in their place), ``nostage`` copies nothing
into the shared tiles, ``nosteps`` runs no step of the scan (staging,
sums and stores only), ``nobar2`` drops the barrier between a chunk's y
tile and its stores; a probe's output is not held to the plain version.
``base`` is the source as it is; all nvcc processes start together,
and a variant nvcc refuses is reported and left out (exit 1).
``--parent`` adds the ``mamba_scan.cu`` of another checkout's
``src/repro_torch/kernels/csrc`` as the variant ``parent`` (the same C
entry; ``NAME=DIR`` names it, and the option may be given more than
once).  ``--sass`` counts each library's SASS instructions by kernel
(``cuobjdump -sass``): all, MUFU, FP32 (FFMA, FMUL, FADD), LDS, SHFL,
local (spill) loads and stores.
Prints each variant's ptxas lines, then one JSON line:

* ``ms``: CUDA-event milliseconds a call at chip_smoke.py phase 8a's
  jamba shapes (a: contiguous B / C, d: B / C as column views), ``iters``
  calls a timing, the variants in turns (forward, then backward order,
  ``variants.ROUNDS`` times), the mean kept;
* ``share``: the shape's bound (the SFU's exps at 16 a clock an SM at
  the card's maximum SM clock, or bytes at 3.35 TB/s, the larger) over
  the time;
* ``max_abs_err``: y and the final state against ``ref.mamba_scan`` at
  every 8a shape and at di 200 (a ragged block, B / C as views, f32); a variant beyond 8a's
  ``SCAN_TOL`` (2e-5 f32, 2e-2 bf16 y; 2e-5 h_T) is reported and not
  timed (exit 1).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

# chip_smoke.py phase 8a's shapes: (b, T, di, ds, u dtype, B / C as views)
SHAPES = {
    "a jamba prefill": (4, 2048, 8192, 16, "bfloat16", False),
    "b reduced ragged": (2, 37, 128, 4, "float32", False),
    "c T=1": (4, 1, 8192, 16, "bfloat16", False),
    "d strided views": (4, 2048, 8192, 16, "bfloat16", True),
    "e ragged di": (2, 300, 200, 16, "float32", True),
}
TIMED = ("a jamba prefill", "d strided views")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK = 16
CONSTANTS = {"mb": "kMinBlocks", "c": "kChunk", "s": "kStates",
             "t": "kThreads"}
LOG2E = "1.4426950408889634f"
# probe -> (pattern, replacement, matches) edits of the source
PROBES = {
    "noexp": [(r"expf\((dtv \* A\[[^]]*\])\)", r"(1.0f + \g<1>)", 1)],
    "nobc": [(r"\*reinterpret_cast<const float4\*>\(\s*&sbc\[buf\]\[i\]"
              r"\[[^]]*\]\)", "make_float4(dtv, uv, uv, dtv)", 2)],
    "nostage": [(r"\bstage\([^;]*\);", "copy_commit();", 2)],
    "nosteps": [(r"(const float dtv = sdt\[buf\]\[i\]\[c\], "
                 r"uv = to_f32\(su\[buf\]\[i\]\[c\]\);)",
                 r"\g<1>\n      if (P.seq > 0) { p[i] = dtv + uv; continue; }",
                 1)],
    "nobar2": [(r"(__syncthreads\(\);(?:.|\n)*?)__syncthreads\(\);",
                r"\g<1>;", 1)],
}


def variant_source(src: str, mods: list) -> str:
    """``src`` with each of ``mods`` applied (see the module note)."""
    for m in mods:
        if m == "base":
            continue
        if m in PROBES:
            for pattern, repl, count in PROBES[m]:
                src, n = re.subn(pattern, repl, src)
                if n != count:
                    raise RuntimeError(f"{m}: {pattern!r} found {n} times")
            continue
        if m == "exp2":
            src, n1 = re.subn(r"expf\(dtv \* A\[", "exp2f(dtv * A[", src)
            src, n2 = re.subn(r"(A\[s\] = live \? P\.A\[[^]]*\])",
                              rf"\g<1> * {LOG2E}", src)
            if n1 != 1 or n2 != 1:
                raise RuntimeError("exp2: the exp or A's load not found")
            continue
        key = re.match(r"[a-z]+", m).group(0)
        if key not in CONSTANTS or not m[len(key):].isdigit():
            raise ValueError(f"unknown variant change {m!r}")
        src, n = re.subn(rf"(constexpr int {CONSTANTS[key]} = )\d+",
                         rf"\g<1>{m[len(key):]}", src)
        if n != 1:
            raise RuntimeError(f"{CONSTANTS[key]} not found in mamba_scan.cu")
    return src


def build(variants, parent, out_dir: Path, nvcc, arch, csrc: Path):
    """({name: (library path, nvcc output)}, {name: nvcc output of a
    variant that did not build}), every nvcc started together; each
    ``--parent`` source builds under its own directory."""
    from repro_torch.benchmarks import variants as V
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in variants:
        src = out_dir / f"mamba_scan-{name}.cu"
        src.write_text(variant_source(
            (csrc / "mamba_scan.cu").read_text(), name.split("+")))
        jobs[name] = src
    built, refused = V.build(jobs, out_dir, nvcc, arch, csrc)
    for other in parent:
        label, _, where = other.rpartition("=")
        label = label or "parent"
        more, bad = V.build({label: Path(where) / "mamba_scan.cu"},
                            out_dir / label, nvcc, arch, csrc)
        built.update(more)
        refused.update(bad)
    return built, refused

def sass_counts(nvcc: str, lib: Path) -> dict:
    """kernel (mangled name) -> instruction counts of its SASS."""
    tool = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kinds = {"all": None, "MUFU": ("MUFU",), "FP32": ("FFMA", "FMUL", "FADD"),
             "LDS": ("LDS",), "SHFL": ("SHFL",), "local": ("LDL", "STL")}
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(kinds, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if name is None or not m:
            continue
        op = m.group(1).split(".")[0]
        for kind, ops in kinds.items():
            if ops is None or op in ops:
                out[name][kind] += 1
    return out


def bind(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_forward.argtypes = [P] * 8 + [
        ctypes.POINTER(ctypes.c_int64), I, I, I, I, I, P]
    lib.mamba_scan_forward.restype = ctypes.c_int
    return lib.mamba_scan_forward


def caller(torch, fn, args):
    """A zero-argument call of one library's mamba_scan_forward on
    ``args`` (as the wrapper makes it), returning (y, h_T)."""
    u, dt, B, C, A, D = args
    b, T, di = u.shape
    ds = B.shape[-1]
    y = torch.empty(b, T, di, dtype=u.dtype, device=u.device)
    h = torch.empty(b, di, ds, dtype=torch.float32, device=u.device)
    strides = (ctypes.c_int64 * 8)(*(s for t in (u, dt, B, C)
                                     for s in t.stride()[:2]))
    ptrs = [t.data_ptr() for t in (u, dt, B, C, A, D, y, h)]
    bf16 = int(u.dtype == torch.bfloat16)

    def call():
        rc = fn(*ptrs, strides, bf16, b, T, di, ds,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mamba_scan_forward returned cuda error {rc}")
        return y, h
    return call


def inputs(torch, b, T, di, ds, dtype, strided, seed):
    """chip_smoke.py phase 8a's distributions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    u = (rnd(b, T, di) * 0.4).to(getattr(torch, dtype))
    dts = torch.nn.functional.softplus(rnd(b, T, di))
    if strided:
        xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
        B, C = xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:]
    else:
        B, C = rnd(b, T, ds) * 0.4, rnd(b, T, ds) * 0.4
    A = -torch.exp(rnd(di, ds) * 0.3)
    return u, dts, B, C, A, torch.ones(di, device="cuda")


def exp_rate(torch) -> float:
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK * sms * mhz * 1e6


def bound_ms(b, T, di, ds, esize, rate) -> float:
    n = b * T * di
    nbytes = (2 * esize * n + 4 * n + 4 * 2 * b * T * ds
              + 4 * (b * di * ds + di * ds + di))
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, n * ds / rate)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base,s4+mb8,s16+mb3,exp2")
    ap.add_argument("--parent", action="append", default=[],
                    help="a csrc directory whose mamba_scan.cu is timed too, "
                    "as the variant 'parent' (or NAME=DIR: as NAME)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", action="store_true",
                    help="count each library's SASS instructions by kernel")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[3]
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants needs a CUDA card")
    from repro_torch.benchmarks import variants as V
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ref as R
    variants = [v for v in args.variants.split(",") if v]
    built, refused = build(variants, args.parent, root / "build" / "variants",
                           B.nvcc(), B.ARCH_FLAGS, B.CSRC)
    ptxas = V.ptxas_lines(built)
    rec = {"device": torch.cuda.get_device_name(0), "ms": {}, "share": {},
           "max_abs_err": {}, "ptxas": ptxas, "refused": sorted(refused)}
    if args.sass:
        rec["sass"] = {name: sass_counts(B.nvcc(), lib)
                       for name, (lib, _) in built.items()}
        for name, kernels in rec["sass"].items():
            for kernel, counts in kernels.items():
                print(f"sass {name} {kernel}: {counts}", flush=True)
    fns = {name: bind(lib) for name, (lib, _) in built.items()}
    rate = exp_rate(torch)
    bad = set()
    for label, (b, T, di, ds, dt, strided) in SHAPES.items():
        args_ = inputs(torch, b, T, di, ds, dt, strided, seed=T + di + ds)
        want, h_want = R.mamba_scan(*args_)
        calls = {n: caller(torch, fn, args_) for n, fn in fns.items()}
        tol = TOL[dt]
        for name, call in calls.items():
            y, h = call()
            torch.cuda.synchronize()
            err = max(float((y.float() - want.float()).abs().max()),
                      float((h - h_want).abs().max()))
            ok = (torch.allclose(y.float(), want.float(), rtol=tol, atol=tol)
                  and torch.allclose(h, h_want, rtol=2e-5, atol=2e-5))
            rec["max_abs_err"].setdefault(name, {})[label] = err
            print(f"{label} [{b},{T},{di}] ds {ds} {name}: max abs err "
                  f"{err:.3g}{'' if ok else ' OUT OF TOLERANCE'}", flush=True)
            if not ok and not any(p in name for p in PROBES):
                bad.add(name)
        if label not in TIMED:
            continue
        ms = V.event_ms(torch, {n: c for n, c in calls.items()
                              if n not in bad}, args.iters)
        bound = bound_ms(b, T, di, ds, args_[0].element_size(), rate)
        for name, t in ms.items():
            rec["ms"].setdefault(name, {})[label] = t
            rec["share"].setdefault(name, {})[label] = bound / t
            print(f"{label} [{b},{T},{di}] {name}: {t:.4f} ms, "
                  f"{100 * bound / t:.1f}% of the {bound:.4f} ms bound",
                  flush=True)
        del args_, want, h_want, calls
        torch.cuda.empty_cache()
    rec["out_of_tolerance"] = sorted(bad)
    print(json.dumps(rec), flush=True)
    return 1 if bad or refused else 0


if __name__ == "__main__":
    sys.exit(main())
