"""B14 (the WKV6 recurrence, csrc/wkv6.cu) built at several chunk lengths
and block sizes, each held against the plain version and timed in turns
with the others on one card.

    python src/repro_torch/benchmarks/wkv6_variants.py \\
        [--variants 16x256,8x128,16x256-no3] [--parent DIR] [--iters N]

Needs one CUDA card and nvcc.  Each variant ``CxT`` is a copy of
``csrc/wkv6.cu`` under ``build/variants/`` whose ``Geometry<64>`` (hd
64's chunk length and threads a block) is set to C and T (the kernel's
static checks want T = C * 64 / 4), all nvcc processes started together;
a variant the static checks refuse is reported and left out.  A probe
``CxT-noN`` (N in 1, 2, 3, fetch) also leaves out the pipeline's calls
of phase N (or the staging): its time, beside the whole kernel's, says
what that phase costs; a probe's output is not held to the plain
version.  ``--parent`` adds the ``wkv6.cu``
of another checkout's ``src/repro_torch/kernels/csrc`` directory as the
variant ``parent`` (the same C entry), so an earlier design is timed in
the same turns.
Prints each variant's ptxas lines, then one JSON line:

* ``ms``: CUDA-event milliseconds a call at each of chip_smoke.py phase
  7a's shapes (f32), ``iters`` calls a timing, the variants timed in
  turns (forward, then backward order, ``ROUNDS`` times), the mean kept;
* ``share``: the shape's bound (bytes at 3.35 TB/s or f32 FMAs at 67
  TFLOP/s, the larger) over the time;
* ``max_abs_err``: out and the final state against ``ref.wkv6`` at each
  shape, and at the decay cases (w with exact zeros, with denormals);
  a variant beyond 2e-5 (rtol and atol) is reported and not timed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# chip_smoke.py phase 7a's shapes: (b, h, T, hd, [b, T, h, hd] views)
SHAPES = {
    "a rwkv6 prefill": (4, 32, 2048, 64, False),
    "b reduced hd16 ragged": (2, 4, 37, 16, False),
    "c T=1": (4, 32, 1, 64, False),
    "d strided views": (4, 32, 2048, 64, True),
}
# decay cases: (b, h, T, hd, what w is drawn as)
DECAYS = {"w zeros": (2, 8, 300, 64, "zero"),
          "w denormal": (2, 8, 300, 64, "denormal")}
TOL = 2e-5
ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def variant_source(src: str, chunk: str, threads: str, mods: list) -> str:
    """``src`` with hd 64's geometry set to ``chunk`` and ``threads``, and
    the pipeline's calls of each phase cut by ``mods`` (no1, no2, no3 or
    nofetch: fetch and stash) made empty statements."""
    src, n = re.subn(r"(struct Geometry<64> \{\s*static constexpr int "
                     r"kChunk = )\d+(, kThreads = )\d+",
                     rf"\g<1>{chunk}\g<2>{threads}", src)
    if n != 1:
        raise RuntimeError("Geometry<64> not found in wkv6.cu")
    calls = {"1": ["phase1"], "2": ["phase2"], "3": ["phase3a", "phase3b"],
             "fetch": ["fetch", "stash"]}
    for m in mods:
        for fn in calls[m[2:]]:
            src = re.sub(rf"^(\s*)(if \([^;]*\) )?{fn}\([^;]*\);$",
                         r"\1;", src, flags=re.M)
    return src


def build(variants, parent, out_dir: Path, nvcc, arch, csrc: Path):
    """({name: (library path, nvcc output)}, {name: nvcc output of a
    variant that did not build}), every nvcc started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in variants:
        geometry, *mods = name.split("-")
        src = out_dir / f"wkv6-{name}.cu"
        src.write_text(variant_source((csrc / "wkv6.cu").read_text(),
                                      *geometry.split("x"), mods))
        jobs[name] = src
    if parent:
        jobs["parent"] = Path(parent) / "wkv6.cu"
    procs = {}
    for name, src in jobs.items():
        lib = out_dir / f"libwkv6-{name}.so"
        cmd = [nvcc, *arch, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", str(csrc), "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, refused = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            refused[name] = log
            print(f"nvcc refused {name}:\n{log}", flush=True)
        else:
            built[name] = (lib, log)
    return built, refused


def bind(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward.argtypes = [P, P, P, P, P, P, P,
                                 ctypes.POINTER(ctypes.c_int64),
                                 I, I, I, I, I, P]
    lib.wkv6_forward.restype = ctypes.c_int
    return lib.wkv6_forward


def caller(torch, fn, args):
    """A zero-argument call of one library's wkv6_forward on ``args``
    (as the wrapper makes it), returning (out, S_T)."""
    r, k, v, w, u = args
    b, h, T, hd = r.shape
    out = torch.empty(b, T, h, hd, dtype=r.dtype,
                      device=r.device).permute(0, 2, 1, 3)
    s_out = torch.empty(b, h, hd, hd, dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(s for t in (r, k, v, w, out)
                                      for s in t.stride()[:3]))
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, out, s_out)]
    bf16 = int(r.dtype == torch.bfloat16)

    def call():
        rc = fn(*ptrs, strides, bf16, b, h, T, hd,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"wkv6_forward returned cuda error {rc}")
        return out, s_out
    return call


def inputs(torch, b, h, T, hd, strided=False, decay="test", seed=0):
    """The reference test_wkv6's distributions (w in (0.35, 0.95)); a
    decay case sets 30% of w to 0 or to 1e-40."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, T, h, hd) if strided else (b, h, T, hd)
    rnd = lambda: torch.randn(*shape, generator=g, device="cuda")
    r, k, v = rnd() * 0.4, rnd() * 0.4, rnd()
    w = torch.sigmoid(rnd()) * 0.6 + 0.35
    if decay != "test":
        hit = torch.rand(*shape, generator=g, device="cuda") < 0.3
        w = torch.where(hit, torch.tensor(0.0 if decay == "zero" else 1e-40,
                                          device="cuda"), w)
    ts = [r, k, v, w]
    if strided:
        ts = [t.transpose(1, 2) for t in ts]
    return (*ts, torch.randn(h, hd, generator=g, device="cuda") * 0.2)


def bound_ms(b, h, T, hd):
    n = b * h * T * hd
    t_mem = 4 * (5 * n + b * h * hd * hd + h * hd) / HBM_BYTES_PER_S
    t_ops = 2 * 3 * n * hd / F32_OPS_PER_S
    return 1e3 * max(t_mem, t_ops)


def event_ms(torch, calls: dict, iters: int) -> dict:
    """Mean CUDA-event ms a call of each of ``calls``, in turns."""
    keys = list(calls)
    runs = {k: [] for k in keys}
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        calls[keys[0]]()
        torch.cuda.synchronize()
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            calls[k]()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                calls[k]()
            t1.record()
            t1.synchronize()
            runs[k].append(t0.elapsed_time(t1) / iters)
    return {k: sum(v) / len(v) for k, v in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants",
                    default="16x256,8x128,32x512")
    ap.add_argument("--parent", default="",
                    help="a csrc directory whose wkv6.cu is timed too")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[3]
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_variants needs a CUDA card")
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ref as R
    variants = [v for v in args.variants.split(",") if v]
    built, refused = build(variants, args.parent, root / "build" / "variants",
                           B.nvcc(), B.ARCH_FLAGS, B.CSRC)
    ptxas = {}
    for name, (_, log) in built.items():
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln]
        for ln in ptxas[name]:
            print(f"ptxas {name}: {ln}", flush=True)
    fns = {name: bind(lib) for name, (lib, _) in built.items()}

    rec = {"device": torch.cuda.get_device_name(0), "ms": {}, "share": {},
           "max_abs_err": {}, "ptxas": ptxas, "refused": sorted(refused)}
    bad = set()
    cases = [(n, (*s, "test")) for n, s in SHAPES.items()] + \
        [(n, (b, h, T, hd, False, d)) for n, (b, h, T, hd, d) in
         DECAYS.items()]
    for label, (b, h, T, hd, strided, decay) in cases:
        args_ = inputs(torch, b, h, T, hd, strided, decay, seed=T + hd)
        want, s_want = R.wkv6(*args_)
        calls = {n: caller(torch, fn, args_) for n, fn in fns.items()}
        for name, call in calls.items():
            o, s = call()
            torch.cuda.synchronize()
            err = max(float((o - want).abs().max()),
                      float((s - s_want).abs().max()))
            ok = (torch.allclose(o, want, rtol=TOL, atol=TOL)
                  and torch.allclose(s, s_want, rtol=TOL, atol=TOL)
                  and bool(torch.isfinite(o).all()))
            rec["max_abs_err"].setdefault(name, {})[label] = err
            print(f"{label} [{b},{h},{T},{hd}] {name}: max abs err {err:.3g}"
                  f"{'' if ok else ' OUT OF TOLERANCE'}", flush=True)
            if not ok and "-no" not in name:
                bad.add(name)
        if decay != "test":
            continue
        ms = event_ms(torch, {n: c for n, c in calls.items()
                              if n not in bad}, args.iters)
        bound = bound_ms(b, h, T, hd)
        for name, t in ms.items():
            rec["ms"].setdefault(name, {})[label] = t
            rec["share"].setdefault(name, {})[label] = bound / t
            print(f"{label} [{b},{h},{T},{hd}] {name}: {t:.4f} ms, "
                  f"{100 * bound / t:.1f}% of the {bound:.4f} ms bound",
                  flush=True)
        del args_, want, s_want, calls
        torch.cuda.empty_cache()
    rec["out_of_tolerance"] = sorted(bad)
    print(json.dumps(rec), flush=True)
    return 1 if bad or refused else 0


if __name__ == "__main__":
    sys.exit(main())
