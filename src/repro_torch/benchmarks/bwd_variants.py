"""B14's and B15's backward kernels (csrc/wkv6_bwd.cu,
csrc/mamba_scan_bwd.cu) built as copies with one part left out or one
constant changed, each timed in turns with the tree's kernel (and
another tree's) on one card.

    python src/repro_torch/benchmarks/bwd_variants.py \\
        [--wkv6 new,new-rows0,parent,...] [--scan new,parent,...] \\
        [--parent DIR] [--iters N] [--shapes train,long] [--sass]

Needs one CUDA card and nvcc.  ``--wkv6`` / ``--scan`` list each
kernel's variants (an empty list skips the kernel).  A variant is
``TREE[-CHANGE...]``: TREE is ``new`` (this checkout) or ``parent`` (the
checkout at ``--parent``, e.g. ``git archive <commit> | tar -x -C
build/parent``), CHANGE a probe that leaves a part out or a constant
set (``kc4``: kCluster 4, ``sub8``: kSub 8, ``mb3``: kMinBlocks 3); the
changed copy of the tree's source is built under
``build/variants/bwd/``, all nvcc processes started together, and
called through that tree's own wrapper (``kernels/rwkv6_scan.py::
wkv6_bwd``, ``kernels/mamba_scan.py::mamba_scan_bwd``, loaded from the
tree's file with its library swapped in), on the chunk states of this
checkout's forward (the checkpoint contract is one in both trees).  A
probe whose edit does not match the tree's source is reported and left
out.

Probes of the earlier designs (one CTA a (b, h); 2 lanes a channel),
for a ``--parent`` tree that holds them (``parent-``):
  wkv6: ``nore`` no recompute of a chunk's first sub-walk, ``nocols`` no
  column rounds (dv), ``norows`` no row butterflies, ``nostash`` no stash
  stores or loads (the running state in their place), ``nostage`` no
  staging loads.
  scan: ``noexp2`` no exp in the reverse walk (1 + dt A), ``nochan`` no
  channel rounds (dB / dC), ``nostash`` no stash, ``nostage`` no staging
  loads.
Probes of this tree's design (``new-``): wkv6 ``rows0`` / ``cols0`` no
row / column butterflies, ``fwd0`` no state steps, ``stage0`` no staging
of the next chunk, ``cluster0`` no cluster sums of dv; scan ``exp0`` no
exp (1 + dt A), ``lanes0`` no butterfly over a channel's lanes,
``chan0`` none over the warp's channels, ``stage0``, ``cluster0``.

A probe's output is not held to the plain backward; every other
variant is, at every shape (1e-5 of max |plain| + 1e-4 |plain|, bf16 du
within 2e-2 (1 + |plain|), as chip_smoke.py phase 15a), and one that
is not is reported and not timed (exit 1).  Prints each variant's ptxas
lines, then one JSON line: ``ms`` (CUDA-event ms a call, ``iters``
calls a timing, the variants in turns A B ... B A, ``variants.ROUNDS``
times, the mean kept), ``share`` (the shape's bound over the time: bytes
at 3.35 TB/s, f32 FMAs at 67 TFLOP/s, and for the scan one exp a
state-step at 16 a clock an SM at 1,980 MHz, the largest), ``bound_ms``,
``max_abs_err``, the card's ``nvidia-smi`` name and power limit, and
with ``--sass`` each library's SASS instruction counts by kernel
(``scan_variants.sass_counts``: all, MUFU, FP32, LDS, SHFL, local).
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

# (b, h, T, hd, share of exact-0 decays); timed shapes first
WKV_SHAPES = {
    "train": (8, 32, 128, 64, 0.0),     # rwkv6-1.6b's training step
    "long": (4, 32, 2048, 64, 0.0),     # b * h = 128 < 132 SMs
    "small": (2, 3, 100, 64, 0.0),      # b * h = 6
    "hd16 ragged": (2, 4, 63, 16, 0.3),
    "T=300 zeros": (2, 4, 300, 64, 0.3),
}
# (b, T, di, ds, u dtype)
SCAN_SHAPES = {
    "train": (8, 128, 8192, 16, "bfloat16"),   # jamba's training step
    "long": (2, 2048, 8192, 16, "bfloat16"),
    "ragged f32": (2, 63, 200, 16, "float32"),
    "ds4": (2, 37, 130, 4, "float32"),
}
TIMED = ("train", "long")
TOL, BF16_TOL = (1e-5, 1e-4), 2e-2
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
EXPS_PER_S = 16 * 132 * 1.98e9     # the SFU: 16 a clock an SM

# probe -> [(pattern, replacement, matches)] edits of a source
PROBES = {
    "wkv6": {
        # the earlier design
        "nore": [(r"for \(int t = 0; t < sw \* L; \+\+t\) step\(S, t\);",
                  ";", 1)],
        "nocols": [(r"column_rounds<JW, 0>\(dv, lane, base\);", ";", 1)],
        "norows": [(r"__shfl_xor_sync\(0xffffffffu, (up[12] \? \w+ : \w+), "
                    r"[12]\)", r"(\1)", 3)],
        "nostash": [(r"stash\[\(l \* NV \+ q\) \* NT \+ tid\] =\s*"
                     r"make_float4\([^;]*\);", ";", 1),
                    (r"const float4 y = stash\[\(l \* NV \+ q\) \* NT "
                     r"\+ tid\];",
                     "const float4 y = make_float4(S[4 * q], S[4 * q + 1], "
                     "S[4 * q + 2], S[4 * q + 3]);", 1)],
        "nostage": [(r"in_s\[n\] = t < seq \? src\[a\]\[t \* ts\[a\] \+ j\]"
                     r" : \(a == 2 \? 1\.0f : 0\.0f\);",
                     "in_s[n] = a == 2 ? 0.9f : 0.1f;", 1)],
        # this design: a part left out (0)
        "rows0": [(r"fold_rounds<4, 1, LR>\(x, lane, slot\);", ";", 1)],
        "cols0": [(r"fold_rounds<kColsLane, LR, 32>\(dv, lane, base\);",
                   ";", 1)],
        "fwd0": [(r"return make_float4\(fmaf\(ww, S\.x[^;]*;",
                  "return S;", 1)],
        "stage0": [(r"stage\(ch - 1, \(ch - 1\) & 1\);", ";", 1)],
        "cluster0": [(r"cluster_sum\(ch \+ 1\);", ";", 1)],
    },
    "scan": {
        # the earlier design
        "noexp2": [(r"const float a = expf\(dtv \* A\[s\]\);",
                    "const float a = 1.0f + dtv * A[s];", 1)],
        "nochan": [(r"channel_rounds<kVals, kLanes>\(x, lane, base\);",
                    ";", 1)],
        "nostash": [(r"stash\[\(i \* NV \+ v\) \* kThreads \+ tid\] =\s*"
                     r"make_float4\([^;]*\);", ";", 1),
                    (r"const float4 y = stash\[\(i \* NV \+ v\) \* kThreads"
                     r" \+ tid\];",
                     "const float4 y = make_float4(h[4 * v], h[4 * v + 1], "
                     "h[4 * v + 2], h[4 * v + 3]);", 1)],
        "nostage": [(r"ok \? to_f32\(ub\[t \* P\.st\[1\] \+ ch\]\) : 0\.0f",
                     "0.25f", 1),
                    (r"ok \? dtb\[t \* P\.st\[3\] \+ ch\] : 0\.0f", "0.5f", 1),
                    (r"ok \? to_f32\(dyb\[static_cast<int64_t>\(t\) \* P\.di"
                     r" \+ ch\]\) : 0\.0f", "1.0f", 1),
                    (r"t >= seq \? 0\.0f\s*: s < DS \? Bb\[t \* P\.st\[5\] \+ "
                     r"s\] : Cb\[t \* P\.st\[7\] \+ s - DS\]", "0.1f", 1)],
        # this design: a part left out (0)
        "exp0": [(r"a\[s\] = expf\(dtv \* A\[s\]\);",
                  "a[s] = 1.0f + dtv * A[s];", 1)],
        "lanes0": [(r"fold_rounds<2, 1, kLanes>\(gs, lane, slot\);", ";", 1)],
        "chan0": [(r"fold_rounds<kVals, kLanes, 32>\(x, lane, base\);",
                   ";", 1)],
        "stage0": [(r"stage\(ci - 1, \(ci - 1\) & 1\);", ";", 1)],
        "cluster0": [(r"cluster_sum\(ci \+ 1\);", ";", 1)],
    },
}
CONSTANTS = {"kc": "kCluster", "mb": "kMinBlocks", "sub": "kSub"}
KERNELS = {
    "wkv6": ("wkv6_bwd", "rwkv6_scan.py", "wkv6_bwd"),
    "scan": ("mamba_scan_bwd", "mamba_scan.py", "mamba_scan_bwd"),
}


def variant_source(kernel: str, src: str, changes: list) -> str:
    """``src`` with each change applied (a probe or ``<key><N>``)."""
    for ch in changes:
        if ch in PROBES[kernel]:
            for pattern, repl, count in PROBES[kernel][ch]:
                src, n = re.subn(pattern, repl, src)
                if n != count:
                    raise RuntimeError(f"{ch}: {pattern!r} found {n} times, "
                                       f"not {count}")
            continue
        m = re.fullmatch(r"([a-z]+)(\d+)", ch)
        if not m or m.group(1) not in CONSTANTS:
            raise ValueError(f"unknown change {ch!r}")
        src, n = re.subn(rf"(constexpr int {CONSTANTS[m.group(1)]} = )\d+",
                         rf"\g<1>{m.group(2)}", src)
        if n != 1:
            raise RuntimeError(f"{CONSTANTS[m.group(1)]} found {n} times")
    return src


def wrapper(tree: Path, kernel: str, lib_path: Path, tag: str):
    """A fresh instance of ``tree``'s wrapper module whose backward library
    is ``lib_path`` (the forward's is this checkout's build)."""
    from repro_torch.kernels import build as B
    name, module, _ = KERNELS[kernel]
    path = tree / "src" / "repro_torch" / "kernels" / module
    spec = importlib.util.spec_from_file_location(f"_bwd_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Shim:
        @staticmethod
        def load(n):
            return ctypes.CDLL(str(lib_path)) if n == name else B.load(n)
    mod.build = Shim
    mod._libs.clear()
    return mod


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def wkv_case(torch, WK, b, h, T, hd, zeros, seed):
    """chip_smoke.py phase 15a's inputs: [b, T, h, hd] views, the chunk
    states from this checkout's forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda: torch.randn(b, T, h, hd, generator=g, device=dev)
    r, k, v = rnd() * 0.4, rnd() * 0.4, rnd()
    w = torch.sigmoid(rnd()) * 0.6 + 0.35
    if zeros:
        hit = torch.rand(b, T, h, hd, generator=g, device=dev) < zeros
        w = torch.where(hit, torch.zeros((), device=dev), w)
    r, k, v, w = (t.transpose(1, 2) for t in (r, k, v, w))
    u = torch.randn(h, hd, generator=g, device=dev) * 0.2
    do = torch.randn(b, h, T, hd, generator=g, device=dev)
    states = WK.chunk_states(r)
    WK.wkv6(r, k, v, w, u, states=states)
    return (r, k, v, w, u, do, states)


def wkv_bound(b, h, T, hd, chunk=16):
    n = b * h * T * hd
    nbytes = 4 * (9 * n + b * h * -(-T // chunk) * hd * hd + 2 * h * hd)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, 12 * n * hd / F32_OPS_PER_S)


def scan_case(torch, MK, b, T, di, ds, dt, seed):
    """chip_smoke.py phase 15a's inputs: B / C column views of an x_proj
    output, the chunk states from this checkout's forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    dtype = getattr(torch, dt)
    u = (rnd(b, T, di) * 0.4).to(dtype)
    dts = torch.nn.functional.softplus(rnd(b, T, di))
    xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
    B, C = xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:]
    A = -torch.exp(rnd(di, ds) * 0.3)
    D = rnd(di)
    dy = rnd(b, T, di).to(dtype)
    h_ck = MK.chunk_states(u, ds)
    MK.mamba_scan(u, dts, B, C, A, D, h_ck=h_ck)
    return (u, dts, B, C, A, D, dy, h_ck)


def scan_bound(b, T, di, ds, es, chunk=16):
    n = b * T * di
    nbytes = (3 * es * n + 4 * 2 * n + 4 * 4 * b * T * ds
              + 4 * b * -(-T // chunk) * di * ds + 4 * 2 * (di * ds + di))
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, n * ds / EXPS_PER_S,
                     20 * n * ds / F32_OPS_PER_S)


def worst(torch, got, want, bf16_first: bool) -> float:
    """Max abs err of ``got`` against ``want``; inf where one is out of
    tolerance or not finite."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        if bf16_first and i == 0:
            lim = BF16_TOL * (1 + w.abs())
        else:
            lim = TOL[0] * max(float(w.abs().max()), 1.0) + TOL[1] * w.abs()
        if not bool(torch.isfinite(g).all()) or not bool((d <= lim).all()):
            return float("inf")
        err = max(err, float(d.max()))
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wkv6", default="new,parent")
    ap.add_argument("--scan", default="new,parent")
    ap.add_argument("--parent", default="",
                    help="another checkout's root (its src/repro_torch)")
    ap.add_argument("--shapes", default=",".join(TIMED),
                    help="the shapes timed (every shape is checked)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[3]
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bwd_variants needs a CUDA card")
    from repro_torch.benchmarks import variants as V
    from repro_torch.kernels import build as B
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as WK
    B.build_all()
    trees = {"new": root}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    lists = {"wkv6": args.wkv6, "scan": args.scan}
    timed = [s for s in args.shapes.split(",") if s]
    out_dir = root / "build" / "variants" / "bwd"
    out_dir.mkdir(parents=True, exist_ok=True)

    rec = {"smi": smi(), "device": torch.cuda.get_device_name(0),
           "ms": {}, "share": {}, "bound_ms": {}, "max_abs_err": {},
           "ptxas": {}, "refused": []}
    bad = False
    for kernel, names in lists.items():
        name, _, fn_name = KERNELS[kernel]
        jobs = {}
        for var in (v for v in names.split(",") if v):
            tree, *changes = var.split("-")
            if tree not in trees:
                raise SystemExit(f"{var}: no tree {tree!r} (--parent?)")
            csrc = trees[tree] / "src" / "repro_torch" / "kernels" / "csrc"
            try:
                text = variant_source(kernel, (csrc / f"{name}.cu")
                                      .read_text(), changes)
            except RuntimeError as e:
                print(f"{kernel} {var}: left out ({e})", flush=True)
                rec["refused"].append(f"{kernel} {var}")
                continue
            src = out_dir / kernel / f"{name}-{var}.cu"
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(text)
            jobs[var] = src
        # -I this checkout's csrc (smem.cuh, one in both trees)
        built, refused = V.build(jobs, out_dir / kernel, B.nvcc(),
                                 B.ARCH_FLAGS, B.CSRC)
        rec["refused"] += [f"{kernel} {v}" for v in refused]
        rec["ptxas"][kernel] = V.ptxas_lines(built)
        if args.sass:
            from repro_torch.benchmarks.scan_variants import sass_counts
            for var, (lib, _) in built.items():
                counts = sass_counts(B.nvcc(), lib)
                rec.setdefault("sass", {})[f"{kernel} {var}"] = counts
                for fn, c in counts.items():
                    print(f"sass {kernel} {var} {fn[-40:]}: {c}", flush=True)
        fns = {}
        for var, (lib, _) in built.items():
            mod = wrapper(trees[var.split("-")[0]], kernel, lib,
                          f"{kernel}_{var}".replace("-", "_"))
            fns[var] = getattr(mod, fn_name)
        shapes = WKV_SHAPES if kernel == "wkv6" else SCAN_SHAPES
        for label, shape in shapes.items():
            seed = sum(shape[:4])
            if kernel == "wkv6":
                case = wkv_case(torch, WK, *shape, seed)
                want = R.wkv6_bwd(*case[:6])
                bound = wkv_bound(*shape[:4])
                bf16 = False
            else:
                case = scan_case(torch, MK, *shape, seed)
                want = R.mamba_scan_bwd(*case[:7])
                bound = scan_bound(*shape[:4], case[0].element_size())
                bf16 = case[0].dtype == torch.bfloat16
            calls = {v: (lambda f=f: f(*case)) for v, f in fns.items()}
            ok = {}
            for var, call in calls.items():
                got = call()
                again = call()
                torch.cuda.synchronize()
                probe = "-" in var
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                err = worst(torch, got, want, bf16)
                rec["max_abs_err"].setdefault(f"{kernel} {var}", {})[label] \
                    = err
                flag = "" if probe or (same and err < float("inf")) else \
                    " OUT OF TOLERANCE OR NOT BIT-EQUAL"
                print(f"{kernel} {label} {shape} {var}: max abs err "
                      f"{err:.3g}, bit-equal run to run {same}{flag}",
                      flush=True)
                if flag:
                    bad = True
                else:
                    ok[var] = call
                del got, again
            if label in timed:
                ms = V.event_ms(torch, ok, args.iters)
                rec["bound_ms"][f"{kernel} {label}"] = bound
                for var, t in ms.items():
                    rec["ms"].setdefault(f"{kernel} {var}", {})[label] = t
                    rec["share"].setdefault(f"{kernel} {var}", {})[label] = \
                        bound / t
                    print(f"{kernel} {label} {var}: {t:.4f} ms, "
                          f"{100 * bound / t:.1f}% of the {bound:.4f} ms "
                          f"bound", flush=True)
            del case, want, calls, ok
            torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return 1 if bad or rec["refused"] else 0


if __name__ == "__main__":
    sys.exit(main())
