"""What the kernel-variant tools (``wkv6_variants.py``,
``scan_variants.py``) share: each variant a copy of one kernel source,
built into its own library with every nvcc started together, its ptxas
lines, and CUDA-event times of the variants in turns on one card."""
from __future__ import annotations

import subprocess
import time
from pathlib import Path

ROUNDS = 3


def build(jobs: dict, out_dir: Path, nvcc: str, arch, include: Path):
    """jobs {name: source path} -> ({name: (library path, nvcc output)},
    {name: nvcc output of a variant that did not build}); each library is
    ``out_dir/lib<source stem>.so``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in jobs.items():
        lib = out_dir / f"lib{Path(src).stem}.so"
        cmd = [nvcc, *arch, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", str(include), "-o", str(lib),
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


def ptxas_lines(built: dict) -> dict:
    """name -> the ptxas lines (entry, registers, spills) of its build,
    each printed."""
    out = {}
    for name, (_, log) in built.items():
        out[name] = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
        for ln in out[name]:
            print(f"ptxas {name}: {ln}", flush=True)
    return out


def event_ms(torch, calls: dict, iters: int) -> dict:
    """Mean CUDA-event ms a call of each of ``calls``, in turns (forward,
    then backward order, ROUNDS times) after a second of the first."""
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
