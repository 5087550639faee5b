"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is never served a stale build.  Building happens at first use, from the
checkout's sources only; importing this module runs nothing.  All
sources compile in parallel (one nvcc each, started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("vc_asgd_update", "topk_mask", "quantize",
                        "sparse_pack", "flash_attention",
                        "flash_attention_sm90", "flash_attention_bwd",
                        "flash_attention_bwd_sm90",
                        "wkv6", "wkv6_bwd", "mamba_scan",
                        "mamba_scan_bwd")}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None     # wall time of the last build
build_log: Dict[str, str] = {}            # nvcc output per source


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (src/repro_torch/kernels/csrc)")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # shared by every source
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes
    started together; returns {name: library path}.  Raises with nvcc's
    output if any compile fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])       # atomic: never a torn library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib
