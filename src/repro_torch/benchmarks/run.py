"""The port's kernel bench: the reference's ``benchmarks/run.py`` suites
kernels, flat, flat_adam and compression, plus the per-kernel roofline
table.  Prints the reference's CSV rows ``name,us_per_call,derived``.

  PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      [--only kernels,flat,flat_adam,compression,roofline] \\
      [--device cuda|cpu] [--check] [--write]

It runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions, host-clock times), and raises without a GPU.  ``--check`` is
the launch gate: every suite run that carries a ``_launches`` dict must
equal its entry of ``results/BASELINE_launches.json`` exactly (flat 1 /
per_leaf 96, flat_adam 1, compression blocked_topk 2 / quantize_pack 1 /
pack_body 1): a higher count is a fused pass broken apart, a lower one a
path that bypassed a kernel.  Launches exist only on the card, so
``--check`` with ``--device cpu`` is an error.  ``--write`` writes
``results/BENCH_torch_<suite>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.benchmarks import kernel_bench as KB
from repro_torch.benchmarks.roofline_report import bench_roofline
from repro_torch.device import resolve_device

RESULTS = Path(__file__).resolve().parents[3] / "results"
BASELINE = RESULTS / "BASELINE_launches.json"
SUITES = {
    "kernels": KB.bench_kernels,
    "flat": KB.bench_flat_assimilate,
    "flat_adam": KB.bench_flat_adam,
    "compression": KB.bench_compression,
    "roofline": bench_roofline,
}


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return (f"{torch.cuda.get_device_name(dev)} "
                f"x{torch.cuda.device_count()}")
    return "cpu"


def check_launches(results: Dict[str, dict]) -> int:
    """0 when every ``_launches`` entry equals the baseline's, else 1."""
    baseline = json.loads(BASELINE.read_text())
    failures = []
    for suite, res in results.items():
        current = res.get("_launches")
        if current is None:
            continue
        base = baseline.get(suite, {})
        for key in sorted(set(current) | set(base)):
            got, want = current.get(key), base.get(key)
            if got != want:
                failures.append(f"{suite}.{key}: {got} launches != baseline "
                                f"{want}")
            else:
                print(f"check {suite}.{key}: {got} == {want} OK",
                      file=sys.stderr)
    for f in failures:
        print(f"LAUNCH GATE {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default="",
                    help="comma list of " + ",".join(SUITES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--check", action="store_true",
                    help="hold each suite's launch counts to "
                         "results/BASELINE_launches.json (card only)")
    ap.add_argument("--write", action="store_true",
                    help="write results/BENCH_torch_<suite>.json")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or list(SUITES)
    unknown = sorted(set(only) - set(SUITES))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; choose from {list(SUITES)}")
    if args.check and args.device == "cpu":
        ap.error("--check gates kernel launch counts, and launches exist "
                 "only on the card: run it with --device cuda")
    dev = resolve_device(args.device)
    name = device_name(dev)
    print(f"device: {name}", file=sys.stderr)
    print("name,us_per_call,derived")
    results = {}
    for suite in only:
        res = SUITES[suite](dev)
        res["_device"] = name
        results[suite] = res
        for key, r in res.items():
            if not key.startswith("_"):
                print(f"{suite}.{key},{r['us_per_call']},{r['derived']}",
                      flush=True)
        for key, why in res.get("_not_ported", {}).items():
            print(f"{suite}.{key}: not ported: {why}", file=sys.stderr)
        if args.write:
            (RESULTS / f"BENCH_torch_{suite}.json").write_text(
                json.dumps(res, indent=1))
    return check_launches(results) if args.check else 0


if __name__ == "__main__":
    sys.exit(main())
