"""The port's bench: the reference's ``benchmarks/run.py`` suites
kernels, flat, flat_adam, compression and sharded_flat, plus the
per-kernel roofline table (run by default), the paper's figure suites fig2, fig3, fig4,
fig6, consistency and cost (``paper_figs.py``), the fleet and handout
scenario suites (``fleet_bench.py``, ``handout_bench.py``) and the
cost/throughput frontier (``frontier_bench.py``), run when named.  Prints the reference's CSV rows: ``name,us_per_call,derived`` a
kernel-bench row, ``suite,wall_us,claims:n/m`` a claim suite (its failed
claims named after ``FAILED:``, joined by ``+``), preceded for a
scenario suite by one ``suite.row,wall_us,events_per_sec=...`` row a
scenario run.

  PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      [--only kernels,flat,flat_adam,compression,sharded_flat,roofline,
              fig2,fig3,fig4,fig6,consistency,cost,fleet,handout,
              frontier] [--full] \\
      [--device cuda|cpu] [--check] [--write]

It runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions, host-clock times), and raises without a GPU.  ``--full`` runs
the paper suites at the paper's horizon (40 epochs, 50 shards) instead
of the quick one, the scenario suites with fleet_100k and the
100k / 1M subscriber crowds, and the frontier with fleet_1k.  ``--check`` is
the launch gate: every suite run that carries a ``_launches`` dict must
equal its entry of ``results/BASELINE_launches.json`` exactly (flat 1 /
per_leaf 96, flat_adam 1, compression blocked_topk 2 / quantize_pack 1 /
pack_body 1, sharded_flat sharded 1 / single 1 / per_leaf 96): a
higher count is a fused pass broken apart, a lower one a
path that bypassed a kernel.  With the fleet or handout suite it also
holds their floors, measured on the card and pinned in
``results/BASELINE_torch_fleet.json``: the fleet_smoke scenario's
events/sec at least 25% of its baseline, handout_smoke's dedup ratio at
least half of its.  Launches and those floors exist only on the card, so
``--check`` with ``--device cpu`` is an error.  ``--write`` writes
``results/BENCH_torch_<suite>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.benchmarks import fleet_bench
from repro_torch.benchmarks import frontier_bench
from repro_torch.benchmarks import handout_bench
from repro_torch.benchmarks import kernel_bench as KB
from repro_torch.benchmarks import paper_figs
from repro_torch.benchmarks.roofline_report import bench_roofline
from repro_torch.device import resolve_device

RESULTS = Path(__file__).resolve().parents[3] / "results"
BASELINE = RESULTS / "BASELINE_launches.json"
FLEET_BASELINE = RESULTS / "BASELINE_torch_fleet.json"
SUITES = {
    "kernels": KB.bench_kernels,
    "flat": KB.bench_flat_assimilate,
    "flat_adam": KB.bench_flat_adam,
    "compression": KB.bench_compression,
    "sharded_flat": KB.bench_sharded_flat,
    "roofline": bench_roofline,
}
# suites that print one claims row (paper figures, scenario suites)
PAPER_SUITES = {**paper_figs.SUITES, "fleet": fleet_bench.bench_fleet,
                "handout": handout_bench.bench_handout,
                "frontier": frontier_bench.bench_frontier}


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


def check_floors(suites: Sequence[str], dev: torch.device) -> int:
    """0 when the fleet / handout floors of ``results/
    BASELINE_torch_fleet.json`` hold for the suites run, else 1."""
    baseline = json.loads(FLEET_BASELINE.read_text())
    floors = {
        "fleet": ("smoke_events_per_sec", fleet_bench.FLOOR_FRACTION,
                  fleet_bench.smoke_events_per_sec),
        "handout": ("smoke_unique_to_served",
                    handout_bench.DEDUP_FLOOR_FRACTION,
                    handout_bench.smoke_unique_to_served)}
    failures = []
    for suite in suites:
        if suite not in floors:
            continue
        key, fraction, measure = floors[suite]
        floor = baseline[suite][key] * fraction
        got = measure(dev)
        line = (f"{suite}.{key}: {got} vs floor {floor:.1f} (baseline "
                f"{baseline[suite][key]} x {fraction})")
        if got < floor:
            failures.append(line)
        else:
            print(f"check {line} OK", file=sys.stderr)
    for f in failures:
        print(f"FLOOR {f}", file=sys.stderr)
    return 1 if failures else 0


def run_paper_suite(suite: str, quick: bool, dev: torch.device) -> dict:
    """One claim suite on ``dev``: its result with ``_wall_s`` (host clock,
    ending in a synchronize on the card), a CSV row a scenario run where
    the suite has them, and its claims row."""
    t0 = time.perf_counter()
    res = PAPER_SUITES[suite](quick, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res["_wall_s"] = time.perf_counter() - t0
    for key, row in res.items():
        if isinstance(row, dict) and "events_per_sec" in row:
            print(f"{suite}.{key},{1e6 * row['bench_wall_s']:.0f},"
                  f"events_per_sec={row['events_per_sec']}", flush=True)
    claims = res.get("_claims", {})
    failed = [k for k, ok in claims.items() if not ok]
    print(f"{suite},{1e6 * res['_wall_s']:.0f},claims:"
          f"{len(claims) - len(failed)}/{len(claims)}"
          + (" FAILED:" + "+".join(failed) if failed else ""), flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run_cli(argv)[0]


def run_cli(argv: Optional[Sequence[str]] = None) -> Tuple[int, dict]:
    """``main``'s work: (exit code, each suite's result by name)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default="",
                    help="comma list of " + ",".join([*SUITES, *PAPER_SUITES])
                    + " (default: the kernel-bench suites)")
    ap.add_argument("--full", action="store_true",
                    help="paper suites at the paper's horizon (40 epochs, "
                         "50 shards); scenario suites at 100k / 1M")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--check", action="store_true",
                    help="hold each suite's launch counts to "
                         "results/BASELINE_launches.json and the fleet / "
                         "handout floors to results/BASELINE_torch_fleet."
                         "json (card only)")
    ap.add_argument("--write", action="store_true",
                    help="write results/BENCH_torch_<suite>.json")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or list(SUITES)
    unknown = sorted(set(only) - set(SUITES) - set(PAPER_SUITES))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; choose from "
                 f"{[*SUITES, *PAPER_SUITES]}")
    if args.check and args.device == "cpu":
        ap.error("--check gates kernel launch counts and card-measured "
                 "floors, and launches exist only on the card: run it with "
                 "--device cuda")
    dev = resolve_device(args.device)
    name = device_name(dev)
    print(f"device: {name}", file=sys.stderr)
    print("name,us_per_call,derived")
    results = {}
    for suite in only:
        if suite in PAPER_SUITES:
            res = run_paper_suite(suite, not args.full, dev)
        else:
            res = SUITES[suite](dev)
            for key, r in res.items():
                if not key.startswith("_"):
                    print(f"{suite}.{key},{r['us_per_call']},{r['derived']}",
                          flush=True)
        res["_device"] = name
        results[suite] = res
        if args.write:
            (RESULTS / f"BENCH_torch_{suite}.json").write_text(
                json.dumps(res, indent=1))
    if not args.check:
        return 0, results
    return check_launches(results) | check_floors(only, dev), results


if __name__ == "__main__":
    sys.exit(main())
