"""Cost/throughput frontier over the scenario registry (``run --only
frontier``; port of the reference's ``benchmarks/frontier_bench.py``,
§IV-E extension).

The paper prices ONE fixed 5-instance fleet (standard vs preemptible).
The scenario registry spans a much wider operating space — correlated AZ
reclaims, spot-price churn, diurnal volunteers, heterogeneous tiers — and
each point trades assimilation throughput against fleet cost differently.
This suite runs each frontier scenario on ``device``, re-prices its exact
fleet through ``core/cost_model.fleet_cost`` (per-instance Table I
prices, server always on-demand), and emits one frontier point per
scenario:

    results_per_hour   assimilated results / simulated hour
    usd_per_1k_pre     preemptible-fleet dollars per 1000 results
    saving_frac        1 - preemptible/standard $/hr
    wire_gb            upload bytes actually shipped (real frames)

Points on the Pareto front (max throughput, min $/1k results) are marked.
Every field but ``bench_wall_s`` (the host wall of the scenario's run,
ending in a synchronize on the card) is a function of the event trace,
so it equals the reference's ``results/BENCH_frontier.json`` on any
device.  ``run --write`` writes ``results/BENCH_torch_frontier.json``;
this module writes nothing.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from repro_torch.core.cost_model import fleet_cost
from repro_torch.core.preemption import PreemptionModel, make_fleet
from repro_torch.device import resolve_device
from repro_torch.scenarios.registry import Scenario, get

# the frontier slice of the registry: the smoke point plus every
# behaviour scenario (each opens a different preemption/heterogeneity axis)
FRONTIER_SCENARIOS = ("fleet_smoke", "az_reclaim", "spot_price",
                      "diurnal", "tiered")


def _fleet_for(sc: Scenario):
    """Rebuild the exact fleet the simulator uses (same seeds), so the
    pricing below matches the simulated instance mix."""
    cfg = sc.config()
    if cfg.fleet_fn is not None:
        return cfg.fleet_fn(cfg)
    pre = PreemptionModel(mean_lifetime_s=cfg.mean_lifetime_s,
                          restart_delay_s=cfg.restart_delay_s,
                          enabled=cfg.preemptible)
    return make_fleet(cfg.n_clients, seed=cfg.seed, preemption=pre)


def _point(sc: Scenario, dev: torch.device) -> Dict:
    t0 = time.perf_counter()
    res = sc.run(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    bench_wall = time.perf_counter() - t0
    hours = max(res.wall_time_s, 1.0) / 3600.0
    itypes = [c.itype for c in _fleet_for(sc)]
    report = fleet_cost(itypes, hours, include_server=True)
    results_per_hour = res.results_assimilated / hours
    usd_per_1k_pre = (report.total_pre
                      / max(res.results_assimilated, 1) * 1000.0)
    return {
        "scenario": sc.name,
        "n_clients": sc.config().n_clients,
        "sim_hours": round(hours, 3),
        "bench_wall_s": round(bench_wall, 2),
        "results_assimilated": res.results_assimilated,
        "results_per_hour": round(results_per_hour, 1),
        "fleet_std_per_hr": round(report.fleet_std_per_hr, 2),
        "fleet_pre_per_hr": round(report.fleet_pre_per_hr, 2),
        "total_usd_std": round(report.total_std, 2),
        "total_usd_pre": round(report.total_pre, 2),
        "saving_frac": round(report.saving_frac, 4),
        "usd_per_1k_pre": round(usd_per_1k_pre, 3),
        "preemptions": res.preemptions,
        "wire_gb": round(res.wire.bytes_sent / 2 ** 30, 3),
    }


def _pareto(points: List[Dict]) -> List[str]:
    """Non-dominated set: maximize results_per_hour, minimize
    usd_per_1k_pre."""
    front = []
    for p in points:
        dominated = any(
            q["results_per_hour"] >= p["results_per_hour"]
            and q["usd_per_1k_pre"] <= p["usd_per_1k_pre"]
            and (q["results_per_hour"] > p["results_per_hour"]
                 or q["usd_per_1k_pre"] < p["usd_per_1k_pre"])
            for q in points)
        if not dominated:
            front.append(p["scenario"])
    return front


def bench_frontier(quick: bool = True, device="cuda") -> Dict:
    """The frontier points, the Pareto front and the reference's three
    claims; ``quick=False`` adds fleet_1k."""
    dev = resolve_device(device)
    names = FRONTIER_SCENARIOS if quick else (*FRONTIER_SCENARIOS,
                                              "fleet_1k")
    points = [_point(get(n), dev) for n in names]
    front = _pareto(points)
    for p in points:
        p["pareto"] = p["scenario"] in front
    return {
        "points": points,
        "pareto_front": front,
        "_claims": {
            "pareto_nonempty": bool(front),
            # §IV-E: preemptible fleets must stay in the published 70-90%
            # discount band for every scenario's instance mix
            "saving_in_paper_band": all(
                0.5 <= p["saving_frac"] <= 0.95 for p in points),
            "all_scenarios_assimilate": all(
                p["results_assimilated"] > 0 for p in points),
        },
    }
