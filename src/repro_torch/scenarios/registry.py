"""Fleet-scale scenario registry (port of ``repro/scenarios/registry.py``):
named, fixed (cfg, fleet, scheme) bundles that the fleet and handout
bench suites and ``chip_smoke.py`` run THE SAME WAY, with the
reference's names, configurations and fleet functions.

Every scenario is deterministic in its seed.  The fleet-size scenarios
(``fleet_1k/10k/100k``) use the ``ProbeTask`` surrogate (real protocol +
wire bytes, one-element client nudges) so the measurement is the event
loop and the protocol; the behaviour scenarios (``az_reclaim``, ``spot_price``,
``diurnal``, ``tiered``) open the preemption-model space stubbed by
core/preemption.py — ``az_reclaim`` runs a SHARDED parameter bus so the
thundering-herd mass re-download exercises the version-vector delta
ledger end to end.

Run one from the CLI (on the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.scenarios.registry \
        --scenario fleet_1k [--device cpu] [--json]
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core.preemption import (PAPER_FLEET, CorrelatedReclaimModel,
                                   DiurnalChurnModel, LatencyModel,
                                   PreemptionModel, SpotPricePreemption,
                                   make_fleet)
from repro_torch.core.simulator import SimConfig, SimResult, run_simulation
from repro_torch.scenarios.probe import ProbeTask, make_probe_data


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    cfg_kwargs: dict
    # builds the fleet off cfg (None = the simulator's default path)
    fleet_fn: Optional[Callable] = None
    vc_beta: float = 0.95                # VC-ASGD averaging weight
    # ProbeTask constructor kwargs (e.g. a wider bus for the handout-
    # serving scenarios, so updates spread across several chunks)
    task_kwargs: Optional[dict] = None

    def config(self, **overrides) -> SimConfig:
        """Build the SimConfig; ``overrides`` lets a benchmark re-run
        the SAME scenario with one knob turned (e.g. handout_dtype)."""
        return SimConfig(fleet_fn=self.fleet_fn,
                         **{**self.cfg_kwargs, **overrides})

    def run(self, device="cuda", **overrides) -> SimResult:
        """Run on ``device`` (the probe bus lives there); ``overrides``
        turn SimConfig knobs."""
        from repro_torch.core.baselines import VCASGD
        cfg = self.config(**overrides)
        task = ProbeTask(**(self.task_kwargs or {}))
        data = make_probe_data(cfg.n_shards, seed=cfg.seed)
        return run_simulation(task, data, VCASGD(self.vc_beta), cfg,
                              device=device)


# ---- fleets (cfg -> list[ClientModel]) -------------------------------------

def _az_reclaim_fleet(cfg: SimConfig):
    model = CorrelatedReclaimModel(
        mean_lifetime_s=cfg.mean_lifetime_s,
        restart_delay_s=cfg.restart_delay_s,
        enabled=cfg.preemptible,
        az_reclaim_interval_s=4 * 3600.0, n_az=3, reclaim_seed=cfg.seed)
    return make_fleet(cfg.n_clients, seed=cfg.seed, preemption=model,
                      n_az=3)


def _spot_price_fleet(cfg: SimConfig):
    model = SpotPricePreemption(
        mean_lifetime_s=cfg.mean_lifetime_s,
        restart_delay_s=cfg.restart_delay_s,
        enabled=cfg.preemptible,
        bid=0.95, n_az=3, price_seed=cfg.seed)
    return make_fleet(cfg.n_clients, seed=cfg.seed, preemption=model,
                      n_az=3)


def _diurnal_fleet(cfg: SimConfig):
    model = DiurnalChurnModel(
        mean_lifetime_s=cfg.mean_lifetime_s,
        restart_delay_s=cfg.restart_delay_s,
        enabled=cfg.preemptible, n_regions=4)
    return make_fleet(cfg.n_clients, seed=cfg.seed, preemption=model,
                      n_az=4)


def _tiered_fleet(cfg: SimConfig):
    # fast/medium/slow compute+bandwidth mix (weights sum to 1)
    tiers = [(PAPER_FLEET[3], 0.2),      # c5a.4xlarge: 2.3x speed
             (PAPER_FLEET[4], 0.5),      # m5.2xlarge: reference
             (PAPER_FLEET[2], 0.3)]      # c5a.2xlarge: 1.2x, 2 Gbps
    model = PreemptionModel(mean_lifetime_s=cfg.mean_lifetime_s,
                            restart_delay_s=cfg.restart_delay_s,
                            enabled=cfg.preemptible)
    return make_fleet(cfg.n_clients, seed=cfg.seed, preemption=model,
                      tiers=tiers)


# ---- the registry -----------------------------------------------------------
# fleet_1k / fleet_10k / fleet_10k_tier and the handout scenarios are the
# configurations results/BENCH_fleet.json and BENCH_handout.json
# fingerprint: the port's runs must reproduce those traces exactly.

SCENARIOS: Dict[str, Scenario] = {}


def _reg(s: Scenario) -> Scenario:
    SCENARIOS[s.name] = s
    return s


_reg(Scenario(
    "fleet_smoke",
    "tiny fleet scenario for the CI gate (seconds)",
    dict(n_param_servers=2, n_clients=200, tasks_per_client=1,
         n_shards=400, max_epochs=1, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=7)))

_reg(Scenario(
    "fleet_1k",
    "1k clients x 2 epochs, exponential churn, probe task",
    dict(n_param_servers=4, n_clients=1000, tasks_per_client=1,
         n_shards=2000, max_epochs=2, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=7)))

_reg(Scenario(
    "fleet_10k",
    "10k clients x 1 epoch, exponential churn, probe task",
    dict(n_param_servers=8, n_clients=10000, tasks_per_client=1,
         n_shards=12000, max_epochs=1, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.02, seed=7)))

_reg(Scenario(
    "fleet_smoke_tier",
    "fleet_smoke behind 4 edge aggregators (2-level CI smoke)",
    dict(n_param_servers=2, n_clients=200, tasks_per_client=1,
         n_shards=400, max_epochs=1, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=7, aggregators=4)))

_reg(Scenario(
    "fleet_10k_tier",
    "fleet_10k behind 32 edge aggregators: clients lease from their edge, "
    "the hub sees ONE merged KIND_AGG frame per flush window (~312 "
    "clients' results) — the 2-level fan-in the ROADMAP scale item asks "
    "for; compare hub wire counters against flat fleet_10k",
    dict(n_param_servers=8, n_clients=10000, tasks_per_client=1,
         n_shards=12000, max_epochs=1, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.02, seed=7, aggregators=32)))

_reg(Scenario(
    "fleet_100k",
    "100k clients x 3 epochs, exponential churn, eval every 64th result",
    dict(n_param_servers=16, n_clients=100000, tasks_per_client=1,
         n_shards=100000, max_epochs=3, local_steps=1,
         timeout_s=3600.0, preemptible=True, mean_lifetime_s=14400.0,
         restart_delay_s=120.0, subtask_compute_s=300.0,
         server_proc_s=0.005, seed=7, eval_stride=64)))

# ---- content-addressed handout serving (read-heavy scenarios) --------------
# A modest trainer fleet keeps the bus moving; the measurement is the
# SERVING leg: N read-only subscribers pulling through the coordinator's
# frame cache (protocol/handout.py).  The probe bus is widened to 64k
# params (8 chunks of one BLOCK each) so updates spread across several
# chunks instead of always landing in chunk 0.  Headline numbers:
# bytes-served / unique-bytes-encoded (dedup) and p99 pull latency.

_SERVE_TASK = dict(dim=65536)
_SERVE_BASE = dict(n_param_servers=2, n_clients=200, tasks_per_client=1,
                   n_shards=400, max_epochs=2, local_steps=1,
                   timeout_s=1800.0, preemptible=True,
                   mean_lifetime_s=5400.0, restart_delay_s=120.0,
                   subtask_compute_s=120.0, server_proc_s=0.05, seed=7,
                   bus_shards=8)

_reg(Scenario(
    "handout_smoke",
    "tiny serving scenario for the CI gate and the --check dedup floor: "
    "400 flash-crowd subscribers over a 50-trainer fleet (seconds)",
    dict(_SERVE_BASE, n_clients=50, n_shards=100, max_epochs=1,
         subscribers=400, sub_lag="flash", sub_interval_s=120.0,
         sub_jitter_s=20.0),
    task_kwargs=_SERVE_TASK))

_reg(Scenario(
    "handout_flash_10k",
    "10k subscribers re-pulling in 30s flash crowds every 240s while 200 "
    "trainers move the bus: one encode per changed chunk serves the "
    "whole crowd (the >=50x dedup acceptance scenario)",
    dict(_SERVE_BASE, subscribers=10000, sub_lag="flash",
         sub_interval_s=240.0, sub_jitter_s=30.0),
    task_kwargs=_SERVE_TASK))

_reg(Scenario(
    "handout_lagged_10k",
    "10k subscribers at heavy-tailed (lognormal) re-pull lag, mean 300s: "
    "staggered reads, varied staleness per pull",
    dict(_SERVE_BASE, subscribers=10000, sub_lag="lognormal",
         sub_interval_s=300.0),
    task_kwargs=_SERVE_TASK))

_reg(Scenario(
    "handout_flash_100k",
    "100k flash-crowd subscribers, one epoch (bench --full scale)",
    dict(_SERVE_BASE, max_epochs=1, subscribers=100000, sub_lag="flash",
         sub_interval_s=240.0, sub_jitter_s=60.0, sub_frontends=16),
    task_kwargs=_SERVE_TASK))

_reg(Scenario(
    "handout_flash_1m",
    "1M flash-crowd subscribers, one epoch: the cache stays bounded at "
    "n_chunks x keep_rounds frames while serving ~8M frames (--full)",
    dict(_SERVE_BASE, n_clients=100, n_shards=200, max_epochs=1,
         subscribers=1000000, sub_lag="flash", sub_interval_s=300.0,
         sub_jitter_s=120.0, sub_frontends=64),
    task_kwargs=_SERVE_TASK))


_reg(Scenario(
    "az_reclaim",
    "correlated AZ mass reclaims over a SHARDED bus: the thundering herd "
    "of full re-downloads goes through the version-vector delta ledger",
    dict(n_param_servers=4, n_clients=600, tasks_per_client=1,
         n_shards=1200, max_epochs=2, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=7200.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=11, bus_shards=8),
    fleet_fn=_az_reclaim_fleet))

_reg(Scenario(
    "spot_price",
    "spot-market preemption: per-AZ mean-reverting price vs a fixed bid",
    dict(n_param_servers=4, n_clients=600, tasks_per_client=1,
         n_shards=1200, max_epochs=2, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=180.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=11),
    fleet_fn=_spot_price_fleet))

_reg(Scenario(
    "diurnal",
    "volunteer churn with a 24h sinusoidal departure hazard per region",
    dict(n_param_servers=4, n_clients=600, tasks_per_client=1,
         n_shards=1200, max_epochs=2, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=10800.0,
         restart_delay_s=300.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=11),
    fleet_fn=_diurnal_fleet))

_reg(Scenario(
    "tiered",
    "heterogeneous compute/bandwidth tiers (20% fast / 50% ref / 30% slow)",
    dict(n_param_servers=4, n_clients=600, tasks_per_client=1,
         n_shards=1200, max_epochs=2, local_steps=1,
         timeout_s=1800.0, preemptible=True, mean_lifetime_s=5400.0,
         restart_delay_s=120.0, subtask_compute_s=120.0,
         server_proc_s=0.05, seed=11),
    fleet_fn=_tiered_fleet))


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


def summarize(sc: Scenario, res: SimResult, wall: float) -> dict:
    """The reference CLI's summary of one run (``wall`` in host seconds)."""
    summary = {
        "scenario": sc.name,
        "bench_wall_s": round(wall, 3),
        "events_processed": res.events_processed,
        "events_per_sec": round(res.events_processed / max(wall, 1e-9), 1),
        "sim_wall_time_s": res.wall_time_s,
        "epochs_done": res.epochs_done,
        "results_assimilated": res.results_assimilated,
        "preemptions": res.preemptions,
        "reassignments": res.reassignments,
        "final_accuracy": res.final_accuracy,
        "wire_bytes_sent": int(res.wire.bytes_sent),
        "handout_frames": res.handout_frames,
        "handout_bytes": int(res.handout_bytes),
    }
    if res.aggregators:
        summary.update({
            "aggregators": res.aggregators,
            "agg_flushes": res.agg_flushes,
            "upstream_agg_frames": res.wire_agg_frames,
            "edge_bytes_sent": int(res.edge_wire.bytes_sent),
        })
    if res.subscribers:
        summary.update({
            "subscribers": res.subscribers,
            "sub_pulls": res.sub_pulls,
            "sub_bytes_served": res.sub_bytes_served,
            "unique_bytes_encoded": res.handout_unique_bytes_encoded,
            "handout_dedup_ratio": round(res.handout_dedup_ratio, 1),
            "sub_latency_p99_s": round(res.sub_latency_p99_s, 4),
        })
    return summary


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios.registry",
        description="Run one fleet scenario and print its summary.")
    ap.add_argument("--scenario", required=True,
                    help="one of: " + ", ".join(sorted(SCENARIOS)))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", action="store_true",
                    help="emit the result summary as json")
    args = ap.parse_args(argv)
    sc = get(args.scenario)
    t0 = time.perf_counter()
    res = sc.run(device=args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = summarize(sc, res, wall)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        for k, v in summary.items():
            print(f"{k:>22}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
