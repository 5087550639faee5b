"""The paper's figures and tables on the port (counterpart of the
reference's ``benchmarks/paper_figs.py``): one function per artifact,
the same configurations (``_base``, quick and full) and the same
``_claims``.

Accuracy dynamics are real (the MLP trained on the synthetic task, one
fused Adam launch a client step and one fused Eq. 1 launch a result on
the card); wall clock is simulated from the paper's measured constants
(§IV-A sizes, §IV-D latencies, Table I speeds), so every hour figure is
a function of the event trace alone and equals the reference's for the
same configuration.  ``quick`` shrinks epochs and shards; ``quick=False``
is the paper's 40-epoch horizon.  Every suite takes ``device`` (the card
unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.baselines import VCASGD
from repro_torch.core.cost_model import fleet_cost, paper_p5c5_fleet
from repro_torch.core.simulator import (SimConfig, SimResult, run_simulation,
                                        run_single_instance)
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.core.vc_asgd import var_alpha


def _task_data(quick: bool):
    n = 2500 if quick else 5000
    return MLPTask(), make_classification_data(n_train=n, n_val=800)


def _base(quick: bool, **kw) -> SimConfig:
    # param_bytes / upload_bytes pin both transfer legs to the paper's
    # measured 21.2 MB .h5 (§IV-A), so the timings stay paper-calibrated
    base = dict(n_shards=20 if quick else 50,
                max_epochs=8 if quick else 40,
                local_steps=2 if quick else 4,
                subtask_compute_s=180.0, seed=11,
                param_bytes=21.2e6, upload_bytes=21.2e6)
    base.update(kw)
    return SimConfig(**base)


def _curve(res: SimResult) -> List[Dict]:
    return [dict(epoch=p.epoch, hours=p.t_complete / 3600,
                 acc=round(p.acc_mean, 4), std=round(p.acc_std, 4))
            for p in res.points]


def fig2_distributed(quick: bool = True, device="cuda") -> Dict:
    """Fig. 2: accuracy vs time for P1C3T2 / P1C3T8 / P3C3T8 / P5C5T2,
    alpha = 0.95."""
    task, data = _task_data(quick)
    out = {}
    for name, (P, C, T) in {"P1C3T2": (1, 3, 2), "P1C3T8": (1, 3, 8),
                            "P3C3T8": (3, 3, 8), "P5C5T2": (5, 5, 2)}.items():
        cfg = _base(quick, n_param_servers=P, n_clients=C, tasks_per_client=T)
        res = run_simulation(task, data, VCASGD(0.95), cfg, device=device)
        out[name] = {"curve": _curve(res),
                     "final_acc": round(res.final_accuracy, 4),
                     "hours": round(res.wall_time_s / 3600, 3)}
    # paper claim: all configs converge to similar accuracy, times differ
    finals = [v["final_acc"] for v in out.values()]
    hours = [v["hours"] for v in out.values()]
    out["_claims"] = {
        "similar_final_accuracy": bool(max(finals) - min(finals) < 0.08),
        "times_differ": bool(max(hours) > 1.15 * min(hours)),
    }
    return out


def fig3_server_scaling(quick: bool = True, device="cuda") -> Dict:
    """Fig. 3: training time vs (Pn, Tn) — server backlog when Cn*Tn
    results outrun Pn serial assimilation."""
    task, data = _task_data(quick)
    out = {}
    for P, C in ((1, 3), (3, 3), (5, 5)):
        for T in (2, 4, 8):
            cfg = _base(quick, n_param_servers=P, n_clients=C,
                        tasks_per_client=T, server_proc_s=4.0)
            res = run_simulation(task, data, VCASGD(0.95), cfg,
                                 device=device)
            out[f"P{P}C{C}T{T}"] = round(res.wall_time_s / 3600, 3)
    out["_claims"] = {
        # P1C3T8 backlogs behind P3C3T8 (paper: ~3h gap at 40 epochs)
        "P3_faster_than_P1_at_T8": out["P3C3T8"] < out["P1C3T8"],
    }
    return out


def fig4_alpha(quick: bool = True, device="cuda") -> Dict:
    """Fig. 4/5: alpha in {0.7, 0.95, 0.999, Var} on P3C3T4."""
    task, data = _task_data(quick)
    out = {}
    schemes = {"0.7": VCASGD(0.7), "0.95": VCASGD(0.95),
               "0.999": VCASGD(0.999), "var": VCASGD(var_alpha())}
    for name, scheme in schemes.items():
        cfg = _base(quick, n_param_servers=3, n_clients=3, tasks_per_client=4)
        res = run_simulation(task, data, scheme, cfg, device=device)
        out[name] = {"curve": _curve(res),
                     "final_acc": round(res.final_accuracy, 4),
                     "mean_std": round(float(np.mean([p.acc_std
                                                      for p in res.points])),
                                       4)}
    early = {k: v["curve"][min(2, len(v["curve"]) - 1)]["acc"]
             for k, v in out.items()}
    out["_claims"] = {
        # small alpha learns faster early (rate prop. to 1-alpha)
        "alpha07_faster_early_than_0999": early["0.7"] > early["0.999"],
        # alpha=0.999 (EASGD-equivalent) is the slowest overall
        "alpha0999_slowest": out["0.999"]["final_acc"]
        == min(v["final_acc"] for k, v in out.items()
               if not k.startswith("_")),
        # var schedule at least matches 0.95 with smaller spread
        "var_competitive": out["var"]["final_acc"]
        >= out["0.95"]["final_acc"] - 0.02,
        "var_lower_std_than_07": out["var"]["mean_std"]
        <= out["0.7"]["mean_std"] + 1e-9,
    }
    return out


def fig6_vs_serial(quick: bool = True, device="cuda") -> Dict:
    """Fig. 6: distributed (P5C5T2, var alpha) vs single-instance serial."""
    task, data = _task_data(quick)
    cfg = _base(quick, n_param_servers=5, n_clients=5, tasks_per_client=2)
    dist = run_simulation(task, data, VCASGD(var_alpha()), cfg, device=device)
    serial = run_single_instance(task, data, max_epochs=cfg.max_epochs,
                                 steps_per_epoch=120 if quick else 250,
                                 epoch_time_s=dist.wall_time_s
                                 / max(dist.epochs_done, 1), device=device)
    gaps = [ps.acc_mean - pd.acc_mean
            for pd, ps in zip(dist.points, serial.points)]
    out = {
        "distributed": _curve(dist), "serial": _curve(serial),
        "final_gap": round(gaps[-1], 4) if gaps else None,
        "early_gap": round(gaps[min(2, len(gaps) - 1)], 4) if gaps else None,
        "dist_smoother": bool(np.std(np.diff([p.acc_mean for p in dist.points]))
                              <= np.std(np.diff([p.acc_mean
                                                 for p in serial.points]))),
    }
    out["_claims"] = {
        # serial >= distributed at matched epochs, gap shrinks over time
        "serial_ahead": (out["final_gap"] is not None
                         and out["final_gap"] > -0.02),
        "gap_narrows": (out["early_gap"] is not None
                        and out["final_gap"] <= out["early_gap"] + 0.02),
    }
    return out


def consistency_bench(quick: bool = True, device="cuda") -> Dict:
    """§IV-D: Redis (eventual) vs MySQL (strong) — per-update latency and
    the projected overhead at CIFAR10 (2k updates) / ImageNet (1.6M)
    scale."""
    from repro_torch.core.consistency import MYSQL_UPDATE_S, REDIS_UPDATE_S
    task, data = _task_data(quick)
    res = {}
    for mode in ("eventual", "strong"):
        cfg = _base(quick, n_param_servers=3, n_clients=3,
                    tasks_per_client=4, consistency=mode)
        r = run_simulation(task, data, VCASGD(0.95), cfg, device=device)
        res[mode] = {"hours": round(r.wall_time_s / 3600, 3),
                     "lost_updates": r.store_stats.lost_updates,
                     "queue_wait_s": round(r.store_stats.queue_wait_s, 1),
                     "final_acc": round(r.final_accuracy, 4)}
    per_update_gap = MYSQL_UPDATE_S - REDIS_UPDATE_S
    res["projection"] = {
        "per_update_ratio": round(MYSQL_UPDATE_S / REDIS_UPDATE_S, 3),
        "cifar_2000_updates_overhead_min": round(2000 * per_update_gap / 60,
                                                 1),
        "imagenet_1p6m_updates_overhead_hr":
            round(1_600_000 * per_update_gap / 3600, 1),
    }
    res["_claims"] = {
        "ratio_1p5x": abs(MYSQL_UPDATE_S / REDIS_UPDATE_S - 1.5) < 0.05,
        "cifar_overhead_14min": abs(
            res["projection"]["cifar_2000_updates_overhead_min"] - 14) < 1.0,
        "imagenet_overhead_187hr": abs(
            res["projection"]["imagenet_1p6m_updates_overhead_hr"] - 187) < 5,
        "strong_no_loss": res["strong"]["lost_updates"] == 0,
        "eventual_acc_tolerates_loss": abs(res["eventual"]["final_acc"]
                                           - res["strong"]["final_acc"]) < 0.1,
    }
    return res


def cost_bench(quick: bool = True, device="cuda") -> Dict:
    """§IV-E: preemptible vs standard fleet cost for the P5C5T2 run (a
    price table: ``device`` is accepted for a uniform suite signature and
    touched by nothing)."""
    rep = fleet_cost(paper_p5c5_fleet(), hours=8.0)
    out = {
        "fleet_std_per_hr": round(rep.fleet_std_per_hr, 3),
        "fleet_pre_per_hr": round(rep.fleet_pre_per_hr, 3),
        "run_8h_std": round(rep.total_std, 2),
        "run_8h_pre": round(rep.total_pre, 2),
        "saving_frac": round(rep.saving_frac, 3),
    }
    out["_claims"] = {
        # paper: $1.67/hr std, $0.50/hr preemptible, 70% saving, $4 vs $13.4
        "std_rate_matches": abs(out["fleet_std_per_hr"] - 1.67) < 0.35,
        "saving_70_90pct": 0.69 <= out["saving_frac"] <= 0.91,
        "run_cost_band": out["run_8h_pre"] < 0.35 * out["run_8h_std"],
    }
    return out


# suite name -> function(quick, device), the reference's names
SUITES = {"fig2": fig2_distributed, "fig3": fig3_server_scaling,
          "fig4": fig4_alpha, "fig6": fig6_vs_serial,
          "consistency": consistency_bench, "cost": cost_bench}
