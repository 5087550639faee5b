"""Training-cost model (§IV-E; port of ``repro/core/cost_model.py``,
standard library only): standard vs preemptible fleets, and the
wall-clock a preemption rate adds."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.preemption import (PAPER_FLEET, SERVER_INSTANCE,
                                         InstanceType)


@dataclass(frozen=True)
class CostReport:
    hours: float
    fleet_std_per_hr: float
    fleet_pre_per_hr: float
    total_std: float
    total_pre: float
    saving_frac: float


def fleet_cost(itypes: Sequence[InstanceType], hours: float,
               include_server: bool = False) -> CostReport:
    """Cost of running ``itypes`` for ``hours`` at standard and at
    preemptible prices; the server, when included, stays on-demand."""
    std = sum(t.price_standard for t in itypes)
    pre = sum(t.price_preemptible for t in itypes)
    if include_server:
        std += SERVER_INSTANCE.price_standard
        pre += SERVER_INSTANCE.price_standard
    return CostReport(
        hours=hours, fleet_std_per_hr=std, fleet_pre_per_hr=pre,
        total_std=std * hours, total_pre=pre * hours,
        saving_frac=1.0 - pre / std if std else 0.0)


def paper_p5c5_fleet() -> Sequence[InstanceType]:
    """The §IV-E experiment: 5 instances, 40 vCPU, 160 GB total."""
    return PAPER_FLEET


def preemption_overhead_hours(base_hours: float, preempt_rate_per_hr: float,
                              n_clients: int, restart_delay_s: float,
                              lost_work_s: float) -> float:
    """Expected wall-clock with preemptions: each event costs the restart
    delay plus the lost (reassigned) subtask work, amortized over the
    fleet."""
    events = preempt_rate_per_hr * n_clients * base_hours
    extra_s = events * (restart_delay_s + lost_work_s) / max(n_clients, 1)
    return base_hours + extra_s / 3600.0
