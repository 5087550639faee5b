"""Client-fleet models: heterogeneity, network latency, preemption (§III-B,
§III-E).  All distributions are seeded and deterministic, so every
experiment in EXPERIMENTS.md reproduces bit-for-bit.

Copied unchanged from ``repro/core/preemption.py`` (numpy and the standard library
only): the port keeps its own copy so that it never imports the
reference, and every numpy rng stream stays identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class InstanceType:
    """Mirrors the paper's Table I fleet + §IV-E pricing."""
    name: str
    vcpu: int
    clock_ghz: float
    ram_gb: int
    net_gbps: float
    price_standard: float        # $/hr
    price_preemptible: float     # $/hr
    # relative training throughput (samples/s multiplier vs the 2.3GHz/8vCPU
    # reference server) — heterogeneity knob
    rel_speed: float = 1.0


# the paper's Table I fleet (prices from §IV-E: fleet of 5 = $1.67/hr std,
# $0.50/hr preemptible -> per-instance averages; per-type prices chosen to
# reproduce those totals with the published 70-90% discount band)
PAPER_FLEET = (
    InstanceType("c5.2xlarge-a", 8, 2.2, 32, 5, 0.340, 0.102, rel_speed=0.96),
    InstanceType("c5.2xlarge-b", 8, 2.5, 32, 5, 0.340, 0.102, rel_speed=1.09),
    InstanceType("c5a.2xlarge", 8, 2.8, 15, 2, 0.308, 0.092, rel_speed=1.22),
    InstanceType("c5a.4xlarge", 16, 2.8, 30, 2, 0.616, 0.185, rel_speed=2.30),
    InstanceType("m5.2xlarge", 8, 2.3, 61, 10, 0.384, 0.115, rel_speed=1.00),
)

SERVER_INSTANCE = InstanceType("m5.4xlarge-server", 8, 2.3, 61, 10,
                               0.768, 0.768, rel_speed=1.0)


@dataclass
class PreemptionModel:
    """Exponential instance lifetime (memoryless — matches how cloud spot
    reclaims behave at fleet scale) + restart delay."""
    mean_lifetime_s: float = 3600.0     # expected time-to-preempt
    restart_delay_s: float = 120.0      # replacement instance spin-up
    enabled: bool = True

    def sample_lifetime(self, rng: np.random.Generator) -> float:
        if not self.enabled:
            return float("inf")
        return float(rng.exponential(self.mean_lifetime_s))

    def lifetime_end(self, rng: np.random.Generator, now: float,
                     client: Optional["ClientModel"] = None) -> float:
        """Absolute sim-time this instance dies if spawned at ``now``.
        The base model is memoryless: one exponential draw past ``now``.
        Subclasses may use ``client`` (AZ, instance type) for correlated
        or time-of-day effects."""
        return now + self.sample_lifetime(rng)


@dataclass
class SpotPricePreemption(PreemptionModel):
    """Spot-market preemption: a mean-reverting per-AZ price series on a
    fixed grid; an instance is reclaimed the first time its AZ's price
    rises above the bid.  All clients in one AZ die at the same crossing
    — the paper's mass-reclaim regime, driven by an actual price path
    instead of iid lifetimes.

    The series and its upward bid-crossing times are precomputed once
    per model (deterministic in ``price_seed``), so ``lifetime_end`` is
    a single ``searchsorted``."""
    bid: float = 1.0                    # $/hr the fleet bids
    price_mean: float = 0.85            # long-run price level
    price_sigma: float = 0.12           # per-step shock scale
    price_theta: float = 0.05           # mean-reversion rate per step
    price_dt_s: float = 60.0            # grid resolution
    horizon_s: float = 7 * 24 * 3600.0  # precomputed span
    n_az: int = 3
    price_seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng((self.price_seed, 0x5307))
        n_steps = max(int(self.horizon_s / self.price_dt_s), 2)
        self._crossings = []
        for az in range(max(self.n_az, 1)):
            shocks = rng.standard_normal(n_steps)
            p = np.empty(n_steps)
            p[0] = self.price_mean
            for i in range(1, n_steps):        # AR(1) mean reversion
                p[i] = (p[i - 1]
                        + self.price_theta * (self.price_mean - p[i - 1])
                        + self.price_sigma * shocks[i])
            above = p > self.bid
            up = np.flatnonzero(above[1:] & ~above[:-1]) + 1
            self._crossings.append(up.astype(np.float64) * self.price_dt_s)

    def lifetime_end(self, rng: np.random.Generator, now: float,
                     client: Optional["ClientModel"] = None) -> float:
        del rng                             # price path is the only driver
        if not self.enabled:
            return float("inf")
        az = (client.az if client is not None else 0) % max(self.n_az, 1)
        times = self._crossings[az]
        i = int(np.searchsorted(times, now, side="right"))
        return float(times[i]) if i < len(times) else float("inf")


@dataclass
class CorrelatedReclaimModel(PreemptionModel):
    """Individual exponential lifetimes PLUS per-AZ mass reclaims: at
    Poisson times every live instance in the AZ vanishes at once (the
    thundering-herd case — all survivors of the AZ re-download the full
    model through the delta ledger when they respawn)."""
    az_reclaim_interval_s: float = 6 * 3600.0   # mean gap between AZ events
    n_az: int = 3
    horizon_s: float = 7 * 24 * 3600.0
    reclaim_seed: int = 0

    def __post_init__(self) -> None:
        self._az_times = []
        for az in range(max(self.n_az, 1)):
            rng = np.random.default_rng((self.reclaim_seed, 0xA2, az))
            t, times = 0.0, []
            while t < self.horizon_s:
                t += float(rng.exponential(self.az_reclaim_interval_s))
                times.append(t)
            self._az_times.append(np.asarray(times))

    def lifetime_end(self, rng: np.random.Generator, now: float,
                     client: Optional["ClientModel"] = None) -> float:
        if not self.enabled:
            return float("inf")
        own = now + float(rng.exponential(self.mean_lifetime_s))
        az = (client.az if client is not None else 0) % max(self.n_az, 1)
        times = self._az_times[az]
        i = int(np.searchsorted(times, now, side="right"))
        az_next = float(times[i]) if i < len(times) else float("inf")
        return min(own, az_next)


@dataclass
class DiurnalChurnModel(PreemptionModel):
    """Volunteer-computing churn: the departure hazard follows a 24h
    sinusoid (volunteers leave when their machines wake up for the day),
    phase-shifted per region.  Lifetimes are drawn by inverting the
    cumulative hazard — one Exp(1) draw + one ``searchsorted`` against a
    precomputed per-region hazard grid."""
    amplitude: float = 0.8              # hazard swing, 0..1
    period_s: float = 24 * 3600.0
    n_regions: int = 4
    grid_dt_s: float = 300.0
    horizon_s: float = 14 * 24 * 3600.0

    def __post_init__(self) -> None:
        base_rate = 1.0 / max(self.mean_lifetime_s, 1e-9)
        n = max(int(self.horizon_s / self.grid_dt_s), 2)
        t = np.arange(n) * self.grid_dt_s
        self._grid_t = t
        self._cum = []
        for r in range(max(self.n_regions, 1)):
            phase = (r / max(self.n_regions, 1)) * self.period_s
            lam = base_rate * (1.0 + self.amplitude
                               * np.sin(2 * np.pi * (t + phase)
                                        / self.period_s))
            self._cum.append(np.concatenate(
                [[0.0], np.cumsum(lam[:-1] * self.grid_dt_s)]))

    def lifetime_end(self, rng: np.random.Generator, now: float,
                     client: Optional["ClientModel"] = None) -> float:
        if not self.enabled:
            return float("inf")
        region = ((client.az if client is not None else 0)
                  % max(self.n_regions, 1))
        cum, t = self._cum[region], self._grid_t
        u = float(rng.exponential(1.0))     # target hazard mass
        base = float(np.interp(now, t, cum))
        i = int(np.searchsorted(cum, base + u, side="left"))
        if i >= len(t):                     # beyond the grid: mean rate
            tail = (base + u) - cum[-1]
            return float(t[-1] + tail * self.mean_lifetime_s)
        return float(t[i])


@dataclass(frozen=True)
class KillSchedule:
    """Deterministic coordinator-kill injection for the fault-injection
    harness (core/simulator.py::run_preemptible_training): the coordinator
    'dies' immediately before executing each listed global step, losing
    ALL in-memory state — recovery must come entirely from the last
    one-pass train checkpoint (checkpoint/store.py).  Each kill fires
    once; steps re-reached after a restore are not re-killed."""

    kill_steps: tuple = ()

    @classmethod
    def at(cls, *steps: int) -> "KillSchedule":
        return cls(kill_steps=tuple(sorted(set(int(s) for s in steps))))

    @classmethod
    def exponential(cls, mean_interval_steps: float, horizon: int,
                    seed: int = 0) -> "KillSchedule":
        """Memoryless kill times (the spot-reclaim model of
        PreemptionModel, in steps instead of seconds)."""
        rng = np.random.default_rng(seed)
        steps, t = [], 0.0
        while True:
            t += float(rng.exponential(mean_interval_steps))
            if t >= horizon:
                break
            steps.append(int(t))
        return cls.at(*steps)


@dataclass
class LatencyModel:
    """WAN-ish transfer latency: base RTT + size/bandwidth + lognormal jitter
    (§III-B: clients in different regions see variable latency)."""
    base_s: float = 0.15
    jitter_sigma: float = 0.5

    def sample(self, rng: np.random.Generator, nbytes: float,
               net_gbps: float) -> float:
        bw = net_gbps * 1e9 / 8.0
        jitter = float(rng.lognormal(0.0, self.jitter_sigma))
        return self.base_s * jitter + nbytes / bw


@dataclass
class ClientModel:
    """One volunteer/preemptible client: instance type + stochastic state."""
    cid: int
    itype: InstanceType
    preemption: PreemptionModel
    latency: LatencyModel
    rng: np.random.Generator
    alive_until: float = 0.0
    reliability: float = 1.0            # scheduler's EMA estimate
    az: int = 0                         # availability zone / region

    def spawn(self, now: float) -> None:
        self.alive_until = self.preemption.lifetime_end(self.rng, now, self)

    def compute_time(self, base_cost_s: float) -> float:
        """Time to run a subtask whose reference cost is base_cost_s on the
        1.0-speed instance; +-10% run-to-run noise."""
        noise = 1.0 + 0.1 * float(self.rng.standard_normal())
        return max(base_cost_s / self.itype.rel_speed * max(noise, 0.5), 1e-3)

    def transfer_time(self, nbytes: float) -> float:
        return self.latency.sample(self.rng, nbytes, self.itype.net_gbps)


def make_fleet(n_clients: int, *, seed: int = 0,
               preemption: Optional[PreemptionModel] = None,
               latency: Optional[LatencyModel] = None,
               tiers: Optional[list] = None,
               n_az: int = 1) -> list[ClientModel]:
    """Build the client fleet.  ``tiers`` (optional) is a list of
    ``(InstanceType, weight)`` pairs for heterogeneous compute/bandwidth
    mixes — picks use a SEPARATE rng stream so the default path's
    per-client seed consumption (and thus every pinned trace) is
    unchanged.  ``n_az`` spreads clients round-robin over availability
    zones / regions for the correlated preemption models."""
    preemption = preemption or PreemptionModel()
    latency = latency or LatencyModel()
    rng = np.random.default_rng(seed)
    if tiers:
        trng = np.random.default_rng((seed, 0x71E5))
        w = np.asarray([t[1] for t in tiers], np.float64)
        picks = trng.choice(len(tiers), size=n_clients, p=w / w.sum())
    fleet = []
    for cid in range(n_clients):
        itype = (tiers[picks[cid]][0] if tiers
                 else PAPER_FLEET[cid % len(PAPER_FLEET)])
        fleet.append(ClientModel(
            cid=cid, itype=itype, preemption=preemption, latency=latency,
            rng=np.random.default_rng(rng.integers(2 ** 63)),
            az=cid % max(n_az, 1)))
    return fleet
