"""Fleet-scale event-loop suite (``run --only fleet``; port of the
reference's ``benchmarks/fleet_bench.py``).

Runs the registry's fleet scenarios (1k / 10k clients; 100k with
``--full``) on the port and reports each run's host wall and events/sec,
plus the aggregation-tier comparison: the same 10k fleet behind 32 edge
aggregators (``fleet_10k_tier``), claiming the hub's upstream frame count
shrinks by at least half the fan-in against flat.

The fingerprint fields (simulated wall clock, results, preemptions, wire
and handout bytes) are functions of the event trace alone, so they must
equal the reference's ``results/BENCH_fleet.json`` on any device: each
row carries ``fingerprint_matches_reference``, and the fleet_1k /
fleet_10k rows keep the reference's claim keys for it.  The reference's
``10k_speedup_ge_10x`` is not claimed: it compares the reference's own
event loop before and after a refactor, and no wall of the port is
comparable with those CPU walls.  The port reports ``events_per_sec``
(events processed over the host wall, ending in a synchronize on the
card) instead.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from repro_torch.device import resolve_device

REFERENCE = Path(__file__).resolve().parents[3] / "results" / "BENCH_fleet.json"
FINGERPRINT = ("sim_wall_time_s", "results_assimilated", "preemptions",
               "wire_bytes_sent", "handout_bytes")

# headroom of the --check throughput floor: it fails only when the smoke
# scenario's events/sec drops below the pinned baseline x FLOOR_FRACTION
FLOOR_FRACTION = 0.25


def warm_up(device="cuda") -> None:
    """One small untimed fleet run (40 clients, a tier and subscribers),
    so that no timed run carries the process's first kernel build, CUDA
    start-up or allocator growth."""
    timed_run("fleet_smoke", device, n_clients=40, n_shards=80,
              aggregators=2, subscribers=20)


def timed_run(name: str, device="cuda", **overrides):
    """(SimResult, host wall s) of one registry scenario on ``device``;
    the wall ends in a synchronize on the card."""
    from repro_torch.scenarios.registry import get
    dev = resolve_device(device)
    t0 = time.perf_counter()
    res = get(name).run(device=dev, **overrides)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def _run(name: str, device) -> dict:
    res, wall = timed_run(name, device)
    return {
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
        # result frames the HUB transport carried upward: per-client
        # payloads when flat, merged KIND_AGG frames behind the tier
        "upstream_frames": int(res.wire.frames_sent) - res.handout_frames,
        "aggregators": res.aggregators,
        "agg_flushes": res.agg_flushes,
    }


def fingerprint_matches(entry: dict, ref: dict, fields) -> bool:
    return all(entry[k] == ref[k] for k in fields)


def bench_fleet(quick: bool = True, device="cuda") -> dict:
    ref = json.loads(REFERENCE.read_text())
    names = ["fleet_1k", "fleet_10k"] + ([] if quick else ["fleet_100k"])
    warm_up(device)
    out: dict = {}
    claims = {}
    for name in names:
        entry = _run(name, device)
        if name in ref:
            ok = fingerprint_matches(entry, ref[name], FINGERPRINT)
            entry["fingerprint_matches_reference"] = ok
            claims[f"{name}_fingerprint_identical"] = ok
        out[name] = entry
    if "fleet_10k" in out:
        # the hub sees ONE merged frame per flush window instead of one
        # frame per result: a reduction on the order of the fan-in
        # (10000 / 32 = 312.5 clients an aggregator)
        tier = _run("fleet_10k_tier", device)
        flat_up = out["fleet_10k"]["upstream_frames"]
        fan_in = 10000 / 32
        tier["upstream_reduction_x"] = round(
            flat_up / max(tier["upstream_frames"], 1), 1)
        tier["upstream_bytes_reduction_x"] = round(
            out["fleet_10k"]["wire_bytes_sent"]
            / max(tier["wire_bytes_sent"], 1), 1)
        tier["fingerprint_matches_reference"] = fingerprint_matches(
            tier, ref["fleet_10k_tier"],
            FINGERPRINT + ("upstream_frames", "agg_flushes"))
        out["fleet_10k_tier"] = tier
        claims["10k_tier_all_results_assimilated"] = (
            tier["results_assimilated"]
            == out["fleet_10k"]["results_assimilated"])
        claims["10k_tier_upstream_reduction_ge_half_fan_in"] = (
            tier["upstream_reduction_x"] >= 0.5 * fan_in)
    if "fleet_100k" in out:
        claims["100k_single_digit_minutes"] = (
            out["fleet_100k"]["bench_wall_s"] < 600.0)
    out["_claims"] = claims
    return out


def smoke_events_per_sec(device="cuda") -> float:
    """events/sec of the tiny smoke scenario: the --check floor."""
    warm_up(device)
    return _run("fleet_smoke", device)["events_per_sec"]
