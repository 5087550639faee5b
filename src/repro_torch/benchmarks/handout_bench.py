"""Content-addressed handout serving suite (``run --only handout``; port
of the reference's ``benchmarks/handout_bench.py``).

Runs the registry's subscriber scenarios (10k flash-crowd and lagged
readers; 100k and 1M with ``--full``) and reports the read path's
economics: bytes SERVED to clients and subscribers against unique bytes
ENCODED by the frame cache (the dedup ratio), and the p50/p99 pull
latency through the modelled frontends.  Every such number is a function
of the event trace and of the bus's bytes, so each row's
``fingerprint_matches_reference`` holds it to the reference's
``results/BENCH_handout.json``.

Claims (the reference's keys): ``flash_10k_dedup_ge_50x``,
``lagged_10k_dedup_ge_10x``, ``bf16_bytes_halved`` (the same flash crowd
with ``handout_dtype="bfloat16"`` ships at most 0.55x the f32 bytes),
``p99_reported``, and ``flash_1m_dedup_ge_1000x`` with ``--full``.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.benchmarks.fleet_bench import (fingerprint_matches, timed_run,
                                                warm_up)

REFERENCE = (Path(__file__).resolve().parents[3] / "results"
             / "BENCH_handout.json")
FINGERPRINT = ("sim_wall_time_s", "epochs_done", "results_assimilated",
               "subscribers", "sub_pulls", "sub_frames_served",
               "sub_bytes_served", "handout_bytes_served",
               "handout_unique_bytes_encoded", "handout_dedup_ratio",
               "sub_latency_p50_s", "sub_latency_p99_s")

# headroom of the --check dedup floor (the ratio is deterministic; the
# floor flags an order-of-magnitude regression, a cache that re-encodes)
DEDUP_FLOOR_FRACTION = 0.5
# bf16 halves the body; the 68-byte header keeps the ratio above 0.5
BF16_BYTES_RATIO_MAX = 0.55


def _run(name: str, device, **overrides) -> dict:
    res, wall = timed_run(name, device, **overrides)
    return {
        "bench_wall_s": round(wall, 3),
        "events_processed": res.events_processed,
        "events_per_sec": round(res.events_processed / max(wall, 1e-9), 1),
        "sim_wall_time_s": res.wall_time_s,
        "epochs_done": res.epochs_done,
        "results_assimilated": res.results_assimilated,
        "subscribers": res.subscribers,
        "sub_pulls": res.sub_pulls,
        "sub_frames_served": res.sub_frames_served,
        "sub_bytes_served": int(res.sub_bytes_served),
        "handout_bytes_served": int(res.handout_bytes_served),
        "handout_unique_bytes_encoded": int(res.handout_unique_bytes_encoded),
        "handout_dedup_ratio": round(res.handout_dedup_ratio, 1),
        "sub_latency_p50_s": round(res.sub_latency_p50_s, 6),
        "sub_latency_p99_s": round(res.sub_latency_p99_s, 6),
    }


def bench_handout(quick: bool = True, device="cuda") -> dict:
    ref = json.loads(REFERENCE.read_text())
    names = ["handout_flash_10k", "handout_lagged_10k"]
    if not quick:
        names += ["handout_flash_100k", "handout_flash_1m"]
    warm_up(device)
    out: dict = {}
    for name in names:
        out[name] = _run(name, device)
    # the same flash crowd in bf16 download frames: half the bytes on
    # both the served and the unique-encoded side
    bf16 = _run("handout_flash_10k", device, handout_dtype="bfloat16")
    out["handout_flash_10k_bf16"] = bf16
    f32 = out["handout_flash_10k"]
    bf16["bytes_vs_f32"] = round(
        bf16["handout_bytes_served"] / max(f32["handout_bytes_served"], 1), 3)
    for name, entry in out.items():
        if name in ref:
            entry["fingerprint_matches_reference"] = fingerprint_matches(
                entry, ref[name], FINGERPRINT)
    claims = {
        "flash_10k_dedup_ge_50x": f32["handout_dedup_ratio"] >= 50.0,
        "lagged_10k_dedup_ge_10x":
            out["handout_lagged_10k"]["handout_dedup_ratio"] >= 10.0,
        "bf16_bytes_halved": bf16["bytes_vs_f32"] <= BF16_BYTES_RATIO_MAX,
        "p99_reported": all(
            out[n]["sub_latency_p99_s"] > 0.0 for n in names),
    }
    if "handout_flash_1m" in out:
        claims["flash_1m_dedup_ge_1000x"] = (
            out["handout_flash_1m"]["handout_dedup_ratio"] >= 1000.0)
    out["_claims"] = claims
    return out


def smoke_unique_to_served(device="cuda") -> float:
    """Dedup ratio (bytes served / unique bytes encoded) of the tiny
    smoke scenario: the --check floor."""
    return _run("handout_smoke", device)["handout_dedup_ratio"]
