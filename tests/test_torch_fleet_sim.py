"""The rest of the simulator on the CPU: the fixture's five fleet and
tier cases, the fleet event loop and the scenario registry, against the
reference.

Tolerances:
* the four ProbeTask cases of ``results/PINNED_sim_regression.json``
  (fleet-churn, fleet-sharded-bus, fleet-eval-stride, tier-fleet) equal
  the fixture in EVERY field, accuracy included, and the reference run
  live in every field and in the final bus, bit for bit: the probe's
  arithmetic is numpy's (one f32 rounding of the nudge, an f32 add, B1's
  plain version in the reference's operation order);
* tier-2level equals the port's own tier-flat-twin bit for bit (bus and
  final accuracy: one aggregator in front of one strong PS folds exactly
  what the flat hub folds), its trace and tier fields equal the fixture,
  and its accuracy is within 0.02 of the reference run live on the same
  params and minibatch draws (the MLP's training rounds differently at
  the ulp level; tests/test_torch_simulator.py says why);
* every other comparison with the reference (registry scenarios, same
  seed, eval stride, the sharded bus in the loop) is exact.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.baselines import VCASGD as RefVCASGD
from repro.core.simulator import SimConfig as RefSimConfig
from repro.core.simulator import run_simulation as ref_run
from repro.core.tasks import MLPTask as RefMLP
from repro.core.tasks import make_classification_data as ref_data
from repro.scenarios import registry as RREG
from repro.scenarios.probe import ProbeTask as RefProbe
from repro.scenarios.probe import make_probe_data as ref_probe_data
from repro_torch.convert import params_from_reference
from repro_torch.core.baselines import VCASGD
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.tasks import make_classification_data
from repro_torch.scenarios import registry as PREG
from repro_torch.scenarios.probe import ProbeTask, make_probe_data
from test_torch_tasks import InjectedDraws

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the port's pinned-case table)
import pin_sim_regression as PIN  # noqa: E402  (the reference's)

torch.set_num_threads(2)
PINNED = json.loads((ROOT / "results" / "PINNED_sim_regression.json")
                    .read_text())
PROBE_CASES = sorted(n for n, c in CS.PINNED_FLEET_CASES.items()
                     if c[3] == "probe")


def _bits(res):
    return res.scheme_state.params.buf.detach().cpu().numpy().view(np.uint32)


def _pinned(res) -> dict:
    return {**CS.pinned_fields(res),
            "final_accuracy": float(res.final_accuracy),
            "acc_mean": [float(p.acc_mean) for p in res.points]}


@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_pinned_case_exact_to_fixture_and_reference(name):
    scheme, cfg = CS.pinned_case(name)
    task, data = CS.pinned_task(name, cfg)
    res = run_simulation(task, data, scheme, cfg, device="cpu")
    want = PINNED["cases"][name]
    got = _pinned(res)
    assert set(want) <= set(got)
    for f in want:
        assert got[f] == want[f], f
    # the reference run live, on its numpy bus: same fields, same bits
    ref = PIN.run_case(None, None, name)
    assert {f: got[f] for f in ref} == ref
    rres = ref_run(RefProbe(), ref_probe_data(cfg.n_shards, seed=cfg.seed),
                   PIN.CASES[name][0](),
                   RefSimConfig(**{**PIN.BASE, **PIN.CASES[name][1]}))
    np.testing.assert_array_equal(
        _bits(res), np.asarray(rres.scheme_state.params.buf).view(np.uint32))
    assert res.events_processed == rres.events_processed
    # every result was asked for at least one step (the probe's nudge
    # scales with them)
    assert res.client_steps >= res.results_assimilated > 0


def test_tier_2level_is_its_flat_twin_and_tracks_the_reference():
    d = PINNED["data"]
    p0 = RefMLP().init_params(jax.random.PRNGKey(PIN.BASE["seed"]))
    params0 = params_from_reference({k: np.asarray(v) for k, v in p0.items()},
                                    "cpu")
    runs = {}
    for name in ("tier-flat-twin", "tier-2level"):
        scheme, cfg = CS.pinned_case(name)
        runs[name] = run_simulation(InjectedDraws(),
                                    make_classification_data(**d), scheme,
                                    cfg, device="cpu", params0=params0)
    twin, tier = runs["tier-flat-twin"], runs["tier-2level"]
    np.testing.assert_array_equal(_bits(tier), _bits(twin))
    assert tier.final_accuracy == twin.final_accuracy
    assert tier.results_assimilated == twin.results_assimilated == 9
    want = PINNED["cases"]["tier-2level"]
    got = CS.pinned_fields(tier)
    for f in CS.PIN_TRACE + CS.PIN_TIER:
        assert got[f] == want[f], f
    assert tier.wire.frames_sent < twin.wire.frames_sent
    ref = PIN.run_case(RefMLP(), ref_data(**d), "tier-2level")
    assert abs(tier.final_accuracy - ref["final_accuracy"]) <= 0.02
    assert [p.acc_mean for p in tier.points] == ref["acc_mean"] == [0.0]


# ---------------------------------------------------------------------------
# the fleet event loop (the reference's tests/test_scenarios.py), each run
# held to the reference's
# ---------------------------------------------------------------------------

def _small(**kw) -> dict:
    base = dict(n_param_servers=2, n_clients=60, tasks_per_client=1,
                n_shards=120, max_epochs=1, local_steps=1,
                timeout_s=1800.0, preemptible=True, mean_lifetime_s=3600.0,
                restart_delay_s=60.0, subtask_compute_s=60.0,
                server_proc_s=0.05, seed=3)
    base.update(kw)
    return base


def _fingerprint(res):
    return (res.wall_time_s, res.results_assimilated, res.preemptions,
            res.reassignments, res.final_accuracy,
            int(res.wire.bytes_sent), int(res.handout_bytes),
            res.events_processed, res.handout_frames, res.leases_dropped,
            res.leases_expired, [(p.t_complete, p.acc_mean)
                                 for p in res.points])


def _both(kw, ref_fleet_fn=None, port_fleet_fn=None):
    ref = ref_run(RefProbe(), ref_probe_data(kw["n_shards"], seed=kw["seed"]),
                  RefVCASGD(0.95), RefSimConfig(fleet_fn=ref_fleet_fn, **kw))
    port = run_simulation(ProbeTask(), make_probe_data(kw["n_shards"],
                                                       seed=kw["seed"]),
                          VCASGD(0.95),
                          SimConfig(fleet_fn=port_fleet_fn, **kw),
                          device="cpu")
    return ref, port


def test_same_seed_same_trace_as_the_reference():
    ref, port = _both(_small())
    again = run_simulation(ProbeTask(), make_probe_data(120, seed=3),
                           VCASGD(0.95), SimConfig(**_small()), device="cpu")
    assert _fingerprint(port) == _fingerprint(again) == _fingerprint(ref)
    assert port.events_processed > 0


def test_eval_stride_changes_only_eval_sampling():
    full = run_simulation(ProbeTask(), make_probe_data(120, seed=3),
                          VCASGD(0.95), SimConfig(**_small()), device="cpu")
    ref, strided = _both(_small(eval_stride=8))
    assert _fingerprint(strided) == _fingerprint(ref)
    for f in ("wall_time_s", "results_assimilated", "preemptions",
              "events_processed", "final_accuracy"):
        assert getattr(strided, f) == getattr(full, f), f
    assert int(strided.wire.bytes_sent) == int(full.wire.bytes_sent)


@pytest.mark.parametrize("kw", [dict(preemptible=False, bus_shards=4),
                                dict(bus_shards=3, handout_dtype="bfloat16"),
                                dict(aggregators=3, bus_shards=2),
                                dict(subscribers=30, sub_lag="lognormal",
                                     sub_interval_s=200.0),
                                dict(subscribers=30, sub_lag="uniform",
                                     sub_interval_s=200.0, aggregators=2,
                                     consistency="strong")])
def test_every_option_replays_the_reference(kw):
    """The sharded bus, bf16 handouts, the tier and subscribers (each
    arrival process) in the loop: every trace, wire, tier and serving
    field and the final bus equal the reference's."""
    ref, port = _both(_small(**kw))
    assert _fingerprint(port) == _fingerprint(ref)
    np.testing.assert_array_equal(
        _bits(port), np.asarray(ref.scheme_state.params.buf).view(np.uint32))
    for f in ("aggregators", "agg_flushes", "wire_agg_frames", "subscribers",
              "sub_pulls", "sub_frames_served", "sub_bytes_served",
              "handout_unique_bytes_encoded", "handout_bytes_served",
              "handout_dedup_ratio", "sub_latency_p50_s", "sub_latency_p99_s",
              "wire_dense_frames"):
        assert getattr(port, f) == getattr(ref, f), f
    assert dataclasses.asdict(port.wire) == dataclasses.asdict(ref.wire)
    if ref.edge_wire is not None:
        assert dataclasses.asdict(port.edge_wire) == dataclasses.asdict(
            ref.edge_wire)
    if kw.get("bus_shards", 1) > 1 and not kw.get("aggregators"):
        # later handouts skip unchanged shards
        assert port.handout_frames < kw["bus_shards"] * (
            port.results_assimilated + 60)


def test_subscribers_leave_the_trainer_trace_invariant():
    off = PREG.get("handout_smoke").run(device="cpu", subscribers=0)
    on = PREG.get("handout_smoke").run(device="cpu", subscribers=50)
    for f in ("final_accuracy", "wall_time_s", "epochs_done",
              "results_assimilated", "preemptions", "reassignments",
              "handout_frames", "handout_bytes"):
        assert getattr(on, f) == getattr(off, f), f
    assert on.sub_pulls > 0 and off.sub_pulls == 0
    np.testing.assert_array_equal(_bits(on), _bits(off))


def test_handout_smoke_dedups_reports_latency_and_bf16_halves():
    sc = PREG.get("handout_smoke")
    res = sc.run(device="cpu")
    ref = RREG.get("handout_smoke").run()
    assert res.subscribers == sc.config().subscribers
    assert res.sub_pulls > res.subscribers
    assert res.handout_dedup_ratio == ref.handout_dedup_ratio > 10.0
    assert res.handout_bytes_served > res.handout_unique_bytes_encoded
    assert 0.0 < res.sub_latency_p50_s <= res.sub_latency_p99_s
    assert res.sub_latency_p99_s == ref.sub_latency_p99_s
    b16 = sc.run(device="cpu", max_epochs=1, handout_dtype="bfloat16")
    f32 = sc.run(device="cpu", max_epochs=1)
    assert b16.sub_bytes_served < 0.55 * f32.sub_bytes_served
    assert b16.handout_bytes < 0.55 * f32.handout_bytes


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_is_the_references():
    assert set(PREG.SCENARIOS) == set(RREG.SCENARIOS)
    for name, sc in PREG.SCENARIOS.items():
        ref = RREG.SCENARIOS[name]
        assert (sc.name, sc.description, sc.cfg_kwargs, sc.vc_beta,
                sc.task_kwargs) == (ref.name, ref.description,
                                    ref.cfg_kwargs, ref.vc_beta,
                                    ref.task_kwargs), name
        assert (sc.fleet_fn is None) == (ref.fleet_fn is None), name
        if sc.fleet_fn is not None:
            assert sc.fleet_fn.__name__ == ref.fleet_fn.__name__
    with pytest.raises(KeyError):
        PREG.get("nope")


@pytest.mark.parametrize("fleet_fn", ["_az_reclaim_fleet", "_spot_price_fleet",
                                     "_diurnal_fleet", "_tiered_fleet"])
def test_fleet_functions_build_the_references_fleet(fleet_fn):
    kw = _small(n_clients=40, n_shards=80)
    port = getattr(PREG, fleet_fn)(SimConfig(**kw))
    ref = getattr(RREG, fleet_fn)(RefSimConfig(**kw))
    assert len(port) == len(ref) == 40
    for a, b in zip(port, ref):
        assert (a.cid, a.az, a.itype.name, type(a.preemption).__name__) == (
            b.cid, b.az, b.itype.name, type(b.preemption).__name__)
        assert a.rng.integers(2 ** 32) == b.rng.integers(2 ** 32)


@pytest.mark.parametrize("fleet_fn,extra", [
    ("_az_reclaim_fleet", {"bus_shards": 4}), ("_spot_price_fleet", {}),
    ("_diurnal_fleet", {}), ("_tiered_fleet", {})])
def test_behaviour_scenarios_replay_the_reference(fleet_fn, extra):
    kw = _small(n_clients=40, n_shards=80, **extra)
    ref, port = _both(kw, getattr(RREG, fleet_fn), getattr(PREG, fleet_fn))
    assert port.results_assimilated == 80 and port.final_accuracy > 0.0
    assert _fingerprint(port) == _fingerprint(ref)


def test_registry_smoke_run_and_cli(capsys):
    res = PREG.get("fleet_smoke").run(device="cpu")
    assert res.results_assimilated == 400 and res.events_processed > 0
    assert PREG.main(["--scenario", "fleet_smoke_tier", "--device", "cpu",
                      "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    ref = RREG.get("fleet_smoke_tier").run()
    assert out["results_assimilated"] == ref.results_assimilated == 400
    assert out["upstream_agg_frames"] == ref.wire_agg_frames
    assert out["edge_bytes_sent"] == ref.edge_wire.bytes_sent
    assert out["sim_wall_time_s"] == ref.wall_time_s
    assert {"scenario", "bench_wall_s", "events_per_sec", "aggregators",
            "agg_flushes"} <= set(out)
