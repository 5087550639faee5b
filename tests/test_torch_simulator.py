"""The slice as a whole: ``run_simulation`` at the quickstart ``--smoke``
size in both packages, with the reference's initial params carried
across and the reference's minibatch draws injected.

Tolerances:
* the event trace is exact — wall clock, every epoch's t_complete, wire
  frames and bytes on both legs, preemptions, reassignments, results
  assimilated, lease counters, events processed;
* each epoch's accuracy statistics agree within 0.02 (four validation
  samples of the 200).  The parameters themselves are not compared:
  both sides round differently at the ulp level (the reference trains
  under jit), and Adam turns an ulp on a near-zero gradient into a full
  lr-sized step, so the buses drift apart by up to ~1e-2 while accuracy
  moves by at most a sample (measured: <= 0.005 on these cases).
Also: the not-yet-ported options raise.

The pinned replay: the 12 flat MLP cases of
``results/PINNED_sim_regression.json`` (every server scheme, dense and
compressed uploads) run through the port on the CPU with the reference's
params and minibatch draws, from ``chip_smoke.py``'s case table (held
here to ``tools/pin_sim_regression.py``'s).  Tolerances:
* every pinned event-trace and wire field equals the fixture exactly;
* each epoch's accuracy and the final accuracy are within 0.02 of the
  reference run live on the same inputs (measured: equal to 7 digits),
  and within 0.07 (21 of the 300 validation samples) of the fixture:
  the fixture's accuracy fields were taken under an older jax, and the
  reference itself misses them today by up to 0.0613 (its own
  tests/test_protocol.py::test_pinned_regression_bit_identical fails on
  exactly those fields) while every trace field still reproduces.
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
from repro.core.vc_asgd import var_alpha as ref_var_alpha
from repro_torch.convert import params_from_reference
from repro_torch.core.baselines import VCASGD
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.core.vc_asgd import var_alpha
from repro_torch.kernels.launches import KERNELS
from test_torch_tasks import InjectedDraws

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the port's pinned-case table)
import pin_sim_regression as PIN  # noqa: E402  (the reference's)

torch.set_num_threads(2)
PINNED = json.loads((ROOT / "results" / "PINNED_sim_regression.json")
                    .read_text())

# examples/quickstart.py --smoke
SMOKE = dict(n_param_servers=3, n_clients=5, tasks_per_client=2, n_shards=8,
             max_epochs=2, preemptible=True, mean_lifetime_s=2400.0,
             consistency="eventual", seed=0)
TRACE = ("wall_time_s", "epochs_done", "reassignments", "preemptions",
         "results_assimilated", "handout_frames", "handout_bytes",
         "leases_expired", "leases_dropped", "events_processed",
         "wire_dense_frames", "wire_sparse_frames")


@pytest.mark.parametrize("overrides", [
    {},                                                   # quickstart --smoke
    {"consistency": "strong", "preemptible": False, "seed": 3},
    {"timeout_s": 400.0, "n_param_servers": 1, "seed": 1},  # expiries
])
def test_smoke_run_matches_reference(overrides):
    kw = {**SMOKE, **overrides}
    rtask = RefMLP()
    rdata = ref_data(n_train=800, n_val=200)
    ref = ref_run(rtask, rdata, RefVCASGD(alpha=ref_var_alpha()),
                  RefSimConfig(**kw))
    p0 = rtask.init_params(jax.random.PRNGKey(kw["seed"]))
    port = run_simulation(
        InjectedDraws(), make_classification_data(n_train=800, n_val=200),
        VCASGD(alpha=var_alpha()), SimConfig(**kw), device="cpu",
        params0=params_from_reference({k: np.asarray(v)
                                       for k, v in p0.items()}, "cpu"))
    for f in TRACE:
        assert getattr(port, f) == getattr(ref, f), f
    assert dataclasses.asdict(port.wire) == dataclasses.asdict(ref.wire)
    assert dataclasses.asdict(port.store_stats) == dataclasses.asdict(
        ref.store_stats)
    assert len(port.points) == len(ref.points) == kw["max_epochs"]
    for a, b in zip(port.points, ref.points):
        assert (a.epoch, a.t_complete) == (b.epoch, b.t_complete)
        for f in ("acc_mean", "acc_min", "acc_max"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 0.02, f
    assert abs(port.final_accuracy - ref.final_accuracy) <= 0.02
    assert port.scheme_state.version == ref.scheme_state.version
    assert port.client_steps > 0


@pytest.mark.parametrize("field,value", [("aggregators", 2),
                                         ("subscribers", 4),
                                         ("bus_shards", 2),
                                         ("handout_dtype", "bfloat16")])
def test_unported_options_raise(field, value):
    cfg = SimConfig(**{**SMOKE, "max_epochs": 1, field: value})
    with pytest.raises(NotImplementedError):
        run_simulation(MLPTask(), make_classification_data(n_train=80,
                                                           n_val=20),
                       VCASGD(alpha=0.9), cfg, device="cpu")


def _scheme_fingerprint(scheme) -> dict:
    """The constructor parameters a scheme of either package carries."""
    fp = {"cls": type(scheme).__name__, "name": scheme.name}
    for attr in ("density", "server_lr", "lam", "beta", "n_replicas",
                 "compress_density", "n_shards", "staleness_gamma"):
        if hasattr(scheme, attr):
            fp[attr] = getattr(scheme, attr)
    if hasattr(scheme, "alpha"):
        fp["alpha"] = [scheme.alpha(e) for e in range(4)]
    return fp


def test_pinned_case_table_matches_the_pin_tool():
    flat_mlp = {n for n, c in PIN.CASES.items()
                if len(c) == 2 and "aggregators" not in c[1]}
    assert set(CS.PINNED_CASES) == flat_mlp and len(flat_mlp) == 12
    assert CS.PIN_BASE == PIN.BASE == PINNED["base_cfg"]
    assert CS.PIN_DATA == PINNED["data"]
    for name in flat_mlp:
        factory, overrides = PIN.CASES[name]
        scheme, cfg = CS.pinned_case(name)
        assert cfg == SimConfig(**{**PIN.BASE, **overrides}), name
        assert _scheme_fingerprint(scheme) == _scheme_fingerprint(
            factory()), name
    assert set(CS.PIN_TRACE) == set(PINNED["cases"]["vc-asgd"]) - {
        "final_accuracy", "acc_mean"}


@pytest.mark.parametrize("name", sorted(CS.PINNED_CASES))
def test_pinned_flat_mlp_case_replays(name):
    scheme, cfg = CS.pinned_case(name)
    d = PINNED["data"]
    ref = PIN.run_case(RefMLP(), ref_data(**d), name)
    p0 = RefMLP().init_params(jax.random.PRNGKey(cfg.seed))
    res = run_simulation(
        InjectedDraws(), make_classification_data(**d), scheme, cfg,
        device="cpu",
        params0=params_from_reference({k: np.asarray(v)
                                       for k, v in p0.items()}, "cpu"))
    got, want = CS.pinned_fields(res), PINNED["cases"][name]
    for f in CS.PIN_TRACE:
        assert got[f] == want[f] == ref[f], f
    port_acc = [p.acc_mean for p in res.points] + [res.final_accuracy]
    ref_acc = ref["acc_mean"] + [ref["final_accuracy"]]
    pin_acc = want["acc_mean"] + [want["final_accuracy"]]
    assert len(port_acc) == len(ref_acc) == len(pin_acc)
    for a, r, w in zip(port_acc, ref_acc, pin_acc):
        assert abs(a - r) <= 0.02
        assert abs(a - w) <= 0.07
    # chip_smoke holds the card's launches to these: one entry a kernel
    assert set(CS.implied_launches(scheme, res)) == set(KERNELS)
