"""The paper-figure suites on the port against the reference's, run live
on the CPU: fig3 and fig6 here (fig2, fig4 and consistency in
``test_torch_paper_figs_more.py``), and the port's ``run.py`` printing a
suite's claims.

Both packages run each suite in its quick configuration; the port's
MLP starts from the reference's initial params and draws its minibatches
as the reference does (``test_torch_preemptible.ReferenceTask``).
Tolerances:
* every hour figure, epoch time, lost update and queue wait, and every
  claim, exact — fig3's ``P3_faster_than_P1_at_T8`` is False in both
  (P1C3T8 1.024 h, P3C3T8 1.186 h): the reference's live result, which
  ``results/BENCH_claims.json`` (True, from an older run) no longer
  matches;
* accuracy figures (curves, finals, spreads, gaps) within 0.02 (measured:
  at most 1e-4, one rounding step of the suites' 4 decimals).
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import paper_figs as PFIGS
from repro_torch.benchmarks import run as RUN
from repro_torch.core.tasks import make_classification_data
from test_torch_preemptible import ReferenceTask

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import paper_figs as REF_FIGS  # noqa: E402

torch.set_num_threads(2)
ACC_KEYS = {"acc", "final_acc", "std", "mean_std", "final_gap", "early_gap"}
ACC_TOL = 0.02


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(PFIGS, "_task_data", lambda quick: (
        ReferenceTask(), make_classification_data(
            n_train=2500 if quick else 5000, n_val=800)))


def assert_suite_matches(port, ref, path="") -> None:
    """Same structure; accuracy figures within ACC_TOL, the rest exact."""
    assert type(port) is type(ref) or (
        isinstance(port, (int, float)) and isinstance(ref, (int, float))), path
    if isinstance(ref, dict):
        assert list(port) == list(ref), path
        for k in ref:
            if k in ACC_KEYS and ref[k] is not None:
                assert math.isclose(port[k], ref[k], rel_tol=0,
                                    abs_tol=ACC_TOL), f"{path}.{k}"
            else:
                assert_suite_matches(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_suite_matches(a, b, f"{path}[{i}]")
    else:
        assert port == ref, path


def test_fig3_hours_and_claims_match_reference(reference_draws):
    ref = REF_FIGS.fig3_server_scaling(True)
    port = PFIGS.fig3_server_scaling(True, device="cpu")
    assert port == ref                              # hours exact, claims
    assert port["_claims"] == {"P3_faster_than_P1_at_T8": False}
    assert (port["P1C3T8"], port["P3C3T8"]) == (1.024, 1.186)


def test_fig6_matches_reference(reference_draws):
    ref = REF_FIGS.fig6_vs_serial(True)
    port = PFIGS.fig6_vs_serial(True, device="cpu")
    assert_suite_matches(port, ref)
    assert port["_claims"] == ref["_claims"] == {"serial_ahead": True,
                                                 "gap_narrows": True}
    assert len(port["serial"]) == len(port["distributed"]) == 8


def test_run_prints_paper_suite_claims(capsys, tmp_path, monkeypatch):
    import json
    monkeypatch.setattr(RUN, "RESULTS", tmp_path)
    assert RUN.main(["--only", "cost", "--device", "cpu", "--write"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    name, us, derived = lines[1].split(",")
    assert name == "cost" and float(us) >= 0 and derived == "claims:3/3"
    res = json.loads((tmp_path / "BENCH_torch_cost.json").read_text())
    assert res["_device"] == "cpu" and res["_wall_s"] >= 0
    assert res["_claims"] == REF_FIGS.cost_bench(True)["_claims"]


def test_run_names_failed_claims(capsys, monkeypatch):
    monkeypatch.setitem(RUN.PAPER_SUITES, "cost", lambda quick, dev: {
        "_claims": {"a": True, "b": False, "c": False}})
    assert RUN.main(["--only", "cost", "--device", "cpu"]) == 0
    row = capsys.readouterr().out.splitlines()[1]
    assert row.count(",") == 2 and row.endswith("claims:1/3 FAILED:b+c")
