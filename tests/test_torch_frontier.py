"""The frontier suite on the port: ``run --only frontier --device cpu``.

Every point's fields but ``bench_wall_s`` are functions of the event
trace and of the fleet's Table I prices, so they must EQUAL the
reference's pinned ``results/BENCH_frontier.json``, and so must the
Pareto front and the three claims.  The suite writes no file unless
``--write`` is given, and then only ``results/BENCH_torch_frontier.json``
(never the reference's pin).
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import frontier_bench as FB
from repro_torch.benchmarks import run as RUN

torch.set_num_threads(2)

PIN = Path(__file__).resolve().parents[1] / "results" / "BENCH_frontier.json"


def test_frontier_reproduces_the_reference_pin(capsys):
    pin = json.loads(PIN.read_text())
    before = PIN.read_bytes()
    code, results = RUN.run_cli(["--only", "frontier", "--device", "cpu"])
    out = capsys.readouterr().out
    assert code == 0
    assert "frontier," in out and out.rstrip().endswith("claims:3/3")
    res = results["frontier"]
    assert [p["scenario"] for p in res["points"]] == \
        [p["scenario"] for p in pin["points"]] == list(FB.FRONTIER_SCENARIOS)
    for got, want in zip(res["points"], pin["points"]):
        strip = lambda p: {k: v for k, v in p.items() if k != "bench_wall_s"}
        assert strip(got) == strip(want), got["scenario"]
        assert got["bench_wall_s"] >= 0
    assert res["pareto_front"] == pin["pareto_front"]
    assert res["_claims"] == pin["_claims"]
    assert all(res["_claims"].values())
    assert PIN.read_bytes() == before                 # the pin is untouched


def test_pareto_front_is_the_non_dominated_set():
    pts = [{"scenario": "a", "results_per_hour": 10, "usd_per_1k_pre": 5},
           {"scenario": "b", "results_per_hour": 20, "usd_per_1k_pre": 5},
           {"scenario": "c", "results_per_hour": 5, "usd_per_1k_pre": 1},
           {"scenario": "d", "results_per_hour": 20, "usd_per_1k_pre": 5}]
    assert FB._pareto(pts) == ["b", "c", "d"]


def test_frontier_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FB.bench_frontier()
