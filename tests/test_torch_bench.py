"""The port's kernel bench on the CPU: ``python -m repro_torch.benchmarks.run
--device cpu`` runs each suite (the plain versions, host-clock times) and
keeps the reference's row names and ``_launches`` keys
(``results/BENCH_{kernels,flat_assimilate,flat_adam,compression}.json``),
apart from the rows the port adds (B4, B8 and B11 in ``kernels``); its
CSV has no comma in ``derived``; the CPU route never builds a kernel; ``--check`` on the
CPU is an error, and the launch gate itself compares exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import run as RUN
from repro_torch.kernels import build
from repro_torch.kernels import vc_asgd_update as VK

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = {"kernels": "BENCH_kernels", "flat": "BENCH_flat_assimilate",
             "flat_adam": "BENCH_flat_adam",
             "compression": "BENCH_compression"}
ADDED = {"kernels": {"dc_lerp_flat_16M", "threshold_sparsify_2M",
                     "quantize_pack_105k"}}
NOT_PORTED: dict = {}
ROOFLINE = {"select_topk", "compress_flat", "threshold_sparsify",
            "pack_body", "decompress_flat", "quantize_pack", "dc_lerp_flat"}


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("suite", list(RUN.SUITES))
def test_suite_runs_on_cpu_with_the_reference_rows(suite, no_build, capsys,
                                                   monkeypatch, tmp_path):
    monkeypatch.setattr(RUN, "RESULTS", tmp_path)
    VK.reset_launch_count()
    assert RUN.main(["--only", suite, "--device", "cpu", "--write"]) == 0
    assert VK.launch_count() == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert all(ln.count(",") == 2 and ln.startswith(suite + ".")
               for ln in lines[1:])
    assert "device: cpu" in out.err
    res = json.loads((tmp_path / f"BENCH_torch_{suite}.json").read_text())
    assert res["_device"] == "cpu"
    rows = {k for k in res if not k.startswith("_")}
    assert {ln.split(",")[0] for ln in lines[1:]} == {
        f"{suite}.{r}" for r in rows}
    if suite == "roofline":
        assert rows == ROOFLINE
        for r in rows:
            assert res[r]["share"] is None          # no device share on cpu
            assert res[r]["floor_bytes"] > 0
        return
    ref = json.loads((ROOT / "results" / f"{REFERENCE[suite]}.json")
                     .read_text())
    ref_rows = {k for k in ref if not k.startswith("_")}
    assert rows == (ref_rows | ADDED.get(suite, set())) - NOT_PORTED.get(
        suite, set())
    assert set(res.get("_launches", {})) == set(ref.get("_launches", {}))
    assert all(v == 0 for v in res.get("_launches", {}).values())
    for r in ADDED.get(suite, ()):
        assert "bound=" in res[r]["derived"]
        assert "maxerr=0.0e+00" in res[r]["derived"]


def test_module_entry_point_runs_on_cpu():
    """The command line a user types, in a fresh interpreter."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "flat_adam", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0] == "name,us_per_call,derived"
    assert "flat_adam.adam_flat," in proc.stdout


def test_check_on_cpu_is_an_error(capsys):
    with pytest.raises(SystemExit) as exc:
        RUN.main(["--only", "flat", "--device", "cpu", "--check"])
    assert exc.value.code != 0
    assert "launches exist only on the card" in capsys.readouterr().err


def test_unknown_suite_and_missing_gpu_raise(monkeypatch):
    with pytest.raises(SystemExit):
        RUN.main(["--only", "fleet", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RUN.main(["--only", "flat_adam"])


def test_launch_gate_compares_exactly(capsys):
    base = json.loads(RUN.BASELINE.read_text())
    good = {s: {"_launches": dict(base[s])}
            for s in ("flat", "flat_adam", "compression")}
    good["kernels"] = {"x": {}}                  # no _launches: not gated
    assert RUN.check_launches(good) == 0
    for suite, key, delta in (("flat", "per_leaf", -1), ("flat", "flat", 1),
                              ("compression", "blocked_topk", -1)):
        bad = json.loads(json.dumps(good))
        bad[suite]["_launches"][key] += delta
        assert RUN.check_launches(bad) == 1
        assert f"LAUNCH GATE {suite}.{key}" in capsys.readouterr().err
    bad = json.loads(json.dumps(good))
    bad["compression"]["_launches"]["extra"] = 0
    assert RUN.check_launches(bad) == 1
