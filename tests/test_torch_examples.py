"""The port's examples run, and their event traces are the reference's.

``examples/torch_quickstart.py`` and ``examples/torch_asgd_comparison.py``
run in ``--smoke --device cpu``; the reference's ``examples/quickstart.py``
and ``examples/asgd_comparison.py`` run in-process on ``--smoke``.  The
initial params and the minibatch draws differ (each package draws its
own), and the event trace does not depend on them, so the trace columns
must be EQUAL: quickstart's epochs and simulated hours, its preemptions,
reassignments, lost store updates and wire frames and MB; the
comparison's hours, preemptions, reassignments and wire MB for every
scheme.  Accuracies are not compared (other draws).
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _run_example(name, argv, capsys):
    path = ROOT / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def _quickstart_trace(out):
    rows = re.findall(r"^\s+(\d+)\s+([\d.]+)\s+[\d.]+ ±", out, re.M)
    tail = re.search(r"preemptions (\d+) \| subtask reassignments (\d+) \| "
                     r"lost store updates (\d+)", out).groups()
    wire = re.search(r"(\d+) sent / (\d+) delivered / (\d+) dropped, "
                     r"([\d.]+) MB total", out).groups()
    return rows, tail, wire


def _comparison_trace(out):
    rows = re.findall(r"^\s*(\S+)\s+([\d.]+)\s+[\d.]+\s+(\d+)\s+(\d+)\s+"
                      r"([\d.]+)$", out, re.M)
    return {name: rest for name, *rest in rows}


def test_torch_quickstart_trace_equals_reference(capsys):
    got = _quickstart_trace(_run_example(
        "torch_quickstart.py", ["--smoke", "--device", "cpu"], capsys))
    want = _quickstart_trace(_run_example("quickstart.py", ["--smoke"],
                                          capsys))
    assert len(got[0]) == 2 and got == want


def test_torch_asgd_comparison_trace_equals_reference(capsys):
    got = _comparison_trace(_run_example(
        "torch_asgd_comparison.py", ["--smoke", "--device", "cpu"], capsys))
    want = _comparison_trace(_run_example("asgd_comparison.py", ["--smoke"],
                                          capsys))
    assert len(got) == 8 and got == want


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_asgd_comparison.py"])
def test_torch_examples_run_on_the_card_unless_told(name, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_example(name, ["--smoke"], capsys)
