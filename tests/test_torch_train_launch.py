"""The port's LLM trainer (``repro_torch.launch.train``) and its example, on
the CPU.

* Across packages, both ways, for the reduced internlm2, rwkv6 and jamba:
  the reference's own ``launch/train.py`` (a subprocess with 2 XLA host
  devices, one an island, mesh 1,1) trains round 0 and writes its
  record; the reference resumes it for rounds 1-2 and ``python -m
  repro_torch.launch.train --reduced --device cpu`` resumes a copy of it:
  both rebroadcast the islands from the server and start fresh optimizer
  states, so their per-round losses agree within 0.02 (bf16 compute, the
  shipped reduced config: internlm2 measured 4e-4 on losses of ~6; the
  two frameworks round bf16 at other points).  Then the port's record of
  round 3 is read by the reference's ``load_checkpoint`` (its server
  leaves, bit-equal to the port's server), the reference resumes it for
  round 3, and the port resumes the same server without its optimizer
  lanes: losses within 0.02 again.
* A port record resumes bit-equal, for the same three: killed after
  round 3 (a run that stops there) and resumed, round 4's loss and the
  server bus equal the run that was never stopped, island 0 preempted in
  round 2 in both.
* ``--mesh`` other than 1,1 raises naming the mesh plans; without
  ``--device cpu`` the trainer raises on a machine with no GPU.
* ``examples/torch_vc_train_llm.py --smoke --device cpu`` trains, masks
  its preempted island and restarts from the checkpoint it wrote.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import load_checkpoint as ref_load_checkpoint
from repro.configs import get_reduced as ref_get_reduced
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.checkpoint.store import (checkpoint_extra, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_reduced
from repro_torch.core import flat as F
from repro_torch.launch import train as LT

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
# the families the trainer takes: attention, WKV6 (B14 and its backward on
# the card), mamba + MoE + attention (B15 and its backward)
ARCHS = ("internlm2-1.8b", "rwkv6-1.6b", "jamba-v0.1-52b")
LOSS_TOL = 0.02


def _common(arch: str) -> list:
    return ["--arch", arch, "--reduced", "--islands", "2", "--local-steps",
            "2", "--batch", "4", "--seq", "32"]
_LINE = re.compile(r"\[train\] round\s+(\d+) alpha=\S+ loss=([-\d.]+)")


def _losses(text: str) -> dict:
    return {int(r): float(v) for r, v in _LINE.findall(text)}


def _reference(arch: str, ckpt: Path, rounds: int) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *_common(arch), "--mesh",
         "1,1", "--rounds", str(rounds), "--ckpt-dir", str(ckpt)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return _losses(out.stdout)


def _port(arch: str, ckpt: Path, rounds: int, capsys) -> dict:
    capsys.readouterr()
    assert LT.main([*_common(arch), "--rounds", str(rounds), "--device",
                    "cpu", "--ckpt-dir", str(ckpt)]) == 0
    return _losses(capsys.readouterr().out)


def _only(src: Path, step: int, dst: Path) -> None:
    dst.mkdir()
    name = f"ckpt_{step:08d}.msgpack"
    shutil.copy(src / name, dst / name)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_resumes_either_package_record(tmp_path, capsys, arch):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _reference(arch, ref_dir, 1)                    # round 0, record 1
    _only(ref_dir, 1, port_dir)
    want = _reference(arch, ref_dir, 3)             # resumes: rounds 1, 2
    got = _port(arch, port_dir, 3, capsys)
    assert sorted(want) == sorted(got) == [1, 2]
    for r in want:
        assert abs(got[r] - want[r]) <= LOSS_TOL, (got, want)

    # the port's record of round 3: server leaves first, then the lanes
    rec = port_dir / "ckpt_00000003.msgpack"
    assert checkpoint_extra(rec)["opt_steps"] == [4, 4]
    rcfg = ref_get_reduced(arch)
    shapes = jax.eval_shape(lambda: ref_build_model(rcfg).init(
        jax.random.PRNGKey(0)))
    ref_tree, extra = ref_load_checkpoint(rec, shapes)
    assert extra["round"] == 3
    cfg = get_reduced(arch)
    skel = LT._skeleton(cfg)
    port_tree, _ = load_checkpoint(rec, C.lm_params_to_reference(skel, cfg),
                                   "cpu")
    for a, b in zip(jax.tree.leaves(ref_tree), F.tree_flatten(port_tree)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    ref2, port2 = tmp_path / "ref2", tmp_path / "port2"
    _only(port_dir, 3, ref2)
    want = _reference(arch, ref2, 4)                # round 3, fresh opts
    port2.mkdir()
    save_checkpoint(port2 / "ckpt_00000003.msgpack", port_tree,
                    {"round": 3})                   # the server alone
    got = _port(arch, port2, 4, capsys)
    assert sorted(want) == sorted(got) == [3]
    assert abs(got[3] - want[3]) <= LOSS_TOL, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_record_resumes_bit_equal(tmp_path, arch):
    cfg = get_reduced(arch)
    kw = dict(islands=2, local_steps=2, batch=4, seq=32, preempt_round=2,
              device="cpu", log=lambda m: None)
    clean = LT.train(cfg, rounds=4, ckpt_dir=None, **kw)
    first = LT.train(cfg, rounds=3, ckpt_dir=str(tmp_path), **kw)
    resumed = LT.train(cfg, rounds=4, ckpt_dir=str(tmp_path), **kw)
    assert [r["loss"] for r in first.rounds] == \
        [r["loss"] for r in clean.rounds[:3]]
    assert resumed.start_round == 3 and len(resumed.rounds) == 1
    assert resumed.rounds[0]["loss"] == clean.rounds[3]["loss"]
    assert torch.equal(resumed.server.buf, clean.server.buf)


def test_mesh_and_device_are_refused(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="mesh plans' layouts"):
        LT.main([*_common(ARCH), "--mesh", "1,2", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.train(get_reduced(ARCH), rounds=1, log=lambda m: None)


def test_example_smoke_trains_preempts_and_restarts(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_vc_train_llm.py"),
         "--smoke", "--device", "cpu", "--ckpt", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "island 0 preempted" in text
    assert "restart: server of round 4 restored" in text
    losses = [float(x) for x in re.findall(r"loss=([\d.]+)", text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.msgpack", "ckpt_00000004.msgpack"]
