"""The port stands alone and runs where it is told to.

* every ``repro_torch`` module, the benchmarks and the checkpoint store
  included, imports in a fresh interpreter in which ``jax``, ``repro``
  and ``msgpack`` cannot be imported at all;
* no file under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax``, ``repro`` or ``msgpack`` (AST scan, so a lazy import inside a
  function is caught too);
* entry points raise without a GPU unless the caller passes
  ``device="cpu"``, and the CPU route never touches the kernel build.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.convert as C
from repro_torch.core.baselines import VCASGD, CompressedVCASGD, EASGDFlatPod
from repro_torch.core.flat import BLOCK
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.kernels import mamba_scan as MK
from repro_torch.kernels import quantize as QK
from repro_torch.kernels import rwkv6_scan as WK
from repro_torch.kernels import sparse_pack as SK
from repro_torch.kernels import topk_mask as TM
from repro_torch.kernels import vc_asgd_update as VK
from repro_torch.runtime import vc_runtime as VR

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack"}


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'repro_torch.benchmarks.run',\n"
        "        'repro_torch.benchmarks.kernel_bench',\n"
        "        'repro_torch.benchmarks.roofline_report',\n"
        "        'repro_torch.benchmarks.paper_figs',\n"
        "        'repro_torch.checkpoint.store',\n"
        "        'repro_torch.checkpoint._msgpack',\n"
        "        'repro_torch.core.cost_model'} <= set(names)\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['msgpack'] is None\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20          # the whole package walked


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        MLPTask().init_params(0)
    with pytest.raises(RuntimeError):
        C.params_from_reference({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError):
        C.flat_from_reference(np.zeros(BLOCK, np.float32),
                              {"shapes": [[3]], "dtypes": ["float32"],
                               "offsets": [0], "n": 3, "padded": BLOCK})
    cfg = SimConfig(n_clients=2, n_shards=2, max_epochs=1)
    with pytest.raises(RuntimeError):
        run_simulation(MLPTask(), make_classification_data(80, 20),
                       VCASGD(alpha=0.9), cfg)


def test_cpu_run_asked_for_never_builds(no_gpu, no_build):
    VK.reset_launch_count()
    cfg = SimConfig(n_clients=2, n_shards=2, max_epochs=1, local_steps=2)
    res = run_simulation(MLPTask(), make_classification_data(80, 20),
                         VCASGD(alpha=0.9), cfg, device="cpu")
    assert res.results_assimilated == 2 and res.client_steps > 0
    assert VK.launch_counts() == dict.fromkeys(VK.KERNELS, 0)


@pytest.mark.parametrize("scheme", [
    lambda: CompressedVCASGD(0.9, density=0.05),
    lambda: EASGDFlatPod(n_replicas=2, beta=0.1, compress_density=0.1)])
def test_cpu_scheme_runs_asked_for_never_build(no_gpu, no_build, scheme):
    VK.reset_launch_count()
    cfg = SimConfig(n_clients=2, n_shards=2, max_epochs=2, local_steps=2)
    res = run_simulation(MLPTask(), make_classification_data(80, 20),
                         scheme(), cfg, device="cpu")
    assert res.wire_sparse_frames == res.results_assimilated == 4
    assert VK.launch_counts() == dict.fromkeys(VK.KERNELS, 0)


def test_new_converters_raise_without_gpu(no_gpu):
    from repro_torch.core.compression import CompressedDelta
    p = CompressedDelta(np.zeros(1, np.int8), np.ones(1, np.float32),
                        np.zeros(1, np.int32), (4,), 0.25)
    with pytest.raises(RuntimeError):
        C.compressed_from_reference(p)
    state = VCASGD(alpha=0.5).init_state(
        C.params_from_reference({"w": np.zeros(3, np.float32)}, "cpu"))
    with pytest.raises(RuntimeError):
        C.state_from_reference(state, state)


def test_ops_route_cpu_tensors_to_plain_versions(no_build):
    VK.reset_launch_count()
    s, c = torch.ones(BLOCK), torch.zeros(BLOCK)
    assert torch.equal(ops.fused_lerp_flat(s, c, 0.25), torch.full_like(s, 0.25))
    out = ops.fused_assimilate_flat(s, torch.stack([c, s]), [0.5, 0.25, 0.25])
    assert torch.equal(out, torch.full_like(s, 0.75))
    p, m, v = ops.fused_adam_flat(s, c, c, c, 1e-3, 0.9, 0.999, 1e-8, 0.0,
                                  np.float32(0.1), np.float32(0.001))
    assert torch.equal(p, s) and torch.count_nonzero(m) == 0
    co, xo = ops.fused_easgd_flat(c, torch.stack([s, s]), 0.25)
    assert torch.equal(co, torch.full_like(c, 0.5))       # 0 + 0.25 * 2
    assert torch.equal(xo, torch.full((2, BLOCK), 0.75))  # 1 - 0.25 * 1
    q, sc = ops.quantize_int8(torch.full((300,), 2.0))
    assert q.tolist() == [127] * 300 and sc.numel() == 2
    assert torch.equal(ops.dequantize_int8(q, sc, 300), torch.full((300,),
                                                                   2.0))
    body = ops.pack_body(q, sc, torch.arange(300, dtype=torch.int32))
    assert body.dtype == torch.uint8 and body.numel() == 5 * 300 + 8
    # WKV6 with w = 1, u = 0: out_t = r_t . sum_{s<t} k_s v_s^T
    r = torch.ones(1, 2, 3, 16)
    out, S = ops.wkv6(r, r, r, r, torch.zeros(2, 16))
    assert torch.equal(out, 16.0 * torch.arange(3.0)[:, None].expand(
        1, 2, 3, 16))
    assert torch.equal(S, torch.full((1, 2, 16, 16), 3.0))
    # selective scan with dt = 1, A = 0 (no decay), B = C = 1, D = 0:
    # h_t = sum of u up to t in every state, y_t = ds * h_t
    u = torch.ones(1, 3, 2)
    y, h = ops.mamba_scan(u, u, torch.ones(1, 3, 4), torch.ones(1, 3, 4),
                          torch.zeros(2, 4), torch.zeros(2))
    assert torch.equal(y, 4.0 * torch.arange(1.0, 4.0)[None, :, None]
                       .expand(1, 3, 2))
    assert torch.equal(h, torch.full((1, 2, 4), 3.0))
    assert VK.launch_count() == 0


def test_kernel_wrappers_refuse_cpu_and_other_devices(no_build):
    s = torch.zeros(BLOCK)
    with pytest.raises(ValueError, match="CUDA"):
        VK.vc_asgd_lerp_flat(s, s, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        VK.assimilate_flat(s, s[None], [0.5, 0.5])
    with pytest.raises(ValueError, match="CUDA"):
        VK.adam_update_flat(s, s, s, s, 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        VK.easgd_elastic_flat(s, s[None], 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        QK.quantize_int8(s)
    q8 = torch.zeros(4, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        QK.dequantize_int8(q8, torch.ones(1), 4)
    with pytest.raises(ValueError, match="CUDA"):
        SK.pack_body(q8, torch.ones(1), torch.zeros(4, dtype=torch.int32))
    r = torch.zeros(1, 2, 3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        WK.wkv6(r, r, r, r, torch.zeros(2, 16))
    u, bc = torch.zeros(1, 3, 8), torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        MK.mamba_scan(u, u, bc, bc, torch.zeros(8, 4), torch.zeros(8))
    with pytest.raises(ValueError):
        ops.fused_lerp_flat(torch.zeros(BLOCK, device="meta"),
                            torch.zeros(BLOCK, device="meta"), 0.5)
    with pytest.raises(ValueError):
        m = r.to("meta")
        ops.wkv6(m, m, m, m, torch.zeros(2, 16, device="meta"))
    with pytest.raises(ValueError):
        m = u.to("meta")
        ops.mamba_scan(m, m, bc, bc, torch.zeros(8, 4), torch.zeros(8))


def test_build_targets_live_in_ignored_build_dir():
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert set(build.SOURCES) == {"vc_asgd_update", "topk_mask", "quantize",
                                  "sparse_pack", "flash_attention",
                                  "flash_attention_sm90", "wkv6",
                                  "mamba_scan"}
    for src in build.SOURCES.values():
        assert src.is_file() and src.suffix == ".cu"


def test_pod_round_runs_on_cpu_only_when_asked(no_gpu, no_build):
    """The compressed cross-pod round and the blocked top-k: the entry
    point raises without a GPU unless the caller passes ``device="cpu"``,
    and the CPU route (B6, B7 on a 2^20-element bus) never builds."""
    from repro_torch.core.compression import select_topk
    rng = np.random.default_rng(0)
    server = {"w": torch.from_numpy(
        rng.standard_normal((1024, 1024)).astype(np.float32))}
    islands = {"w": server["w"][None] + torch.from_numpy(
        rng.standard_normal((2, 1024, 1024)).astype(np.float32)) * 0.01}
    alive = torch.tensor([True, True])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VR.compressed_assimilate(server, islands, 0.9, alive)
    VK.reset_launch_count()
    out, res = VR.compressed_assimilate(server, islands, 0.9, alive,
                                        device="cpu")
    assert out["w"].device.type == res["w"].device.type == "cpu"
    assert res["w"].shape == (2, 1024, 1024)
    words, counts = ops.blocked_topk_stats(server["w"].reshape(-1), 1)
    assert words.shape == (128, 256) and int(counts.sum()) == 1 << 20
    kept, resid = ops.threshold_sparsify_exact(
        server["w"].reshape(-1), 10.0, torch.zeros(128, dtype=torch.int32), 0)
    assert int((kept != 0).sum()) == 0
    assert select_topk(server["w"], 5000).numel() == 5000
    assert VK.launch_counts() == dict.fromkeys(VK.KERNELS, 0)


def test_topk_wrappers_refuse_cpu_tensors(no_build):
    x = torch.zeros(TM.BLOCK)
    with pytest.raises(ValueError, match="CUDA"):
        TM.blocked_topk_stats(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        TM.threshold_sparsify_exact(x, 1.0, torch.zeros(1, dtype=torch.int32),
                                    0)
    with pytest.raises(ValueError):
        ops.blocked_topk_stats(x.to("meta"), 1)
