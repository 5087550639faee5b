"""The pod mesh and the sharded flat bus against the JAX package, on the
CPU.

* Every sharded op (``runtime/sharding.py``: Eq. 1, Eq. 2, Adam through
  ``Adam.update_flat_sharded``, the elastic EASGD round, the
  redistribution broadcast) at 1, 2, 4 and 8 shards of a CPU pod mesh, on
  the reference's fixed 8-way layout (tests/test_sharded_flat.py:290: one
  length every shard count divides, so the buffers compared are the same
  length), bit-equal to the reference's single-host flat path
  (``V.assimilate_many_flat``, ``opt.update_flat`` with weight decay,
  ``R.easgd_elastic``, ``R.vc_asgd_lerp``, the broadcast), and Adam also
  to the port's whole-bus ``update_flat``; the masked Eq. 2 with a dead (nan)
  island bit-equal to the port's whole-bus pass.  ``shard_flat`` refuses
  a length the axis does not divide, as the reference does.
* One subprocess with four forced host devices runs the reference's own
  sharded forms (``use_kernel=False``: the jnp path under ``shard_map``)
  on a 4-way pod mesh, and its ``make_vc_round`` with ``flat_shard_axis``
  over them (tests/test_sharded_flat.py:367's round on a (4, 1, 1)
  mesh): the ops bit for bit against the port's at 4 shards, the round's
  losses within 1e-5 relative (the unsharded round's bound,
  tests/test_torch_llm_train.py).  Adam there without weight decay: the
  reference's ``shard_map`` body is compiled, and XLA then fuses its
  ``step + lr * wd * p`` into one multiply-add (1 of 65,536 elements 1
  ulp off its own eager ``update_flat``, which the port matches).
* The port's ``make_vc_round`` with ``flat_shard_axis`` on the reduced
  internlm2 (2 islands, 3 rounds, island 1 dead in round 2) bit-equal to
  its unsharded round on the same layout: every loss, the server, the
  island rows, the optimizer states.
* ``make_flat_train_step`` over a pod mesh bit-equal to the whole-bus
  step; ``ep_tune`` equal to the reference's for every MoE config at dp
  1, 2, 4, 8 and 16 (raising where it raises); the mesh constructors.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import flat as RF
from repro.core import vc_asgd as RV
from repro.kernels import ref as RR
from repro.optim import Adam as RefAdam
from repro.runtime.sharding import ep_tune as ref_ep_tune
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core import flat as F
from repro_torch.launch import mesh as M
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime import sharding as S
from repro_torch.runtime import vc_runtime as VR
from repro_torch.runtime.train import make_flat_train_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
POD_COUNTS = (1, 2, 4, 8)
ALPHA, BETA = 0.9, 0.3
LR = 1e-3


def _tree(rng):
    return {f"p{i}": rng.standard_normal((257, 31 + i)).astype(np.float32)
            for i in range(5)}


@pytest.fixture(scope="module")
def bus():
    """The reference's fixed 8-way layout and its single-host results."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    fp8 = RF.flatten_sharded({k: jnp.asarray(v) for k, v in tree.items()}, 8)
    n = fp8.buf.size
    clients = np.asarray(fp8.buf)[None] + 0.01 * np.arange(
        1, 4, dtype=np.float32)[:, None]
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    ropt = RefAdam(lr=LR, weight_decay=0.01)
    p1, o1 = ropt.update_flat(jnp.asarray(g), ropt.init_flat(fp8), fp8)
    c, x = RR.easgd_elastic(fp8.buf, jnp.asarray(clients), BETA)
    want = {"assim": RV.assimilate_many_flat(fp8, jnp.asarray(clients),
                                             ALPHA).buf,
            "adam_p": p1.buf, "adam_m": o1.m, "adam_v": o1.v,
            "easgd_c": c, "easgd_x": x,
            "lerp": RR.vc_asgd_lerp(fp8.buf, jnp.asarray(clients[0]), ALPHA),
            "bcast": jnp.broadcast_to(fp8.buf[None], (3, n))}
    return (tree, np.asarray(fp8.buf), clients, g,
            {k: np.asarray(v) for k, v in want.items()})


def _port_ops(tree, buf, clients, g, n_pods, wd=0.01):
    """Every sharded op of the port at ``n_pods`` shards, gathered."""
    mesh = M.make_pod_mesh(n_pods, device="cpu")
    spec = F.shard_spec(F.tree_spec({k: torch.from_numpy(v)
                                     for k, v in tree.items()}), n_pods,
                        pad_to=F.BLOCK * (8 // n_pods))
    fp = S.shard_flat(F.FlatParams(torch.from_numpy(buf), spec), mesh)
    assert len(fp.buf.shards) == n_pods
    assert all(s.is_contiguous() for s in fp.buf.shards)
    cl = torch.from_numpy(clients)
    w = RV.assimilation_weights(3, ALPHA)
    opt = Adam(lr=LR, weight_decay=wd)
    p2, o2 = opt.update_flat_sharded(torch.from_numpy(g), opt.init_flat(fp),
                                     fp, mesh=mesh)
    whole_fp = F.FlatParams(torch.from_numpy(buf), spec)
    p1, o1 = opt.update_flat(torch.from_numpy(g), opt.init_flat(whole_fp),
                             whole_fp)
    for a, b in ((p2.buf, p1.buf), (o2.m, o1.m), (o2.v, o1.v)):
        assert torch.equal(S.gather_flat(a), b)
    c, x = S.sharded_easgd_flat(fp.buf, cl, BETA, mesh)
    wi, ws = VR.island_weights(3, 0.6, torch.tensor([True, False, True]))
    dead = cl.clone()
    dead[1] = float("nan")
    out = {"assim": S.sharded_assimilate_flat(fp.buf, cl, np.asarray(w),
                                              mesh),
           "adam_p": p2.buf, "adam_m": o2.m, "adam_v": o2.v,
           "easgd_c": c, "easgd_x": x,
           "lerp": S.sharded_lerp_flat(fp.buf, cl[0], ALPHA, mesh),
           "bcast": VR.redistribute_flat(fp.buf, 3, mesh=mesh,
                                         shard_axis="pod"),
           "masked": VR.assimilate_flat(fp.buf, dead, wi, ws, mesh=mesh,
                                        shard_axis="pod")}
    for v in out.values():
        assert isinstance(v, S.ShardedBuf) and v.sharding.n_shards == n_pods
    whole = VR.assimilate_flat(torch.from_numpy(buf), dead, wi, ws)
    return {k: S.gather_flat(v).numpy() for k, v in out.items()}, whole


@pytest.mark.parametrize("n_pods", POD_COUNTS)
def test_sharded_ops_bit_equal_to_the_reference_single_host(bus, n_pods):
    tree, buf, clients, g, want = bus
    got, whole = _port_ops(tree, buf, clients, g, n_pods)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    np.testing.assert_array_equal(got["masked"], whole.numpy())
    assert np.isfinite(got["masked"]).all()


def test_shard_flat_refuses_a_length_that_does_not_divide(bus):
    tree, buf, *_ = bus
    mesh7 = M.make_pod_mesh(7, device="cpu")
    fp = F.FlatParams(torch.from_numpy(buf), F.tree_spec(
        {k: torch.from_numpy(v) for k, v in tree.items()}))
    with pytest.raises(ValueError, match="does not divide the 7-way mesh"):
        S.shard_flat(fp, mesh7)
    with pytest.raises(ValueError, match="does not divide"):
        S.sharded_lerp_flat(fp.buf, fp.buf, 0.5, mesh7)
    other = S.shard_flat(fp, M.make_pod_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="not laid out"):
        S.sharded_lerp_flat(other.buf, fp.buf, 0.5,
                            M.make_pod_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="no axis"):
        S.shard_flat(fp, M.make_pod_mesh(2, device="cpu"), axis="data")


def test_meshes():
    m = M.make_pod_mesh(4, device="cpu")
    assert m.shape == {"pod": 4}
    assert m.axis_devices("pod") == [torch.device("cpu")] * 4
    t = M.make_test_mesh((2, 3), ("data", "model"), device="cpu")
    assert t.shape == {"data": 2, "model": 3}
    assert len(t.axis_devices("model")) == 3
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="holds no devices"):
        M.make_production_mesh().axis_devices("data")
    with pytest.raises(ValueError, match="n_pods"):
        M.make_pod_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="3 devices"):
        M.make_pod_mesh(2, devices=["cpu"] * 3)


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_pod_mesh(2)


def test_flat_train_step_sharded_equals_whole():
    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32)), "b": torch.zeros(48)}
    fp = F.flatten_sharded(tree, 4)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))

    def loss_fn(t, batch):
        return ((batch @ t["w"] + t["b"]).tanh() ** 2).mean()

    opt = Adam(lr=LR)
    mesh = M.make_pod_mesh(4, device="cpu")
    whole = make_flat_train_step(loss_fn, opt)
    sharded = make_flat_train_step(loss_fn, opt, mesh=mesh)
    a, sa = fp, opt.init_flat(fp)
    b, sb = fp, opt.init_flat(fp)
    for _ in range(3):
        a, sa, la = whole(a, sa, x)
        b, sb, lb = sharded(b, sb, x)
        assert torch.equal(la, lb)
    assert isinstance(b.buf, S.ShardedBuf) and sb.step == 3
    assert torch.equal(S.gather_flat(b.buf), a.buf)
    assert torch.equal(S.gather_flat(sb.m), sa.m)
    assert torch.equal(S.gather_flat(sb.v), sa.v)


MOE_ARCHS = [a for a in ARCHS if get_config(a).moe is not None]


@pytest.mark.parametrize("dp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_tune_matches_the_reference(arch, dp):
    try:
        want = ref_ep_tune(ref_get_config(arch), dp).moe.ep_virtual
    except ValueError as e:
        with pytest.raises(ValueError, match="no virtual factor"):
            S.ep_tune(get_config(arch), dp)
        assert "no virtual factor" in str(e)
        return
    got = S.ep_tune(get_config(arch), dp)
    assert got.moe.ep_virtual == want
    assert (got.moe.n_virtual % dp == 0
            and got.moe.d_ff_expert % got.moe.ep_virtual == 0)


# --- the VC round on a sharded bus, and the reference's own sharded forms --

ROUNDS, N_PODS, STEPS = 3, 2, 2
SHARDS = 4


def _round_inputs():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (N_PODS, STEPS, 4, 32)).astype(np.int32)
            for _ in range(ROUNDS)]


def _survivors(rnd):
    return np.array([True, rnd != 1])


@pytest.fixture(scope="module")
def port_rounds():
    """The port's round, unsharded and over a 4-way CPU pod mesh, on one
    layout (padded to BLOCK x 4, as the reference pads a sharded round)
    from the reference's initial weights, in f32 compute (the bound
    against the reference's round is the f32 one)."""
    from repro.configs import get_reduced as ref_get_reduced
    from repro.models.registry import build_model as ref_build_model
    rcfg = ref_get_reduced("internlm2-1.8b").replace(compute_dtype="float32")
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced("internlm2-1.8b").replace(compute_dtype="float32")
    model = build_model(cfg)
    tree = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                      "cpu")
    mesh = M.make_pod_mesh(SHARDS, device="cpu")
    toks = _round_inputs()
    out = {}
    for axis in (None, "pod"):
        server = F.flatten(tree, pad_to=F.BLOCK * SHARDS)
        isl, opts = VR.init_islands(server, N_PODS, Adam(lr=LR))
        rnd = VR.make_vc_round(model, N_PODS, STEPS, Adam(lr=LR),
                               flat_shard_axis=axis,
                               mesh=mesh if axis else None)
        losses = []
        for r in range(ROUNDS):
            server, isl, opts, m = rnd(server, isl, opts,
                                       {"tokens": torch.from_numpy(toks[r])},
                                       0.5, _survivors(r))
            losses.append(m["loss"])
        out[axis] = (server, isl, opts, losses)
    return out


def test_vc_round_sharded_bit_equal_to_unsharded(port_rounds):
    s0, i0, o0, l0 = port_rounds[None]
    s1, i1, o1, l1 = port_rounds["pod"]
    assert [float(x) for x in l0] == [float(x) for x in l1]
    assert torch.equal(s0.buf, s1.buf) and torch.equal(i0, i1)
    assert all(torch.equal(row, s1.buf) for row in i1)
    for a, b in zip(o0, o1):
        assert a.step == b.step == ROUNDS * STEPS
        assert torch.equal(a.m, b.m) and torch.equal(a.v, b.v)
    assert bool(torch.isfinite(s1.buf).all())


def test_vc_round_refuses_a_bus_that_does_not_shard():
    cfg = get_reduced("internlm2-1.8b")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="go together"):
        VR.make_vc_round(model, 2, 1, flat_shard_axis="pod")
    server = F.flatten(model.init(0, device="cpu"))
    n_blocks = server.spec.padded // F.BLOCK
    mesh = M.make_pod_mesh(n_blocks + 1, device="cpu")
    isl, opts = VR.init_islands(server, 2, Adam(lr=LR))
    rnd = VR.make_vc_round(model, 2, 1, flat_shard_axis="pod", mesh=mesh)
    with pytest.raises(ValueError, match="BLOCK-multiple shards"):
        rnd(server, isl, opts, {}, 0.5, [True, True])


_REFERENCE_SHARDED = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.core import flat as F
    from repro.core import vc_asgd as V
    from repro.launch.mesh import compat_make_mesh, make_pod_mesh
    from repro.models.registry import build_model
    from repro.optim import Adam
    from repro.runtime import sharding as S
    from repro.runtime import vc_runtime as VR
    from repro.runtime.sharding import MeshPlan

    inp = np.load(sys.argv[1])
    buf, clients, g = (jnp.asarray(inp[k]) for k in ("buf", "clients", "g"))
    tree = {f"p{i}": jnp.zeros(tuple(inp[f"shape{i}"])) for i in range(5)}
    mesh = make_pod_mesh(4)
    spec = F.shard_spec(F.tree_spec(tree), 4, pad_to=F.BLOCK * 2)
    sh = S.shard_flat(F.FlatParams(buf, spec), mesh)
    assert len(sh.buf.sharding.device_set) == 4
    w = V.assimilation_weights(3, %(alpha)r)
    opt = Adam(lr=%(lr)r, weight_decay=%(wd)r)
    p2, o2 = opt.update_flat_sharded(g, F.init_opt_state(sh.spec), sh,
                                     mesh=mesh, axis="pod")
    c, x = S.sharded_easgd_flat(sh.buf, clients, %(beta)r, mesh, "pod")
    out = {"assim": S.sharded_assimilate_flat(sh.buf, clients, w, mesh,
                                              "pod"),
           "adam_p": p2.buf, "adam_m": o2.m, "adam_v": o2.v,
           "easgd_c": c, "easgd_x": x,
           "lerp": S.sharded_lerp_flat(sh.buf, clients[0], %(alpha)r, mesh,
                                       "pod"),
           "bcast": VR.redistribute_flat(sh.buf, 3, mesh=mesh,
                                         shard_axis="pod")}

    cfg = get_reduced("internlm2-1.8b").replace(compute_dtype="float32")
    model = build_model(cfg)
    m3 = compat_make_mesh((4, 1, 1), ("pod", "data", "model"))
    plan = MeshPlan.build(cfg, m3)
    ropt = Adam(lr=%(lr)r)
    vc = VR.make_vc_round(model, plan, %(pods)d, %(steps)d, ropt,
                          flat_shard_axis="pod")
    losses = []
    with m3:
        server = model.init(jax.random.PRNGKey(0))
        islands = jax.tree.map(lambda s: jnp.stack([s] * %(pods)d), server)
        opts = jax.vmap(ropt.init)(islands)
        for r in range(%(rounds)d):
            server, islands, opts, m = vc(
                server, islands, opts, {"tokens": jnp.asarray(inp[f"tok{r}"])},
                jnp.asarray(0.5, jnp.float32),
                jnp.asarray(inp[f"surv{r}"]))
            losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def test_reference_sharded_forms_on_a_four_device_mesh(bus, port_rounds,
                                                       tmp_path):
    tree, buf, clients, g, _ = bus
    toks = _round_inputs()
    inp = {"buf": buf, "clients": clients, "g": g,
           **{f"shape{i}": np.array(tree[f"p{i}"].shape) for i in range(5)},
           **{f"tok{r}": toks[r] for r in range(ROUNDS)},
           **{f"surv{r}": _survivors(r) for r in range(ROUNDS)}}
    np.savez(tmp_path / "in.npz", **inp)
    code = textwrap.dedent(_REFERENCE_SHARDED % dict(
        alpha=ALPHA, beta=BETA, lr=LR, wd=0.0, pods=N_PODS, steps=STEPS,
        rounds=ROUNDS))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", code,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    got, _ = _port_ops(tree, buf, clients, g, 4, wd=0.0)
    for k in ("assim", "adam_p", "adam_m", "adam_v", "easgd_c", "easgd_x",
              "lerp", "bcast"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    losses = [float(x) for x in port_rounds["pod"][3]]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
