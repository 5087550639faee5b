"""Port parity: flat Adam and the flat train step against repro.optim /
repro.runtime.train, on numpy-seeded inputs.

Tolerances:
* one Adam step (plain version vs ``repro.kernels.ref.adam_update`` and
  vs the reference's ``Adam.update_flat``): 2e-6 absolute and relative,
  the reference's own f32 kernel tolerance (tests/test_kernels.py TOL) —
  the two sides differ by at most 1 ulp where XLA's CPU sqrt/divide
  rounds differently;
* k train steps on the MLP loss: 2e-6 absolute on the parameter bus —
  the reference step is jitted (XLA may contract multiply-adds and sum
  the gradient in another order), so ulps accumulate over the steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core.tasks import MLPTask as RefMLP
from repro.core.tasks import make_classification_data as ref_data
from repro.kernels import ref as RR
from repro.optim import Adam as RefAdam
from repro.runtime.train import make_flat_train_step as ref_make_step
from repro_torch.convert import params_from_reference
from repro_torch.core import flat as PF
from repro_torch.core.tasks import MLPTask
from repro_torch.kernels import ref as PR
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime.train import make_flat_train_step

torch.set_num_threads(2)

TOL = 2e-6


def _lanes(seed, n=2 * PF.BLOCK):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("t", [1, 2, 10, 1000])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_adam_matches_reference_oracle(t, wd):
    p, g, m, v = _lanes(t)
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
    c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
    want = RR.adam_update(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                          jnp.asarray(v), lr=1e-3, b1=0.9, b2=0.999,
                          eps=1e-8, c1=jnp.float32(c1), c2=jnp.float32(c2),
                          weight_decay=wd)
    got = PR.adam_update(*(torch.from_numpy(a) for a in (p, g, m, v)),
                         lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, c1=c1, c2=c2,
                         weight_decay=wd)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_update_flat_matches_reference_update_flat_over_steps():
    p, _, _, _ = _lanes(7)
    ref_fp = RF.FlatParams(jnp.asarray(p), RF.tree_spec({"x": jnp.zeros(p.size)}))
    port_fp = PF.FlatParams(torch.from_numpy(p), PF.tree_spec(
        {"x": torch.zeros(p.size)}))
    ropt, popt = RefAdam(lr=3e-3), Adam(lr=3e-3)
    rs, ps = ropt.init_flat(ref_fp), popt.init_flat(port_fp)
    rng = np.random.default_rng(8)
    for _ in range(5):
        g = rng.standard_normal(p.size).astype(np.float32)
        ref_fp, rs = ropt.update_flat(jnp.asarray(g), rs, ref_fp)
        port_fp, ps = popt.update_flat(torch.from_numpy(g), ps, port_fp)
    assert ps.step == int(rs.step) == 5
    np.testing.assert_allclose(port_fp.buf.numpy(), np.asarray(ref_fp.buf),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ps.v.numpy(), np.asarray(rs.v), rtol=TOL,
                               atol=TOL)


def test_flat_train_step_on_mlp_loss_matches_reference():
    rtask, ptask = RefMLP(), MLPTask()
    data = ref_data(n_train=400, n_val=100)
    p0 = rtask.init_params(jax.random.PRNGKey(3))
    rfp = RF.flatten(p0)
    ropt = RefAdam(lr=1e-3)
    rfos = ropt.init_flat(rfp)
    rstep = ref_make_step(lambda p, b: rtask._loss(p, b[0], b[1]), ropt)
    pfp = params_from_reference({k: np.asarray(v) for k, v in p0.items()},
                                "cpu")
    popt = Adam(lr=1e-3)
    pfos = popt.init_flat(pfp)
    pstep = make_flat_train_step(lambda p, b: ptask.loss(p, b[0], b[1]), popt)
    rng = np.random.default_rng(0)
    for _ in range(12):
        idx = rng.integers(0, 400, 50)
        x, y = data.x_train[idx], data.y_train[idx]
        rfp, rfos, rloss = rstep(rfp, rfos, (jnp.asarray(x), jnp.asarray(y)))
        pfp, pfos, ploss = pstep(pfp, pfos, (torch.from_numpy(x),
                                             torch.from_numpy(y).long()))
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    assert pfp.spec.meta() == rfp.spec.meta()
    np.testing.assert_allclose(pfp.buf.numpy(), np.asarray(rfp.buf),
                               rtol=0, atol=TOL)
    assert torch.count_nonzero(pfp.buf[pfp.spec.n:]) == 0   # tail stays 0


# ---------------------------------------------------------------------------
# Sgd and flat_opt_to_tree
# ---------------------------------------------------------------------------

from repro.optim import optimizers as RO                           # noqa: E402
from repro_torch.optim.optimizers import (Sgd, flat_opt_from_tree,  # noqa: E402
                                          flat_opt_to_tree)


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(5, 3), "b": f(3), "n": {"k": f(2, 2, 2)}}


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _map(fn, t):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", [0.05, lambda t: 0.1 / t],
                         ids=["const", "schedule"])
def test_sgd_matches_reference_over_steps(momentum, lr):
    """Five SGD steps from the same params and gradients: bit-equal (the
    same f32 multiply and subtract, scalars rounded the same way)."""
    p_np = _tree(0)
    ref_lr = lr if not callable(lr) else (lambda t: 0.1 / t)
    ref, port = RO.Sgd(lr=ref_lr, momentum=momentum), Sgd(lr=lr,
                                                          momentum=momentum)
    rp, pp = _map(jnp.asarray, p_np), _map(torch.from_numpy, p_np)
    rs, ps = ref.init(rp), port.init(pp)
    assert (ps.m is None) == (rs.m is None) and ps.v is None
    for i in range(5):
        g = _tree(10 + i)
        rp, rs = ref.update(_map(jnp.asarray, g), rs, rp)
        pp, ps = port.update(_map(torch.from_numpy, g), ps, pp)
    assert ps.step == int(rs.step) == 5
    got, want = _map(lambda t: t.numpy(), pp), _np_tree(rp)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["n"]["k"], want["n"]["k"])
    if momentum:
        np.testing.assert_array_equal(ps.m["w"].numpy(), np.asarray(rs.m["w"]))


def test_flat_opt_to_tree_matches_reference():
    """Three flat Adam steps, then the lanes viewed as trees: equal to
    the reference's ``flat_opt_to_tree`` leaf for leaf, and lifted back
    by ``flat_opt_from_tree`` to the same lanes."""
    p_np = _tree(1)
    rfp = RF.flatten(_map(jnp.asarray, p_np))
    pfp = PF.flatten(_map(torch.from_numpy, p_np))
    ra, pa = RefAdam(), Adam()
    rs, ps = ra.init_flat(rfp), pa.init_flat(pfp)
    for i in range(3):
        g = RF.flatten(_map(jnp.asarray, _tree(20 + i))).buf
        rfp, rs = ra.update_flat(g, rs, rfp)
        pfp, ps = pa.update_flat(torch.from_numpy(np.array(g)), ps, pfp)
    rt, pt = RO.flat_opt_to_tree(rs), flat_opt_to_tree(ps)
    assert pt.step == int(rt.step) == 3
    for lane in ("m", "v"):
        want, got = _np_tree(getattr(rt, lane)), getattr(pt, lane)
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["n"]["k"].numpy(), want["n"]["k"],
                                   rtol=TOL, atol=TOL)
        assert got["w"].dtype == torch.float32 and got["w"].shape == (5, 3)
    back = flat_opt_from_tree(pt, ps.spec)
    assert torch.equal(back.m, ps.m) and torch.equal(back.v, ps.v)
    assert back.step == ps.step
