"""The f32 scalars the port's wrappers hand to B3 (fused Adam) and B1
(Eq. 1), against the ones the JAX reference forms, bit for bit, over a
sweep of hyperparameters.  No card is needed: the scalars are formed on
the host before any launch.

* B3: ``1-b1``, ``1-b2`` and ``lr*wd`` (and ``b1``, ``b2``) as the
  reference's jnp Adam (``repro.kernels.ref.adam_update``, the oracle the
  port's plain version is bit-exact with) forms them: Python floats
  combined in double, each rounded once to f32 where it meets an f32
  array.  They are read from the literals of its jaxpr.  The Pallas
  ``_adam_kernel`` forms ``1.0 - b1`` and ``1.0 - b2`` inside the kernel
  from the f32 ``b1``, ``b2`` instead (pinned below): 0.100000024 for
  b1 = 0.9 where the oracle has 0.1, within the reference's own 2e-6
  kernel-vs-oracle tolerance.
* B1: ``a`` and ``1-a`` as the reference's Pallas ``vc_asgd_lerp_flat``
  (interpret mode) and its jnp oracle form them, read off a probe whose
  outputs are exactly those scalars: ``a*0 + (1-a)*1`` and
  ``a*1 + (1-a)*0``.
* Adam's bias corrections, now cached by step, equal the uncached f32
  powers.
* B2: the f32 weights the ``assimilate_flat`` wrapper hands its kernel
  by value (``assimilate_weights``: a ``FixedWeights`` for up to 8
  clients, an f32 array above), read back from the ctypes objects, equal
  ``np.float32`` of each weight and the reference's own rounding in its
  ``assimilate_flat`` (``jnp.asarray(x, jnp.float32)``), for the Eq. 2,
  staleness-damped and island weights; the masked pod fold and the
  compressed round hand over the reference's island weights.
* B5: ``beta`` as its C entry receives it (the wrapper passes the Python
  number; the entry's f32 argument rounds it once, read back through a
  ctypes callback of the same argtypes) equals the reference's
  ``jnp.asarray([beta], jnp.float32)``.  B7's (and B8's) ``tau`` given
  as a number reaches its entry the same way, as the f32 the plain
  version compares (``torch.as_tensor(tau, dtype=torch.float32)``), and
  the plain version cuts there.
"""
import ctypes

import jax
import jax.numpy as jnp
from jax.extend.core import Literal
import numpy as np
import pytest
import torch

from repro.core import vc_asgd as RVA
from repro.kernels import ref as RR
from repro.kernels import vc_asgd_update as RV
from repro.runtime import vc_runtime as RVR
from repro_torch.core import vc_asgd as PVA
from repro_torch.core.flat import BLOCK
from repro_torch.kernels import ref as PR
from repro_torch.kernels import topk_mask as TK
from repro_torch.kernels import vc_asgd_update as VK
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime import vc_runtime as PVR


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


ADAM_SWEEP = [  # (lr, b1, b2, eps, weight_decay)
    (1e-3, 0.9, 0.999, 1e-8, 0.0),
    (1e-3, 0.9, 0.999, 1e-8, 0.01),
    (3e-3, 0.95, 0.98, 1e-6, 0.1),
    (0.1, 0.5, 0.9999, 1e-12, 5e-4),
    (2.5e-4, 0.8, 0.99, 1e-8, 1e-2),
    (1.0 / 3.0, 0.0, 0.0, 1e-7, 0.3),
]


def _oracle_literals(lr, b1, b2, eps, wd):
    """{operand: [literals it is multiplied by, in order]} of the jnp
    Adam's jaxpr: p -> [lr*wd], g -> [1-b1, 1-b2], m -> [b1], v -> [b2]."""
    z = jnp.zeros(4, jnp.float32)
    jp = jax.make_jaxpr(lambda p, g, m, v: RR.adam_update(
        p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps, c1=jnp.float32(0.5),
        c2=jnp.float32(0.25), weight_decay=wd))(z, z, z, z).jaxpr
    names = dict(zip(jp.invars, "pgmv"))
    out = {k: [] for k in "pgmv"}
    for eqn in jp.eqns:
        if eqn.primitive.name != "mul":
            continue
        lits = [x for x in eqn.invars if isinstance(x, Literal)]
        ops = [names[x] for x in eqn.invars
               if not isinstance(x, Literal) and x in names]
        if len(lits) == 1 and len(ops) == 1:
            out[ops[0]].append(float(lits[0].val))
    return out


@pytest.mark.parametrize("lr,b1,b2,eps,wd", ADAM_SWEEP)
def test_adam_scalars_equal_reference_oracle(lr, b1, b2, eps, wd):
    sc = VK.adam_scalars(lr, b1, b2, eps, wd, np.float32(0.5),
                         np.float32(0.25))
    lit = _oracle_literals(lr, b1, b2, eps, wd)
    assert [_bits(x) for x in lit["g"]] == [_bits(sc.omb1), _bits(sc.omb2)]
    assert [_bits(x) for x in lit["m"]] == [_bits(sc.b1)]
    assert [_bits(x) for x in lit["v"]] == [_bits(sc.b2)]
    if wd:
        assert [_bits(x) for x in lit["p"]] == [_bits(sc.lr_wd)]
    else:
        assert lit["p"] == [] and sc.lr_wd == 0.0
    assert _bits(sc.lr) == _bits(np.float32(lr))
    assert _bits(sc.eps) == _bits(np.float32(eps))
    assert (_bits(sc.c1), _bits(sc.c2)) == (_bits(0.5), _bits(0.25))


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.95, 0.98)])
def test_pallas_adam_forms_one_minus_beta_in_f32(b1, b2):
    """The reference's Pallas kernel, probed at m = v = 0, g = 1: its
    m' and v' lanes are ``1 - b1`` and ``1 - b2`` as it forms them."""
    z, one = jnp.zeros(BLOCK, jnp.float32), jnp.ones(BLOCK, jnp.float32)
    _, m, v = RV.adam_update_flat(z, one, z, z, 1e-3, b1, b2, 1e-8, 0.0,
                                  1.0, 1.0)
    assert _bits(m[0]) == _bits(np.float32(1) - np.float32(b1))
    assert _bits(v[0]) == _bits(np.float32(1) - np.float32(b2))
    assert _bits(m[0]) != _bits(VK.adam_scalars(1e-3, b1, b2, 1e-8, 0.0,
                                                1.0, 1.0).omb1)


LERP_ALPHAS = [0.0, 1.0, 0.5, 2.0 / 3.0, 0.9, 0.95, 0.999, 1e-30, 1e-8,
               2.0 ** -25, 2.0 ** -25 + 2.0 ** -60, 3e-8, 1 - 2.0 ** -24,
               -0.5, 1.5, 1e10, -3e38, 7.0]


@pytest.mark.parametrize("alpha", LERP_ALPHAS, ids=repr)
def test_lerp_scalars_equal_reference(alpha):
    a, oma = VK.lerp_scalars(alpha)
    z, one = jnp.zeros(BLOCK, jnp.float32), jnp.ones(BLOCK, jnp.float32)
    for lerp in (RV.vc_asgd_lerp_flat, RR.vc_asgd_lerp):
        assert _bits(lerp(z, one, alpha)[0]) == _bits(oma)
        assert _bits(lerp(one, z, alpha)[0]) == _bits(a)
    assert _bits(oma) == _bits(np.float32(1) - np.float32(alpha))


def test_adam_bias_corrections_cached_equal_f32_powers():
    for b1, b2 in ((0.9, 0.999), (0.95, 0.98)):
        opt = Adam(b1=b1, b2=b2)
        for step in range(0, 3000, 7):
            t, _, c1, c2 = opt._scalars(step)
            tt = np.float32(t)
            assert c1.dtype == c2.dtype == np.float32
            assert _bits(c1) == _bits(np.float32(1) - np.float32(b1) ** tt)
            assert _bits(c2) == _bits(np.float32(1) - np.float32(b2) ** tt)


# ---- B2: Eq. 2's weights by value ------------------------------------------

EQ2_CASES = [(n, alpha) for n in (1, 2, 3, 4, 7, 8, 9, 33, 511)
             for alpha in (0.5, 2.0 / 3.0, 0.9, 0.999, 1 - 2.0 ** -30)]


def _handed(weights) -> list:
    """The f32 bits of the weights B2's wrapper hands its kernel, read from
    the ctypes object it passes, and its unused tail."""
    obj = VK.assimilate_weights(weights)
    if isinstance(obj, VK.FixedWeights):
        vals = [getattr(obj, f"w{j}") for j in range(VK.FIXED_CLIENTS + 1)]
        n = len(weights)
        assert len(weights) <= VK.FIXED_CLIENTS + 1
        assert all(v == 0.0 for v in vals[n:])
        return [_bits(v) for v in vals[:n]]
    assert len(weights) > VK.FIXED_CLIENTS + 1 and len(obj) == len(weights)
    return [_bits(v) for v in obj]


def _reference_rounding(weights) -> list:
    """The reference's ``assimilate_flat`` (vc_asgd_update.py:202):
    ``jnp.stack([jnp.asarray(x, jnp.float32).reshape(()) ...])``."""
    w = jnp.stack([jnp.asarray(x, jnp.float32).reshape(()) for x in weights])
    return [int(b) for b in np.asarray(w).view(np.int32)]


@pytest.mark.parametrize("n,alpha", EQ2_CASES)
def test_eq2_weights_by_value_equal_reference(n, alpha):
    w = PVA.assimilation_weights(n, alpha)
    assert w == RVA.assimilation_weights(n, alpha)
    got = _handed(w)
    assert got == [_bits(np.float32(x)) for x in w]
    assert got == _reference_rounding(RVA.assimilation_weights(n, alpha))


@pytest.mark.parametrize("n", [1, 4, 8, 9, 33])
@pytest.mark.parametrize("alpha,gamma", [(0.9, 0.7), (2.0 / 3.0, 0.5),
                                         (0.999, 0.95)])
def test_staleness_weights_by_value_equal_reference(n, alpha, gamma):
    stale = [(3 * j + 1) % 5 for j in range(n)]
    w = PVA.staleness_weights(n, alpha, stale, gamma)
    want = RVA.staleness_weights(n, alpha, stale, gamma)
    got = _handed(w)
    assert got == [_bits(np.float32(x)) for x in w]
    assert got == _reference_rounding(want)


def _alive(n_pods, dead):
    alive = np.ones(n_pods, bool)
    alive[list(dead)] = False
    return alive


ISLAND_CASES = [(n, alpha, dead) for n in (1, 4, 8, 9)
                for alpha in (0.8, 0.9, 0.95)
                for dead in ((), (0,), (n - 1,))]


@pytest.mark.parametrize("n_pods,alpha,dead", ISLAND_CASES)
def test_island_weights_by_value_equal_reference(n_pods, alpha, dead):
    alive = _alive(n_pods, dead)
    rw, rws = RVR.island_weights(n_pods, alpha, jnp.asarray(alive))
    pw, pws = PVR.island_weights(n_pods, alpha, torch.from_numpy(alive))
    got = _handed([float(pws)] + pw.tolist())
    assert got == _reference_rounding([rws] + [rw[j] for j in range(n_pods)])
    hw, hws = PVR._host_island_weights(n_pods, alpha, alive)
    assert got == [_bits(hws)] + [_bits(x) for x in hw]


@pytest.mark.parametrize("n_pods,dead", [(4, (2,)), (8, (0, 4, 7)), (9, ())])
def test_masked_fold_hands_b2_the_reference_island_weights(n_pods, dead,
                                                           monkeypatch):
    """``vc_runtime.assimilate_flat`` hands B2 host floats whose f32
    rounding is the reference's island weights, read from the call."""
    seen = []
    monkeypatch.setattr(PVR.K, "fused_assimilate_flat",
                        lambda s, c, w: seen.append(list(w)) or s)
    alive = _alive(n_pods, dead)
    pw, pws = PVR.island_weights(n_pods, 0.9, torch.from_numpy(alive))
    PVR.assimilate_flat(torch.zeros(BLOCK), torch.zeros(n_pods, BLOCK), pw,
                        pws)
    assert len(seen) == 1 and all(type(x) is float for x in seen[0])
    rw, rws = RVR.island_weights(n_pods, 0.9, jnp.asarray(alive))
    assert _handed(seen[0]) == _reference_rounding(
        [rws] + [rw[j] for j in range(n_pods)])


# ---- B5's beta and B7's tau by value ----------------------------------------

SCALAR_SWEEP = [0.05, 0.1, 1.0 / 3.0, 0.9, 0.999, 1e-8, 1e-30,
                2.0 ** -25 + 2.0 ** -60, 1 - 2.0 ** -25, 1.5, 7.0, 1e10,
                np.float32(0.05), np.float64(0.3)]


def _received(argtypes, args, at: int) -> float:
    """The value a C entry of ``argtypes`` receives as argument ``at`` when
    called with ``args``: a ctypes callback of the same signature stands
    in for the entry."""
    seen = []
    probe = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(
        lambda *a: seen.append(a[at]) or 0)
    probe(*args)
    return seen[0]


@pytest.mark.parametrize("beta", SCALAR_SWEEP, ids=repr)
def test_easgd_beta_by_value_equals_reference(beta):
    got = _received(VK.SIGNATURES["easgd"], (0, 0, 0, 0, beta, 3, BLOCK, 0),
                    4)
    want = np.asarray(jnp.asarray([beta], jnp.float32))[0]
    assert _bits(got) == _bits(want) == _bits(np.float32(beta))


@pytest.mark.parametrize("entry,at", [("tk_exact", 2),
                                      ("tk_threshold_f32", 2)])
@pytest.mark.parametrize("tau", SCALAR_SWEEP, ids=repr)
def test_topk_tau_by_value_is_the_plain_versions_f32(tau, entry, at):
    tau_p, tau_v = TK._ptr_or_value("tau", tau, torch.float32, 0)
    assert tau_p is None
    args = [0] * len(TK.SIGNATURES[entry])
    args[at] = tau_v
    got = _received(TK.SIGNATURES[entry], args, at)
    t32 = torch.as_tensor(tau, dtype=torch.float32)
    assert _bits(got) == _bits(t32.numpy())
    # the plain version keeps what lies above that f32 and ties at it
    up, down = np.nextafter(np.float32(got), np.float32(np.inf)), \
        np.nextafter(np.float32(got), np.float32(0))
    x = torch.tensor([down, got, up, -got], dtype=torch.float32)
    kept, _ = PR.threshold_sparsify_exact(
        x, tau, torch.zeros(1, dtype=torch.int32), 1)
    assert kept.tolist() == [0.0, float(np.float32(got)), float(up), 0.0]


def test_topk_budget_by_value_is_range_checked():
    assert TK._ptr_or_value("tie_budget", np.int32(7), torch.int32, 0) == (
        None, 7)
    for bad in (1 << 31, -(1 << 31) - 1):
        with pytest.raises(ValueError):
            TK._ptr_or_value("tie_budget", bad, torch.int32, 0)
    with pytest.raises(TypeError):
        TK._ptr_or_value("tie_budget", 1.5, torch.int32, 0)
