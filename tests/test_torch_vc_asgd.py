"""Port parity: Eq. 1 / Eq. 2 and the weight schedules against
repro.core.vc_asgd, on the same numpy-seeded buffers.

Tolerance: none.  Eq. 1 is bit-exact against the reference's eager jnp
bus AND its numpy bus (separate f32 multiply and add, 1-a in f32); Eq. 2
is bit-exact against ``assimilate_many_flat(use_kernel=False)``; weights
and schedules are equal as Python floats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core import vc_asgd as RV
from repro_torch.core import flat as PF
from repro_torch.core import vc_asgd as PV

torch.set_num_threads(2)

N = 2 * PF.BLOCK


def _bufs(seed, n_clients=1):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(N).astype(np.float32)
    c = rng.standard_normal((n_clients, N)).astype(np.float32)
    return s, c


def _spec():
    return PF.tree_spec({"x": torch.zeros(N)})


def _ref_spec():
    return RF.tree_spec({"x": jnp.zeros(N)})


@pytest.mark.parametrize("alpha", [0.0, 0.5, 2 / 3, 0.95, 0.999, 1.0])
def test_eq1_bit_exact_vs_jnp_and_numpy_bus(alpha):
    s, c = _bufs(0)
    port = PV.vc_asgd_update_flat(
        PF.FlatParams(torch.from_numpy(s), _spec()), torch.from_numpy(c[0]),
        alpha).buf.numpy()
    ref_jnp = RV.vc_asgd_update_flat(
        RF.FlatParams(jnp.asarray(s), _ref_spec()), jnp.asarray(c[0]), alpha)
    ref_np = RV.vc_asgd_update_flat(RF.FlatParams(s, _ref_spec()), c[0], alpha)
    assert port.tobytes() == np.asarray(ref_jnp.buf).tobytes()
    assert port.tobytes() == np.asarray(ref_np.buf).tobytes()


def test_eq1_bf16_storage_bit_exact_vs_jnp_bus():
    s, c = _bufs(1)
    s16, c16 = jnp.asarray(s, jnp.bfloat16), jnp.asarray(c[0], jnp.bfloat16)
    ref = RV.vc_asgd_update_flat(RF.FlatParams(s16, _ref_spec()), c16, 0.8)
    port = PV.vc_asgd_update_flat(
        PF.FlatParams(torch.from_numpy(s).to(torch.bfloat16), _spec()),
        torch.from_numpy(c[0]).to(torch.bfloat16), 0.8).buf
    assert port.dtype == torch.bfloat16
    assert (port.view(torch.int16).numpy().tobytes()
            == np.asarray(ref.buf).view(np.int16).tobytes())


@pytest.mark.parametrize("n_clients", [1, 3, 5])
def test_eq2_bit_exact_vs_reference_jnp_path(n_clients):
    s, c = _bufs(2 + n_clients, n_clients)
    ref = RV.assimilate_many_flat(RF.FlatParams(jnp.asarray(s), _ref_spec()),
                                  jnp.asarray(c), 0.83, use_kernel=False)
    port = PV.assimilate_many_flat(PF.FlatParams(torch.from_numpy(s), _spec()),
                                   torch.from_numpy(c), 0.83)
    assert port.buf.numpy().tobytes() == np.asarray(ref.buf).tobytes()


def test_eq2_staleness_weights_and_list_input_bit_exact():
    s, c = _bufs(9, 3)
    w = RV.staleness_weights(3, 0.9, [0, 2, 5])
    assert PV.staleness_weights(3, 0.9, [0, 2, 5]) == w
    ref = RV.assimilate_many_flat(RF.FlatParams(jnp.asarray(s), _ref_spec()),
                                  jnp.asarray(c), 0.9, weights=w)
    spec = _spec()
    port = PV.assimilate_many_flat(
        PF.FlatParams(torch.from_numpy(s), spec),
        [PF.FlatParams(torch.from_numpy(r.copy()), spec) for r in c], 0.9,
        weights=w)
    assert port.buf.numpy().tobytes() == np.asarray(ref.buf).tobytes()


def test_eq2_bf16_storage_bit_exact():
    s, c = _bufs(11, 4)
    ref = RV.assimilate_many_flat(
        RF.FlatParams(jnp.asarray(s, jnp.bfloat16), _ref_spec()),
        jnp.asarray(c, jnp.bfloat16), 0.7, use_kernel=False)
    port = PV.assimilate_many_flat(
        PF.FlatParams(torch.from_numpy(s).to(torch.bfloat16), _spec()),
        torch.from_numpy(c).to(torch.bfloat16), 0.7)
    assert (port.buf.view(torch.int16).numpy().tobytes()
            == np.asarray(ref.buf).view(np.int16).tobytes())


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.999])
def test_weights_and_schedules_equal(n, alpha):
    assert PV.assimilation_weights(n, alpha) == RV.assimilation_weights(n, alpha)
    assert PV.staleness_alpha(alpha, n, 0.6) == RV.staleness_alpha(alpha, n, 0.6)
    for e in range(6):
        assert PV.var_alpha()(e) == RV.var_alpha()(e)
        assert PV.const_alpha(alpha)(e) == RV.const_alpha(alpha)(e)
        assert PV.power_alpha()(e) == RV.power_alpha()(e)


def test_eq2_rejects_wrong_weight_count():
    s, c = _bufs(3, 2)
    with pytest.raises(ValueError):
        PV.assimilate_many_flat(PF.FlatParams(torch.from_numpy(s), _spec()),
                                torch.from_numpy(c), 0.5, weights=[1.0, 0.0])
