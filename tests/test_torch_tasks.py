"""Port parity: repro_torch.core.tasks against repro.core.tasks.

* the data generator is numpy in both: byte-identical arrays;
* ``client_train`` from the reference's params with the reference's own
  minibatch draws injected (core/tasks.py:98's expression, reproduced
  here) ends within 1e-5 absolute of the reference's trained params —
  the reference trains under jit (FMA contraction, other summation
  order) for 120 Adam steps, so ulps accumulate;
* accuracy on the same params is the same number.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core.tasks import MLPTask as RefMLP
from repro.core.tasks import make_classification_data as ref_data
from repro_torch.convert import params_from_reference
from repro_torch.core import flat as PF
from repro_torch.core.tasks import MLPTask, make_classification_data

torch.set_num_threads(2)


class InjectedDraws(MLPTask):
    """MLPTask drawing its minibatches exactly as the reference does."""

    def batch_indices(self, seed, steps, n):
        key = jax.random.PRNGKey(seed)
        draw = jax.vmap(lambda i: jax.random.randint(
            jax.random.fold_in(key, i), (self.batch,), 0, n))
        idx = draw(jnp.arange(steps, dtype=jnp.float32))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _ref_params_np(seed):
    p = RefMLP().init_params(jax.random.PRNGKey(seed))
    return p, {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("kw", [dict(), dict(n_train=800, n_val=200),
                                dict(n_train=64, n_val=16, dim=8, seed=5)])
def test_data_byte_identical(kw):
    a, b = ref_data(**kw), make_classification_data(**kw)
    for f in ("x_train", "y_train", "x_val", "y_val"):
        ra, pa = getattr(a, f), getattr(b, f)
        assert ra.dtype == pa.dtype and ra.tobytes() == pa.tobytes()


def test_client_train_with_injected_draws_matches_reference():
    data = ref_data(n_train=400, n_val=100)
    p0, p0_np = _ref_params_np(1)
    x, y = data.x_train[:100], data.y_train[:100]
    steps, seed = 120, 1000003 + 17
    want = RF.flatten(RefMLP().client_train(p0, x, y, steps=steps, seed=seed))
    base = params_from_reference(p0_np, "cpu")
    got = InjectedDraws().client_train(base, torch.from_numpy(x),
                                       torch.from_numpy(y).long(),
                                       steps=steps, seed=seed)
    assert base.spec.meta() == want.spec.meta()
    np.testing.assert_allclose(got.numpy(), np.asarray(want.buf), rtol=0,
                               atol=1e-5)
    assert not torch.equal(got, base.buf)           # it did train


def test_evaluate_matches_reference():
    data = ref_data(n_train=100, n_val=300)
    p0, p0_np = _ref_params_np(2)
    task = MLPTask()
    tree = PF.unflatten(params_from_reference(p0_np, "cpu"))
    assert task.evaluate(tree, torch.from_numpy(data.x_val),
                         torch.from_numpy(data.y_val).long()) == \
        RefMLP().evaluate(p0, data.x_val, data.y_val)


def test_init_params_layout_and_he_normal_draws():
    task = MLPTask()
    p = task.init_params(0, device="cpu")
    _, ref_np = _ref_params_np(0)
    assert PF.tree_spec(p).meta() == RF.tree_spec(
        {k: jnp.asarray(v) for k, v in ref_np.items()}).meta()
    for name, fan_in in (("w1", 32), ("w2", 128), ("w3", 64)):
        w = p[name]
        std = math.sqrt(2.0 / fan_in)
        # truncated at 2 std of the untruncated normal, rescaled
        assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) / std - 1) < 0.15
    assert all(torch.count_nonzero(p[b]) == 0 for b in ("b1", "b2", "b3"))
    again = task.init_params(0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)   # seeded, CPU draws


def test_batch_indices_are_seeded_cpu_draws():
    task = MLPTask()
    a = task.batch_indices(7, 5, 100)
    assert a.shape == (5, task.batch) and a.device.type == "cpu"
    assert torch.equal(a, task.batch_indices(7, 5, 100))
    assert int(a.min()) >= 0 and int(a.max()) < 100
