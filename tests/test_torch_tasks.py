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


# ---------------------------------------------------------------------------
# the image task: make_image_data and CNNTask
# ---------------------------------------------------------------------------

from repro.core.tasks import CNNTask as RefCNN                     # noqa: E402
from repro.core.tasks import make_image_data as ref_image_data     # noqa: E402
from repro_torch.core.tasks import CNNTask, make_image_data        # noqa: E402

# CNNTask tolerances: forward logits and the loss within 2e-5 absolute
# (measured 2.9e-6 / 4.8e-7: XLA's convolution and PyTorch's sum in other
# orders); 20 Adam steps within 1e-5 absolute on the bus (measured
# 1.1e-7); accuracy within one validation sample (the two means of the
# same hit count may round one f32 ulp apart).


class InjectedCNNDraws(CNNTask):
    batch_indices = InjectedDraws.batch_indices


@pytest.mark.parametrize("kw", [dict(), dict(n_train=300, n_val=100),
                                dict(n_train=40, n_val=8, res=4, seed=3)])
def test_image_data_byte_identical(kw):
    a, b = ref_image_data(**kw), make_image_data(**kw)
    for f in ("x_train", "y_train", "x_val", "y_val"):
        ra, pa = getattr(a, f), getattr(b, f)
        assert ra.dtype == pa.dtype and ra.shape == pa.shape
        assert ra.tobytes() == pa.tobytes()


def _cnn_case(seed=0):
    data = ref_image_data(n_train=300, n_val=100, seed=seed)
    p0 = RefCNN().init_params(jax.random.PRNGKey(seed))
    return data, p0, {k: np.asarray(v) for k, v in p0.items()}


def test_cnn_forward_and_loss_match_reference():
    data, p0, p0_np = _cnn_case()
    task = CNNTask()
    tree = PF.unflatten(params_from_reference(p0_np, "cpu"))
    xf = jnp.asarray(data.x_val.reshape(len(data.x_val), -1))
    want = np.asarray(RefCNN()._fwd(p0, xf))
    for x in (data.x_val, data.x_val.reshape(len(data.x_val), -1)):
        got = task(tree, torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape == (100, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    y = torch.from_numpy(data.y_val).long()
    assert float(task.loss(tree, torch.from_numpy(data.x_val), y)) == \
        pytest.approx(float(RefCNN()._loss(p0, xf, jnp.asarray(data.y_val))),
                      abs=2e-5)


def test_cnn_client_train_with_injected_draws_matches_reference():
    data, p0, p0_np = _cnn_case(1)
    steps, seed = 20, 5
    want = RF.flatten(RefCNN().client_train(p0, data.x_train, data.y_train,
                                            steps=steps, seed=seed))
    base = params_from_reference(p0_np, "cpu")
    got = InjectedCNNDraws().client_train(
        base, torch.from_numpy(data.x_train),
        torch.from_numpy(data.y_train).long(), steps=steps, seed=seed)
    assert base.spec.meta() == want.spec.meta()
    np.testing.assert_allclose(got.numpy(), np.asarray(want.buf), rtol=0,
                               atol=1e-5)
    assert not torch.equal(got, base.buf)


def test_cnn_evaluate_and_init_layout():
    data, p0, p0_np = _cnn_case(2)
    task = CNNTask()
    tree = PF.unflatten(params_from_reference(p0_np, "cpu"))
    got = task.evaluate(tree, torch.from_numpy(data.x_val),
                        torch.from_numpy(data.y_val).long())
    assert got == pytest.approx(RefCNN().evaluate(p0, data.x_val,
                                                  data.y_val), abs=1 / 100)
    own = task.init_params(0, device="cpu")
    assert PF.tree_spec(own).meta() == RF.tree_spec(p0).meta()
    std = math.sqrt(2.0 / 27)                   # c1: fan-in 3 x 3 x 3
    assert abs(float(own["c1"].std()) / std - 1) < 0.2
    assert torch.backends.cudnn.allow_tf32 is False
