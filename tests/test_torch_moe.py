"""The port's MoE (token-choice top-k, capacity-bounded dispatch, gathered
decode) against the JAX package, on the CPU, at the reduced jamba config
(4 experts, top-2) in f32.

* ``apply_moe`` (the port dispatches each batch row on its own, as the
  reference vmaps it over rows) against the reference's, 1e-5: at the
  config's capacity factor 1.25 with tokens that overflow an expert's
  capacity — the dropped (token, choice) set must be the reference's,
  which is the count of earlier assignments to the expert in token-major
  order — and at 8.0, where none drop; also with virtual experts
  (``ep_virtual`` = 2).  The Switch aux term per row, 1e-6.
* Routing ties: logits built from small integers (exact in any summation
  order) tie exactly; the port's stable descending sort must pick the
  experts ``lax.top_k`` picks (ties to the lowest index), and the whole
  MoE must agree.
* ``moe_decode_gathered``, 1e-5.

Inputs are drawn with numpy from a seed; the reference's weights are
carried over as numpy arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models import layers as JL
from repro_torch.configs import get_reduced
from repro_torch.models import layers as L

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**moe):
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32")
    pcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    return (rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe)),
            pcfg.replace(moe=dataclasses.replace(pcfg.moe, **moe)))


def _params(rcfg, seed=0):
    p = JL.init_moe(jax.random.PRNGKey(seed), rcfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _skewed_tokens(p, b, T, d, seed):
    """Tokens that lean towards expert 0 (a shared component along its
    router column), so at capacity factor 1.25 it overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, d)).astype(np.float32)
    col = np.asarray(p["router"])[:, 0]
    return (x + 3.0 * col / np.linalg.norm(col) * np.sqrt(d)).astype(
        np.float32)


def _ref_valid(p, x, cfg):
    """The reference's kept (token, choice) assignments per row, computed
    as its apply_moe computes them (lax.top_k, token-major cumsum)."""
    m = cfg.moe
    T = x.shape[1]
    cap = JL.moe_capacity(T, cfg)

    def row(xs):
        probs = jax.nn.softmax((xs @ p["router"]).astype(jnp.float32), -1)
        top_p, top_i = jax.lax.top_k(probs, m.top_k)
        vt_i, _ = JL._virtual_assignments(top_i, top_p, m.ep_virtual)
        flat = vt_i.reshape(-1)
        oh = jax.nn.one_hot(flat, m.n_virtual, dtype=jnp.int32)
        pos = (jnp.cumsum(oh, 0) - oh)[jnp.arange(flat.shape[0]), flat]
        return pos < cap
    return np.asarray(jax.vmap(row)(jnp.asarray(x)))


@pytest.mark.parametrize("cf,drops", [(1.25, True), (8.0, False)])
def test_apply_moe_matches_the_reference_and_drops_the_same_tokens(cf,
                                                                   drops):
    rcfg, pcfg = _cfgs(capacity_factor=cf)
    p, pt = _params(rcfg, seed=1)
    x = _skewed_tokens(p, 3, 40, pcfg.d_model, seed=1)
    out, aux = L.apply_moe(pt, torch.from_numpy(x), pcfg)
    r_out, r_aux = jax.vmap(lambda t: JL.apply_moe(p, t, rcfg))(
        jnp.asarray(x))
    # the port's kept set, from the functions apply_moe runs
    _, top_p, top_i = L.route(pt, torch.from_numpy(x), pcfg)
    cap = L.moe_capacity(40, pcfg)
    _, valid = L.moe_dispatch(top_i.reshape(3, -1), 4, cap)
    want = _ref_valid(p, x, rcfg)
    assert cap == JL.moe_capacity(40, rcfg) == (32 if cf == 1.25 else 40)
    np.testing.assert_array_equal(valid.numpy(), want)
    assert bool((~want).any()) == drops
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(r_aux), rtol=1e-6,
                               atol=1e-6)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape


def test_dropped_choices_contribute_nothing():
    """A row whose every token picks expert 0 first: past capacity, each
    token keeps only its second choice's gated output."""
    rcfg, pcfg = _cfgs()
    _, pt = _params(rcfg, seed=2)
    x = torch.from_numpy(_skewed_tokens(
        {"router": pt["router"].numpy()}, 1, 40, pcfg.d_model, seed=2))
    _, top_p, top_i = L.route(pt, x, pcfg)
    assert bool((top_i[..., 0] == 0).all())
    out, _ = L.apply_moe(pt, x, pcfg)
    cap = L.moe_capacity(40, pcfg)
    # token t > cap - 1 lost its first choice: its output is the second
    # expert's alone, gated by its renormalised probability
    t = 39
    e2 = int(top_i[0, t, 1])
    xe = x[0, t]
    h = torch.nn.functional.silu(xe @ pt["wg"][e2]) * (xe @ pt["wi"][e2])
    want = (h @ pt["wo"][e2]) * top_p[0, t, 1]
    assert t >= cap
    np.testing.assert_allclose(out[0, t].numpy(), want.numpy(), **TOL)


def test_apply_moe_with_virtual_experts_matches_the_reference():
    rcfg, pcfg = _cfgs(capacity_factor=8.0, ep_virtual=2)
    p, pt = _params(rcfg, seed=3)
    assert tuple(pt["wi"].shape) == (8, pcfg.d_model, 32)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, pcfg.d_model)).astype(np.float32)
    out, aux = L.apply_moe(pt, torch.from_numpy(x), pcfg)
    r_out, r_aux = jax.vmap(lambda t: JL.apply_moe(p, t, rcfg))(
        jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(r_aux), rtol=1e-6,
                               atol=1e-6)
    vt, vp = L._virtual_assignments(torch.tensor([[2, 0]]),
                                    torch.tensor([[0.7, 0.3]]), 2)
    r_vt, r_vp = JL._virtual_assignments(jnp.asarray([[2, 0]]),
                                         jnp.asarray([[0.7, 0.3]]), 2)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(r_vt))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(r_vp))


def _tied(d, e, T, seed):
    """x [1, T, d] one-hot rows and an integer router [d, e] (every
    logit exact in any summation order) with many exact ties."""
    rng = np.random.default_rng(seed)
    x = np.zeros((1, T, d), np.float32)
    x[0, np.arange(T), rng.integers(0, d, T)] = 1.0
    router = rng.integers(0, 3, (d, e)).astype(np.float32)
    router[:, 2] = router[:, 1]            # experts 1 and 2 always tie
    return x, router


def test_router_ties_go_to_the_lowest_index_as_lax_top_k():
    rcfg, pcfg = _cfgs(capacity_factor=8.0)
    p, pt = _params(rcfg, seed=4)
    x, router = _tied(pcfg.d_model, 4, 64, seed=4)
    p = {**p, "router": jnp.asarray(router)}
    pt = {**pt, "router": torch.from_numpy(router)}
    probs, _, top_i = L.route(pt, torch.from_numpy(x), pcfg)
    r_probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], -1)
    _, r_top = jax.lax.top_k(r_probs, 2)
    # softmax's last bit differs between the packages; a tie in the
    # logits is a tie in each package's probabilities
    np.testing.assert_allclose(probs.numpy(), np.asarray(r_probs),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(r_top))
    assert torch.equal(probs[..., 1], probs[..., 2])
    ties = (probs[..., :, None] == probs[..., None, :]).sum(-1) > 1
    assert int(ties.any(-1).sum()) > 40            # most tokens have a tie
    out, _ = L.apply_moe(pt, torch.from_numpy(x), pcfg)
    r_out, _ = JL.apply_moe(p, jnp.asarray(x[0]), rcfg)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(r_out), **TOL)


def test_route_ties_at_sixteen_experts():
    """jamba's published expert count: 16 experts, integer logits with
    ties everywhere; the port's top-2 equals lax.top_k's."""
    _, pcfg = _cfgs()
    pcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe, n_experts=16))
    x, router = _tied(pcfg.d_model, 16, 200, seed=5)
    _, top_p, top_i = L.route({"router": torch.from_numpy(router)},
                              torch.from_numpy(x), pcfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    r_p, r_i = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(
        top_p.numpy(), np.asarray(r_p / r_p.sum(-1, keepdims=True)),
        rtol=1e-6, atol=1e-7)


def test_moe_decode_gathered_matches_the_reference():
    rcfg, pcfg = _cfgs()
    p, pt = _params(rcfg, seed=6)
    x = np.random.default_rng(6).standard_normal(
        (5, pcfg.d_model)).astype(np.float32)
    got = L.moe_decode_gathered(pt, torch.from_numpy(x), pcfg)
    want = JL.moe_decode_gathered(p, jnp.asarray(x), rcfg)
    assert tuple(got.shape) == (5, pcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with no capacity bound, one token's decode equals its apply_moe
    rcfg8, pcfg8 = _cfgs(capacity_factor=8.0)
    full, _ = L.apply_moe(pt, torch.from_numpy(x)[None], pcfg8)
    np.testing.assert_allclose(got.numpy(), full[0].numpy(), **TOL)


@pytest.mark.parametrize("T", [1, 7, 40, 2048, 8192])
@pytest.mark.parametrize("n_experts", [4, 16])
def test_moe_capacity_matches_the_reference(T, n_experts):
    rcfg, pcfg = _cfgs(n_experts=n_experts)
    assert L.moe_capacity(T, pcfg) == JL.moe_capacity(T, rcfg)


def test_init_moe_follows_the_reference():
    rcfg, pcfg = _cfgs()
    port = L.init_moe(torch.Generator().manual_seed(0), pcfg)
    ref = JL.init_moe(jax.random.PRNGKey(0), rcfg)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    d, f = pcfg.d_model, pcfg.moe.d_ff_expert
    for name, std in (("wi", np.sqrt(2 / d)), ("wg", np.sqrt(2 / d)),
                      ("wo", np.sqrt(2 / f)), ("router", np.sqrt(1 / d))):
        got = float(port[name].std())
        assert abs(got - std) < 0.1 * std, name


def test_only_the_swiglu_moe_is_ported():
    """Every MoE config of the repo (jamba, granite, mixtral) is swiglu;
    another activation raises instead of running an untested branch."""
    from repro_torch.models import transformer as T
    cfg = get_reduced(ARCH)
    T.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="geglu MoE"):
        T.check_ported(cfg.replace(mlp_act="geglu"))
