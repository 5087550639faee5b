"""The one-card forms of the mesh plans against the JAX package, on the
CPU: contiguous-chunk context parallelism (``NullPlan(attn_mode="cp")``)
and the expert-parallel MoE dispatch (``NullPlan(moe_ep=True)``), each
run under the same plan in both packages from the same weights and
tokens (drawn with numpy from a seed).

* CP forward: the reduced qwen2.5 (GQA, qkv bias) under cp = 4, 2e-3 in
  f32 and 0.15 in the shipped bf16 (the dense forward's bounds,
  tests/test_torch_models.py); the reduced gemma3 (5 sliding-window
  layers + 1 global) with ``window_gather`` True (each query chunk gets
  only its neighbour key chunks, ``_attn_per_chunk``) and False (the
  whole key sequence), 2e-3 in f32, and the two equal to cp = 1.
* The CP training loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's loss under its plan, 1e-5
  (the dense families' bound, tests/test_torch_lm_loss.py).
* Prefill under cp = 4: the logits, and the caches in the reference's
  two-tier layout, then 8 teacher-forced decode steps, 2e-3 in f32.
* ``blocked_attention``: P > 1 contiguous chunks equal the P = 1 call
  (the same plain call), and the strided CP layout (the reference's
  ``strided_positions``) against the reference's ``blocked_attention``
  at those positions, 1e-5.
* EP: ``apply_moe_ep`` with virtual experts (``ep_virtual`` 2), ep = 2 at
  capacity factor 8.0 against the reference's, 1e-5, and the dense
  dispatch; at 1.25 (where tokens overflow) the kept (token, choice) set
  equals the reference's per source group; the reduced granite under
  ``moe_ep`` after ``ep_tune`` through the whole forward, 2e-3 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models import layers as JL
from repro.models.plan import NullPlan as RefPlan
from repro.models.registry import build_model as ref_build_model
from repro.runtime.sharding import ep_tune as ref_ep_tune
from repro_torch import convert as C
from repro_torch.configs import get_reduced
from repro_torch.core import flat as F
from repro_torch.models import layers as L
from repro_torch.models.plan import NullPlan
from repro_torch.models.registry import build_model
from repro_torch.runtime.sharding import ep_tune

torch.set_num_threads(2)

LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
GRAD_TOL = 1e-5
BATCH, SEQ = 2, 64


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _pair(arch, dtype="float32", cfg_fn=None):
    rcfg = ref_get_reduced(arch).replace(compute_dtype=dtype)
    pcfg = get_reduced(arch).replace(compute_dtype=dtype)
    if cfg_fn is not None:
        rcfg, pcfg = cfg_fn(rcfg), cfg_fn(pcfg)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams),
                                         pcfg, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return rmodel, rparams, pmodel, pparams, tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cp_forward_matches_the_reference(dtype):
    rmodel, rparams, pmodel, pparams, tokens = _pair("qwen2.5-14b", dtype)
    want = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens)},
                          plan=RefPlan(attn_mode="cp", cp=4))
    pp = pmodel.compute_params(pparams)
    got = pmodel.forward(pp, {"tokens": torch.from_numpy(tokens)},
                         plan=NullPlan(attn_mode="cp", cp=4))
    v, tol = pmodel.cfg.vocab_size, LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np32(got)[..., :v], _np32(want)[..., :v],
                               rtol=tol, atol=tol)
    local = pmodel.forward(pp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np32(got), _np32(local), rtol=tol, atol=tol)


@pytest.mark.parametrize("gather", [True, False])
def test_cp_window_gather_matches_the_reference(gather):
    rmodel, rparams, pmodel, pparams, tokens = _pair("gemma3-4b")
    assert any(s.attn_kind == "swa" and s.window < SEQ
               for s in pmodel.cfg.all_blocks)      # the gather has work
    plan = dict(attn_mode="cp", cp=4, window_gather=gather)
    want = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens)},
                          plan=RefPlan(**plan))
    got = pmodel.forward(pparams, {"tokens": torch.from_numpy(tokens)},
                         plan=NullPlan(**plan))
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-3,
                               atol=2e-3)
    local = pmodel.forward(pparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np32(got), _np32(local), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2.5-14b"])
def test_cp_loss_and_every_gradient_match_the_reference(arch):
    rmodel, rparams, pmodel, pparams, tokens = _pair(arch)
    rplan, pplan = RefPlan(attn_mode="cp", cp=4), NullPlan(attn_mode="cp",
                                                           cp=4)
    (rl, _), rg = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, {"tokens": jnp.asarray(tokens)},
                              plan=rplan), has_aux=True))(rparams)
    leaves, td = F.tree_flatten(pparams)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    pl, _ = pmodel.loss(F.tree_unflatten(td, req),
                        {"tokens": torch.from_numpy(tokens)}, plan=pplan)
    grads = torch.autograd.grad(pl, req)
    np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-5)
    want = C.lm_params_from_reference(jax.tree.map(np.asarray, rg),
                                      pmodel.cfg, "cpu")
    want_l, td2 = F.tree_flatten(want)
    assert td == td2
    for g, w in zip(grads, want_l):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL)


def test_cp_prefill_caches_and_decode_match_the_reference():
    rmodel, rparams, pmodel, pparams, tokens = _pair("gemma3-4b")
    rplan, pplan = RefPlan(attn_mode="cp", cp=4), NullPlan(attn_mode="cp",
                                                           cp=4)
    rl, rc = jax.jit(lambda p, t: rmodel.prefill(p, {"tokens": t},
                                                 plan=rplan))(
        rparams, jnp.asarray(tokens))
    decode = jax.jit(lambda p, c, t, i: rmodel.decode_step(p, c, t, i,
                                                           plan=rplan))
    pl, pc = pmodel.prefill(pparams, {"tokens": torch.from_numpy(tokens)},
                            plan=pplan)
    tol = LOGIT_TOL["float32"]
    np.testing.assert_allclose(_np32(pl), _np32(rl), rtol=tol, atol=tol)
    want = C.caches_from_reference(jax.tree.map(np.asarray, rc), pmodel.cfg,
                                   "cpu")
    _, local = pmodel.prefill(pparams, {"tokens": torch.from_numpy(tokens)})
    for got, ref, loc in zip(pc, want, local):
        assert got.k_old.shape == ref.k_old.shape == loc.k_old.shape
        assert torch.equal(got.old_pos, ref.old_pos)
        np.testing.assert_allclose(_np32(got.k_old), _np32(ref.k_old),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np32(got.v_old), _np32(ref.v_old),
                                   rtol=tol, atol=tol)
    v = pmodel.cfg.vocab_size
    tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
    for i in range(8):
        pos = SEQ + i
        rl, rc = decode(rparams, rc, tok, jnp.asarray(pos, jnp.int32))
        pl, pc = pmodel.decode_step(pparams, pc,
                                    torch.from_numpy(np.array(tok)), pos,
                                    plan=pplan)
        np.testing.assert_allclose(_np32(pl), _np32(rl), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)


def _qkv(rng, b, s, h, kvh, hd):
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 24])
def test_blocked_attention_over_chunks(window):
    rng = np.random.default_rng(3)
    b, P, sl, h, kvh, hd = 2, 4, 16, 4, 2, 16
    q, k, v = _qkv(rng, b, P * sl, h, kvh, hd)
    t = torch.from_numpy
    one = L.blocked_attention(t(q)[:, None], t(k), t(v), causal=True,
                              window=window)
    pos = np.arange(P * sl).reshape(P, sl)
    chunks = L.blocked_attention(t(q).reshape(b, P, sl, h, hd), t(k), t(v),
                                 causal=True, window=window, q_positions=pos)
    assert torch.equal(chunks.reshape(one.shape), one)
    # the strided layout: chunk p holds positions p, p + P, ...
    sp = L.strided_positions(P, sl)
    np.testing.assert_array_equal(sp, JL.strided_positions(P, sl))
    qs = q[:, sp.reshape(-1)].reshape(b, P, sl, h, hd)
    got = L.blocked_attention(t(qs), t(k), t(v), causal=True, window=window,
                              q_positions=sp, kv_positions=np.arange(P * sl))
    want = JL.blocked_attention(jnp.asarray(qs), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_positions=jnp.asarray(sp),
                                kv_positions=jnp.arange(P * sl),
                                q_block=16, kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # strided chunks are a permutation of the one-chunk rows
    np.testing.assert_allclose(
        got.reshape(b, P * sl, h, hd).numpy(),
        one[:, 0].numpy()[:, sp.reshape(-1)], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="q_positions"):
        L.blocked_attention(t(qs), t(k), t(v), causal=True)


def _moe_cfgs(cf, v):
    def fn(cfg):
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf, ep_virtual=v))
    return (fn(ref_get_reduced("mixtral-8x7b").replace(
        compute_dtype="float32")),
        fn(get_reduced("mixtral-8x7b").replace(compute_dtype="float32")))


def _moe_inputs(rcfg, b, T, seed=0, skew=0.0):
    p = JL.init_moe(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, rcfg.d_model)).astype(np.float32)
    if skew:                       # lean towards expert 0: it overflows
        col = np.asarray(p["router"])[:, 0]
        x = (x + skew * col / np.linalg.norm(col) * np.sqrt(rcfg.d_model)
             ).astype(np.float32)
    return p, {k: torch.from_numpy(np.array(a)) for k, a in p.items()}, x


def test_apply_moe_ep_matches_the_reference_and_the_dense_dispatch():
    rcfg, pcfg = _moe_cfgs(8.0, 2)
    rp, pp, x = _moe_inputs(rcfg, 4, 8)
    want, waux = jax.jit(lambda p, x_: JL.apply_moe_ep(
        p, x_, rcfg, RefPlan(moe_ep=True, ep=2)))(rp, jnp.asarray(x))
    got, aux = L.apply_moe_ep(pp, torch.from_numpy(x), pcfg,
                              NullPlan(moe_ep=True, ep=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    dense, _ = L.apply_moe(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def _ref_ep_kept(p, x, cfg, D):
    """The reference's kept assignments per source group, computed as its
    ``apply_moe_ep``'s ``route_one`` computes them."""
    m = cfg.moe
    b, s, d = x.shape
    xl = jnp.asarray(x).reshape(D, (b // D) * s, d)
    cap = JL.moe_capacity(xl.shape[1], cfg)

    def one(xs):
        probs = jax.nn.softmax((xs @ p["router"]).astype(jnp.float32), -1)
        top_p, top_i = jax.lax.top_k(probs, m.top_k)
        vt_i, _ = JL._virtual_assignments(top_i, top_p, m.ep_virtual)
        flat = vt_i.reshape(-1)
        oh = jax.nn.one_hot(flat, m.n_virtual, dtype=jnp.int32)
        pos = (jnp.cumsum(oh, 0) - oh)[jnp.arange(flat.shape[0]), flat]
        return pos < cap
    return np.asarray(jax.jit(jax.vmap(one))(xl))


@pytest.mark.parametrize("v", [1, 2])
def test_apply_moe_ep_drops_what_the_reference_drops(v):
    rcfg, pcfg = _moe_cfgs(1.25, v)
    rp, pp, x = _moe_inputs(rcfg, 4, 24, seed=2, skew=3.0)
    kept = L.moe_kept(pp, torch.from_numpy(x), pcfg, ep=2).numpy()
    want = _ref_ep_kept(rp, x, rcfg, 2)
    assert (~want).any()                      # tokens overflow capacity
    np.testing.assert_array_equal(kept, want)
    # the dense dispatch keeps another set (a capacity a row, not a group)
    assert not np.array_equal(
        L.moe_kept(pp, torch.from_numpy(x), pcfg).numpy().reshape(-1),
        kept.reshape(-1))
    got, _ = L.apply_moe_ep(pp, torch.from_numpy(x), pcfg,
                            NullPlan(moe_ep=True, ep=2))
    ref, _ = jax.jit(lambda p, x_: JL.apply_moe_ep(
        p, x_, rcfg, RefPlan(moe_ep=True, ep=2)))(rp, jnp.asarray(x))
    # outputs of magnitude ~30 here (the skew): 1e-5 of their scale
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * scale)


def test_moe_ep_model_forward_matches_the_reference():
    fn = lambda cfg: dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    tuned = lambda cfg: (ref_ep_tune if cfg.__module__.startswith("repro.")
                         else ep_tune)(fn(cfg), 4)
    rmodel, rparams, pmodel, pparams, tokens = _pair(
        "granite-moe-1b-a400m", cfg_fn=tuned)
    assert pmodel.cfg.moe.ep_virtual == rmodel.cfg.moe.ep_virtual
    tok = np.concatenate([tokens, tokens[::-1]])          # batch 4
    want = rmodel.forward(rparams, {"tokens": jnp.asarray(tok)},
                          plan=RefPlan(moe_ep=True, ep=4))
    got = pmodel.forward(pparams, {"tokens": torch.from_numpy(tok)},
                         plan=NullPlan(moe_ep=True, ep=4))
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-3,
                               atol=2e-3)


def test_plans_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="attn_mode"):
        NullPlan(attn_mode="ring")
    with pytest.raises(ValueError, match="cp"):
        NullPlan(attn_mode="cp", cp=0)
    _, _, pmodel, pparams, tokens = _pair("qwen2.5-14b")
    with pytest.raises(ValueError, match="CP chunks"):
        pmodel.forward(pparams, {"tokens": torch.from_numpy(tokens[:, :30])},
                       plan=NullPlan(attn_mode="cp", cp=4))
    # head_tp computes what local computes on one device
    a = pmodel.forward(pparams, {"tokens": torch.from_numpy(tokens)})
    b = pmodel.forward(pparams, {"tokens": torch.from_numpy(tokens)},
                       plan=NullPlan(attn_mode="head_tp"))
    assert torch.equal(a, b)
    rwkv = get_reduced("rwkv6-1.6b").replace(compute_dtype="float32")
    m = build_model(rwkv)
    with pytest.raises(NotImplementedError, match="context parallelism"):
        m.forward(m.init(0, device="cpu"),
                  {"tokens": torch.from_numpy(tokens % rwkv.vocab_size)},
                  plan=NullPlan(attn_mode="cp", cp=4))
