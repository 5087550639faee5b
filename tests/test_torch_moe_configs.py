"""The MoE family's configs on the port (granite-moe-1b-a400m, mixtral-8x7b)
against the JAX package, on the CPU.

Each config module is the reference's field for field; at the reduced
size, with the reference's initial weights carried over by
``convert.lm_params_from_reference``, the prefill logits and 70 decode
steps teacher-forced with the reference's greedy tokens, crossing one
compaction of the two-tier cache (after step 64), agree with
``repro``'s.  Mixtral's reduced window is 32, so the 40-token prompt
already fills its rolling cache and every decode step slides it.

Tolerances, as for the dense family (tests/test_torch_models.py):
2e-3 with f32 compute (the reference's own prefill/decode tolerance);
0.15 absolute on logits of magnitude ~4 in the shipped bf16 compute, the
two packages rounding bf16 at different points.

In bf16 a decode token's top-k experts can be a near-tie: granite's
reduced router has tokens whose k-th and (k+1)-th probabilities differ
by 7e-4 (step 53), under the bf16 rounding of its logits, and a route
picked the other way moves that step's logits by 0.6-1.1 (the next
teacher-forced step is back within 0.05).  So in bf16 the decode runs
the reference step by step outside ``jit`` with its ``lax.top_k`` calls
recorded, and the port is fed the reference's experts (gated by its own
probabilities, renormalised as ``layers.route`` does), as the card-vs-CPU
checks of ``chip_smoke.py`` feed the CPU the card's routes.  Every route
the port would have picked otherwise must be a near-tie: an expert only
the port picks trails one only the reference picks by less than 2^-4 in
log-probability under the port's router.
"""
import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.launch.serve import _compact_all as ref_compact_all
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch.serve import compact_all
from repro_torch.models import layers as L
from repro_torch.models.common import torch_dtype
from repro_torch.models.registry import build_model

torch.set_num_threads(2)

MOE = ("granite-moe-1b-a400m", "mixtral-8x7b")
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
PROMPT, STEPS, BATCH = 40, 70, 2


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_are_ported_field_for_field(arch):
    assert arch in ARCHS
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_reduced(arch), ref_get_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.describe() == ref.describe()
        build_model(port)                     # check_ported admits it


def test_published_shapes():
    granite, mixtral = get_config(MOE[0]), get_config(MOE[1])
    assert (granite.moe.n_experts, granite.moe.top_k) == (32, 8)
    assert granite.tie_embeddings and granite.hd == 64
    assert L.padded_vocab(granite) == 49168 and granite.vocab_size == 49155
    assert mixtral.hd == 128 and (mixtral.moe.n_experts,
                                  mixtral.moe.top_k) == (8, 2)
    assert all(s.attn_kind == "swa" and s.window == 4096
               for s in mixtral.all_blocks)


ROUTE_TIE_GAP = 2.0 ** -4


@contextmanager
def _recorded_top_k(calls: list):
    """``jax.lax.top_k`` recording each call's indices (concrete: the
    caller runs outside ``jit``)."""
    real = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k)
        calls.append(np.asarray(idx))
        return vals, idx
    jax.lax.top_k = top_k
    try:
        yield
    finally:
        jax.lax.top_k = real


@contextmanager
def _fed_routes(routes: list, gaps: list):
    """``layers.route`` fed ``routes`` (one [.., k] index array a call, in
    call order); each call's own choice, where it differs, appends its
    log-probability gap to ``gaps``."""
    real, it = L.route, iter(routes)

    def route(p, x, cfg):
        probs, _, own = real(p, x, cfg)
        top_i = torch.from_numpy(np.array(next(it))).to(torch.long)
        logp = probs.clamp(min=1e-30).log().reshape(-1, probs.shape[-1])
        for r, (a, b) in enumerate(zip(top_i.reshape(-1, top_i.shape[-1]),
                                       own.reshape(-1, own.shape[-1]))):
            ours = set(b.tolist()) - set(a.tolist())
            theirs = set(a.tolist()) - set(b.tolist())
            if ours:
                gaps.append(float(logp[r, list(ours)].min()
                                  - logp[r, list(theirs)].max()))
        top_p = probs.gather(-1, top_i)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        return probs, top_p, top_i
    L.route = route
    try:
        yield
    finally:
        L.route = real


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rcfg = ref_get_reduced(arch).replace(compute_dtype=dtype)
    pcfg = get_reduced(arch).replace(compute_dtype=dtype)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = pmodel.compute_params(C.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), pcfg, "cpu"))
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, t: rmodel.prefill(p, {"tokens": t}))
    decode = jax.jit(lambda p, c, t, i: rmodel.decode_step(p, c, t, i))
    compact = jax.jit(ref_compact_all)
    v, tol = rcfg.vocab_size, LOGIT_TOL[dtype]

    rl, rc = prefill(rparams, jnp.asarray(tokens))
    pl, pc = pmodel.prefill(pparams, {"tokens": torch.from_numpy(tokens)})
    assert pl.dtype == torch_dtype(dtype) and tuple(pl.shape) == rl.shape
    np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v], rtol=tol,
                               atol=tol, err_msg="prefill")
    tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
    gaps = []
    for i in range(STEPS):
        pos = PROMPT + i
        if dtype == "float32":
            rl, rc = decode(rparams, rc, tok, jnp.asarray(pos, jnp.int32))
            pl, pc = pmodel.decode_step(pparams, pc,
                                        torch.from_numpy(np.array(tok)), pos)
        else:
            routes = []
            with jax.disable_jit(), _recorded_top_k(routes):
                rl, rc = rmodel.decode_step(rparams, rc, tok,
                                            jnp.asarray(pos, jnp.int32))
            assert len(routes) == pcfg.n_layers
            with _fed_routes(routes, gaps):
                pl, pc = pmodel.decode_step(
                    pparams, pc, torch.from_numpy(np.array(tok)), pos)
        np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v],
                                   rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
        if (i + 1) % L.RECENT_RING == 0:
            rc = compact(rc, jnp.asarray(pos, jnp.int32))
            pc = compact_all(pc, pos)
            for got, want in zip(pc, C.caches_from_reference(
                    jax.tree.map(np.asarray, rc), pcfg, "cpu")):
                assert torch.equal(got.old_pos, want.old_pos)
                assert torch.equal(got.rec_pos, want.rec_pos)
    assert all(g < ROUTE_TIE_GAP for g in gaps), gaps
