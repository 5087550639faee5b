"""The port's VLM stub (internvl2-2b: a projection of precomputed patch
embeddings in front of the internlm2 backbone) against the JAX package,
on the CPU.

The reduced internvl2 (2 layers, d 64, 8 patches of 32), the reference's
initial weights carried over by ``convert.lm_params_from_reference``
(``vis_proj`` included) and its inputs from ``make_batch_for``:

* ``make_batch_for``: the patch embeddings' bf16 bits and the tokens
  (``seq_len - n_patches`` of them) equal the reference's.
* prefill (patches first) and 70 teacher-forced decode steps across a
  compaction (f32 2e-3, bf16 0.15, as tests/test_torch_models.py argues
  them), at the reference's serve positions ``prompt_len + n_patches +
  i``: the prefill covers ``prompt_len`` positions (patches included), so
  decode starts n_patches past them, and the compaction lands ring
  position p at old slot ``p mod prompt_len`` (positions that land on one
  slot sum there): defects of the reference the port keeps (ROADMAP.md).
  The caches after the compaction equal the reference's.
* ``lm_loss`` (the patch prefix excluded from the loss) and every
  parameter leaf's gradient, ``vis_proj``'s too, against
  ``jax.value_and_grad`` (f32): the loss within 1e-5 relative, each leaf
  within 1e-5 absolute.
* ``launch/serve.py``'s greedy token stream equals the reference's
  ``launch/serve.py`` (f32), and its decode positions are the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.data import make_batch_for as ref_make_batch_for
from repro.launch.serve import _compact_all as ref_compact_all
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import flat as F
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import compact_all
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from test_torch_whisper import (_bits, _np32, _port_value_and_grad,
                                serve_equals_the_reference)

torch.set_num_threads(2)

ARCH = "internvl2-2b"
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
PROMPT, STEPS, BATCH = 40, 70, 2
N_PATCHES = 8


def _setup(dtype="float32"):
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype=dtype)
    pcfg = get_reduced(ARCH).replace(compute_dtype=dtype)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams),
                                         pcfg, "cpu")
    return rmodel, rparams, pmodel, pparams


@pytest.mark.parametrize("full", [False, True])
def test_make_batch_for_is_bit_equal(full):
    cfg, rcfg = ((get_config(ARCH), ref_get_config(ARCH)) if full else
                 (get_reduced(ARCH), ref_get_reduced(ARCH)))
    b, s = (1, 2048) if full else (3, 40)
    rb = ref_make_batch_for(rcfg, b, s, 9)
    pb = make_batch_for(cfg, b, s, 9)
    assert list(pb) == list(rb) == ["patch_embeds", "tokens"]
    pe, n = pb["patch_embeds"], cfg.vision.n_patches
    assert pe.dtype == torch.bfloat16
    assert tuple(pe.shape) == (b, n, cfg.vision.vit_dim)
    assert tuple(pb["tokens"].shape) == (b, s - n)
    np.testing.assert_array_equal(_bits(pe), _bits(rb["patch_embeds"]))
    np.testing.assert_array_equal(pb["tokens"].numpy(),
                                  np.asarray(rb["tokens"]))


def test_init_draws_vis_proj_as_the_reference():
    cfg = get_reduced(ARCH)
    vp = build_model(cfg).init(2, device="cpu")["vis_proj"]
    assert tuple(vp["w1"].shape) == (cfg.vision.vit_dim, cfg.d_model)
    assert tuple(vp["w2"].shape) == (cfg.d_model, cfg.d_model)
    for w in vp.values():                                  # he_normal
        std = (2.0 / w.shape[0]) ** 0.5
        assert abs(float(w.std()) - std) < 0.1 * std
    cast = T.compute_params({"vis_proj": vp}, cfg)["vis_proj"]
    assert all(w.dtype == cfg.cdtype for w in cast.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype):
    rmodel, rparams, pmodel, pparams = _setup(dtype)
    pparams = pmodel.compute_params(pparams)
    rb = ref_make_batch_for(rmodel.cfg, BATCH, PROMPT, 3)
    pb = make_batch_for(pmodel.cfg, BATCH, PROMPT, 3)
    prefill = jax.jit(lambda p, b: rmodel.prefill(p, b))
    decode = jax.jit(lambda p, c, t, i: rmodel.decode_step(p, c, t, i))
    compact = jax.jit(ref_compact_all)
    v, tol = rmodel.cfg.vocab_size, LOGIT_TOL[dtype]

    rl, rc = prefill(rparams, rb)
    pl, pc = pmodel.prefill(pparams, pb)
    np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v], rtol=tol,
                               atol=tol, err_msg="prefill")
    # the old tier holds the whole prompt, patches first
    assert pc[0].old_pos.flatten().tolist() == list(range(PROMPT))
    tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
    for i in range(STEPS):
        pos = PROMPT + N_PATCHES + i               # the reference's serve
        rl, rc = decode(rparams, rc, tok, jnp.asarray(pos, jnp.int32))
        pl, pc = pmodel.decode_step(pparams, pc,
                                    torch.from_numpy(np.array(tok)), pos)
        np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v],
                                   rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
        if (i + 1) % L.RECENT_RING == 0:
            rc = compact(rc, jnp.asarray(pos, jnp.int32))
            pc = compact_all(pc, pos)
            for got, want in zip(pc, C.caches_from_reference(
                    jax.tree.map(np.asarray, rc), pmodel.cfg, "cpu")):
                assert torch.equal(got.old_pos, want.old_pos)
                np.testing.assert_allclose(_np32(got.k_old),
                                           _np32(want.k_old), rtol=tol,
                                           atol=tol)
            # ring position p lands at old slot p mod 40, not at the slot
            # of its distance from the prompt's end; two that land on one
            # slot sum there (both the reference's)
            want_pos = list(range(PROMPT))
            for j in range(PROMPT):
                hits = [p for p in range(pos - L.RECENT_RING + 1, pos + 1)
                        if p % PROMPT == j]
                want_pos[j] = sum(hits) if hits else j
            assert pc[0].old_pos.flatten().tolist() == want_pos


def test_loss_excludes_the_prefix_and_every_gradient_matches():
    rmodel, rparams, pmodel, pparams = _setup()
    rb = ref_make_batch_for(rmodel.cfg, BATCH, 64, 4)
    pb = make_batch_for(pmodel.cfg, BATCH, 64, 4)
    (rl, rmet), rg = jax.value_and_grad(
        lambda p: rmodel.loss(p, rb), has_aux=True)(rparams)
    pl, pmet, pg = _port_value_and_grad(pmodel, pparams, pb)
    np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-5)
    want = C.lm_params_from_reference(jax.tree.map(np.asarray, rg),
                                      pmodel.cfg, "cpu")
    got_l, td = F.tree_flatten(pg)
    want_l, td2 = F.tree_flatten(want)
    assert td == td2
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    assert float(pg["vis_proj"]["w1"].abs().max()) > 0
    # the loss is the CE of the token positions only: the hidden states
    # past the prefix against the tokens shifted by one
    with torch.no_grad():
        h, _ = T.lm_hidden(pparams, pmodel.cfg, pb)
        t = pb["tokens"].long()
        lg = L.logits(pparams["embed"], h[:, N_PATCHES:-1], pmodel.cfg)
        ce = torch.nn.functional.cross_entropy(
            lg.flatten(0, 1), t[:, 1:].flatten())
    np.testing.assert_allclose(float(pmet["ce"].detach()), float(ce),
                               rtol=1e-5)


def test_serve_stream_and_positions_equal_the_references(monkeypatch,
                                                         capsys):
    res = serve_equals_the_reference(ARCH, monkeypatch, capsys)
    assert res.compactions == STEPS // L.RECENT_RING
    assert res.next_pos == PROMPT + N_PATCHES + STEPS - 1
