"""The port's whisper (``models/whisper.py``) against the JAX package, on the
CPU.

The reduced whisper-tiny (2 + 2 layers, d 32, 16 frames), with the
reference's initial weights carried over by
``convert.lm_params_from_reference`` and its inputs from the reference's
``make_batch_for`` draws:

* ``make_batch_for``: the frame embeddings' bf16 bits and the tokens
  equal the reference's (reduced and full config); the f64 -> bf16
  rounding equals ``jnp.asarray(a, jnp.bfloat16)`` also at values one
  double-rounding step apart from a direct rounding.
* ``sinusoidal_pos``: the reference's f32 ops.  XLA's f32 ``exp`` differs
  from PyTorch's by an ulp on some of the frequencies, so an angle pos x
  div moves by up to pos x 2^-23 x div; the bound per element is
  pos x 2^-22 + 2^-22 (measured 1.2e-4 at position 1,499).
* ``encode`` (f32): within 1e-5 (measured ~1e-6).
* prefill and 70 teacher-forced decode steps (f32 2e-3, the reference's
  own prefill/decode tolerance; bf16 0.15 as tests/test_torch_models.py
  argues it) across the recent ring's wrap at step 64: no compaction for
  an encoder-decoder, as in the reference's serve loop, so from step 64
  on each step overwrites the oldest ring slot.  The caches after
  prefill and after the last step equal the reference's.
* ``whisper_loss`` and every parameter leaf's gradient against
  ``jax.value_and_grad`` (f32): the loss within 1e-5 relative, each leaf
  within 1e-5 absolute; remat changes no bit.
* ``launch/serve.py``'s greedy token stream equals the reference's
  ``launch/serve.py`` (f32, its printed continuations and the whole
  stream of its loop, 70 steps across the ring's wrap).
* ``convert``: the parameter tree and the decode caches round-trip.
"""
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.data import make_batch_for as ref_make_batch_for
from repro.launch import serve as ref_serve
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import flat as F
from repro_torch.data import make_batch_for
from repro_torch.data.pipeline import _bf16
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.models.registry import Model, build_model

torch.set_num_threads(2)

ARCH = "whisper-tiny"
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
PROMPT, STEPS, BATCH = 40, 70, 2


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _setup(dtype="float32"):
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype=dtype)
    pcfg = get_reduced(ARCH).replace(compute_dtype=dtype)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams),
                                         pcfg, "cpu")
    return rmodel, rparams, pmodel, pparams


def _batches(cfg, rcfg, b=BATCH, s=PROMPT, seed=3):
    rb = ref_make_batch_for(rcfg, b, s, seed)
    return rb, make_batch_for(cfg, b, s, seed)


@pytest.mark.parametrize("full", [False, True])
def test_make_batch_for_is_bit_equal(full):
    cfg, rcfg = ((get_config(ARCH), ref_get_config(ARCH)) if full else
                 (get_reduced(ARCH), ref_get_reduced(ARCH)))
    b, s = (1, 448) if full else (3, 24)
    rb, pb = _batches(cfg, rcfg, b, s, seed=7)
    assert list(pb) == list(rb) == ["frame_embeds", "tokens"]
    fe = pb["frame_embeds"]
    assert fe.dtype == torch.bfloat16
    assert tuple(fe.shape) == (b, cfg.encoder.n_frames, cfg.encoder.d_model)
    np.testing.assert_array_equal(_bits(fe), _bits(rb["frame_embeds"]))
    np.testing.assert_array_equal(pb["tokens"].numpy(),
                                  np.asarray(rb["tokens"]))


def test_bf16_rounding_is_the_references():
    """Values a direct f64 -> bf16 rounding and the rounding through f32
    send to different bf16 neighbours (a midpoint plus or minus less
    than an f32 ulp), subnormals and large values: the port's bits equal
    ``jnp.asarray(a, jnp.bfloat16)``'s."""
    mid = 1 + 2.0 ** -8                                # between 1 and 1+2^-7
    a = np.array([mid + 2.0 ** -40, mid - 2.0 ** -40, -(mid + 2.0 ** -40),
                  1 + 3 * 2.0 ** -8 - 2.0 ** -40, 3 * 2.0 ** -9 + 2.0 ** -45,
                  1e-39, -3e-41, 1.5e38, 0.0, -0.0, 0.7, 1e-3])
    a = np.concatenate([a, np.random.default_rng(0).standard_normal(4096)])
    np.testing.assert_array_equal(_bits(_bf16(a)),
                                  _bits(jnp.asarray(a, jnp.bfloat16)))


@pytest.mark.parametrize("seq,dim", [(16, 32), (448, 384), (1500, 384)])
def test_sinusoidal_pos_follows_the_reference(seq, dim):
    got = L.sinusoidal_pos(seq, dim).numpy()
    want = np.asarray(JL.sinusoidal_pos(seq, dim))
    assert got.dtype == np.float32 and got.shape == want.shape == (seq, dim)
    bound = (np.arange(seq, dtype=np.float64)[:, None] + 1) * 2.0 ** -22
    assert (np.abs(got - want) <= bound).all()
    np.testing.assert_array_equal(got[0], want[0])     # sin 0, cos 0


def test_encode_matches_the_reference():
    rmodel, rparams, pmodel, pparams = _setup()
    rb, pb = _batches(pmodel.cfg, rmodel.cfg)
    want = JW.encode(rparams, rmodel.cfg, rb["frame_embeds"])
    got = W.encode(pparams, pmodel.cfg, pb["frame_embeds"])
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5, atol=1e-5)


def _assert_caches_equal(got, want, cfg, tol):
    want = C.caches_from_reference(jax.tree.map(np.asarray, want), cfg,
                                   "cpu")
    for g, w in zip(got.self_cache, want.self_cache):
        assert torch.equal(g.old_pos, w.old_pos)
        assert torch.equal(g.rec_pos, w.rec_pos)
        for name in ("k_old", "v_old", "k_rec", "v_rec"):
            np.testing.assert_allclose(_np32(getattr(g, name)),
                                       _np32(getattr(w, name)), rtol=tol,
                                       atol=tol, err_msg=name)
    for g, w in zip(got.cross, want.cross):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_allclose(_np32(a), _np32(b), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype):
    rmodel, rparams, pmodel, pparams = _setup(dtype)
    pparams = pmodel.compute_params(pparams)
    rb, pb = _batches(pmodel.cfg, rmodel.cfg)
    prefill = jax.jit(lambda p, b: rmodel.prefill(p, b))
    decode = jax.jit(lambda p, c, t, i: rmodel.decode_step(p, c, t, i))
    v, tol = rmodel.cfg.vocab_size, LOGIT_TOL[dtype]

    rl, rc = prefill(rparams, rb)
    pl, pc = pmodel.prefill(pparams, pb)
    assert isinstance(pc, W.WhisperDecCache)
    assert tuple(pl.shape) == rl.shape and pl.dtype == pmodel.cfg.cdtype
    np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v], rtol=tol,
                               atol=tol, err_msg="prefill")
    assert (_np32(pl)[:, v:] == _np32(rl)[:, v:]).all()   # padded vocab
    _assert_caches_equal(pc, rc, pmodel.cfg, tol)
    tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
    for i in range(STEPS):
        pos = PROMPT + i
        rl, rc = decode(rparams, rc, tok, jnp.asarray(pos, jnp.int32))
        pl, pc = pmodel.decode_step(pparams, pc,
                                    torch.from_numpy(np.array(tok)), pos)
        np.testing.assert_allclose(_np32(pl)[:, :v], _np32(rl)[:, :v],
                                   rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = jnp.argmax(rl[:, :v], -1).astype(jnp.int32)
    _assert_caches_equal(pc, rc, pmodel.cfg, tol)
    # the ring wrapped: it holds the last 64 positions, the old tier the
    # prompt
    assert sorted(pc.self_cache[0].rec_pos.tolist()) == \
        list(range(PROMPT + STEPS - L.RECENT_RING, PROMPT + STEPS))
    assert pc.self_cache[0].old_pos.flatten().tolist() == list(range(PROMPT))


def _port_value_and_grad(pmodel, pparams, batch, remat=True):
    leaves, treedef = F.tree_flatten(pparams)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss, metrics = pmodel.loss(F.tree_unflatten(treedef, req), batch,
                                remat=remat)
    grads = torch.autograd.grad(loss, req)
    return loss, metrics, F.tree_unflatten(treedef, list(grads))


def test_loss_and_every_gradient_match_the_reference():
    rmodel, rparams, pmodel, pparams = _setup()
    rb, pb = _batches(pmodel.cfg, rmodel.cfg, s=64)
    (rl, rmet), rg = jax.value_and_grad(
        lambda p: rmodel.loss(p, rb), has_aux=True)(rparams)
    pl, pmet, pg = _port_value_and_grad(pmodel, pparams, pb)
    np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(pmet["ce"].detach()), float(rmet["ce"]),
                               rtol=1e-5)
    assert float(pmet["aux"]) == float(rmet["aux"]) == 0.0
    want = C.lm_params_from_reference(jax.tree.map(np.asarray, rg),
                                      pmodel.cfg, "cpu")
    got_l, td = F.tree_flatten(pg)
    want_l, td2 = F.tree_flatten(want)
    assert td == td2
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    # every leaf the loss reaches has a gradient: the encoder's too
    assert all(float(g.abs().max()) > 0 for g in
               F.tree_flatten(pg["enc"])[0] if g.dim() > 1)
    # remat changes no bit
    again = _port_value_and_grad(pmodel, pparams, pb, remat=False)
    assert torch.equal(again[0], pl)
    for a, b in zip(F.tree_flatten(again[2])[0], got_l):
        assert torch.equal(a, b)


def test_params_and_caches_round_trip():
    rmodel, rparams, pmodel, pparams = _setup()
    back = C.lm_params_to_reference(pparams, pmodel.cfg)
    want = jax.tree.leaves(rparams)
    got, _ = F.tree_flatten(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert F.tree_flatten(C.lm_params_from_reference(back, pmodel.cfg,
                                                     "cpu"))[1] == \
        F.tree_flatten(pparams)[1]
    # the port's own init has the reference's tree and shapes
    shapes = lambda t: [tuple(x.shape) for x in F.tree_flatten(t)[0]]
    assert shapes(pmodel.init(0, device="cpu")) == shapes(pparams)


def _ref_f32(monkeypatch):
    """The reference's serve loop at f32 compute (its config getter
    patched), so that greedy tokens are no near-tie of bf16 rounding."""
    monkeypatch.setattr(ref_serve, "get_reduced", lambda a: ref_get_reduced(
        a).replace(compute_dtype="float32"))
    monkeypatch.setattr(serve, "get_reduced", lambda a: get_reduced(
        a).replace(compute_dtype="float32"))


def _port_weights_are_the_references(monkeypatch, seed):
    """The port's serve gets the reference's init for ``seed``."""
    def init(self, seed_=0, device="cuda", cast=False):
        rcfg = ref_get_reduced(self.cfg.arch).replace(
            compute_dtype=self.cfg.compute_dtype)
        tree = ref_build_model(rcfg).init(jax.random.PRNGKey(seed_))
        p = C.lm_params_from_reference(jax.tree.map(np.asarray, tree),
                                       self.cfg, device)
        return self.compute_params(p) if cast else p
    monkeypatch.setattr(Model, "init", init)


def reference_serve_stream(cfg, batch, prompt_len, gen, seed):
    """The reference's ``launch/serve.py`` loop (its model, positions and
    compaction rule) on one device, every greedy token kept."""
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    inputs = ref_make_batch_for(cfg, batch, prompt_len, seed)
    lg, caches = jax.jit(lambda p, b: model.prefill(p, b))(params, inputs)
    decode = jax.jit(lambda p, c, t, i: model.decode_step(p, c, t, i))
    tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
    prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    out = [tok]
    for i in range(gen):
        pos = jnp.asarray(prompt_len + prefix + i, jnp.int32)
        lg, caches = decode(params, caches, tok, pos)
        tok = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        out.append(tok)
        if (i + 1) % JL.RECENT_RING == 0 and not cfg.is_enc_dec:
            caches = ref_serve._compact_all(caches, pos)
    return np.stack([np.asarray(t) for t in out], 1)


def serve_equals_the_reference(arch, monkeypatch, capsys):
    """The port's ``serve.run`` against the reference's ``serve.main``
    (its printed continuations) and its loop (the whole stream); returns
    the port's result."""
    seed, b, s, gen = 1, 2, PROMPT, STEPS
    _ref_f32(monkeypatch)
    _port_weights_are_the_references(monkeypatch, seed)
    argv = ["--arch", arch, "--reduced", "--batch", str(b), "--prompt-len",
            str(s), "--gen", str(gen), "--seed", str(seed)]
    assert ref_serve.main(argv + ["--mesh", "1,1"]) == 0
    printed = capsys.readouterr().out.split("sample continuations:")[1]
    rows = [ast.literal_eval(line.strip())
            for line in printed.strip().splitlines()]
    res = serve.run(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(res.tokens[:, :16].numpy(), np.array(rows))
    want = reference_serve_stream(ref_serve.get_reduced(arch), b, s, gen,
                                  seed)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    return res


def test_serve_stream_equals_the_references(monkeypatch, capsys):
    res = serve_equals_the_reference(ARCH, monkeypatch, capsys)
    assert res.compactions == 0 and res.next_pos == PROMPT + STEPS - 1
    assert isinstance(res.caches, W.WhisperDecCache)
