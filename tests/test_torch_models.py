"""The port's dense transformer against the JAX package, on the CPU.

For each of the four dense architectures at its reduced config, with the
reference's initial weights carried over by
``convert.lm_params_from_reference``: prefill logits, then 70 decode
steps teacher-forced with the reference's greedy tokens and crossing one
compaction of the two-tier cache (after step 64), against ``repro``'s
``prefill`` / ``decode_step`` / ``_compact_all``.

Tolerances:
* ``compute_dtype="float32"``: 2e-3, the reference's own prefill/decode
  tolerance (tests/test_models.py::test_arch_prefill_decode_consistency);
  measured at most 7e-6.
* the shipped bf16 compute: 0.15 absolute on logits of magnitude ~4
  (measured at most 0.092, qwen2.5's reduced config, decode step 13).  A
  bf16 value near 4 has a spacing of 0.031, and the two packages round
  to bf16 at different points: the reference's blocked attention rounds
  p to bf16 before P.V where the port's attention keeps p in f32 (the
  Pallas kernel's spelling); XLA and PyTorch round bf16 elementwise ops
  (silu, gelu, rope products) and matmul outputs in their own orders.
  A few ulps through two layers is the expected gap, not a bug: the f32
  comparison above pins the arithmetic itself.

Port-internal checks mirror the reference's own model tests: prefill +
one decode step equals the full forward, and compaction leaves decode
attention unchanged.  Inputs are drawn with numpy from a seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.launch.serve import _compact_all as ref_compact_all
from repro.models import layers as JL
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch.serve import compact_all
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import torch_dtype
from repro_torch.models.registry import build_model

torch.set_num_threads(2)

DENSE = ("internlm2-1.8b", "qwen2.5-14b", "stablelm-3b", "gemma3-4b")
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
PROMPT, STEPS, BATCH = 40, 70, 2


def _ref_params(cfg):
    return ref_build_model(cfg).init(jax.random.PRNGKey(0))


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_port_has_the_dense_family():
    assert set(ARCHS) == set(DENSE) | {"rwkv6-1.6b", "jamba-v0.1-52b"}


@pytest.mark.parametrize("arch", DENSE + ("jamba-v0.1-52b",))
def test_configs_equal_the_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_reduced(arch), ref_get_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.hd == ref.hd and port.n_layers == ref.n_layers
        assert port.describe() == ref.describe()
        assert port.cdtype == torch_dtype(ref.compute_dtype)


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "jamba-v0.1", "whisper-tiny",
                                  "internvl2-2b", "granite-moe-1b-a400m",
                                  "no-such-arch"])
def test_other_families_raise_naming_the_roadmap(arch):
    for get in (get_config, get_reduced):
        with pytest.raises(KeyError, match="ROADMAP"):
            get(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_init_shapes_and_distributions_follow_the_reference(arch):
    cfg = get_reduced(arch)
    port = build_model(cfg).init(3, device="cpu")
    ref = C.lm_params_from_reference(
        jax.tree.map(np.asarray, _ref_params(ref_get_reduced(arch))), cfg,
        "cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(port) == shapes(ref)
    for blk in port["blocks"]:
        assert torch.equal(blk["norm1"]["scale"], torch.ones(cfg.d_model))
        a = blk["attn"]
        for name in ("bq", "bk", "bv"):
            if name in a:
                assert torch.count_nonzero(a[name]) == 0
        std = float(np.sqrt(2.0 / cfg.d_model))      # he_normal, fan_in d
        got = float(torch.cat([a["wq"].flatten(), blk["mlp"]["wi"].flatten()]
                              ).std())
        assert abs(got - std) < 0.08 * std
    table = port["embed"]["table"]                   # lecun_normal
    assert abs(float(table.std()) - cfg.d_model ** -0.5) < 0.05 * \
        cfg.d_model ** -0.5
    again = build_model(cfg).init(3, device="cpu")
    assert torch.equal(again["blocks"][-1]["attn"]["wo"],
                       port["blocks"][-1]["attn"]["wo"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rcfg = ref_get_reduced(arch).replace(compute_dtype=dtype)
    pcfg = get_reduced(arch).replace(compute_dtype=dtype)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = _ref_params(rcfg)
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
    assert (_np32(pl)[:, v:] == _np32(rl)[:, v:]).all()    # padded vocab
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
        if (i + 1) % L.RECENT_RING == 0:
            rc = compact(rc, jnp.asarray(pos, jnp.int32))
            pc = compact_all(pc, pos)
            # the caches themselves agree after the compaction
            for got, want in zip(pc, C.caches_from_reference(
                    jax.tree.map(np.asarray, rc), pcfg, "cpu")):
                assert torch.equal(got.old_pos, want.old_pos)
                assert torch.equal(got.rec_pos, want.rec_pos)
                np.testing.assert_allclose(_np32(got.k_old),
                                           _np32(want.k_old), rtol=tol,
                                           atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_equals_forward(arch):
    """Mirrors the reference's test_arch_prefill_decode_consistency."""
    cfg = get_reduced(arch).replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 24
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    full = model.forward(params, {"tokens": tokens})
    lg_pref, caches = model.prefill(params, {"tokens": tokens[:, :s]})
    lg_dec, _ = model.decode_step(params, caches, tokens[:, s], s)
    np.testing.assert_allclose(_np32(lg_pref), _np32(full[:, s - 1]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np32(lg_dec), _np32(full[:, s]), rtol=2e-3,
                               atol=2e-3)


def _random_cache(rng, b=2, kv=2, C_=2, ln=16, hd=16, prefilled=20):
    cache = L.make_decode_cache(b, kv, C_, ln, hd, torch.float32,
                                prefilled=prefilled)
    return cache._replace(
        k_old=torch.from_numpy(rng.standard_normal(cache.k_old.shape)
                               .astype(np.float32)),
        v_old=torch.from_numpy(rng.standard_normal(cache.v_old.shape)
                               .astype(np.float32)))


def test_decode_two_tier_compaction():
    """Attention over (old tier + recent ring) == attention over the cache
    after the ring was compacted into the old tier (mirrors the
    reference's test of the same name)."""
    rng = np.random.default_rng(3)
    cache = _random_cache(rng)
    for i in range(3):
        kn, vn = (torch.from_numpy(rng.standard_normal((2, 2, 16))
                                   .astype(np.float32)) for _ in range(2))
        cache = L.cache_append_recent(cache, kn, vn, 20 + i)
    q = torch.from_numpy((rng.standard_normal((2, 4, 16)) * 0.4)
                         .astype(np.float32))
    out1 = L.decode_attention(q, cache, 22)
    compacted = L.compact_cache(cache, 22)
    out2 = L.decode_attention(q, compacted, 22)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(compacted.rec_pos.max()) == -1           # ring emptied


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("chunks,ln,prompt", [(1, 128, 100), (2, 16, 20)])
def test_decode_attention_and_compaction_match_the_reference(
        chunks, ln, prompt, window):
    """decode_attention, cache_append_recent and compact_cache on the same
    cache in both packages, 69 steps past a prompt (the ring wraps).  With
    128 old slots, compaction writes ring slot r to old slot
    rec_pos mod 128 and so overwrites the oldest prompt positions (the
    reference's rolling window); with 32 old slots, two ring slots land
    on each old slot and sum there, as in the reference."""
    rng = np.random.default_rng(4)
    cache = _random_cache(rng, C_=chunks, ln=ln, prefilled=prompt)
    ref = JL.DecodeCache(*(jnp.asarray(t.numpy()) for t in cache))
    q = (rng.standard_normal((2, 4, 16)) * 0.4).astype(np.float32)
    for pos in range(prompt, prompt + 64 + 5):
        kn, vn = (rng.standard_normal((2, 2, 16)).astype(np.float32)
                  for _ in range(2))
        cache = L.cache_append_recent(cache, torch.from_numpy(kn),
                                      torch.from_numpy(vn), pos)
        ref = JL.cache_append_recent(ref, jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(pos, jnp.int32))
        if pos % 16 == 0:
            got = L.decode_attention(torch.from_numpy(q), cache, pos,
                                     window=window)
            want = JL.decode_attention(jnp.asarray(q), ref,
                                       jnp.asarray(pos, jnp.int32),
                                       window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    cache = L.compact_cache(cache, pos)
    ref = JL.compact_cache(ref, jnp.asarray(pos, jnp.int32))
    for got, want in zip(cache, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if chunks * ln == 128:
        # the ring held 105..168 (100..104 were overwritten in the ring);
        # 128..168 rolled over the oldest prompt slots 0..40
        assert sorted(cache.old_pos.flatten().tolist()) == \
            [-1] * 5 + list(range(41, 100)) + list(range(105, 169))


@pytest.mark.parametrize("arch", DENSE)
def test_layers_match_the_reference(arch):
    """Norm, MLP, logits (tied, softcapped, padded vocab), the GQA head
    repeat and rope (both thetas, partial rotary, int and f32 positions)
    at f32 on the same inputs."""
    rcfg = ref_get_reduced(arch).replace(compute_dtype="float32",
                                         logit_softcap=30.0)
    pcfg = get_reduced(arch).replace(compute_dtype="float32",
                                     logit_softcap=30.0)
    rng = np.random.default_rng(5)
    rp = jax.tree.map(np.asarray, _ref_params(rcfg))
    pp = C.lm_params_from_reference(rp, pcfg, "cpu")
    x = rng.standard_normal((2, 7, pcfg.d_model)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    blk_p, blk_r = pp["blocks"][0], jax.tree.map(lambda a: a[0],
                                                  rp["group0"][0])
    close = functools.partial(np.testing.assert_allclose, rtol=1e-5,
                              atol=1e-5)
    close(L.apply_norm(blk_p["norm1"], xt, pcfg).numpy(),
          np.asarray(JL.apply_norm(blk_r["norm1"], xj, rcfg)))
    close(L.apply_mlp(blk_p["mlp"], xt, pcfg).numpy(),
          np.asarray(JL.apply_mlp(blk_r["mlp"], xj, rcfg)), rtol=1e-4,
          atol=1e-4)
    close(L.logits(pp["embed"], xt, pcfg).numpy(),
          np.asarray(JL.logits(rp["embed"], xj, rcfg)), rtol=1e-4, atol=1e-4)
    q = rng.standard_normal((2, 7, pcfg.n_heads, pcfg.hd)).astype(np.float32)
    kv = q[:, :, :pcfg.n_kv_heads]
    np.testing.assert_array_equal(
        L.repeat_kv(torch.from_numpy(kv), pcfg.n_heads).numpy(),
        np.asarray(JL.repeat_kv(jnp.asarray(kv), rcfg.n_heads)))
    pos = np.arange(2000, 2007, dtype=np.int32)
    for theta in {pcfg.rope_theta, pcfg.rope_theta_local or 1e4}:
        close(L.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), pcfg,
                           theta).numpy(),
              np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                       rcfg, theta)))
        one = L.apply_rope(torch.from_numpy(q[:, :1]), 2000, pcfg, theta)
        close(one.numpy(), np.asarray(JL.apply_rope(
            jnp.asarray(q[:, :1]), jnp.asarray([2000.0], jnp.float32), rcfg,
            theta)))


def test_caches_from_reference_unstack_groups():
    rcfg = ref_get_reduced("gemma3-4b").replace(compute_dtype="float32")
    pcfg = get_reduced("gemma3-4b").replace(compute_dtype="float32")
    tokens = np.random.default_rng(6).integers(0, 256, (2, 40)).astype(
        np.int32)
    _, rc = ref_build_model(rcfg).prefill(_ref_params(rcfg),
                                          {"tokens": jnp.asarray(tokens)})
    caches = C.caches_from_reference(jax.tree.map(np.asarray, rc), pcfg,
                                     "cpu")
    assert len(caches) == pcfg.n_layers == 3
    lens = [c.k_old.shape[3] for c in caches]
    assert lens == [32, 32, 40]                     # SWA window, SWA, full
    assert [int(c.old_pos.min()) for c in caches] == [8, 8, 0]


def test_mesh_plans_and_other_blocks_raise():
    from repro_torch.models.common import BlockSpec, uniform_groups
    from repro_torch.models.plan import NullPlan
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        NullPlan(attn_mode="cp", cp=4)
    rwkv_moe = get_reduced("rwkv6-1.6b").replace(
        layer_groups=uniform_groups(2, BlockSpec(mixer="rwkv", ffn="moe")))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(rwkv_moe)
    with pytest.raises(NotImplementedError):
        T.init_lm(0, get_reduced("internlm2-1.8b").replace(
            pos_emb="sinusoidal"))
