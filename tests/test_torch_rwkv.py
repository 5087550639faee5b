"""The port's rwkv6 (B14's plain version, the time and channel mixes and
the whole reduced model) against the JAX package, on the CPU.

* B14's plain version (``kernels/ref.py::wkv6``: what ``ops.wkv6`` runs
  for CPU tensors, and what the CUDA kernel is held against on the card)
  against the reference's ``ref.wkv6``, 2e-5 (the reference's own
  ``test_wkv6`` tolerance); its final state against the ``S`` that the
  reference's chunked log-space ``time_mix_chunked`` returns, 2e-4.  The
  reference's Pallas ``wkv6`` does not run under the installed jax
  (``pl.load`` is gone; ROADMAP queue C), so it is not a party here.
* The port's prefill time mix (one ``ops.wkv6`` call over the sequence)
  against ``time_mix_chunked`` and the token-loop
  ``time_mix_recurrent_ref``, at the reduced config in f32: 2e-4 (the
  reference's own ``test_rwkv_chunked_vs_recurrent``).  The channel mix
  and the decode step likewise.
* The reduced rwkv6-1.6b through prefill and 70 decode steps
  teacher-forced with the reference's greedy tokens, crossing step 64
  (where the serve loop compacts attention caches and leaves rwkv states
  alone), against the reference's ``prefill`` / ``decode_step`` /
  ``_compact_all``:
  - ``compute_dtype="float32"``: 2e-3, the reference's own prefill/decode
    tolerance; measured at most 6.4e-6 (decode step 16).
  - the shipped bf16 compute: 0.15 absolute (the dense family's bound,
    tests/test_torch_models.py) on logits of magnitude up to ~5; measured
    0.055 at prefill and at most 0.078 (decode step 7).  A bf16 value
    near 4 has a spacing of 0.031; the two packages round to bf16 at different
    points: XLA and PyTorch round bf16 matmul outputs, ``silu`` and the
    ddlerp einsum in their own orders, and the prefill's recurrence runs
    step by step (``w = exp(logw)``) where the reference's chunked form
    works with ``exp`` of log-decay differences.  The f32 comparison pins
    the arithmetic itself.

Inputs are drawn with numpy from a seed; the reference's weights are
carried over by ``convert``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import ref as JR
from repro.launch.serve import _compact_all as ref_compact_all
from repro.models import rwkv as JW
from repro.models.common import RWKVConfig as RefRWKVConfig
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.kernels import build, launches, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as WK
from repro_torch.launch.serve import compact_all
from repro_torch.models import rwkv as W
from repro_torch.models import transformer as T
from repro_torch.models.common import RWKVConfig, torch_dtype
from repro_torch.models.layers import RECENT_RING, DecodeCache
from repro_torch.models.registry import build_model

torch.set_num_threads(2)

ARCH = "rwkv6-1.6b"
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.15}
PROMPT, STEPS, BATCH = 40, 70, 2


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _wkv_inputs(b, h, T_, hd, seed=0):
    """The reference test_wkv6's distributions: w in (0.35, 0.95)."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, h, T_, hd)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((b, h, T_, hd)) * 0.4).astype(np.float32)
    v = rng.standard_normal((b, h, T_, hd)).astype(np.float32)
    w = (0.6 / (1 + np.exp(-rng.standard_normal((b, h, T_, hd)))) + 0.35
         ).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.2).astype(np.float32)
    return r, k, v, w, u


def _ref_params(cfg):
    return ref_build_model(cfg).init(jax.random.PRNGKey(0))


def _tm_params(rcfg, pcfg, seed=0):
    """One time-mix parameter dict in both packages (the reference's
    init, carried over)."""
    p = JW.init_time_mix(jax.random.PRNGKey(seed), rcfg)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return p, pt


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

def test_rwkv_config_equals_the_reference():
    assert ARCH in ARCHS
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_reduced(ARCH), ref_get_reduced(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.describe() == ref.describe()
        assert port.cdtype == torch_dtype(ref.compute_dtype)
        assert port.pdtype == torch_dtype(ref.param_dtype)
        assert port.n_layers == ref.n_layers
    assert dataclasses.asdict(RWKVConfig()) == \
        dataclasses.asdict(RefRWKVConfig()) == \
        {"head_dim": 64, "lora_dim_w": 64, "lora_dim_mix": 32}
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.rwkv.head_dim, full.d_ff,
            full.vocab_size, full.tie_embeddings) == \
        (24, 2048, 64, 7168, 65536, False)


def test_init_shapes_dtypes_and_distributions_follow_the_reference():
    cfg = get_reduced(ARCH)
    port = build_model(cfg).init(3, device="cpu")
    ref = C.lm_params_from_reference(
        jax.tree.map(np.asarray, _ref_params(ref_get_reduced(ARCH))), cfg,
        "cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(port) == shapes(ref)
    tm = port["blocks"][0]["rwkv_tm"]
    assert tuple(tm["lora_b"].shape) == (5, 8, cfg.d_model)
    assert tuple(tm["u"].shape) == (4, 16)
    assert tm["w0"].dtype == torch.float32
    assert torch.equal(tm["w0"], torch.full((cfg.d_model,), -5.0))
    assert torch.equal(tm["mu_g"], torch.full((cfg.d_model,), 0.7))
    # he_normal on a d x d weight (fan_in d)
    std = float(np.sqrt(2.0 / cfg.d_model))
    got = float(torch.cat([tm[n].flatten() for n in ("wr", "wk", "wv")]
                          ).std())
    assert abs(got - std) < 0.08 * std
    n_port = sum(t.numel() for t in jax.tree.leaves(
        port, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    n_ref = sum(a.size for a in jax.tree.leaves(_ref_params(
        ref_get_reduced(ARCH))))
    assert n_port == n_ref


def test_compute_params_keep_the_decay_bias_f32():
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    p = model.compute_params(model.init(0, device="cpu"))["blocks"][1]
    tm, cm = p["rwkv_tm"], p["rwkv_cm"]
    for name in ("wr", "wk", "wv", "wg", "wo", "lora_a", "lora_b", "w_a",
                 "w_b"):
        assert tm[name].dtype == torch.bfloat16, name
    for name in ("wk", "wv", "wr"):
        assert cm[name].dtype == torch.bfloat16, name
    for name in ("w0", "u", "ln_x", "mu_x", "mu_w"):
        assert tm[name].dtype == torch.float32, name


# ---------------------------------------------------------------------------
# B14's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [8, 16, 64])
@pytest.mark.parametrize("T_", [1, 7, 64, 200])
def test_plain_wkv6_matches_reference(T_, hd):
    r, k, v, w, u = _wkv_inputs(2, 3, T_, hd, seed=T_ + hd)
    out, S = R.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    want = JR.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    assert out.dtype == torch.float32 and tuple(out.shape) == r.shape
    assert S.dtype == torch.float32 and tuple(S.shape) == (2, 3, hd, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_wkv6_stores_in_r_dtype_and_takes_strided_views():
    r, k, v, w, u = _wkv_inputs(2, 3, 9, 16, seed=1)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                              ).transpose(1, 2) for a in (r, k, v, w)]
    out, S = R.wkv6(*views, torch.from_numpy(u))
    want, S2 = R.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w)),
                      torch.from_numpy(u))
    assert torch.equal(out, want) and torch.equal(S, S2)
    out16, S16 = R.wkv6(*(t.to(torch.bfloat16) for t in views),
                        torch.from_numpy(u))
    assert out16.dtype == torch.bfloat16 and S16.dtype == torch.float32


@pytest.mark.parametrize("s,chunk", [(37, 8), (64, 16), (5, 16)])
def test_plain_wkv6_final_state_matches_time_mix_chunked(s, chunk):
    """Feed the reference's own projections of one time mix to the plain
    version: its final state equals the S of the chunked log-space form."""
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32",
                                         scan_chunk=chunk)
    p = JW.init_time_mix(jax.random.PRNGKey(s), rcfg)
    x = jnp.asarray(np.random.default_rng(s).standard_normal(
        (2, s, rcfg.d_model)).astype(np.float32) * 0.5)
    x_prev = jnp.concatenate([jnp.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    r, k, v, _, logw = JW._time_mix_proj(p, x, x_prev, rcfg)
    _, S_ref, _ = JW.time_mix_chunked(p, x, rcfg)
    view = lambda a: torch.from_numpy(np.array(a, np.float32)).transpose(1, 2)
    _, S = R.wkv6(view(r), view(k), view(v), view(jnp.exp(logw)),
                  torch.from_numpy(np.asarray(p["u"], np.float32)))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), rtol=2e-4,
                               atol=2e-4)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_ops_wkv6_routes_cpu_tensors_to_the_plain_version(no_build):
    args = [torch.from_numpy(a) for a in _wkv_inputs(1, 2, 11, 16)]
    launches.reset_launch_count()
    out, S = ops.wkv6(*args)
    want, S2 = R.wkv6(*args)
    assert torch.equal(out, want) and torch.equal(S, S2)
    assert launches.launch_count("wkv6") == 0


def test_kernel_wrapper_refuses_cpu_tensors(no_build):
    args = [torch.from_numpy(a) for a in _wkv_inputs(1, 2, 4, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        WK.wkv6(*args)


def _bad_args():
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    ok = dict(r=z(1, 2, 5, 16), k=z(1, 2, 5, 16), v=z(1, 2, 5, 16),
              w=z(1, 2, 5, 16), u=z(2, 16))
    yield "head dim", {**{n: z(1, 2, 5, 48) for n in "rkvw"},
                       "u": z(2, 48)}
    yield "dtype", {**ok, **{n: z(1, 2, 5, 16, dt=torch.float16)
                             for n in "rkvw"}}
    yield "dtypes differ", {**ok, "v": z(1, 2, 5, 16, dt=torch.bfloat16)}
    yield "one shape", {**ok, "w": z(1, 2, 6, 16)}
    yield "4-D", {**ok, "k": z(2, 5, 16)}
    yield "unit stride", {**ok, "r": z(1, 2, 16, 5).transpose(2, 3)}
    yield "non-empty", {**{n: z(1, 2, 0, 16) for n in "rkvw"},
                        "u": z(2, 16)}
    yield "u must be", {**ok, "u": z(3, 16)}
    yield "contiguous float32", {**ok, "u": z(2, 16, dt=torch.bfloat16)}


@pytest.mark.parametrize("what,args", list(_bad_args()),
                         ids=[w for w, _ in _bad_args()])
def test_kernel_validation_refuses(what, args):
    with pytest.raises(ValueError, match=what):
        WK.validate(args["r"], args["k"], args["v"], args["w"], args["u"])


def test_kernel_validation_takes_every_head_dim_and_strided_views():
    for hd in WK.HEAD_DIMS:
        t = torch.zeros(2, 9, 4, hd, dtype=torch.bfloat16).transpose(1, 2)
        WK.validate(t, t, t, t, torch.zeros(4, hd))


def test_wkv6_is_registered():
    assert "wkv6" in launches.KERNELS
    assert launches.SOURCE["wkv6"].endswith("kernels/csrc/wkv6.cu")
    assert build.SOURCES["wkv6"].is_file()
    # the line named is the Pallas kernel function itself
    path, line = launches.REPLACES["wkv6"].split(":")
    root = build.CSRC.parents[3]
    text = (root / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _wkv6_kernel(")


# ---------------------------------------------------------------------------
# time mix and channel mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 37, 64])
def test_time_mix_matches_chunked_and_recurrent_reference(s):
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32",
                                         scan_chunk=8)
    pcfg = get_reduced(ARCH).replace(compute_dtype="float32", scan_chunk=8)
    p, pt = _tm_params(rcfg, pcfg, seed=s)
    x = (np.random.default_rng(s).standard_normal((2, s, pcfg.d_model))
         * 0.5).astype(np.float32)
    o, S, xl = W.time_mix_forward(pt, torch.from_numpy(x), pcfg)
    o_c, S_c, xl_c = JW.time_mix_chunked(p, jnp.asarray(x), rcfg)
    o_r = JW.time_mix_recurrent_ref(p, jnp.asarray(x), rcfg)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_c), **tol)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), **tol)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_c), **tol)
    np.testing.assert_array_equal(xl.numpy(), np.asarray(xl_c))
    # the port's own token-loop oracle agrees with both
    np.testing.assert_allclose(
        W.time_mix_recurrent_ref(pt, torch.from_numpy(x), pcfg).numpy(),
        np.asarray(o_r), **tol)


def test_time_mix_decode_and_channel_mix_match_the_reference():
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32")
    pcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    p, pt = _tm_params(rcfg, pcfg, seed=7)
    rng = np.random.default_rng(7)
    d, h, hd = pcfg.d_model, 4, 16
    x, xp, cm = (rng.standard_normal((3, d)).astype(np.float32)
                 for _ in range(3))
    wkv = (rng.standard_normal((3, h, hd, hd)) * 0.3).astype(np.float32)
    st = W.RWKVState(*(torch.from_numpy(a) for a in (wkv, xp, cm)))
    rst = JW.RWKVState(*(jnp.asarray(a) for a in (wkv, xp, cm)))
    o, S, xl = W.time_mix_decode(pt, torch.from_numpy(x), st, pcfg)
    o_r, S_r, xl_r = JW.time_mix_decode(p, jnp.asarray(x), rst, rcfg)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), **tol)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_r), **tol)
    np.testing.assert_array_equal(xl.numpy(), np.asarray(xl_r))
    cp = JW.init_channel_mix(jax.random.PRNGKey(8), rcfg)
    cpt = {k: torch.from_numpy(np.array(a)) for k, a in cp.items()}
    xs = rng.standard_normal((2, 5, d)).astype(np.float32)
    xs_prev = rng.standard_normal((2, 5, d)).astype(np.float32)
    np.testing.assert_allclose(
        W.channel_mix(cpt, torch.from_numpy(xs), torch.from_numpy(xs_prev),
                      pcfg).numpy(),
        np.asarray(JW.channel_mix(cp, jnp.asarray(xs), jnp.asarray(xs_prev),
                                  rcfg)), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the reduced model: prefill + decode across step 64
# ---------------------------------------------------------------------------

def _check_states(pc, rc, pcfg, tol):
    want = C.caches_from_reference(jax.tree.map(np.asarray, rc), pcfg, "cpu")
    assert len(pc) == len(want) == pcfg.n_layers
    for got, ref in zip(pc, want):
        assert isinstance(got, W.RWKVState) and isinstance(ref, W.RWKVState)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(_np32(a), _np32(b), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype):
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype=dtype)
    pcfg = get_reduced(ARCH).replace(compute_dtype=dtype)
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
    if dtype == "float32":
        _check_states(pc, rc, pcfg, 2e-4)
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
        if (i + 1) % RECENT_RING == 0:
            rc = compact(rc, jnp.asarray(pos, jnp.int32))
            before = [tuple(s) for s in pc]
            pc = compact_all(pc, pos)
            # the rwkv states pass through the compaction untouched
            assert all(a is b for s0, s1 in zip(before, pc)
                       for a, b in zip(s0, s1))
    if dtype == "float32":
        _check_states(pc, rc, pcfg, 2e-3)


def test_prefill_then_decode_equals_forward():
    """Mirrors the reference's test_arch_prefill_decode_consistency."""
    cfg = get_reduced(ARCH).replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 24
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s + 2)).astype(np.int32))
    full = model.forward(params, {"tokens": tokens})
    lg_pref, states = model.prefill(params, {"tokens": tokens[:, :s]})
    assert all(isinstance(st, W.RWKVState) for st in states)
    np.testing.assert_allclose(_np32(lg_pref), _np32(full[:, s - 1]),
                               rtol=2e-3, atol=2e-3)
    for i in range(2):
        lg, states = model.decode_step(params, states, tokens[:, s + i],
                                       s + i)
        np.testing.assert_allclose(_np32(lg), _np32(full[:, s + i]),
                                   rtol=2e-3, atol=2e-3)


def test_other_blocks_still_raise():
    from repro_torch.models.common import (BlockSpec, VisionStubConfig,
                                           uniform_groups)
    base = get_reduced(ARCH)
    cases = [base.replace(layer_groups=uniform_groups(2, spec))
             for spec in (BlockSpec(mixer="rwkv", ffn="moe"),
                          BlockSpec(mixer="rwkv", ffn="none"))]
    cases += [base.replace(pos_emb="learned"),
              base.replace(vision=VisionStubConfig(n_patches=4, vit_dim=32))]
    for cfg in cases:
        with pytest.raises(NotImplementedError, match="not ported"):
            T.check_ported(cfg)
    # rwkv, attention, mamba and MoE blocks mix in one stack
    mixed = base.replace(layer_groups=uniform_groups(
        2, BlockSpec(mixer="rwkv")) + uniform_groups(1, BlockSpec())
        + uniform_groups(1, BlockSpec(mixer="mamba", ffn="moe")))
    T.check_ported(mixed)


def test_compact_all_skips_rwkv_states_and_folds_caches():
    from repro_torch.models.layers import make_decode_cache
    cfg = get_reduced(ARCH)
    st = W.rwkv_state_init(2, cfg)
    cache = make_decode_cache(2, 2, 1, 8, 16, torch.float32, prefilled=8)
    out = compact_all([st, cache], 70)
    assert out[0] is st
    assert isinstance(out[1], DecodeCache) and out[1] is not cache
