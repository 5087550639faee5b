"""The port's jamba-v0.1 (the hybrid mamba / attention / MoE stack)
against the JAX package, on the CPU.

* The config, field for field; the init's shapes and distributions; the
  published width cut to one layer group (what ``chip_smoke.py`` serves
  on the card) has the reference's leaf shapes and 13,295,235,072
  parameters, counted without drawing them.
* The reduced jamba (8 layers: 7 mamba, attention at index 4, MoE on the
  odd layers) through prefill and 70 decode steps teacher-forced with the
  reference's greedy tokens, crossing step 64 (where the serve loop
  compacts the attention layer's cache and leaves the mamba states
  alone), against the reference's ``prefill`` / ``decode_step`` /
  ``_compact_all``:
  - ``compute_dtype="float32"``: 2e-3, the reference's own prefill/decode
    tolerance; measured at most 1.4e-4 (decode step 66).  The decode
    states likewise (2e-4 after prefill, 2e-3 after step 70).
  - the shipped bf16 compute: this model magnifies one bf16 rounding
    into a different result.  Its mamba outputs reach ~150 (a bf16 ulp
    of 1) and each layer amplifies the differences of the one before:
    the reference differs from ITSELF by up to 0.79 on the prefill logits
    and 1.50 over the 70 steps when only its scan's chunk size changes
    (``scan_chunk`` 16 vs 40: the same f32 recurrence, summed in another
    order), and its bf16 logits differ from its f32 logits by up to 3.9
    (mean 0.9) on logits of magnitude ~3.  So two independent bf16
    implementations cannot agree to 0.15 (port vs reference: 0.54 at
    prefill, mean 0.6); the test holds the port to the reference's own
    bf16 accuracy instead: against the reference's f32 logits, on one
    token schedule, the port's bf16 logits must be no further off than
    the reference's bf16 logits, in the largest and in the mean over the
    71 logit rows (measured: port 1.89 / 0.74, reference 3.90 / 0.92).

Port-internal checks mirror the reference's model tests: prefill + decode
equals the full forward (drop-free MoE), and cast-at-draw init equals
``compute_params(init)``.  Inputs are drawn with numpy from a seed; the
reference's weights are carried over by ``convert``.
"""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.launch.serve import _compact_all as ref_compact_all
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.common import LayerGroup as RefLayerGroup
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch.serve import compact_all
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.common import torch_dtype
from repro_torch.models.layers import RECENT_RING, DecodeCache
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (the card's jamba configs)

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
PROMPT, STEPS, BATCH = 40, 70, 2


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ref_params(cfg):
    return ref_build_model(cfg).init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------

def test_jamba_config_equals_the_reference():
    assert ARCH in ARCHS
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_reduced(ARCH), ref_get_reduced(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.describe() == ref.describe()
        assert port.hd == ref.hd and port.n_layers == ref.n_layers
        assert port.cdtype == torch_dtype(ref.compute_dtype)
        assert port.moe.n_virtual == ref.moe.n_virtual
        assert port.moe.d_ff_virtual == ref.moe.d_ff_virtual
        assert M._dims(port) == JM._dims(ref)
    full = get_config(ARCH)
    assert M._dims(full) == (8192, 16, 4, 256)
    assert "".join(b.short() for b in full.layer_groups[0].blocks) == \
        "MdMeMdMeAdMeMdMe"


def test_init_shapes_and_distributions_follow_the_reference():
    cfg = get_reduced(ARCH)
    port = build_model(cfg).init(3, device="cpu")
    ref = C.lm_params_from_reference(
        jax.tree.map(np.asarray, _ref_params(ref_get_reduced(ARCH))), cfg,
        "cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(port) == shapes(ref)
    n_port = sum(t.numel() for t in CS._leaves(port))
    n_ref = sum(a.size for a in jax.tree.leaves(_ref_params(
        ref_get_reduced(ARCH))))
    assert n_port == n_ref
    for blk, spec in zip(port["blocks"], cfg.all_blocks):
        assert set(blk) == {"norm1", "norm2",
                            "attn" if spec.mixer == "attn" else "mamba",
                            "moe" if spec.ffn == "moe" else "mlp"}
    moe = port["blocks"][1]["moe"]
    std = math.sqrt(2.0 / cfg.d_model)                 # he_normal, fan_in d
    got = float(torch.cat([moe["wi"].flatten(), moe["wg"].flatten()]).std())
    assert abs(got - std) < 0.08 * std
    again = build_model(cfg).init(3, device="cpu")
    assert torch.equal(again["blocks"][-1]["moe"]["wo"],
                       port["blocks"][-1]["moe"]["wo"])


def test_compute_params_cast_the_mamba_and_moe_matmul_weights():
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    p = model.compute_params(model.init(0, device="cpu"))
    mb, moe = p["blocks"][1]["mamba"], p["blocks"][1]["moe"]
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert mb[name].dtype == torch.bfloat16, name
    for name in ("a_log", "dt_bias", "d_skip", "conv_w", "conv_b"):
        assert mb[name].dtype == torch.float32, name
    for name in ("router", "wi", "wg", "wo"):
        assert moe[name].dtype == torch.bfloat16, name
    assert p["blocks"][4]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [ARCH, "internlm2-1.8b", "rwkv6-1.6b"])
def test_init_cast_equals_compute_params_of_init(arch):
    """Casting each layer as it is placed gives compute_params(init)
    exactly: the same draws, the same casts."""
    model = build_model(get_reduced(arch))
    a = model.init(5, device="cpu", cast=True)
    b = model.compute_params(model.init(5, device="cpu"))
    la, lb = list(CS._leaves(a)), list(CS._leaves(b))
    assert len(la) == len(lb)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def test_one_layer_group_at_full_width_has_the_reference_shapes(
        monkeypatch):
    """chip_smoke's serving config: the published width, one layer group.
    Its leaves are counted on the meta device (nothing of their 13.3B
    values is drawn): the reference's shapes (eval_shape) and parameter
    count, summed in Python integers (the reference's ``param_count``
    multiplies each shape in int32 and overflows on the [4, 16, 4096,
    14336] expert stack of the full model)."""
    monkeypatch.setattr(L, "_normal", lambda gen, shape, dtype, std:
                        torch.empty(shape, dtype=dtype, device="meta"))
    cfg = CS.jamba_config()
    params = T.init_lm(0, cfg, device="meta", cast=True)
    full = ref_get_config(ARCH)
    rcfg = full.replace(layer_groups=(RefLayerGroup(
        full.layer_groups[0].blocks, 1),))
    model = ref_build_model(rcfg)
    ref = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    blocks = [jax.tree.map(lambda a, i=i: a.shape[1:], ref["group0"][i])
              for i in range(8)]
    got = [jax.tree.map(lambda t: tuple(t.shape), blk,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
           for blk in params["blocks"]]
    assert got == blocks
    n = sum(t.numel() for t in CS._leaves(params))
    n_ref = sum(math.prod(a.shape) for a in jax.tree.leaves(ref))
    assert n == n_ref == CS.JAMBA_PARAMS == 13_295_235_072
    assert params["blocks"][1]["moe"]["wi"].dtype == torch.bfloat16
    assert params["blocks"][0]["mamba"]["a_log"].dtype == torch.float32
    # the card-vs-CPU cut: blocks 3 and 4 of the period
    cut = CS.jamba_config(CS.JAMBA_CMP_BLOCKS)
    assert "".join(b.short() for b in cut.all_blocks) == "MeAd"


# ---------------------------------------------------------------------------
# the reduced model: prefill + decode across step 64
# ---------------------------------------------------------------------------

def _check_states(pc, rc, pcfg, tol):
    want = C.caches_from_reference(jax.tree.map(np.asarray, rc), pcfg, "cpu")
    assert len(pc) == len(want) == pcfg.n_layers
    for got, ref, spec in zip(pc, want, pcfg.all_blocks):
        assert type(got) is type(ref) is (
            DecodeCache if spec.mixer == "attn" else M.MambaState)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(_np32(a), _np32(b), rtol=tol,
                                       atol=tol)


def _run(model_prefill, model_decode, compact, tokens, feed, to_np):
    """Prefill, then STEPS decode steps fed ``feed`` (or the run's own
    greedy tokens when None), compacting after step 64.  Returns (the
    logit rows, the tokens fed, the final states)."""
    lg, st = model_prefill(tokens)
    out, fed = [to_np(lg)], []
    for i in range(STEPS):
        tok = feed[i] if feed is not None else \
            np.argmax(to_np(lg), -1).astype(np.int32)
        fed.append(tok)
        lg, st = model_decode(st, tok, PROMPT + i)
        out.append(to_np(lg))
        if (i + 1) % RECENT_RING == 0:
            st = compact(st, PROMPT + i)
    return out, fed, st


def _ref_runner(rcfg, rparams):
    model = ref_build_model(rcfg)
    v = rcfg.vocab_size
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}))
    decode = jax.jit(lambda p, c, t, i: model.decode_step(p, c, t, i))
    compact = jax.jit(ref_compact_all)
    return dict(
        model_prefill=lambda t: prefill(rparams, jnp.asarray(t)),
        model_decode=lambda c, t, i: decode(rparams, c, jnp.asarray(t),
                                            jnp.asarray(i, jnp.int32)),
        compact=lambda c, i: compact(c, jnp.asarray(i, jnp.int32)),
        to_np=lambda a: np.asarray(a, np.float32)[:, :v])


def _port_runner(pcfg, rparams):
    model = build_model(pcfg)
    params = model.compute_params(C.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), pcfg, "cpu"))
    v = pcfg.vocab_size
    return dict(
        model_prefill=lambda t: model.prefill(
            params, {"tokens": torch.from_numpy(t)}),
        model_decode=lambda c, t, i: model.decode_step(
            params, c, torch.from_numpy(np.asarray(t)), i),
        compact=compact_all,
        to_np=lambda a: _np32(a)[:, :v])


def _tokens():
    return np.random.default_rng(1).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32)


def test_prefill_and_decode_match_the_reference_in_f32():
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32")
    pcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    rparams = _ref_params(rcfg)
    ref, port = _ref_runner(rcfg, rparams), _port_runner(pcfg, rparams)
    tokens = _tokens()
    # states right after prefill
    _, rc = ref["model_prefill"](tokens)
    _, pc = port["model_prefill"](tokens)
    _check_states(pc, rc, pcfg, 2e-4)
    r_out, fed, rc = _run(**ref, tokens=tokens, feed=None)
    p_out, _, pc = _run(**port, tokens=tokens, feed=fed)
    for i, (a, b) in enumerate(zip(p_out, r_out)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3,
                                   err_msg=f"logit row {i}")
    _check_states(pc, rc, pcfg, 2e-3)
    # the attention layer's ring was folded once (after step 64) and has
    # held the 6 steps since; the mamba states are recurrent
    assert int((pc[4].rec_pos >= 0).sum()) == STEPS - RECENT_RING
    assert int(pc[4].rec_pos.max()) == PROMPT + STEPS - 1


def test_bf16_logits_are_as_close_to_f32_as_the_reference_bf16():
    rparams = _ref_params(ref_get_reduced(ARCH))     # f32 parameters
    tokens = _tokens()
    cfg = lambda get, dt: get(ARCH).replace(compute_dtype=dt)
    truth, fed, _ = _run(**_ref_runner(cfg(ref_get_reduced, "float32"),
                                       rparams), tokens=tokens, feed=None)
    ref16, _, _ = _run(**_ref_runner(cfg(ref_get_reduced, "bfloat16"),
                                     rparams), tokens=tokens, feed=fed)
    port16, _, _ = _run(**_port_runner(cfg(get_reduced, "bfloat16"),
                                       rparams), tokens=tokens, feed=fed)
    err = lambda xs: [float(np.abs(a - b).max()) for a, b in zip(xs, truth)]
    e_port, e_ref = err(port16), err(ref16)
    assert all(np.isfinite(e_port))
    assert max(e_port) <= max(e_ref), (max(e_port), max(e_ref))
    assert np.mean(e_port) <= np.mean(e_ref), (np.mean(e_port),
                                               np.mean(e_ref))


def test_reference_bf16_moves_by_more_than_015_with_its_scan_chunk():
    """Why the bf16 check above is relative: the reference itself, with
    only its scan's chunk size changed (16 -> 40: the same f32
    recurrence summed in another order), moves its bf16 logits by more
    than 0.15 (measured 0.79 at prefill, 1.50 over the 70 steps)."""
    rparams = _ref_params(ref_get_reduced(ARCH))
    cfg = lambda ch: ref_get_reduced(ARCH).replace(compute_dtype="bfloat16",
                                                   scan_chunk=ch)
    a, fed, _ = _run(**_ref_runner(cfg(16), rparams), tokens=_tokens(),
                     feed=None)
    b, _, _ = _run(**_ref_runner(cfg(40), rparams), tokens=_tokens(),
                   feed=fed)
    spread = [float(np.abs(x - y).max()) for x, y in zip(a, b)]
    assert spread[0] > 0.15 and max(spread) > 0.15, spread


def test_prefill_then_decode_equals_forward():
    """Mirrors the reference's test_arch_prefill_decode_consistency
    (drop-free MoE: capacity factor 8)."""
    cfg = get_reduced(ARCH).replace(compute_dtype="float32", scan_chunk=8)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 24
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s + 2)).astype(np.int32))
    full = model.forward(params, {"tokens": tokens})
    lg_pref, states = model.prefill(params, {"tokens": tokens[:, :s]})
    np.testing.assert_allclose(_np32(lg_pref), _np32(full[:, s - 1]),
                               rtol=2e-3, atol=2e-3)
    for i in range(2):
        lg, states = model.decode_step(params, states, tokens[:, s + i],
                                       s + i)
        np.testing.assert_allclose(_np32(lg), _np32(full[:, s + i]),
                                   rtol=2e-3, atol=2e-3)


def test_forward_aux_loss_matches_the_reference():
    rcfg = ref_get_reduced(ARCH).replace(compute_dtype="float32")
    pcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    rparams = _ref_params(rcfg)
    params = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams),
                                        pcfg, "cpu")
    tokens = _tokens()
    lg, aux = T.lm_forward(params, pcfg, {"tokens": torch.from_numpy(tokens)})
    r_lg, r_aux = JT.lm_forward(rparams, rcfg,
                                {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(_np32(lg), np.asarray(r_lg, np.float32),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)


def test_route_log_records_each_router_call_and_restores_the_router():
    """chip_smoke's card-vs-CPU route check, rehearsed on the CPU: one
    record per MoE layer call, the router restored after; a replayed run
    takes the recorded experts and counts its own picks that differ."""
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    params = model.compute_params(model.init(0, device="cpu"))
    tokens = {"tokens": torch.from_numpy(_tokens())}
    route = L.route
    with CS.RouteLog() as a:
        lg, st = model.prefill(params, tokens)
        model.decode_step(params, st, lg[:, :256].argmax(-1), PROMPT)
    assert L.route is route
    assert [tuple(c.shape) for c in a.calls] == \
        [(BATCH, PROMPT, 2)] * 4 + [(BATCH, 2)] * 4
    assert CS.routes_differing(a, a) == (0, 4 * BATCH * PROMPT + 4 * BATCH,
                                         0.0)
    # replay a log whose first call picks other experts for token 0
    forced = CS.RouteLog()
    forced.calls = [c.clone() for c in a.calls]
    forced.calls[0][0, 0] = torch.tensor([3, 2]) if set(
        a.calls[0][0, 0].tolist()) != {2, 3} else torch.tensor([0, 1])
    with CS.RouteLog(replay=forced) as b:
        lg_b, _ = model.prefill(params, tokens)
    # its own picks are recorded: the first layer's are unchanged (later
    # layers see the forced expert's output)
    assert torch.equal(a.calls[0], b.calls[0])
    forced.calls, forced.probs = forced.calls[:1], []
    b.calls, b.probs = b.calls[:1], b.probs[:1]
    diff, total, gap = CS.routes_differing(forced, b)
    assert (diff, total) == (1, BATCH * PROMPT) and gap > 0
    logp = b.probs[0][0, 0].log()
    own, other = set(a.calls[0][0, 0].tolist()), set(
        forced.calls[0][0, 0].tolist())
    assert gap == pytest.approx(float(logp[list(own - other)].min()
                                      - logp[list(other - own)].max()))
    assert not torch.equal(lg_b, lg)               # the forced route ran
