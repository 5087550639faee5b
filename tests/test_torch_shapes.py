"""The abstract shapes against the JAX package, on the CPU: parameter and
cache specs, parameter counts, the shape cells and their input specs,
the serving steps, and the meta route of the kernels.

* ``Model.param_specs()`` for all 10 archs at full size and reduced
  equals the reference's ``param_specs()`` (its ``jax.eval_shape`` of the
  init) leaf by leaf in shape and dtype, the reference's stacked leaves
  laid out one a layer as ``convert.lm_params_from_reference`` does
  (``port_layout``, held to ``convert`` on the reduced trees).  Every
  leaf is a meta tensor; the port's own ``init(device="cpu")`` gives the
  same shapes at reduced size.
* ``param_count`` equals the Python-int sum over the reference's leaves,
  and the reference's own ``param_count`` wherever no leaf reaches 2^31
  elements; jamba-v0.1's is 51,570,315,264 (the reference's int32
  product wraps to 30,707,712).
* ``Model.cache_specs(b, s, plan)`` equals the reference's at
  ``cache_chunks`` 1, 16 and 256, one state a layer.
* ``SHAPES``, ``cell_applicable``, ``tune_for_shape`` and ``input_specs``
  equal the reference's for all 40 (arch, cell) pairs;
  ``is_attention_free``, ``supports_long_decode``, ``microbatch_specs``
  (accum 2 and 4) and ``padded_vocab_of`` too.
* ``make_prefill_step`` / ``make_decode_step`` equal ``Model.prefill`` /
  ``Model.decode_step`` bit for bit on the reduced configs.
* The meta route (``ops.meta_route``): at full size every arch prefills
  the prefill_32k cell on meta tensors (no plain version runs, peak host
  memory stays flat) into caches equal to ``cache_specs``; a cpu call
  never takes the route, a mix of meta and cpu inputs raises, and
  outside the block a meta tensor raises.
* A prompt that ``cache_chunks`` does not divide: both packages refuse a
  42-token prompt at 4 chunks, the port with a ValueError naming the
  prompt length, the chunk count and the old tier's length.
"""
import dataclasses
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.configs import shapes as RS
from repro.models.common import param_count as ref_param_count
from repro.models.plan import NullPlan as RefPlan
from repro.models.registry import build_model as ref_build_model
from repro.runtime import train as RT
from repro_torch import convert as C
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs import shapes as PS
from repro_torch.data import make_batch_for
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.models.common import param_count
from repro_torch.models.plan import NullPlan
from repro_torch.models.registry import build_model
from repro_torch.runtime import train as PT

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# layout helpers (shared with tests/test_torch_meshplan.py)
# ---------------------------------------------------------------------------

def leaves(tree, path=""):
    """{path: leaf} over dicts (sorted keys), NamedTuples (field names),
    lists and tuples (indices)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{path}/{k}"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            out.update(leaves(v, f"{path}/{f}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{path}/{i}"))
    else:
        out[path] = tree
    return out


def port_layout(tree, cfg, top, stacked):
    """A reference init tree in the port's layout: each ``group{gi}`` (a
    list over the group's blocks of leaves stacked [repeats, ...]) one
    dict a layer in ``cfg.all_blocks`` order, whisper's ``enc`` / ``dec``
    (stacked [layers, ...]) one dict a layer; ``stacked`` maps each
    stacked leaf, ``top`` every other leaf."""
    if cfg.is_enc_dec:
        out = {k: jax.tree.map(top, v) for k, v in tree.items()
               if k not in ("enc", "dec")}
        out["enc"] = [jax.tree.map(stacked, tree["enc"])
                      for _ in range(cfg.encoder.n_layers)]
        out["dec"] = [jax.tree.map(stacked, tree["dec"])
                      for _ in range(cfg.n_layers)]
        return out
    out = {k: jax.tree.map(top, v) for k, v in tree.items()
           if not k.startswith("group")}
    out["blocks"] = [jax.tree.map(stacked, tree[f"group{gi}"][bi])
                     for gi, g in enumerate(cfg.layer_groups)
                     for _ in range(g.repeats) for bi in range(len(g.blocks))]
    return out


def port_cache_layout(caches, cfg, stacked):
    """The reference's decode states (per group, per block position,
    stacked [repeats, ...]; whisper's stacked [layers, ...]) one state a
    layer, ``stacked`` mapping each leaf."""
    if cfg.is_enc_dec:
        return {"self_cache": [jax.tree.map(stacked, caches.self_cache)
                               for _ in range(cfg.n_layers)],
                "cross": [jax.tree.map(stacked, caches.cross)
                          for _ in range(cfg.n_layers)]}
    return [jax.tree.map(stacked, caches[gi][bi])
            for gi, g in enumerate(cfg.layer_groups)
            for _ in range(g.repeats) for bi in range(len(g.blocks))]


def port_caches(caches):
    """The port's decode states as a tree ``leaves`` reads like
    ``port_cache_layout``'s."""
    if hasattr(caches, "self_cache"):
        return {"self_cache": caches.self_cache, "cross": caches.cross}
    return caches


def sds(s):
    """A reference ShapeDtypeStruct as "(shape) dtype" (a string: a leaf
    to ``leaves``)."""
    return f"{tuple(s.shape)} {s.dtype}"


def sds_inner(s):
    """A stacked reference leaf without its repeats dim."""
    return f"{tuple(s.shape[1:])} {s.dtype}"


def spec_of(t: torch.Tensor):
    return f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"


@pytest.fixture(scope="module")
def ref_specs():
    """The reference's param_specs of every arch, full size and reduced."""
    return {(a, full): ref_build_model(
        (ref_get_config if full else ref_get_reduced)(a)).param_specs()
        for a in ARCHS for full in (False, True)}


# ---------------------------------------------------------------------------
# parameter specs and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, full, ref_specs):
    cfg = (get_config if full else get_reduced)(arch)
    port = build_model(cfg).param_specs()
    got = leaves(port)
    assert all(t.is_meta for t in got.values())
    want = leaves(port_layout(ref_specs[arch, full], cfg, sds, sds_inner))
    assert list(got) == list(want)
    assert {k: spec_of(t) for k, t in got.items()} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_is_converts_and_init_has_the_spec_shapes(arch):
    """``port_layout`` lays the reference tree out as
    ``convert.lm_params_from_reference`` does, and the port's own init
    (drawn on the CPU) has the specs' shapes and dtypes."""
    cfg = get_reduced(arch)
    ref = ref_build_model(ref_get_reduced(arch)).init(jax.random.PRNGKey(0))
    conv = C.lm_params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                      "cpu")
    mine = port_layout(ref, cfg, sds, sds_inner)
    assert {k: spec_of(t) for k, t in leaves(conv).items()} == leaves(mine)
    init = build_model(cfg).init(0, device="cpu")
    specs = build_model(cfg).param_specs()
    assert ({k: spec_of(t) for k, t in leaves(init).items()}
            == {k: spec_of(t) for k, t in leaves(specs).items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_in_python_ints(arch, ref_specs):
    for full in (False, True):
        cfg = (get_config if full else get_reduced)(arch)
        ref_leaves = jax.tree.leaves(ref_specs[arch, full])
        exact = sum(int(np.prod(s.shape, dtype=object)) for s in ref_leaves)
        n = param_count(cfg)
        assert isinstance(n, int) and n == exact
        if max(int(np.prod(s.shape, dtype=object))
               for s in ref_leaves) < 2 ** 31:
            rcfg = (ref_get_config if full else ref_get_reduced)(arch)
            assert ref_param_count(rcfg) == n


def test_jamba_count_past_the_reference_int32_wrap():
    assert param_count(get_config("jamba-v0.1-52b")) == 51_570_315_264
    assert ref_param_count(ref_get_config("jamba-v0.1-52b")) == 30_707_712


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for b, s, chunks in ((128, 32768, 1), (128, 32768, 16), (1, 524288, 256),
                         (4, 2048, 16), (3, 1000, 16)):
        got = build_model(cfg).cache_specs(b, s, NullPlan(cache_chunks=chunks))
        gl = leaves(port_caches(got))
        assert all(t.is_meta for t in gl.values())
        want = ref_build_model(rcfg).cache_specs(
            b, s, RefPlan(cache_chunks=chunks))
        assert ({k: spec_of(t) for k, t in gl.items()}
                == leaves(port_cache_layout(want, cfg, sds_inner))), \
            (b, s, chunks)


# ---------------------------------------------------------------------------
# the shape cells
# ---------------------------------------------------------------------------

def test_shape_table_equals_the_reference():
    assert list(PS.SHAPES) == list(RS.SHAPES)
    for name, cell in PS.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(RS.SHAPES[name])


@pytest.mark.parametrize("cell", list(RS.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_input_specs_equal_the_reference(arch, cell):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pc, rc = PS.SHAPES[cell], RS.SHAPES[cell]
    assert PS.cell_applicable(cfg, pc) == RS.cell_applicable(rcfg, rc)
    tuned, rtuned = PS.tune_for_shape(cfg, pc), RS.tune_for_shape(rcfg, rc)
    assert dataclasses.asdict(tuned) == dataclasses.asdict(rtuned)
    got, want = PS.input_specs(tuned, pc), RS.input_specs(rtuned, rc)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "caches":
            assert ({k: spec_of(t) for k, t in
                     leaves(port_caches(got[key])).items()}
                    == leaves(port_cache_layout(want[key], cfg, sds_inner)))
        else:
            assert got[key].is_meta and spec_of(got[key]) == sds(want[key])


@pytest.mark.parametrize("full", [False, True])
def test_small_functions_equal_the_reference(full):
    for arch in ARCHS:
        cfg = (get_config if full else get_reduced)(arch)
        rcfg = (ref_get_config if full else ref_get_reduced)(arch)
        assert cfg.is_attention_free == rcfg.is_attention_free, arch
        assert cfg.supports_long_decode == rcfg.supports_long_decode, arch
        assert (PT.padded_vocab_of(build_model(cfg))
                == RT.padded_vocab_of(ref_build_model(rcfg)))
        cell = PS.SHAPES["train_4k"]
        for accum in (2, 4):
            got = PT.microbatch_specs(PS.input_specs(cfg, cell), accum)
            want = RT.microbatch_specs(
                RS.input_specs(rcfg, RS.SHAPES["train_4k"]), accum)
            assert {k: spec_of(v) for k, v in got.items()} == \
                {k: sds(v) for k, v in want.items()}
            assert all(v.is_meta for v in got.values())
    with pytest.raises(ValueError, match="microbatches"):
        PT.microbatch_specs({"tokens": torch.empty(6, 8, device="meta")}, 4)


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_equal_the_model_entry_points(arch):
    cfg = get_reduced(arch).replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch_for(cfg, 2, 16, seed=4)
    lg, caches = PT.make_prefill_step(model)(params, batch)
    lg2, caches2 = model.prefill(params, batch)
    assert torch.equal(lg, lg2)
    for a, b in zip(leaves(port_caches(caches)).values(),
                    leaves(port_caches(caches2)).values()):
        assert torch.equal(a, b)
    tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    out, _ = PT.make_decode_step(model)(params, caches, tok, 16)
    want, _ = model.decode_step(params, caches2, tok, 16)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the meta route
# ---------------------------------------------------------------------------

@pytest.fixture
def no_plain_kernels(monkeypatch):
    """The plain versions of attention, WKV6 and the scan raise."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the meta route")
    for name in ("attention", "wkv6", "mamba_scan"):
        monkeypatch.setattr(KR, name, boom)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_prefill_on_meta_gives_the_cache_specs(arch,
                                                         no_plain_kernels):
    cfg = get_config(arch)
    model = build_model(cfg)
    cell = PS.SHAPES["prefill_32k"]
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    params = model.param_specs()
    with torch.no_grad(), ops.meta_route():
        logits, caches = PT.make_prefill_step(model)(
            params, PS.input_specs(cfg, cell))
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    b, s = cell.global_batch, cell.seq_len
    assert logits.is_meta and tuple(logits.shape) == (b, PT.padded_vocab_of(
        model))
    got = leaves(port_caches(caches))
    want = leaves(port_caches(model.cache_specs(b, s)))
    assert all(t.is_meta for t in got.values())
    assert ({k: spec_of(t) for k, t in got.items()}
            == {k: spec_of(t) for k, t in want.items()})
    assert rss1 - rss0 < 256 * 1024           # KiB: nothing sized by the model


def test_meta_route_is_named_by_the_caller(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16))
                                .astype(np.float32)) for _ in range(3))
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(mq, mk, mv)           # outside the block

    def no_meta(*a, **kw):
        raise AssertionError("a cpu call took the meta route")
    monkeypatch.setattr(ops, "_meta", no_meta)
    with ops.meta_route():
        assert torch.equal(ops.flash_attention(q, k, v),
                           KR.attention(q, k, v))
    monkeypatch.undo()
    with ops.meta_route():
        out = ops.flash_attention(mq, mk, mv)
        assert out.is_meta and out.shape == q.shape
        with pytest.raises(ValueError, match="mixed"):
            ops.flash_attention(mq, k, v)
        with pytest.raises(ValueError, match="mixed"):
            ops.flash_attention(q, mk, mv)
        r = torch.empty(2, 3, 5, 8, device="meta")
        o, S = ops.wkv6(r, r, r, r, torch.empty(3, 8, device="meta"))
        assert (tuple(o.shape), tuple(S.shape), S.dtype) == (
            (2, 3, 5, 8), (2, 3, 8, 8), torch.float32)
        u = torch.empty(2, 5, 6, dtype=torch.bfloat16, device="meta")
        bc = torch.empty(2, 5, 4, device="meta")
        y, h = ops.mamba_scan(u, u, bc, bc, torch.empty(6, 4, device="meta"),
                              torch.empty(6, device="meta"))
        assert (tuple(y.shape), y.dtype, tuple(h.shape), h.dtype) == (
            (2, 5, 6), torch.bfloat16, (2, 6, 4), torch.float32)
        with pytest.raises(ValueError, match="cuda or cpu"):
            ops.fused_lerp_flat(r.reshape(-1), r.reshape(-1), 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wkv6(r, r, r, r, torch.empty(3, 8, device="meta"))


# ---------------------------------------------------------------------------
# a prompt the chunk count does not divide
# ---------------------------------------------------------------------------

def test_a_prompt_the_chunks_do_not_divide_is_refused_in_both_packages():
    arch = "internlm2-1.8b"
    tokens = np.random.default_rng(6).integers(0, 256, (2, 42)).astype(
        np.int32)
    rmodel = ref_build_model(ref_get_reduced(arch))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="reshape"):
        rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)},
                       RefPlan(cache_chunks=4))
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = C.lm_params_from_reference(jax.tree.map(np.asarray, rparams),
                                        cfg, "cpu")
    with pytest.raises(ValueError, match=r"42-token prompt at "
                       r"cache_chunks=4: the old tier rounds up to 44"):
        model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                      NullPlan(cache_chunks=4))
    # a prompt the chunks divide prefills
    model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :40])},
                  NullPlan(cache_chunks=4))
