"""The mesh plans as data against the JAX package, on the CPU.

The reference's ``MeshPlan`` runs in this process over
``jax.sharding.AbstractMesh`` (no devices) of the shapes the port's
``make_production_mesh`` names: 16 x 16 ("data", "model") and 2 x 16 x 16
("pod", "data", "model", data over ("pod", "data")).  For every arch and
applicable shape cell, built as the reference's dry run builds it
(``launch/dryrun.py::lower_cell``: the cell's tuning, bf16 serving
weights without FSDP, ``decode_batch`` for a decode cell), in the forms
plain, ``zero_dp``, ``moe_ep`` (MoE archs after ``ep_tune``, not decode)
and ``attn_mode`` forced to each of "local", "head_tp" and "cp":

* every field ``build`` sets is equal;
* ``param_shardings(param_specs())``: every leaf's spec equals the
  reference's, whose stacked leaves (a layer group's repeats, whisper's
  layers) carry a leading None the port's per-layer leaves do not have;
* ``batch_shardings(input_specs(...))`` at ``lead_dims`` 0 and 1 (a
  decode cell's token and position; its caches, stacked per group in the
  reference, are held through ``cache_shardings``);
* ``cache_shardings(cache_specs(...))`` of the prefill and decode cells,
  one state a layer;
* ``act_spec`` of every kind, ``_fit`` on batch 1, ``chunk_axes``.

The model entry points refuse a plan over several positions and run one
over a single position as they run a ``NullPlan``; its computing fields
run on one card as ``one_card_plan()``.  ``launch/train.py --mesh``
takes a one-position mesh and refuses a larger one.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as RS
from repro.models.registry import build_model as ref_build_model
from repro.runtime import sharding as RSH
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs import shapes as PS
from repro_torch.data import make_batch_for
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.plan import NullPlan, require_one_card_plan
from repro_torch.models.registry import build_model
from repro_torch.runtime import sharding as PSH
from test_torch_shapes import (leaves, port_cache_layout, port_caches,
                               port_layout)

torch.set_num_threads(2)

MESHES = {"16x16": False, "2x16x16": True}
FORMS = ("plain", "zero_dp", "moe_ep", "local", "head_tp", "cp")
FIELDS = ("data_axis", "model_axis", "tp", "dp", "fsdp", "kv_sharded",
          "cache_mode", "attn_mode", "cp", "cache_chunks", "window_gather",
          "moe_ep", "ep")
KINDS = ("bsd", "enc_bsd", "cp_bpsd", "q_bshd", "kv_bshd", "q_bpshd",
         "kv_rep", "kv_gather", "logits", "dec_x", "dec_q", "dec_logits",
         "cache_old", "cache_old_L", "ep_tokens", "ep_dispatched",
         "ep_returned", "ep_w_in", "ep_w_out", "no_such_kind")


def _ref_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _spec(ns) -> str:
    return repr(tuple(ns.spec))


def _spec_inner(ns) -> str:
    """A reference stacked leaf's spec without its leading None."""
    spec = tuple(ns.spec)
    assert spec[0] is None, spec
    return repr(spec[1:])


@functools.lru_cache(maxsize=None)
def _param_specs(cfg, ref: bool):
    return (ref_build_model(cfg) if ref else build_model(cfg)).param_specs()


def _plans(arch: str, cell_name: str, multi_pod: bool, form: str):
    """(port cfg, reference cfg, port plan, reference plan) as the dry run
    builds them, or None where the form does not apply."""
    cell, rcell = PS.SHAPES[cell_name], RS.SHAPES[cell_name]
    cfg = PS.tune_for_shape(get_config(arch), cell)
    rcfg = RS.tune_for_shape(ref_get_config(arch), rcell)
    if cell.kind in ("prefill", "decode"):
        cfg = cfg.replace(param_dtype="bfloat16")
        rcfg = rcfg.replace(param_dtype="bfloat16")
    moe_ep = form == "moe_ep"
    if moe_ep and (cfg.moe is None or cell.kind == "decode"):
        return None
    data_axis = ("pod", "data") if multi_pod else "data"
    if moe_ep:
        dp = 32 if multi_pod else 16
        cfg, rcfg = PSH.ep_tune(cfg, dp), RSH.ep_tune(rcfg, dp)
        assert cfg.moe.ep_virtual == rcfg.moe.ep_virtual
    kw = dict(data_axis=data_axis,
              attn_mode=form if form in ("local", "head_tp", "cp") else None,
              decode_batch=(cell.global_batch if cell.kind == "decode"
                            else None),
              moe_ep=moe_ep, zero_dp=form == "zero_dp")
    plan = PSH.MeshPlan.build(cfg, make_production_mesh(multi_pod=multi_pod),
                              **kw)
    rplan = RSH.MeshPlan.build(rcfg, _ref_mesh(multi_pod), **kw)
    if cell.kind in ("prefill", "decode"):
        plan.fsdp = rplan.fsdp = False
    return cfg, rcfg, plan, rplan


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_their_specs_equal_the_reference(arch, mesh, form):
    multi_pod = MESHES[mesh]
    ran = 0
    for cell_name, cell in PS.SHAPES.items():
        if PS.cell_applicable(get_config(arch), cell):
            continue
        built = _plans(arch, cell_name, multi_pod, form)
        if built is None:
            continue
        ran += 1
        cfg, rcfg, plan, rplan = built
        where = (arch, mesh, form, cell_name)
        # the fields build sets
        assert plan.mesh.shape == dict(rplan.mesh.shape)
        for f in FIELDS:
            assert getattr(plan, f) == getattr(rplan, f), (where, f)
        assert isinstance(plan, NullPlan)
        # parameters
        got = leaves(plan.param_shardings(_param_specs(cfg, False)))
        assert all(ns.mesh is plan.mesh for ns in got.values())
        want = leaves(port_layout(
            rplan.param_shardings(_param_specs(rcfg, True)), cfg, _spec,
            _spec_inner))
        assert {k: _spec(ns) for k, ns in got.items()} == want, where
        # batch inputs
        specs = PS.input_specs(cfg, cell, plan)
        rspecs = RS.input_specs(rcfg, RS.SHAPES[cell_name], rplan)
        for lead in (0, 1):
            batch = {k: v for k, v in specs.items() if k != "caches"}
            rbatch = {k: v for k, v in rspecs.items() if k != "caches"}
            assert ({k: _spec(ns) for k, ns in
                     plan.batch_shardings(batch, lead).items()}
                    == {k: _spec(ns) for k, ns in
                        rplan.batch_shardings(rbatch, lead).items()}), where
        # decode caches
        if cell.kind == "train":
            continue
        b, s = cell.global_batch, cell.seq_len
        caches = build_model(cfg).cache_specs(b, s, plan)
        rcaches = ref_build_model(rcfg).cache_specs(b, s, rplan)
        assert ({k: _spec(ns) for k, ns in
                 leaves(port_caches(plan.cache_shardings(caches))).items()}
                == leaves(port_cache_layout(rplan.cache_shardings(rcaches),
                                            cfg, _spec_inner))), where
    assert ran or form == "moe_ep"


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_specs_fit_and_chunk_axes_equal_the_reference(mesh, form):
    multi_pod = MESHES[mesh]
    for arch in ("internlm2-1.8b", "gemma3-4b", "whisper-tiny",
                 "granite-moe-1b-a400m"):
        for cell in ("prefill_32k", "decode_32k", "long_500k"):
            if PS.cell_applicable(get_config(arch), PS.SHAPES[cell]):
                continue
            built = _plans(arch, cell, multi_pod, form)
            if built is None:
                continue
            _, _, plan, rplan = built
            for kind in KINDS:
                got, want = plan.act_spec(kind), rplan.act_spec(kind)
                assert (None if got is None else tuple(got)) == \
                    (None if want is None else tuple(want)), (arch, kind)
            for spec, shape in (((plan.data_axis, None), (1, 4096)),
                                ((plan.data_axis, plan.model_axis), (64, 8)),
                                ((None, plan.model_axis, None), (2, 48, 3))):
                want = rplan._fit(RSH.P(*spec), shape)
                assert tuple(plan._fit(PSH.P(*spec), shape)) == tuple(want)
            assert plan.chunk_axes == rplan.chunk_axes
            if plan.cache_chunks > plan.tp:
                assert plan.chunk_axes == (*PSH._tup(plan.data_axis),
                                           *PSH._tup(plan.model_axis))


def test_production_decode_plans_chunk_the_cache():
    """The plans phase 19c of chip_smoke.py serves on one card."""
    mesh = make_production_mesh()
    plan = PSH.MeshPlan.build(get_config("internlm2-1.8b"), mesh,
                              decode_batch=128)
    assert (plan.attn_mode, plan.cache_mode, plan.cache_chunks) == (
        "head_tp", "seq", 16)
    plan = PSH.MeshPlan.build(get_config("gemma3-4b"), mesh, decode_batch=1)
    assert (plan.attn_mode, plan.cp, plan.cache_mode, plan.cache_chunks) == (
        "cp", 16, "seq", 256)
    one = plan.one_card_plan()
    assert type(one) is NullPlan
    assert dataclasses.astuple(one) == (
        "cp", 16, 256, True, False, 1)
    require_one_card_plan(one)


def test_entry_points_refuse_several_positions_and_take_one():
    cfg = get_reduced("internlm2-1.8b").replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch_for(cfg, 2, 16, seed=2)
    many = PSH.MeshPlan.build(cfg, make_production_mesh())
    for call in (lambda: model.prefill(params, batch, many),
                 lambda: model.forward(params, batch, many),
                 lambda: model.loss(params, batch, many),
                 lambda: require_one_card_plan(many),
                 lambda: many.act(batch["tokens"], "bsd")):
        with pytest.raises(NotImplementedError, match="item 2b"):
            call()
    one = PSH.MeshPlan.build(cfg, Mesh(("data", "model"), (1, 1)))
    assert one.act(batch["tokens"], "bsd") is batch["tokens"]
    lg, caches = model.prefill(params, batch, one)
    want, wcaches = model.prefill(params, batch)
    assert torch.equal(lg, want)
    tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    out, _ = model.decode_step(params, caches, tok, 16, one)
    assert torch.equal(out, model.decode_step(params, wcaches, tok, 16)[0])


def test_trainer_mesh_takes_one_position_and_refuses_more(tmp_path):
    common = ["--arch", "internlm2-1.8b", "--reduced", "--rounds", "1",
              "--local-steps", "1", "--islands", "2", "--batch", "2",
              "--seq", "16", "--device", "cpu"]
    assert LT.main([*common, "--mesh", "1,1",
                    "--ckpt-dir", str(tmp_path / "a")]) == 0
    for mesh in ("2,1", "1,4", "2,2"):
        with pytest.raises(NotImplementedError, match="item 2b"):
            LT.main([*common, "--mesh", mesh,
                     "--ckpt-dir", str(tmp_path / "b")])
