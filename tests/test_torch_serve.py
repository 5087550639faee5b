"""The port's serving driver and its token source, on the CPU.

* ``make_batch_for`` gives the reference's tokens bit for bit (both draw
  them with numpy);
* ``launch.serve`` runs end to end at reduced scale when asked for the
  CPU (every ported architecture; one dense run crosses a compaction,
  one rwkv6 run crosses step 64 and leaves its states alone), builds
  no kernel there, and its greedy tokens are the model's own greedy
  decode;
* without ``--device`` it runs on the card, so with no card it raises,
  as do the other new entry points.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.data import SyntheticTokenSource as RefSource
from repro.data import make_batch_for as ref_make_batch_for
from repro.models.registry import build_model as ref_build_model
from repro_torch import convert as C
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import SyntheticTokenSource, make_batch_for
from repro_torch.kernels import build, launches
from repro_torch.launch import serve
from repro_torch.models.layers import RECENT_RING, DecodeCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.registry import build_model
from repro_torch.models.rwkv import RWKVState

torch.set_num_threads(2)


@pytest.mark.parametrize("arch,b,s,seed", [
    ("internlm2-1.8b", 4, 64, 0), ("gemma3-4b", 2, 33, 5),
    ("qwen2.5-14b", 3, 17, 11), ("stablelm-3b", 1, 128, 2)])
def test_make_batch_for_tokens_are_the_references(arch, b, s, seed):
    for cfg, ref_cfg in ((get_reduced(arch), ref_get_reduced(arch)),
                         (get_config(arch), ref_get_config(arch))):
        got = make_batch_for(cfg, b, s, seed)["tokens"]
        want = np.asarray(ref_make_batch_for(ref_cfg, b, s, seed)["tokens"])
        assert got.dtype == torch.int32 and tuple(got.shape) == (b, s)
        np.testing.assert_array_equal(got.numpy(), want)


def test_token_source_offsets_are_the_references():
    for vocab, seed, off in ((256, 0, 0), (92544, 3, 17), (50304, 1, 5)):
        np.testing.assert_array_equal(
            SyntheticTokenSource(vocab, seed).sample(2, 40, off),
            RefSource(vocab, seed).sample(2, 40, off))


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2.5-14b",
                                  "stablelm-3b", "gemma3-4b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_serve_main_runs_reduced_on_the_cpu(arch, no_build, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "24", "--gen", "5",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}: prefill 2x24 in" in out
    assert "[serve] generated 5 tokens/seq in" in out
    assert "[serve] sample continuations:" in out


def test_serve_run_crosses_a_compaction_and_decodes_greedily(no_build):
    launches.reset_launch_count()
    gen = RECENT_RING + 3
    res = serve.run(["--arch", "internlm2-1.8b", "--reduced", "--batch",
                     "2", "--prompt-len", "80", "--gen", str(gen), "--seed",
                     "3", "--device", "cpu"])
    assert res.compactions == 1 and res.logits_finite
    assert tuple(res.tokens.shape) == (2, gen + 1)
    assert res.next_pos == 80 + gen - 1
    assert launches.launch_count() == 0
    assert sum(res.launches_prefill.values()) == 0
    assert sum(res.launches_decode.values()) == 0
    # the compaction wrote positions 80..143 over the prompt's oldest 64
    # slots (the reference's rolling old tier); the ring holds the 3
    # steps since
    for c in res.caches:
        assert sorted(c.old_pos.flatten().tolist()) == list(range(64, 144))
        assert int((c.rec_pos >= 0).sum()) == 3

    # the same greedy decode through the model's API, from the same seed
    cfg = get_reduced("internlm2-1.8b")
    model = build_model(cfg)
    params = model.compute_params(model.init(3, device="cpu"))
    tokens = make_batch_for(cfg, 2, 80, 3)["tokens"]
    lg, caches = model.prefill(params, {"tokens": tokens})
    tok = serve.greedy(lg, cfg)
    want = [tok]
    for i in range(gen):
        lg, caches = model.decode_step(params, caches, tok, 80 + i)
        tok = serve.greedy(lg, cfg)
        want.append(tok)
        if (i + 1) % RECENT_RING == 0:
            caches = serve.compact_all(caches, 80 + i)
    assert torch.equal(res.tokens, torch.stack(want, 1))


def test_serve_rwkv_crosses_step_64_without_compacting_its_states(no_build):
    """rwkv6's decode states are O(1) recurrent states: the serve loop
    runs past step 64 (where it folds attention caches) and leaves them
    as they are; its greedy tokens are the model's own greedy decode."""
    launches.reset_launch_count()
    gen = RECENT_RING + 3
    res = serve.run(["--arch", "rwkv6-1.6b", "--reduced", "--batch", "2",
                     "--prompt-len", "30", "--gen", str(gen), "--seed", "4",
                     "--device", "cpu"])
    assert res.compactions == 0 and res.compact_s == 0.0
    assert res.logits_finite and tuple(res.tokens.shape) == (2, gen + 1)
    assert launches.launch_count() == 0
    cfg = get_reduced("rwkv6-1.6b")
    assert len(res.caches) == cfg.n_layers
    for st in res.caches:
        assert isinstance(st, RWKVState)
        assert tuple(st.wkv.shape) == (2, 4, 16, 16)
        assert st.wkv.dtype == torch.float32
        assert tuple(st.tm_prev.shape) == tuple(st.cm_prev.shape) == (2, 64)

    model = build_model(cfg)
    params = model.compute_params(model.init(4, device="cpu"))
    tokens = make_batch_for(cfg, 2, 30, 4)["tokens"]
    lg, states = model.prefill(params, {"tokens": tokens})
    tok = serve.greedy(lg, cfg)
    want = [tok]
    for i in range(gen):
        lg, states = model.decode_step(params, states, tok, 30 + i)
        tok = serve.greedy(lg, cfg)
        want.append(tok)
    assert torch.equal(res.tokens, torch.stack(want, 1))
    for got, st in zip(res.caches, states):
        assert all(torch.equal(a, b) for a, b in zip(got, st))


def test_serve_jamba_compacts_its_attention_cache_and_carries_mamba_states(
        no_build):
    """jamba's decode states are one two-tier cache (the attention layer)
    and seven mamba states: past step 64 the serve loop folds the cache
    and leaves the mamba states to their recurrence; its greedy tokens
    are the model's own greedy decode."""
    launches.reset_launch_count()
    gen = RECENT_RING + 3
    res = serve.run(["--arch", "jamba-v0.1-52b", "--reduced", "--batch",
                     "2", "--prompt-len", "30", "--gen", str(gen), "--seed",
                     "6", "--device", "cpu"])
    assert res.compactions == 1 and res.logits_finite
    assert tuple(res.tokens.shape) == (2, gen + 1)
    assert launches.launch_count() == 0 and res.init_s > 0
    cfg = get_reduced("jamba-v0.1-52b")
    assert [type(c) for c in res.caches] == [
        DecodeCache if s.mixer == "attn" else MambaState
        for s in cfg.all_blocks]
    st = res.caches[0]
    assert tuple(st.conv.shape) == (2, 128, 3)
    assert tuple(st.ssm.shape) == (2, 128, 4) and st.ssm.dtype == torch.float32
    assert int((res.caches[4].rec_pos >= 0).sum()) == 3

    model = build_model(cfg)
    params = model.compute_params(model.init(6, device="cpu"))
    tokens = make_batch_for(cfg, 2, 30, 6)["tokens"]
    lg, states = model.prefill(params, {"tokens": tokens})
    tok = serve.greedy(lg, cfg)
    want = [tok]
    for i in range(gen):
        lg, states = model.decode_step(params, states, tok, 30 + i)
        tok = serve.greedy(lg, cfg)
        want.append(tok)
        if (i + 1) % RECENT_RING == 0:
            states = serve.compact_all(states, 30 + i)
    assert torch.equal(res.tokens, torch.stack(want, 1))


def test_serve_takes_a_depth_cut_config(no_build):
    """``serve.serve`` runs a given ModelConfig: here the reduced jamba
    cut to its attention + dense and mamba + MoE blocks."""
    from repro_torch.models.common import LayerGroup
    base = get_reduced("jamba-v0.1-52b")
    blocks = base.layer_groups[0].blocks
    cfg = base.replace(layer_groups=(LayerGroup((blocks[3], blocks[4]), 1),))
    res = serve.serve(cfg, 2, 20, 4, seed=1, device="cpu")
    assert res.cfg is cfg and len(res.caches) == 2
    assert isinstance(res.caches[0], MambaState)
    assert isinstance(res.caches[1], DecodeCache)
    assert tuple(res.tokens.shape) == (2, 5) and res.compactions == 0


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serve_without_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(["--arch", "gemma3-4b", "--reduced", "--gen", "1"])


def test_model_entry_points_raise_without_gpu(no_gpu):
    cfg = get_reduced("internlm2-1.8b")
    with pytest.raises(RuntimeError):
        build_model(cfg).init(0)
    rcfg = ref_get_reduced("internlm2-1.8b")
    tree = jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError):
        C.lm_params_from_reference(tree, cfg)
    assert C.lm_params_from_reference(tree, cfg, "cpu")["blocks"][1][
        "attn"]["wq"].device.type == "cpu"

    # the rwkv6 model's entry points and converters likewise
    cfg = get_reduced("rwkv6-1.6b")
    with pytest.raises(RuntimeError):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(["--arch", "rwkv6-1.6b", "--reduced", "--gen", "1"])
    rcfg = ref_get_reduced("rwkv6-1.6b").replace(compute_dtype="float32")
    rmodel = ref_build_model(rcfg)
    tree = rmodel.init(jax.random.PRNGKey(0))
    _, states = rmodel.prefill(tree, {"tokens": np.zeros((2, 5), np.int32)})
    tree, states = (jax.tree.map(np.asarray, t) for t in (tree, states))
    with pytest.raises(RuntimeError):
        C.lm_params_from_reference(tree, cfg)
    with pytest.raises(RuntimeError):
        C.caches_from_reference(states, cfg)
    p = C.lm_params_from_reference(tree, cfg, "cpu")["blocks"][1]
    assert p["rwkv_tm"]["u"].device.type == "cpu"
    st = C.caches_from_reference(states, cfg, "cpu")
    assert [type(s) for s in st] == [RWKVState] * cfg.n_layers
    assert st[0].wkv.dtype == torch.float32

    # the jamba model's entry points and converters likewise
    cfg = get_reduced("jamba-v0.1-52b")
    with pytest.raises(RuntimeError):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(["--arch", "jamba-v0.1-52b", "--reduced", "--gen", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve(cfg, 1, 8, 1)
    rmodel = ref_build_model(ref_get_reduced("jamba-v0.1-52b"))
    tree = rmodel.init(jax.random.PRNGKey(0))
    _, states = rmodel.prefill(tree, {"tokens": np.zeros((2, 5), np.int32)})
    tree, states = (jax.tree.map(np.asarray, t) for t in (tree, states))
    with pytest.raises(RuntimeError):
        C.lm_params_from_reference(tree, cfg)
    with pytest.raises(RuntimeError):
        C.caches_from_reference(states, cfg)
    st = C.caches_from_reference(states, cfg, "cpu")
    assert [type(s) for s in st] == [
        DecodeCache if s.mixer == "attn" else MambaState
        for s in cfg.all_blocks]
