"""B13's plain version and the model's attention entry point against the
JAX package, on the CPU.

The port's ``kernels/ref.py::attention`` (what ``ops.flash_attention``
runs for CPU tensors, and what the CUDA kernel is held against on the
card) is compared with the reference's ``repro.kernels.ref.attention``
and with the model's online-softmax ``repro.models.layers.
blocked_attention``; the port's ``blocked_attention`` (the model's
entry, [b, P=1, s, h, hd]) with the reference's.  The reference's Pallas
kernel does not run under the installed jax (``pl.load`` is gone; ROADMAP
queue C), so it is not a party here.

Inputs are drawn with numpy from a seed.  Tolerances: 2e-5 in f32 (the
reference's own for blocked vs plain attention, tests/test_models.py) and
``tests/test_kernels.py::TOL`` in bf16 (2e-2: the outputs are rounded to
bf16, and the model's blocked attention also rounds p to bf16 before the
product with V where the plain version keeps it in f32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import build, launches, ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (h, kvh): GQA groups 1, 2, 4 and qwen's reduced 5 heads over 1 kv head
HEADS = [(4, 4), (4, 2), (8, 2), (5, 1)]
# (causal, window, softcap, sq, skv): ragged lengths throughout
MODES = {
    "causal": (True, None, None, 37, 37),
    "causal-window": (True, 9, None, 37, 37),
    "noncausal-cross": (False, None, None, 21, 53),
    "noncausal-window": (False, 12, None, 37, 37),
    "causal-softcap": (True, None, 5.0, 37, 37),
    "noncausal-softcap": (False, None, 50.0, 21, 53),
}
# every GQA group in the two causal modes; the other modes at group 4
CASES = ([(hk, m) for hk in HEADS for m in ("causal", "causal-window")]
         + [((8, 2), m) for m in MODES if not m.startswith("causal")]
         + [((8, 2), "causal-softcap")])


def _inputs(h, kvh, sq, skv, hd=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, sq, hd)) * 0.6).astype(np.float32)
    k = (rng.standard_normal((b, kvh, skv, hd)) * 0.6).astype(np.float32)
    v = rng.standard_normal((b, kvh, skv, hd)).astype(np.float32)
    return q, k, v


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,mode", CASES,
                         ids=[f"h{h}kv{kv}-{m}" for (h, kv), m in CASES])
def test_plain_attention_matches_reference(heads, mode, dtype):
    causal, window, softcap, sq, skv = MODES[mode]
    q, k, v = _inputs(*heads, sq, skv)
    got = R.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                      causal=causal, window=window, softcap=softcap)
    ref = jax.jit(functools.partial(JR.attention, causal=causal,
                                    window=window, softcap=softcap))
    want = ref(_j(q, dtype), _j(k, dtype), _j(v, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _blocked(causal, window, softcap, s=43, block=16):
    """The reference's blocked attention, jitted, with its (trace-time
    constant) positions given as numpy."""
    pos = np.arange(s, dtype=np.int32)
    return jax.jit(functools.partial(
        JL.blocked_attention, causal=causal, window=window, softcap=softcap,
        q_positions=pos[None], kv_positions=pos, q_block=block,
        kv_block=block))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("heads", HEADS, ids=lambda hk: f"h{hk[0]}kv{hk[1]}")
def test_model_attention_matches_blocked_attention(heads, window, dtype):
    """The port's model entry (one ops.flash_attention call) against the
    reference's python-unrolled online softmax, blocks of 16 over a
    ragged 43-token sequence, in the model's [b, 1, s, h, hd] layout."""
    h, kvh = heads
    q, k, v = _inputs(h, kvh, 43, 43)
    q5 = q.transpose(0, 2, 1, 3)[:, None]          # [b, 1, s, h, hd]
    k4, v4 = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    got = L.blocked_attention(_t(np.ascontiguousarray(q5), dtype),
                              _t(np.ascontiguousarray(k4), dtype),
                              _t(np.ascontiguousarray(v4), dtype),
                              causal=True, window=window)
    want = _blocked(True, window, None)(_j(q5, dtype), _j(k4, dtype),
                                        _j(v4, dtype))
    assert tuple(got.shape) == q5.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_plain_attention_matches_blocked_attention_noncausal_softcap():
    q, k, v = _inputs(4, 2, 43, 43, hd=32)
    got = R.attention(_t(q, "float32"), _t(k, "float32"), _t(v, "float32"),
                      causal=False, softcap=20.0)
    want = _blocked(False, None, 20.0)(
        jnp.asarray(q.transpose(0, 2, 1, 3))[:, None],
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)))
    np.testing.assert_allclose(_np(got), _np(want)[:, 0].transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)


def test_blocked_attention_refuses_context_parallel_chunks():
    q = torch.zeros(1, 2, 8, 4, 16)
    kv = torch.zeros(1, 16, 2, 16)
    with pytest.raises(NotImplementedError, match="context-parallel"):
        L.blocked_attention(q, kv, kv, causal=True)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_ops_routes_cpu_tensors_to_the_plain_version(no_build):
    q, k, v = (_t(a, "float32") for a in _inputs(8, 2, 29, 29))
    launches.reset_launch_count()
    got = ops.flash_attention(q, k, v, causal=True, window=7)
    assert torch.equal(got, R.attention(q, k, v, causal=True, window=7))
    assert launches.launch_count("flash_attention") == 0


def test_kernel_wrapper_refuses_cpu_tensors(no_build):
    q, k, v = (_t(a, "float32") for a in _inputs(4, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, v)


def _bad_args():
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    ok = dict(q=z(1, 4, 8, 16), k=z(1, 2, 8, 16), v=z(1, 2, 8, 16),
              window=None, softcap=None)
    yield "head dim", {**ok, "q": z(1, 4, 8, 48), "k": z(1, 2, 8, 48),
                       "v": z(1, 2, 8, 48)}
    yield "dtype", {**ok, "q": z(1, 4, 8, 16, dt=torch.float16),
                    "k": z(1, 2, 8, 16, dt=torch.float16),
                    "v": z(1, 2, 8, 16, dt=torch.float16)}
    yield "dtypes differ", {**ok, "k": z(1, 2, 8, 16, dt=torch.bfloat16)}
    yield "h % kvh", {**ok, "k": z(1, 3, 8, 16), "v": z(1, 3, 8, 16)}
    yield "need q", {**ok, "v": z(1, 2, 9, 16)}
    yield "4-D", {**ok, "q": z(4, 8, 16)}
    yield "unit stride", {**ok, "q": z(1, 4, 16, 8).transpose(2, 3)}
    yield "positive int", {**ok, "window": 0}
    yield "see no key", {**ok, "q": z(1, 4, 12, 16), "window": 4}
    yield "softcap", {**ok, "softcap": -1.0}


@pytest.mark.parametrize("what,args", list(_bad_args()),
                         ids=[w for w, _ in _bad_args()])
def test_kernel_validation_refuses(what, args):
    with pytest.raises(ValueError, match=what):
        FA.validate(args["q"], args["k"], args["v"], args["window"],
                    args["softcap"])


def test_kernel_validation_takes_every_head_dim_and_strided_views():
    for hd in FA.HEAD_DIMS:
        q = torch.zeros(2, 9, 4, hd, dtype=torch.bfloat16).transpose(1, 2)
        kv = torch.zeros(2, 9, 2, hd, dtype=torch.bfloat16).transpose(1, 2)
        FA.validate(q, kv, kv, window=3, softcap=50.0)


def test_flash_attention_is_registered():
    assert "flash_attention" in launches.KERNELS
    assert launches.SOURCE["flash_attention"].endswith(
        "kernels/csrc/flash_attention.cu")
    assert launches.REPLACES["flash_attention"] == \
        "src/repro/kernels/flash_attention.py:23"
    assert build.SOURCES["flash_attention"].is_file()
    # the line named is the Pallas kernel function itself
    path, line = launches.REPLACES["flash_attention"].split(":")
    root = build.CSRC.parents[3]
    text = (root / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _attn_kernel(")
