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

B13's wgmma route (bf16 at hd 64, 80, 128 and 256,
csrc/flash_attention_sm90.cu) runs only on the card; here a test-local
emulation of its arithmetic (P rounded to bf16 for the P.V product, its
tile walk at each head dim: 128 x 128 tiles, 128 x 64 at hd 256) is held
against the reference, and its route, its TMA checks and its tile walk
are checked directly.

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
    """P > 1 query chunks without their positions are refused (the
    reference asserts P == 1 then); at the contiguous chunk positions
    they are the one-chunk call on the same rows."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 4, 16, generator=g)
    kv = torch.randn(1, 16, 2, 16, generator=g)
    with pytest.raises(ValueError, match="q_positions"):
        L.blocked_attention(q, kv, kv, causal=True)
    got = L.blocked_attention(q, kv, kv, causal=True,
                              q_positions=np.arange(16).reshape(2, 8))
    want = L.blocked_attention(q.reshape(1, 1, 16, 4, 16), kv, kv,
                               causal=True)
    assert torch.equal(got.reshape(want.shape), want)


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


# ---------------------------------------------------------------------------
# B13's wgmma route (bf16 at hd 64, 80, 128 and 256,
# csrc/flash_attention_sm90.cu): its arithmetic, emulated here, against the
# reference; its route; its walk
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _emulate_wgmma(q, k, v, *, causal, window=None, softcap=None,
                   p_bf16=True):
    """The wgmma kernel's arithmetic on the CPU: bf16 q / k / v (torch
    tensors [b, h, sq, hd] / [b, kvh, skv, hd], hd 64, 80, 128 or 256;
    hd 80's zero-filled columns add exact zeros), f32 products, the max
    over the unscaled scores y (or tanh(s scale / softcap) softcap), p =
    2^(y c - m c) with c = scale log2(e) (or log2(e)), masked keys at
    -inf (keys past skv weigh nothing), P rounded to bf16 for the P.V
    product (kept in f32 with ``p_bf16=False``, as the Pallas and SIMT
    kernels do) and l summed from the f32 P, over the kernel's tile walk
    at that head dim (``FA.tile_walk``: 128-row query tiles over kv tiles
    of ``FA.fwd_keys(hd)`` keys).  Returns (o in f32 before its bf16
    rounding, o in bf16)."""
    b, h, sq, hd = q.shape
    rep = h // k.shape[1]
    skv = k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = 1.0 / np.sqrt(hd)
    c = np.float32(LOG2E if softcap else scale * LOG2E)
    o = torch.zeros(b, h, sq, hd)
    T, KT = FA.WGMMA_TILE, FA.fwd_keys(hd)
    for qt, t_lo, t_hi in FA.tile_walk(sq, skv, causal, window, hd):
        rows = torch.arange(qt * T, min(sq, qt * T + T))
        m = torch.full((b, h, len(rows)), -torch.inf)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), hd)
        for t in range(t_lo, t_hi):
            keys = torch.arange(t * KT, min(skv, t * KT + KT))
            y = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            if softcap is not None:
                y = torch.tanh(y * np.float32(scale / softcap)) * np.float32(
                    softcap)
            mask = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                mask &= keys[None, :] <= rows[:, None]
            if window is not None:
                mask &= keys[None, :] > rows[:, None] - window
            y = y.masked_fill(~mask, -torch.inf)
            m_new = torch.maximum(m, y.amax(-1))
            mc = torch.where(m_new == -torch.inf, 0.0, m_new * c)
            alpha = torch.exp2(m * c - mc)
            p = torch.exp2(y * c - mc[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.bfloat16().float() if p_bf16 else p
            acc = acc * alpha[..., None] + pv @ vf[:, :, keys]
            m = m_new
        o[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return o, o.bfloat16()


# (h, kvh, sq, skv, causal, window, softcap): GQA 2 (internlm2) and 4
# (jamba), causal and not, window, softcap, ragged 300 / 333
WGMMA_CASES = {
    "causal-gqa2": (4, 2, 300, 300, True, None, None),
    "causal-gqa4": (8, 2, 333, 333, True, None, None),
    "noncausal-cross": (4, 2, 300, 333, False, None, None),
    "causal-window": (4, 2, 333, 333, True, 100, None),
    "causal-softcap": (4, 2, 300, 300, True, None, 50.0),
    "noncausal-window-softcap": (8, 2, 300, 300, False, 40, 20.0),
}


# each case at hd 128 (its own id) and at hd 64, 80 and 256 (id +
# "-hd64" ...)
WGMMA_HD_CASES = [pytest.param(c, hd, id=c if hd == 128 else f"{c}-hd{hd}")
                  for hd in (128, 64, 80, 256) for c in WGMMA_CASES]


@pytest.mark.parametrize("case,hd", WGMMA_HD_CASES)
def test_wgmma_arithmetic_matches_reference(case, hd):
    h, kvh, sq, skv, causal, window, softcap = WGMMA_CASES[case]
    q, k, v = _inputs(h, kvh, sq, skv, hd=hd, b=1, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, got = _emulate_wgmma(_t(q, "bfloat16"), _t(k, "bfloat16"),
                            _t(v, "bfloat16"), **kw)
    want = jax.jit(functools.partial(JR.attention, **kw))(
        _j(q, "bfloat16"), _j(k, "bfloat16"), _j(v, "bfloat16"))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


# the limit the card tests and chip_smoke.py hold the wgmma kernel to:
# 5e-3 before the output's bf16 rounding plus one bf16 ulp of the
# reference's output (at most 2^-7 of it)
WGMMA_TOL = dict(atol=5e-3, rtol=2 ** -7)


@pytest.mark.parametrize("h,kvh,s", [(4, 2, 300), (8, 2, 333),
                                     (4, 2, 1024)])
@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
def test_wgmma_p_in_bf16_moves_output_within_its_stated_bound(qk, h, kvh, s):
    """What the kernel's header states, causal, with v at N(0,1) and q, k
    at qk N(0,1): 0.5 (the smoke's first shapes) gives a flat softmax, 2
    a peaked one whose row max moves between kv tiles.  Rounding P to
    bf16 for P.V moves the output by at most 4e-3 (flat) or 5e-3 (peaked)
    before its bf16 rounding and by at most one bf16 ulp after it, so the
    rounded output is within WGMMA_TOL of the reference's."""
    _p_in_bf16_within_bound(qk, h, kvh, s, 128)


@pytest.mark.parametrize("h,kvh,s", [(4, 2, 300), (8, 2, 333),
                                     (4, 2, 1024)])
@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
def test_wgmma_hd64_p_in_bf16_moves_output_within_its_stated_bound(qk, h,
                                                                   kvh, s):
    """The same bound at hd 64 (granite's head dim), which the kernel's
    header states for both head dims: measured at most 3.6e-3 before the
    output's rounding."""
    _p_in_bf16_within_bound(qk, h, kvh, s, 64)


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("h,kvh,s", [(4, 2, 300), (8, 2, 333),
                                     (4, 2, 1024)])
@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
def test_wgmma_hd80_hd256_p_in_bf16_moves_output_within_its_stated_bound(
        qk, h, kvh, s, hd):
    """The same bound at stablelm-3b's hd 80 (the hd-128 instance on
    zero-filled tiles) and gemma3-4b's hd 256 (64-key tiles)."""
    _p_in_bf16_within_bound(qk, h, kvh, s, hd)


# whisper-tiny's attention (MHA, 6 / 6 heads, hd 64, not causal): the
# encoder's self-attention over 1,500 frames (11 full 128-key tiles and a
# ragged 92), the decoder's cross-attention of 376 serving and 128
# training rows against them
WHISPER_SHAPES = [(1500, 1500), (376, 1500), (128, 1500)]


@pytest.mark.parametrize("sq,skv", WHISPER_SHAPES,
                         ids=[f"{a}x{b}" for a, b in WHISPER_SHAPES])
@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
def test_wgmma_whisper_shapes_within_the_stated_bound(qk, sq, skv):
    """The same bound at whisper's shapes, not causal: every query row
    sees all 1,500 keys, the last kv tile ragged."""
    _p_in_bf16_within_bound(qk, 6, 6, sq, 64, skv=skv, causal=False)


def _p_in_bf16_within_bound(qk, h, kvh, s, hd, skv=None, causal=True):
    rng = np.random.default_rng(0)
    skv = s if skv is None else skv
    q = (rng.standard_normal((1, h, s, hd)) * qk).astype(np.float32)
    k = (rng.standard_normal((1, kvh, skv, hd)) * qk).astype(np.float32)
    v = rng.standard_normal((1, kvh, skv, hd)).astype(np.float32)
    qt, kt, vt = (_t(a, "bfloat16") for a in (q, k, v))
    o_b, ob_b = _emulate_wgmma(qt, kt, vt, causal=causal)
    o_f, _ = _emulate_wgmma(qt, kt, vt, causal=causal, p_bf16=False)
    assert float((o_b - o_f).abs().max()) <= (4e-3 if qk < 1 else 5e-3)
    ulp = torch.finfo(torch.bfloat16).eps * o_f.abs().clamp_min(1.0)
    assert bool(((ob_b.float() - o_f.bfloat16().float()).abs()
                 <= ulp).all())
    want = jax.jit(functools.partial(JR.attention, causal=causal))(
        _j(q, "bfloat16"), _j(k, "bfloat16"), _j(v, "bfloat16"))
    np.testing.assert_allclose(_np(ob_b), _np(want), **WGMMA_TOL)


@pytest.mark.parametrize("case,hd", [
    p for p in WGMMA_HD_CASES
    if WGMMA_CASES[p.values[0]][2] == WGMMA_CASES[p.values[0]][3]])
def test_wgmma_arithmetic_matches_blocked_attention(case, hd):
    """Against the model's online softmax (blocks of the kernel's kv
    tile: 128, 64 at hd 256), in the model's [b, 1, s, h, hd] layout."""
    h, kvh, s, _, causal, window, softcap = WGMMA_CASES[case]
    q, k, v = _inputs(h, kvh, s, s, hd=hd, b=1, seed=4)
    _, got = _emulate_wgmma(_t(q, "bfloat16"), _t(k, "bfloat16"),
                            _t(v, "bfloat16"), causal=causal, window=window,
                            softcap=softcap)
    want = _blocked(causal, window, softcap, s=s, block=FA.fwd_keys(hd))(
        _j(q.transpose(0, 2, 1, 3)[:, None], "bfloat16"),
        _j(k.transpose(0, 2, 1, 3), "bfloat16"),
        _j(v.transpose(0, 2, 1, 3), "bfloat16"))
    np.testing.assert_allclose(_np(got),
                               _np(want)[:, 0].transpose(0, 2, 1, 3),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_depends_on_dtype_and_head_dim_alone(hd, dtype):
    q = torch.zeros(1, 2, 5, hd, dtype=getattr(torch, dtype))
    want = ("wgmma" if dtype == "bfloat16" and hd in (64, 80, 128, 256)
            else "simt")
    assert FA.route(q) == want
    assert FA.route(q.transpose(1, 2).contiguous().transpose(1, 2)) == want
    assert FA.bwd_route(q) == want            # the backward's own table


def test_wgmma_route_takes_the_models_strided_views():
    q = torch.zeros(2, 70, 6, 128, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(2, 70, 3, 128, dtype=torch.bfloat16).transpose(1, 2)
    FA.validate_tma(q, kv, kv)
    one = torch.zeros(1, 1, 9, 128, dtype=torch.bfloat16)
    FA.validate_tma(one, one, one)          # size-1 dims: any stride
    q = torch.zeros(2, 70, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(2, 70, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    FA.validate_tma(q, kv, kv)              # hd 64: granite's views
    qkv = torch.zeros(2, 70, 3 * 32 * 80, dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 70, 32, 80).transpose(1, 2)
               for t in qkv.split(32 * 80, dim=-1))
    FA.validate_tma(q, k, v)                # hd 80: a fused projection's
    q = torch.zeros(2, 70, 8, 256, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(2, 70, 4, 256, dtype=torch.bfloat16).transpose(1, 2)
    FA.validate_tma(q, kv, kv)              # hd 256: gemma3's views


def _misaligned():
    bf = dict(dtype=torch.bfloat16)
    ok = torch.zeros(1, 4, 20, 128, **bf)
    kv = torch.zeros(1, 2, 20, 128, **bf)
    yield "seq stride", torch.zeros(1, 4, 20, 132, **bf)[..., :128], kv, kv
    yield "head stride", torch.zeros(1, 20, 4 * 128 + 4, **bf)[
        ..., :512].reshape(1, 20, 4, 128).transpose(1, 2), kv, kv
    yield "base", ok, torch.zeros(2 * 20 * 128 + 1, **bf)[1:].reshape(
        1, 2, 20, 128), kv
    yield "expanded", ok, torch.zeros(1, 1, 20, 128, **bf).expand(
        1, 2, 20, 128), kv


@pytest.mark.parametrize("what,q,k,v", list(_misaligned()),
                         ids=[w for w, *_ in _misaligned()])
def test_wgmma_route_refuses_what_tma_cannot_address(what, q, k, v):
    FA.validate(q, k, v, None, None)         # the SIMT kernel takes them
    assert FA.route(q) == "wgmma"
    with pytest.raises(ValueError, match="TMA"):
        FA.validate_tma(q, k, v)


def _attn_pairs(sq, skv, causal, window):
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


WALK_CASES = [
    (2048, 2048, True, None), (300, 300, True, None), (333, 333, True, 100),
    (520, 520, True, 33), (300, 333, False, None), (333, 517, False, 40),
    (1, 1, True, None), (129, 128, True, None), (2300, 2300, True, 1024),
    (1500, 1500, False, None), (376, 1500, False, None),
    (128, 1500, False, None)]


@pytest.mark.parametrize("sq,skv,causal,window", WALK_CASES)
def test_tile_walk_covers_exactly_the_visible_pairs(sq, skv, causal, window):
    """The forward's walk at hd 64 / 80 / 128 (128-key tiles): every
    visible pair once, no tile all masked, heaviest first."""
    assert FA.tile_walk(sq, skv, causal, window) == FA.tile_walk(
        sq, skv, causal, window, 80)
    _walk_covers(sq, skv, causal, window, 128)


@pytest.mark.parametrize("sq,skv,causal,window", WALK_CASES)
def test_tile_walk_hd256_covers_exactly_the_visible_pairs(sq, skv, causal,
                                                          window):
    """The same at hd 256 (64-key tiles)."""
    assert FA.fwd_keys(256) == 64
    _walk_covers(sq, skv, causal, window, 256)


def _walk_covers(sq, skv, causal, window, hd):
    T, KT = FA.WGMMA_TILE, FA.fwd_keys(hd)
    walk = FA.tile_walk(sq, skv, causal, window, hd)
    assert [qt for qt, _, _ in walk] == list(range(-(-sq // T)))[::-1]
    seen = 0
    for qt, t_lo, t_hi in walk:
        rows = np.arange(qt * T, min(sq, qt * T + T))[:, None]
        for t in range(t_lo, t_hi):
            keys = np.arange(t * KT, min(skv, t * KT + KT))[None, :]
            vis = np.ones((rows.size, keys.size), bool)
            if causal:
                vis &= keys <= rows
            if window:
                vis &= keys > rows - window
            assert vis.any(), f"tile {t} of query tile {qt} is all masked"
            seen += int(vis.sum())
    assert seen == _attn_pairs(sq, skv, causal, window)
    if causal and window is None:              # heaviest first
        n = [t_hi - t_lo for _, t_lo, t_hi in walk]
        assert n == sorted(n, reverse=True)
