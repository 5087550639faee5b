"""B13's wgmma backward route (bf16 at hd 64, 80, 128 and 256,
csrc/flash_attention_bwd_sm90.cu) by an emulation of its arithmetic, on
the CPU, against the JAX package.

The kernel runs only on the card.  Here a test-local emulation repeats
what it computes: the forward's base-2 log-sum-exp of each row (the
wgmma forward's walk of 128-key tiles, 64 at hd 256, its running max
over the unscaled scores and its sum of the f32 P), delta = rowsum(dO o)
in f32 from the bf16 values, and the two passes in their tile walks and
sum order at each head dim (``bwd_dq_walk``: 128-row query tiles over
64-key tiles, 32 at hd 256; ``bwd_dkv_walk``: 128-key tiles, 64 at hd
256, over each query head of the group and its 64-row query tiles, 32
at hd 256; hd 80's zero-filled columns add exact zeros), with P = 2^(s c
- lse), dS = P (dP - delta),
and P and dS rounded to bf16 for the products they feed (dV, dQ, dK),
every accumulator in f32.  The emulation is held to the reference's
``repro.kernels.ref``-style plain formula (the port's
``ref.attention_bwd``, f32 throughout) and to ``jax.grad`` of the
reference's ``repro.models.layers.blocked_attention`` on the same
numpy-seeded inputs, and both walks are checked to visit every visible
(query, key) pair exactly once.

Tolerance: each gradient within 2e-2 + 2e-2 |ref| of the f32 reference
(chip_smoke.py's bf16 ``BWD_TOL``, which the card holds the kernel to):
P and dS rounded to bf16 move each gradient by under 1% of its scale,
and the gradients themselves are rounded to bf16 (2^-8 relative).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
BWD_TOL = dict(atol=2e-2, rtol=2e-2)


def _inputs(b, h, kvh, s, hd, qk, seed, skv=None):
    """q, k at qk N(0,1) (0.5: flat softmax; 2: peaked), v and dO at
    N(0,1), all rounded to bf16 values, as f32 numpy arrays: s queries,
    ``skv`` (default s) keys."""
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    arr = [rng.standard_normal(shape) * sc for shape, sc in (
        ((b, h, s, hd), qk), ((b, kvh, skv, hd), qk),
        ((b, kvh, skv, hd), 1.0), ((b, h, s, hd), 1.0))]
    return [torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
            for a in arr]


def _visible(rows, keys, causal, window):
    vis = np.ones((len(rows), len(keys)), bool)
    if causal:
        vis &= keys[None, :] <= rows[:, None]
    if window:
        vis &= keys[None, :] > rows[:, None] - window
    return torch.from_numpy(vis)


def emulate_forward(q, k, v, *, causal, window=None):
    """The wgmma forward on bf16 q / k / v: (o in bf16, lse [b, h, sq]
    f32), lse = m c + log2(max(l, 1e-30)) with m the max of the unscaled
    scores, c = scale log2(e) and l the sum of the f32 P, over the
    forward's tile walk at that head dim."""
    b, h, sq, hd = q.shape
    rep = h // k.shape[1]
    skv = k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    c = np.float32(LOG2E / math.sqrt(hd))
    o = torch.zeros(b, h, sq, hd)
    lse = torch.zeros(b, h, sq)
    T, KT = FA.WGMMA_TILE, FA.fwd_keys(hd)
    for qt, t_lo, t_hi in FA.tile_walk(sq, skv, causal, window, hd):
        rows = np.arange(qt * T, min(sq, qt * T + T))
        m = torch.full((b, h, len(rows)), -torch.inf)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), hd)
        for t in range(t_lo, t_hi):
            keys = np.arange(t * KT, min(skv, t * KT + KT))
            y = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            y = y.masked_fill(~_visible(rows, keys, causal, window),
                              -torch.inf)
            m_new = torch.maximum(m, y.amax(-1))
            mc = torch.where(m_new == -torch.inf, 0.0, m_new * c)
            alpha = torch.exp2(m * c - mc)
            p = torch.exp2(y * c - mc[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :,
                                                                     keys]
            m = m_new
        lc = l.clamp_min(1e-30)
        o[:, :, rows] = acc / lc[..., None]
        lse[:, :, rows] = m * c + torch.log2(lc)
    return o.bfloat16(), lse


def emulate_backward(q, k, v, o, do, lse, *, causal, window=None):
    """The wgmma backward's arithmetic on bf16 q / k / v / o / dO and the
    forward's lse: (dq, dk, dv) in bf16, by the kernel's two walks."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    scale = np.float32(1.0 / math.sqrt(hd))
    c = np.float32(LOG2E / math.sqrt(hd))
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    kh = kf.repeat_interleave(group, dim=1)
    vh = vf.repeat_interleave(group, dim=1)
    dq = torch.zeros(b, h, sq, hd)
    BR, BT, BK = FA.bwd_tiles(hd)
    for qt, t_lo, t_hi in FA.bwd_dq_walk(sq, skv, causal, window, hd):
        rows = np.arange(qt * BR, min(sq, qt * BR + BR))
        acc = torch.zeros(b, h, len(rows), hd)
        for t in range(t_lo, t_hi):
            keys = np.arange(t * BT, min(skv, t * BT + BT))
            s = qf[:, :, rows] @ kh[:, :, keys].transpose(-1, -2)
            p = torch.exp2(s * c - lse[:, :, rows, None])
            p = torch.where(_visible(rows, keys, causal, window), p, 0.0)
            dp = dof[:, :, rows] @ vh[:, :, keys].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows, None])
            acc = acc + ds.bfloat16().float() @ kh[:, :, keys]
        dq[:, :, rows] = acc * scale
    dk = torch.zeros(b, kvh, skv, hd)
    dv = torch.zeros(b, kvh, skv, hd)
    for kt, steps in FA.bwd_dkv_walk(sq, skv, group, causal, window, hd):
        keys = np.arange(kt * BK, min(skv, kt * BK + BK))
        ak = torch.zeros(b, kvh, len(keys), hd)
        av = torch.zeros(b, kvh, len(keys), hd)
        for g, qt in steps:
            heads = np.arange(kvh) * group + g      # each kv head's g-th
            rows = np.arange(qt * BT, min(sq, qt * BT + BT))
            qq = qf[:, heads][:, :, rows]
            dd = dof[:, heads][:, :, rows]
            st = kf[:, :, keys] @ qq.transpose(-1, -2)
            pt = torch.exp2(st * c - lse[:, heads][:, :, None, rows])
            pt = torch.where(_visible(rows, keys, causal, window).T, pt, 0.0)
            dpt = vf[:, :, keys] @ dd.transpose(-1, -2)
            dst = pt * (dpt - delta[:, heads][:, :, None, rows])
            av = av + pt.bfloat16().float() @ dd
            ak = ak + dst.bfloat16().float() @ qq
        dk[:, :, keys] = ak * scale
        dv[:, :, keys] = av
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _emulated(q, k, v, do, causal, window):
    qt, kt, vt, dot = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = emulate_forward(qt, kt, vt, causal=causal, window=window)
    return emulate_backward(qt, kt, vt, o, dot, lse, causal=causal,
                            window=window)


def _plain(q, k, v, o, do, causal, window):
    """ref.attention_bwd in f32 on the same (bf16-valued) inputs."""
    return R.attention_bwd(*(torch.as_tensor(a).float()
                             for a in (q, k, v, o, do)),
                           causal=causal, window=window)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(causal, window, block=64):
    """jax.grad of the reference's blocked_attention (f32, blocks of
    ``block``) against the output gradient, jitted once per mask."""
    def f(q_, k_, v_, do_):
        pos = np.arange(q_.shape[1], dtype=np.int32)   # trace-time constants
        kpos = np.arange(k_.shape[1], dtype=np.int32)
        o = JL.blocked_attention(q_[:, None], k_, v_, causal=causal,
                                 window=window, q_positions=pos[None],
                                 kv_positions=kpos, q_block=block,
                                 kv_block=block)
        return jnp.sum(o[:, 0] * do_)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


def _jax_grad(q, k, v, do, causal, window, block=64):
    """``_jax_grad_fn`` in the port's [b, h, s, hd] layout."""
    g = _jax_grad_fn(causal, window, block)(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, do)))
    return [np.asarray(x).transpose(0, 2, 1, 3) for x in g]


def _share(got, want, atol=BWD_TOL["atol"]) -> float:
    """The largest share of its limit, atol + 2e-2 |want|, that any
    element takes (<= 1: within)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    lim = atol + BWD_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / lim).max())


# (h, kvh) for GQA groups 1, 2, 4; sq = skv
GROUPS = {1: (4, 4), 2: (4, 2), 4: (8, 2)}
CASES = [(hd, grp, s, w) for hd in (64, 128, 80, 256) for grp in GROUPS
         for s in (63, 128, 300) for w in (None, 48)]
IDS = [f"hd{hd}-g{g}-s{s}-{'w48' if w else 'causal'}"
       for hd, g, s, w in CASES]


@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
@pytest.mark.parametrize("hd,grp,s,window", CASES, ids=IDS)
def test_emulated_backward_matches_plain_formula(hd, grp, s, window, qk):
    """The backward's own arithmetic: the emulation against
    ref.attention_bwd on the same o (the emulated wgmma forward's bf16
    output), within 2e-2 + 2e-2 |ref| (measured: at most 0.76 of it,
    peaked hd 128)."""
    h, kvh = GROUPS[grp]
    q, k, v, do = _inputs(1, h, kvh, s, hd, qk, seed=hd + grp + s)
    qt, kt, vt, dot = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = emulate_forward(qt, kt, vt, causal=True, window=window)
    got = emulate_backward(qt, kt, vt, o, dot, lse, causal=True,
                           window=window)
    want = _plain(q, k, v, o, do, True, window)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.bfloat16 and g_.shape == w_.shape
        assert _share(g_, w_) <= 1.0, (name, _share(g_, w_))


# end to end (o from the bf16 forward) against the f32 gradient, atol by
# the scores' spread: q, k at 0.5 N(0,1) (flat) and N(0,1) (the card
# tests' draw) within 2e-2 + 2e-2 |ref| (measured: 0.012 + 2e-2 |ref|);
# peaked (2 N(0,1)) within 6e-2 + 2e-2 |ref| (measured 0.046 + 2e-2
# |ref|): where one key dominates, dP - delta cancels (o is close to that
# key's v), so the rounding of the forward's bf16 o, which delta reads,
# reaches dq and dk
E2E_ATOL = {0.5: 2e-2, 1.0: 2e-2, 2.0: 6e-2}
# every head dim, group and mode at the ragged length, and the other
# lengths at GQA 2
JAX_CASES = ([(hd, grp, 300, w) for hd in (64, 128, 80, 256)
              for grp in GROUPS for w in (None, 48)]
             + [(hd, 2, s, None) for hd in (64, 128, 80, 256)
                for s in (63, 128)])


@pytest.mark.parametrize("qk", [0.5, 1.0, 2.0], ids=["flat", "unit",
                                                     "peaked"])
@pytest.mark.parametrize("hd,grp,s,window", JAX_CASES, ids=[
    f"hd{hd}-g{g}-s{s}-{'w48' if w else 'causal'}"
    for hd, g, s, w in JAX_CASES])
def test_emulated_backward_matches_jax_grad_of_blocked_attention(
        hd, grp, s, window, qk):
    h, kvh = GROUPS[grp]
    q, k, v, do = _inputs(1, h, kvh, s, hd, qk, seed=7 * hd + grp + s)
    got = _emulated(q, k, v, do, True, window)
    want = _jax_grad(q, k, v, do, True, window)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        share = _share(g_, w_, E2E_ATOL[qk])
        assert share <= 1.0, (name, share)


# whisper-tiny's training attention (MHA, 6 / 6 heads, hd 64, not
# causal): the encoder's 1,500 frames (the dk / dv pass's last key tile
# holds 92 keys, the dq pass's 28) and the decoder's 128 rows against
# them in cross-attention (each of the 12 key tiles walks both 64-row
# query tiles); against the plain formula (BWD_TOL) and jax.grad
# (E2E_ATOL; blocks of 512, which XLA compiles in seconds at 1,500) as
# above
WHISPER_BWD = [(1500, 1500), (128, 1500)]


@pytest.mark.parametrize("qk", [0.5, 1.0], ids=["flat", "unit"])
@pytest.mark.parametrize("sq,skv", WHISPER_BWD,
                         ids=[f"{a}x{b}" for a, b in WHISPER_BWD])
def test_emulated_backward_at_whispers_shapes(sq, skv, qk):
    q, k, v, do = _inputs(1, 6, 6, sq, 64, qk, seed=sq + 3, skv=skv)
    qt, kt, vt, dot = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = emulate_forward(qt, kt, vt, causal=False)
    got = emulate_backward(qt, kt, vt, o, dot, lse, causal=False)
    plain = _plain(q, k, v, o, do, False, None)
    jgrad = _jax_grad(q, k, v, do, False, None, block=512)
    for name, g_, w_, j_ in zip(("dq", "dk", "dv"), got, plain, jgrad):
        assert tuple(g_.shape) == tuple(w_.shape) == j_.shape
        assert _share(g_, w_) <= 1.0, (name, _share(g_, w_))
        assert _share(g_, j_, E2E_ATOL[qk]) <= 1.0, (name, "jax")


def test_emulated_lse_normalises_every_row():
    """2^(s c - lse) sums to 1 over each row's visible keys (the backward's
    P is the forward's softmax)."""
    q, k, v, _ = _inputs(1, 4, 2, 300, 64, 2.0, seed=5)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    _, lse = emulate_forward(qt, kt, vt, causal=True, window=48)
    rows = keys = np.arange(300)
    s = qt.float() @ kt.float().repeat_interleave(2, 1).transpose(-1, -2)
    p = torch.exp2(s * np.float32(LOG2E / 8.0) - lse[..., None])
    p = torch.where(_visible(rows, keys, True, 48), p, 0.0)
    assert float((p.sum(-1) - 1).abs().max()) < 1e-5


WALKS = [(63, 63, True, None), (128, 128, True, None), (300, 300, True, 48),
         (300, 300, True, None), (129, 128, True, None), (300, 333, False, None),
         (333, 517, False, 40), (520, 520, True, 33), (1, 1, True, None),
         (2300, 2300, True, 1024), (1500, 1500, False, None),
         (128, 1500, False, None), (376, 1500, False, None)]


def _pairs(sq, skv, causal, window):
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,skv,causal,window", WALKS)
def test_dkv_walk_visits_each_visible_pair_once(sq, skv, causal, window,
                                                group):
    """Each (query head, query, key) pair the mask leaves is visited by
    exactly one step of one key tile, and every step sees a pair (hd 64,
    80 and 128: 128-key tiles over 64-row query tiles)."""
    assert FA.bwd_dkv_walk(sq, skv, group, causal, window) == \
        FA.bwd_dkv_walk(sq, skv, group, causal, window, 80)
    _dkv_walk_once(sq, skv, causal, window, group, 128)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,skv,causal,window", WALKS)
def test_dkv_walk_hd256_visits_each_visible_pair_once(sq, skv, causal,
                                                      window, group):
    """The same at hd 256: 64-key tiles over 32-row query tiles."""
    assert FA.bwd_tiles(256) == (128, 32, 64)
    _dkv_walk_once(sq, skv, causal, window, group, 256)


def _dkv_walk_once(sq, skv, causal, window, group, hd):
    seen = np.zeros((group, sq, skv), np.int32)
    _, BT, BK = FA.bwd_tiles(hd)
    walk = FA.bwd_dkv_walk(sq, skv, group, causal, window, hd)
    assert [kt for kt, _ in walk] == list(range(-(-skv // BK)))
    for kt, steps in walk:
        keys = np.arange(kt * BK, min(skv, kt * BK + BK))
        assert [g for g, _ in steps] == sorted(g for g, _ in steps)
        for g, qt in steps:
            rows = np.arange(qt * BT, min(sq, qt * BT + BT))
            vis = _visible(rows, keys, causal, window).numpy()
            assert vis.any(), f"key tile {kt} walks query tile {qt} blind"
            seen[g][np.ix_(rows, keys)] += vis
    assert seen.max() == 1
    assert int(seen.sum()) == group * _pairs(sq, skv, causal, window)


@pytest.mark.parametrize("sq,skv,causal,window", WALKS)
def test_dq_walk_visits_each_visible_pair_once(sq, skv, causal, window):
    assert FA.bwd_dq_walk(sq, skv, causal, window) == FA.bwd_dq_walk(
        sq, skv, causal, window, 80)
    _dq_walk_once(sq, skv, causal, window, 128)


@pytest.mark.parametrize("sq,skv,causal,window", WALKS)
def test_dq_walk_hd256_visits_each_visible_pair_once(sq, skv, causal,
                                                     window):
    """hd 256: 128-row query tiles over 32-key tiles."""
    _dq_walk_once(sq, skv, causal, window, 256)


def _dq_walk_once(sq, skv, causal, window, hd):
    seen = np.zeros((sq, skv), np.int32)
    BR, BT, _ = FA.bwd_tiles(hd)
    walk = FA.bwd_dq_walk(sq, skv, causal, window, hd)
    assert [qt for qt, _, _ in walk] == list(range(-(-sq // BR)))[::-1]
    for qt, t_lo, t_hi in walk:
        rows = np.arange(qt * BR, min(sq, qt * BR + BR))
        for t in range(t_lo, t_hi):
            keys = np.arange(t * BT, min(skv, t * BT + BT))
            vis = _visible(rows, keys, causal, window).numpy()
            assert vis.any(), f"query tile {qt} walks key tile {t} blind"
            seen[np.ix_(rows, keys)] += vis
    assert seen.max() == 1
    assert int(seen.sum()) == _pairs(sq, skv, causal, window)


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_route_table(hd, dtype):
    """The backward's route from dtype and head dim alone: the wgmma
    kernel for bf16 at hd 64, 80, 128 and 256 (the forward's wgmma set),
    the SIMT kernel for the rest; every head dim of the forward has a
    backward; ``launches.ROUTES`` names both sources."""
    from repro_torch.kernels import launches
    q = torch.zeros(1, 2, 5, hd, dtype=getattr(torch, dtype))
    want = ("wgmma" if dtype == "bfloat16" and hd in (64, 80, 128, 256)
            else "simt")
    assert FA.BWD_HEAD_DIMS == FA.HEAD_DIMS
    assert FA.bwd_route(q) == want
    assert FA.bwd_route(q.transpose(1, 2).contiguous().transpose(1, 2)) == \
        want
    assert launches.ROUTES["flash_attention_bwd"] == {
        "wgmma": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "simt": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"}
    assert launches.route_counts("flash_attention_bwd").keys() == {
        "wgmma", "simt"}


def test_lse_buffer_rows_cover_every_tile_the_backward_reads():
    q = torch.zeros(2, 3, 300, 64, dtype=torch.bfloat16)
    assert FA.lse_ld(300) == 384 and FA.lse_ld(128) == 128
    assert FA.lse_buffer(q).shape == (2 * 3 * 384,)
    for kt, steps in FA.bwd_dkv_walk(300, 300, 3, False, None):
        for _, qt in steps:
            assert (qt + 1) * FA.BWD_TILE <= FA.lse_ld(300)


def test_wrappers_refuse_a_route_or_lse_that_does_not_fit():
    """A caller-named ``kernel`` must be a route that takes the inputs,
    and an lse buffer must be ``lse_buffer``'s shape; a ``do`` that no
    tensor map can address is one ``FlashAttention.backward`` copies
    first."""
    q = torch.zeros(1, 4, 70, 64, dtype=torch.bfloat16)
    assert FA._chosen(None, q, "wgmma") == "wgmma"
    assert FA._chosen("simt", q, "wgmma") == "simt"
    with pytest.raises(ValueError, match="'wgmma' or 'simt'"):
        FA._chosen("sdpa", q, "wgmma")
    with pytest.raises(ValueError, match="wgmma route takes"):
        FA._chosen("wgmma", q.float(), "simt")
    with pytest.raises(ValueError, match="wgmma route takes"):
        FA._chosen("wgmma", torch.zeros(1, 4, 70, 32, dtype=torch.bfloat16),
                   "simt")
    FA._check_stats("lse", FA.lse_buffer(q), q)
    for bad in (torch.zeros(4 * 127), FA.lse_buffer(q).double(),
                torch.zeros(2 * 4 * 128)[::2]):
        with pytest.raises(ValueError, match="lse_buffer"):
            FA._check_stats("lse", bad, q)
    do = torch.zeros(1, 1, 70, 64, dtype=torch.bfloat16).expand(1, 4, 70, 64)
    assert not FA._tma_addressable(do)
    assert FA._tma_addressable(do.contiguous())
    assert FA._tma_addressable(
        torch.zeros(1, 70, 4, 64, dtype=torch.bfloat16).transpose(1, 2))
