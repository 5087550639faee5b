"""B14's chunk walk (``csrc/wkv6.cu``) emulated in numpy f32, held against
the plain version (``repro_torch.kernels.ref.wkv6``), the JAX package's
``repro.kernels.ref.wkv6`` and the final state of its chunked time mix
(``repro.models.rwkv.time_mix_chunked``).  No card is needed: the
kernel's arithmetic — the identity steps that pad the last chunk (r = k =
v = 0, w = 1), the running products down each column (rd = r * c_{t-1},
c_{C-1}: a span of lanes a column, each over consecutive steps, joined
by the lanes' multiplicative scan, product for product), the intra walk
over source pairs (p, C-1-p) carrying
k_s * P(s, t) forward one multiply by w_t a step, the bonus on the
intra matrix's diagonal, the inter product with the chunk's starting
state and the state update — is reproduced chunk by chunk, at the
chunk length and block size the kernel is built with (read from
``Geometry`` in ``csrc/wkv6.cu``).  The card tests
(``tests/test_torch_kernels.py``) hold the kernel itself to the plain
version.

Tolerance: 2e-5 (rtol and atol), the reference's ``test_wkv6``; the sums
associate differently from the step-by-step form (about C ulps), and
numpy's f32 sums round like the kernel's FMAs within that.  One case is
held otherwise: with w = 1 - 2^-20 everywhere at T = 300 the state sums
300 steps undecayed, and the plain version and the JAX reference are
themselves up to 5e-5 from the f64 truth, so the chunk walk is held to
the truth, no farther from it than they are (it is nearer).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import ref as JR
from repro.models import rwkv as JW
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as WK

F32 = np.float32
TOL = 2e-5


def source_geometry() -> dict:
    """head dim -> (chunk length, threads a block) as ``Geometry`` in
    csrc/wkv6.cu builds them."""
    src = (Path(WK.__file__).parent / "csrc" / "wkv6.cu").read_text()
    found = re.findall(r"struct Geometry<(\d+)> \{\s*static constexpr int "
                       r"kChunk = (\d+), kThreads = (\d+);", src)
    return {int(hd): (int(c), int(t)) for hd, c, t in found}


GEOMETRY = source_geometry()


def running_products(rc, wc, span: int):
    """rd = r * c_{t-1} and c_{C-1} over one chunk, as the kernel's
    ``span`` lanes a column form them: each lane a run of C / span steps
    from 1, the runs' totals joined by a Hillis-Steele product scan across
    the lanes, c_{t-1} = (the earlier runs' product) * (this run's)."""
    chunk = rc.shape[2]
    steps = chunk // span
    local = np.empty_like(wc)
    totals = []
    for q in range(span):
        c = np.ones(wc.shape[:2] + wc.shape[3:], F32)
        for m in range(steps):
            local[:, :, q * steps + m] = c
            c = c * wc[:, :, q * steps + m]
        totals.append(c)
    incl = list(totals)
    off = 1
    while off < span:
        incl = [incl[q] * incl[q - off] if q >= off else incl[q]
                for q in range(span)]
        off *= 2
    rd = np.empty_like(rc)
    for q in range(span):
        before = incl[q - 1] if q else np.ones_like(incl[0])
        for m in range(steps):
            t = q * steps + m
            rd[:, :, t] = rc[:, :, t] * (before * local[:, :, t])
    return rd, incl[-1]


def chunk_walk(r, k, v, w, u, chunk: int, span: int = 1):
    """out [b, h, T, hd] and S_T [b, h, hd, hd] as csrc/wkv6.cu computes
    them: chunk by chunk, in f32, the running products over ``span``
    lanes a column."""
    b, h, T, hd = r.shape
    nch = -(-T // chunk)
    pad = nch * chunk - T

    def padded(x, fill):
        return np.concatenate([x, np.full((b, h, pad, hd), fill, F32)],
                              axis=2)
    r, k, v, w = padded(r, 0), padded(k, 0), padded(v, 0), padded(w, 1)
    out = np.zeros((b, h, T, hd), F32)
    S = np.zeros((b, h, hd, hd), F32)
    for ch in range(nch):
        t0 = ch * chunk
        rc, kc, wc, vc = (x[:, :, t0:t0 + chunk] for x in (r, k, w, v))
        # 1a. running products down each column
        rd, c = running_products(rc, wc, span)
        # 1b. the intra walk, a pair of sources a thread group
        A = np.zeros((b, h, chunk, chunk), F32)
        kd = np.empty_like(kc)
        for p in range(chunk // 2):
            for s in (p, chunk - 1 - p):
                x = kc[:, :, s].copy()
                A[:, :, s, s] = (rc[:, :, s] * (u * x)).sum(-1, dtype=F32)
                for t in range(s + 1, chunk):
                    A[:, :, t, s] = (rc[:, :, t] * x).sum(-1, dtype=F32)
                    x = x * wc[:, :, t]
                kd[:, :, s] = x
        # 2a. inter + intra (bonus on the diagonal); 2b. the state
        o = (np.einsum("bhti,bhij->bhtj", rd, S)
             + np.einsum("bhts,bhsj->bhtj", A, vc)).astype(F32)
        n = min(chunk, T - t0)
        out[:, :, t0:t0 + n] = o[:, :, :n]
        S = (c[..., None] * S
             + np.einsum("bhsi,bhsj->bhij", kd, vc)).astype(F32)
    return out, S


def shipped(r, k, v, w, u):
    hd = r.shape[-1]
    chunk, threads = GEOMETRY[hd]
    return chunk_walk(r, k, v, w, u, chunk, threads // hd)


def wkv6_f64(r, k, v, w, u):
    """The recurrence step by step in f64."""
    b, h, T, hd = r.shape
    r, k, v, w, u = (np.asarray(x, np.float64) for x in (r, k, v, w, u))
    S = np.zeros((b, h, hd, hd))
    outs = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(((S + u[None, :, :, None] * kv)
                     * r[:, :, t, :, None]).sum(2))
        S = w[:, :, t, :, None] * S + kv
    return np.stack(outs, 2), S


def inputs(b, h, T, hd, decay="test", seed=0):
    """The reference test_wkv6's distributions (w in (0.35, 0.95)); a
    decay case sets 30% of w to exact 0 or to the denormal 1e-40, or all
    of it to 1 - 2^-20."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, h, T, hd)) * 0.4).astype(F32)
    k = (rng.standard_normal((b, h, T, hd)) * 0.4).astype(F32)
    v = rng.standard_normal((b, h, T, hd)).astype(F32)
    w = (0.6 / (1 + np.exp(-rng.standard_normal((b, h, T, hd)))) + 0.35
         ).astype(F32)
    if decay in ("zero", "denormal"):
        w[rng.random(w.shape) < 0.3] = F32(0.0 if decay == "zero" else 1e-40)
    elif decay == "near_one":
        w[:] = F32(1.0 - 2.0 ** -20)
    u = (rng.standard_normal((h, hd)) * 0.2).astype(F32)
    return r, k, v, w, u


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, F32), rtol=TOL,
                               atol=TOL)


def _steps(hd):
    chunk = GEOMETRY[hd][0]
    return [1, chunk - 1, chunk, chunk + 1, 37, 300]


@pytest.mark.parametrize("decay", ["test", "zero", "denormal", "near_one"])
@pytest.mark.parametrize("hd,T", [(hd, T) for hd in WK.HEAD_DIMS
                                  for T in _steps(hd)])
def test_chunk_walk_matches_plain_and_reference(hd, T, decay):
    """The shipped chunk length and block size, over T below, at, just
    past and many times the chunk, with w as test_wkv6 draws it, with
    exact zeros, with denormals and near 1: finite, and out and S_T
    within 2e-5 of the plain version and of the JAX reference."""
    a = inputs(2, 2, T, hd, decay, seed=T + hd)
    out, S = shipped(*a)
    assert np.isfinite(out).all() and np.isfinite(S).all()
    plain, S_plain = (x.numpy() for x in R.wkv6(*map(torch.from_numpy, a)))
    ref = np.asarray(JR.wkv6(*map(jnp.asarray, a)))
    if decay == "near_one" and T == 300:
        truth, S_truth = wkv6_f64(*a)
        for got, others, exact in ((out, (plain, ref), truth),
                                   (S, (S_plain,), S_truth)):
            gap = np.abs(got - exact).max()
            assert gap <= max(max(np.abs(o - exact).max() for o in others),
                              TOL)
        return
    _close(out, plain)
    _close(out, ref)
    _close(S, S_plain)


@pytest.mark.parametrize("chunk,span", [(8, 1), (16, 4), (16, 2), (32, 8)])
def test_chunk_walk_any_geometry_matches_plain(chunk, span):
    """Other chunk lengths and lanes a column (the variants measured on
    the card) compute the same recurrence."""
    a = inputs(1, 2, 45, 64, seed=chunk + span)
    out, S = chunk_walk(*a, chunk, span)
    plain, S_plain = R.wkv6(*map(torch.from_numpy, a))
    _close(out, plain.numpy())
    _close(S, S_plain.numpy())


def test_zero_decay_cuts_the_past():
    """w = 0 at step t zeroes the state (S_t = k_t v_t^T): every output
    after it is that of a sequence starting at t, in the chunk walk as in
    the step-by-step form."""
    r, k, v, w, u = inputs(1, 2, 40, 16, seed=3)
    w[:, :, 20] = 0.0
    out, S = shipped(r, k, v, w, u)
    tail, S_tail = shipped(*(x[:, :, 20:] for x in (r, k, v, w)), u)
    # from step 21 on, only steps 20.. reach the state
    _close(out[:, :, 21:], tail[:, :, 1:])
    _close(S, S_tail)


def test_geometry_covers_the_head():
    """The kernel source builds every head dim the wrapper takes, and each
    one's block geometry divides as the kernel's static checks require:
    an even chunk (source pairs) of whole float4 rows, four lanes a 4 x 4
    output tile over [C][hd], a power-of-two span of lanes a column for
    the running products, a group of lanes a source pair that divides hd
    (a whole warp at hd 64, so a warp's pair is a compile-time constant
    of its branch)."""
    assert sorted(GEOMETRY) == sorted(WK.HEAD_DIMS)
    for hd, (chunk, threads) in GEOMETRY.items():
        assert chunk % 4 == 0 and (hd // 4) % 4 == 0
        assert 4 * threads == chunk * hd
        span = threads // hd
        assert span * hd == threads and span & (span - 1) == 0
        assert chunk % span == 0
        group = threads // (chunk // 2)
        assert group * (chunk // 2) == threads and hd % group == 0
        assert (chunk * hd) % threads == 0
    assert GEOMETRY[64][1] // (GEOMETRY[64][0] // 2) == 32


@pytest.mark.parametrize("s,chunk", [(37, 8), (64, 16), (5, 16), (300, 128)])
def test_chunk_walk_final_state_matches_time_mix_chunked(s, chunk):
    """The reference's own projections of one time mix (the reduced
    rwkv6, hd 16) through the chunk walk: its final state against the S
    of the reference's chunked log-space time mix, 2e-5."""
    rcfg = ref_get_reduced("rwkv6-1.6b").replace(compute_dtype="float32",
                                                 scan_chunk=chunk)
    p = JW.init_time_mix(jax.random.PRNGKey(s), rcfg)
    x = jnp.asarray(np.random.default_rng(s).standard_normal(
        (2, s, rcfg.d_model)).astype(np.float32) * 0.5)
    x_prev = jnp.concatenate([jnp.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    r, k, v, _, logw = JW._time_mix_proj(p, x, x_prev, rcfg)
    _, S_ref, _ = JW.time_mix_chunked(p, x, rcfg)
    view = lambda a: np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 2, 1, 3))
    _, S = shipped(view(r), view(k), view(v), view(jnp.exp(logw)),
                   np.asarray(p["u"], np.float32))
    _close(S, S_ref)
