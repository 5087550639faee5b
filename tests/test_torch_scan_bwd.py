"""The backwards of B14 (WKV6) and B15 (the selective scan) on the CPU.

* The plain backwards (``repro_torch.kernels.ref.wkv6_bwd`` /
  ``mamba_scan_bwd``: explicit reverse recurrences, what the card's
  backward kernels are held to) against ``jax.vjp`` of the JAX package's
  ``repro.kernels.ref.wkv6`` / ``mamba_scan`` on the same numpy inputs:
  T 1, 17 and 64, hd 16, ds 4, decays of exactly 0 in some steps, and
  bf16 u for the scan.  f32: every gradient within 1e-5 of the largest
  |gradient| of its tensor (measured at most 3.3e-7); bf16 u: du, stored
  in bf16 by both, within one bf16 ulp (2^-8 relative), the rest as f32.
* The kernels' walks emulated in numpy f32 at the geometry their sources
  are built with (read from ``csrc/wkv6_bwd.cu`` and
  ``csrc/mamba_scan_bwd.cu``): the chunks in reverse, each chunk's states
  stepped forward from its checkpoint (the kernels' sub-walks re-step
  the same arithmetic, so their values are these; B14: a lane's
  ``kColsLane`` columns, the rows split over a cluster's
  ``Geometry<hd>::kRanks`` CTAs; B15: the forward's own arithmetic, 4
  states a lane, one exp a state-step), the identity steps that pad the
  last chunk, the per-lane partial sums in the kernels' order, the row
  sums over a row's lanes and the column / channel sums as pairwise
  trees over the warp's lanes, the warps' partials in warp order, the
  cluster's ranks in rank order, and the wrappers' sums of the per-(b,
  h) / per-cluster partials; other splits and geometries too, and the
  ones the sources' static_asserts refuse.  Each emulation is held
  to the plain backward and to the JAX gradient within EMU_TOL: 1e-5 of
  the tensor's largest |gradient| plus 1e-4 relative, the cuda tests'
  bound on the kernels themselves (``SCAN_BWD_TOL``): the sums associate
  differently (measured at most 5.6e-7 of the scale).  The checkpoints
  here are the states of the step-by-step recurrence; the forward
  kernel's chunked states are held to those by
  ``tests/test_torch_wkv6_chunks.py`` and ``tests/test_torch_mamba_lanes.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import ref as R

F32 = np.float32
CSRC = Path(R.__file__).parent / "csrc"
VJP_TOL = 1e-5
EMU_TOL = (1e-5, 1e-4)
BF16_ULP = 2.0 ** -8


def _constants(name: str, *names) -> dict:
    src = (CSRC / name).read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names}


def _ranks(name: str) -> dict:
    """hd -> CTAs a (b, h), from the source's Geometry<hd> (kRanks)."""
    src = (CSRC / name).read_text()
    consts = _constants(name, "kCluster")
    out = {}
    for hd, n in re.findall(r"struct Geometry<(\d+)> \{ static constexpr "
                            r"int kRanks = (\w+); \}", src):
        out[int(hd)] = int(n) if n.isdigit() else consts[n]
    return out


WKV_GEOM = {**_constants("wkv6_bwd.cu", "kChunk", "kColsLane"),
            "ranks": _ranks("wkv6_bwd.cu")}
SCAN_GEOM = _constants("mamba_scan_bwd.cu", "kThreads", "kChunk", "kStates",
                       "kCluster")


def test_geometry_matches_the_forwards_checkpoints():
    """The backwards step from the forwards' chunk checkpoints: one
    spacing in both sources and in the wrappers; the wrapper's cluster
    geometry of B15's backward is the source's, and B14's backward
    covers both head dims."""
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import rwkv6_scan as WK
    fwd = re.findall(r"kChunk = (\d+)", (CSRC / "wkv6.cu").read_text())
    assert {int(c) for c in fwd} == {WKV_GEOM["kChunk"]} == {WK.CHUNK}
    scan = _constants("mamba_scan.cu", "kChunk")
    assert scan["kChunk"] == SCAN_GEOM["kChunk"] == MK.CHUNK
    assert set(WKV_GEOM["ranks"]) == set(WK.HEAD_DIMS)
    assert MK._BWD_CLUSTER == SCAN_GEOM["kCluster"]
    for ds in MK.STATE_DIMS:
        lanes = max(ds // SCAN_GEOM["kStates"], 1)
        assert MK._BWD_CHANNELS[ds] == SCAN_GEOM["kThreads"] // lanes


def fma(a, b, c):
    """f32 fmaf: the exact product and sum, rounded once (in f64, then to
    f32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def tree(x, axis):
    """Pairwise sums over ``axis`` (a power of two long), neighbours
    first: the order of a butterfly over lane xor 1, 2, 4, ..."""
    x = np.moveaxis(x, axis, -1)
    while x.shape[-1] > 1:
        x = (x[..., 0::2] + x[..., 1::2]).astype(F32)
    return x[..., 0]


def in_order(x, axis):
    """The sum over ``axis`` from 0.0, one term after another."""
    x = np.moveaxis(x, axis, 0)
    acc = np.zeros(x.shape[1:], F32)
    for t in x:
        acc = (acc + t).astype(F32)
    return acc


# ---- inputs ----------------------------------------------------------------

def wkv_inputs(b, h, T, hd, seed, zeros=0.0):
    """The reference test_wkv6's distributions; ``zeros`` of the decays
    exactly 0 (w = exp(-exp(ww)) underflows past ww ~4.5)."""
    rng = np.random.default_rng(seed)
    rnd = lambda s=1.0: (rng.standard_normal((b, h, T, hd)) * s).astype(F32)
    r, k, v = rnd(0.4), rnd(0.4), rnd()
    w = (1 / (1 + np.exp(-rnd())) * 0.6 + 0.35).astype(F32)
    w[rng.random(w.shape) < zeros] = 0.0
    u = (rng.standard_normal((h, hd)) * 0.2).astype(F32)
    return r, k, v, w, u, rnd()


def scan_inputs(b, T, di, ds, seed):
    """The reference test_mamba_scan's distributions, D drawn."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, T, di)) * 0.4).astype(F32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, di)))).astype(F32)
    B, C = ((rng.standard_normal((b, T, ds)) * 0.4).astype(F32)
            for _ in range(2))
    A = (-np.exp(rng.standard_normal((di, ds)) * 0.3)).astype(F32)
    D = rng.standard_normal(di).astype(F32)
    dy = rng.standard_normal((b, T, di)).astype(F32)
    return u, dt, B, C, A, D, dy


def _scale_close(got, want, tol):
    """max |got - want| within tol[0] of max |want| plus tol[1] |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol[0] * max(np.abs(want).max(), 1e-30) + tol[1] * np.abs(want)
    assert np.all(np.abs(got - want) <= lim), np.abs(got - want).max()


def _jax_vjp(fn, args, cot):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(g, F32) for g in vjp(jnp.asarray(cot))]


# ---- the plain backwards against jax.vjp -----------------------------------

@pytest.mark.parametrize("zeros", [0.0, 0.3])
@pytest.mark.parametrize("T", [1, 17, 64])
def test_plain_wkv6_bwd_matches_jax_vjp(T, zeros):
    r, k, v, w, u, do = wkv_inputs(2, 3, T, 16, seed=T, zeros=zeros)
    want = _jax_vjp(JR.wkv6, (r, k, v, w, u), do)
    got = R.wkv6_bwd(*(torch.from_numpy(x) for x in (r, k, v, w, u, do)))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == wnt.shape
        _scale_close(g.numpy(), wnt, (VJP_TOL, 0.0))


@pytest.mark.parametrize("udtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 17, 64])
def test_plain_mamba_scan_bwd_matches_jax_vjp(T, udtype):
    u, dt, B, C, A, D, dy = scan_inputs(2, T, 24, 4, seed=T)
    if udtype == "bfloat16":
        ju, jdy = jnp.asarray(u, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
        tu = torch.from_numpy(u).to(torch.bfloat16)
        tdy = torch.from_numpy(dy).to(torch.bfloat16)
        # both packages start from the same bf16 values
        assert np.array_equal(np.asarray(ju, F32), tu.float().numpy())
    else:
        ju, jdy, tu, tdy = u, dy, torch.from_numpy(u), torch.from_numpy(dy)
    _, vjp = jax.vjp(JR.mamba_scan, ju, *(jnp.asarray(x)
                                          for x in (dt, B, C, A, D)))
    want = vjp(jdy)
    got = R.mamba_scan_bwd(tu, *(torch.from_numpy(x)
                                 for x in (dt, B, C, A, D)), tdy)
    assert got[0].dtype == tu.dtype
    for i, (g, wnt) in enumerate(zip(got, want)):
        g, wnt = g.float().numpy(), np.asarray(wnt, F32)
        assert g.shape == wnt.shape
        if i == 0 and udtype == "bfloat16":
            np.testing.assert_allclose(g, wnt, rtol=BF16_ULP, atol=1e-6)
        else:
            _scale_close(g, wnt, (VJP_TOL, 0.0))


# ---- B14's backward walk (csrc/wkv6_bwd.cu) --------------------------------

def wkv6_bwd_walk(r, k, v, w, u, do, geom=WKV_GEOM):
    """(dr, dk, dv, dw [b, h, T, hd], du [h, hd]) as csrc/wkv6_bwd.cu and
    its wrapper compute them, in f32: a (b, h) a cluster of ranks[hd]
    CTAs of hd / ranks rows, hd / kColsLane lanes a row, each lane the
    kColsLane columns kColsLane cq + e; the row sums a tree over the
    row's lanes, dv a tree over the warp's rows, then the warps in order,
    then the ranks in order."""
    C, CL = geom["kChunk"], geom["kColsLane"]
    b, h, T, hd = r.shape
    NC = geom["ranks"][hd]
    if hd % NC or (hd // NC) % 4:
        raise ValueError(f"{NC} CTAs do not split {hd} rows into whole "
                         f"16-byte rows")
    R, LR = hd // NC, hd // CL
    RW = 32 // LR                                 # rows a warp
    NW = R // RW                                  # warps a CTA
    nch = -(-T // C)
    pad = nch * C - T
    padded = lambda x, fill: np.concatenate(
        [x, np.full((b, h, pad, hd), fill, F32)], axis=2)
    rp, kp, vp, dop = (padded(x, 0.0) for x in (r, k, v, do))
    wp = padded(w, 1.0)                           # identity steps past T
    ui = u[None, :, :, None, None]                # [1, h, hd, 1, 1]

    def row(x, t):                                # x_t[i] at each lane
        return x[:, :, t, :, None, None]

    def col(x, t):                                # x_t[j] at each slot
        return x[:, :, t].reshape(b, h, 1, LR, CL)

    def step(S, t):                               # S <- w_t S + k_t v_t^T
        return fma(row(wp, t), S, (row(kp, t) * col(vp, t)).astype(F32))

    # the forward's state at each chunk start (the checkpoints)
    ck, S = [], np.zeros((b, h, hd, LR, CL), F32)
    for t in range(nch * C):
        if t % C == 0:
            ck.append(S)
        S = step(S, t)
    G = np.zeros_like(S)
    du = np.zeros((b, h, hd), F32)
    out = {n: np.zeros((b, h, T, hd), F32) for n in ("r", "k", "v", "w")}
    for ch in range(nch - 1, -1, -1):
        t0 = ch * C
        stash, S = [], ck[ch]                     # S_{t-1} of each step
        for l in range(C):
            stash.append(S)
            S = step(S, t0 + l)
        for l in range(C - 1, -1, -1):
            t = t0 + l
            rr, kk, ww = row(rp, t), row(kp, t), row(wp, t)
            vv, dd, Sp = col(vp, t), col(dop, t), stash[l]
            sh = fma((ui * kk).astype(F32), vv, Sp)   # S + u k v
            gh = fma((ui * rr).astype(F32), dd, G)    # G + u r do
            part = {n: np.zeros((b, h, hd, LR), F32)
                    for n in ("r", "k", "w", "vd")}
            for e in range(CL):
                part["r"] = fma(sh[..., e], dd[..., e], part["r"])
                part["k"] = fma(gh[..., e], vv[..., e], part["k"])
                part["w"] = fma(G[..., e], Sp[..., e], part["w"])
                part["vd"] = fma(vv[..., e], dd[..., e], part["vd"])
            dvl = (gh * kk).astype(F32)
            G = fma(ww, G, (rr * dd).astype(F32))
            sums = {n: tree(p, -1) for n, p in part.items()}
            du = fma((rr * kk).astype(F32)[..., 0, 0], sums["vd"], du)
            if t >= T:
                continue                          # an identity step
            for n in ("r", "k", "w"):
                out[n][:, :, t] = sums[n]
            warp = tree(dvl.reshape(b, h, NC, NW, RW, LR, CL), 4)
            out["v"][:, :, t] = in_order(in_order(warp, 3), 2).reshape(
                b, h, hd)
    return out["r"], out["k"], out["v"], out["w"], in_order(du, 0)


@pytest.mark.parametrize("zeros", [0.0, 0.3])
@pytest.mark.parametrize("hd,T", [(16, 1), (16, 15), (16, 16), (16, 17),
                                  (16, 40), (64, 1), (64, 15), (64, 16),
                                  (64, 17), (64, 40), (64, 300)])
def test_wkv6_bwd_walk_matches_plain_and_jax(hd, T, zeros):
    """The chunks in reverse (T below, at and past a chunk, ragged, many
    chunks), each stepped once from its checkpoint, the rows split over
    the cluster's CTAs, at the reduced (16) and published (64) head
    dims."""
    args = wkv_inputs(2, 2, T, hd, seed=hd + T, zeros=zeros)
    got = wkv6_bwd_walk(*args)
    plain = R.wkv6_bwd(*(torch.from_numpy(x) for x in args))
    want = _jax_vjp(JR.wkv6, args[:5], args[5])
    for g, p, j in zip(got, plain, want):
        assert np.all(np.isfinite(g))
        _scale_close(g, p.numpy(), EMU_TOL)
        _scale_close(g, j, EMU_TOL)


@pytest.mark.parametrize("hd,ranks", [(64, 1), (64, 2), (64, 8), (64, 16),
                                       (16, 2)])
def test_wkv6_bwd_walk_other_splits(hd, ranks):
    """Other splits of a head's rows over a cluster: the rank-ordered dv
    sum stays within the limits whatever the number of CTAs."""
    args = wkv_inputs(2, 2, 37, hd, seed=ranks, zeros=0.3)
    geom = {**WKV_GEOM, "ranks": {**WKV_GEOM["ranks"], hd: ranks}}
    got = wkv6_bwd_walk(*args, geom=geom)
    plain = R.wkv6_bwd(*(torch.from_numpy(x) for x in args))
    for g, p in zip(got, plain):
        _scale_close(g, p.numpy(), EMU_TOL)


@pytest.mark.parametrize("hd,ranks", [(64, 3), (64, 32), (16, 8)])
def test_wkv6_bwd_walk_refuses_a_split_that_does_not_divide(hd, ranks):
    """A split whose CTAs would not hold whole 16-byte rows (the source's
    static_assert) is refused."""
    args = wkv_inputs(1, 1, 5, hd, seed=0)
    geom = {**WKV_GEOM, "ranks": {**WKV_GEOM["ranks"], hd: ranks}}
    with pytest.raises(ValueError):
        wkv6_bwd_walk(*args, geom=geom)


# ---- B15's backward walk (csrc/mamba_scan_bwd.cu) ---------------------------

def scan_bwd_walk(u, dt, B, C, A, D, dy, geom=SCAN_GEOM):
    """(du, ddt [b, T, di], dB, dC [b, T, ds], dA [di, ds], dD [di]) as
    csrc/mamba_scan_bwd.cu and its wrapper compute them, in f32 (u f32):
    kStates states a lane, kThreads / lanes channels a CTA, kCluster CTAs
    a cluster (padded with zero channels and CTAs past di), g B and
    g A a h a tree over the channel's lanes, the CTA's dB / dC sums a tree
    over each warp's channels, then the warps in order, then the
    cluster's ranks in order, then the clusters (the wrapper)."""
    threads, chunk, states = geom["kThreads"], geom["kChunk"], \
        geom["kStates"]
    ranks = geom["kCluster"]
    b, T, di = u.shape
    ds = A.shape[1]
    L = ds // states if ds > states else 1
    st, cpb = ds // L, threads // L
    if st != 4 or threads % 32 or (chunk * 2 * ds) % ranks:
        raise ValueError("not a geometry the kernel builds")
    clusters, warps = -(-di // (cpb * ranks)), threads // 32
    dp, nch = clusters * ranks * cpb, -(-T // chunk)
    Tp = nch * chunk

    def pad(x, width):                            # zeros past T and di
        out = np.zeros((b, Tp, width), F32)
        out[:, :T, :x.shape[2]] = x
        return out
    up, dtp, dyp = pad(u, dp), pad(dt, dp), pad(dy, dp)
    Bp, Cp = pad(B, ds), pad(C, ds)
    A4 = np.zeros((dp, ds), F32)
    A4[:di] = A
    A4 = A4.reshape(dp, L, st)
    Dp = np.zeros(dp, F32)
    Dp[:di] = D

    def at(x, t):                                 # x_t[d] at each lane
        return x[:, t, :, None, None]

    def bc(x, t):                                 # x_t[s] at each lane
        return x[:, t].reshape(b, 1, L, st)

    def exp_a(t):                                 # a_t, once a state-step
        return np.exp((at(dtp, t) * A4).astype(F32)).astype(F32)

    def step(h, t, a):                            # the forward's arithmetic
        return fma(a, h, ((at(dtp, t) * at(up, t)).astype(F32)
                          * bc(Bp, t)).astype(F32))

    ck, h = [], np.zeros((b, dp, L, st), F32)
    for t in range(Tp):
        if t % chunk == 0:
            ck.append(h)
        h = step(h, t, exp_a(t))
    carry = np.zeros_like(h)
    dA = np.zeros_like(h)
    dD = np.zeros((b, dp), F32)
    du, ddt = np.zeros((b, T, di), F32), np.zeros((b, T, di), F32)
    dBC = np.zeros((b, T, clusters, 2, ds), F32)
    for ci in range(nch - 1, -1, -1):
        hs, a_s = [ck[ci]], []                    # h_{t-1}, h_t; a_t
        for i in range(chunk):
            a_s.append(exp_a(ci * chunk + i))
            hs.append(step(hs[-1], ci * chunk + i, a_s[-1]))
        for i in range(chunk - 1, -1, -1):
            t = ci * chunk + i
            dtv, uv, dyv = at(dtp, t), at(up, t), at(dyp, t)
            duv = (dtv * uv).astype(F32)
            bt, ct, hp, ht, a = bc(Bp, t), bc(Cp, t), hs[i], hs[i + 1], \
                a_s[i]
            g = fma(ct, dyv, carry)
            gah = ((g * a).astype(F32) * hp).astype(F32)
            gB = np.zeros((b, dp, L), F32)
            gAah = np.zeros((b, dp, L), F32)
            for s in range(st):
                gB = fma(g[..., s], bt[..., s], gB)
                gAah = fma(gah[..., s], A4[..., s], gAah)
            dA = fma(gah, dtv, dA)
            xb, xc = (g * duv).astype(F32), (dyv * ht).astype(F32)
            carry = (a * g).astype(F32)
            gB, gAah = tree(gB, -1), tree(gAah, -1)   # the channel's lanes
            d0, u0, y0 = dtv[..., 0, 0], uv[..., 0, 0], dyv[..., 0, 0]
            dD = fma(y0, u0, dD)
            if t >= T:
                continue                          # an identity step
            du[:, t] = fma(Dp, y0, (d0 * gB).astype(F32))[:, :di]
            ddt[:, t] = fma(u0, gB, gAah)[:, :di]
            for n, x in enumerate((xb, xc)):      # [b, dp, L, st]
                x = x.reshape(b, clusters, ranks, warps, 32 // L, L * st)
                dBC[:, t, :, n] = in_order(in_order(tree(x, 4), 3), 2)
    dBC = in_order(dBC, 2)
    return (du, ddt, dBC[:, :, 0], dBC[:, :, 1],
            in_order(dA.reshape(b, dp, ds), 0)[:di],
            in_order(dD, 0)[:di])


@pytest.mark.parametrize("di,ds,T", [(100, 16, 17), (64, 16, 1),
                                     (130, 4, 40), (37, 4, 16),
                                     (200, 16, 33), (64, 16, 15),
                                     (70, 16, 300), (300, 16, 40),
                                     (50, 4, 15),
                                     (1100, 4, 16)])
def test_scan_bwd_walk_matches_plain_and_jax(di, ds, T):
    """The chunks in reverse (T below, at and past a chunk, many chunks),
    each stepped forward from its checkpoint, at jamba's reduced (4) and
    published (16) state dims, di no multiple of a CTA's channels, CTAs
    past di padding a cluster, two clusters a row."""
    args = scan_inputs(2, T, di, ds, seed=di + T)
    got = scan_bwd_walk(*args)
    plain = R.mamba_scan_bwd(*(torch.from_numpy(x) for x in args))
    want = _jax_vjp(JR.mamba_scan, args[:6], args[6])
    for g, p, j in zip(got, plain, want):
        assert np.all(np.isfinite(g)) and g.shape == j.shape
        _scale_close(g, p.numpy(), EMU_TOL)
        _scale_close(g, j, EMU_TOL)


def test_scan_bwd_walk_bf16_u():
    """u and dy in bf16 (the training path's dtype): the kernel reads them
    exactly into f32 and stores du rounded once to bf16, so the walk on
    their f32 values, du rounded, is held to the plain backward run in
    bf16: du within one bf16 ulp, the rest at EMU_TOL."""
    u, dt, B, C, A, D, dy = scan_inputs(2, 40, 100, 16, seed=7)
    tu = torch.from_numpy(u).to(torch.bfloat16)
    tdy = torch.from_numpy(dy).to(torch.bfloat16)
    got = scan_bwd_walk(tu.float().numpy(), dt, B, C, A, D,
                        tdy.float().numpy())
    plain = R.mamba_scan_bwd(tu, *(torch.from_numpy(x)
                                   for x in (dt, B, C, A, D)), tdy)
    assert plain[0].dtype == torch.bfloat16
    du = torch.from_numpy(got[0]).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(du, plain[0].float().numpy(), rtol=BF16_ULP,
                               atol=1e-6)
    for g, p in zip(got[1:], plain[1:]):
        _scale_close(g, p.numpy(), EMU_TOL)


@pytest.mark.parametrize("change", [{"kCluster": 1}, {"kCluster": 4},
                                    {"kThreads": 64}, {"kThreads": 256}])
def test_scan_bwd_walk_other_geometries(change):
    """Other CTA widths and cluster sizes: the fixed-order dB / dC sums
    stay within the limits."""
    args = scan_inputs(2, 33, 300, 16, seed=3)
    got = scan_bwd_walk(*args, geom={**SCAN_GEOM, **change})
    plain = R.mamba_scan_bwd(*(torch.from_numpy(x) for x in args))
    for g, p in zip(got, plain):
        _scale_close(g, p.numpy(), EMU_TOL)


@pytest.mark.parametrize("change", [{"kStates": 8}, {"kThreads": 48},
                                    {"kCluster": 3}])
def test_scan_bwd_walk_refuses_a_geometry_the_kernel_does_not_build(change):
    """The source's static_asserts: a float4 of states a lane, whole warps,
    whole shares of a chunk's sums a rank."""
    args = scan_inputs(1, 5, 40, 16, seed=0)
    with pytest.raises(ValueError):
        scan_bwd_walk(*args, geom={**SCAN_GEOM, **change})
