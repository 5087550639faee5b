"""B15's lane walk (``csrc/mamba_scan.cu``) emulated in numpy f32, held
against the plain version (``repro_torch.kernels.ref.mamba_scan``), the
JAX package's ``repro.kernels.ref.mamba_scan`` and the final state of its
chunked scan (``repro.models.mamba.mamba_chunked``).  No card is needed:
the kernel's walk is reproduced chunk by chunk at the geometry it is
built with (threads a block, steps a chunk and states a lane, read from
the source) — the staging of each chunk's u, dt, B and C rows from
memory by the kernel's own offsets (so strided B / C views, di that is
no multiple of a block's channels and the ragged last chunk are
exercised), the identity steps that pad the last chunk (u = dt = B = C
= 0), each lane's states and its partial y a step, the transposed
butterfly that sums the lanes' partials once a chunk and leaves each
lane the complete y of its own steps, and D * u.  The card tests
(``tests/test_torch_kernels.py``) hold the kernel itself to the plain
version.  The reference's Pallas ``mamba_scan`` does not run under the
installed jax (ROADMAP queue C), so it is not a party here.

Tolerance: 2e-5 (rtol and atol), the reference's ``test_mamba_scan``, on
y and h_T against the plain version and the JAX reference: the lane
split sums y's states in another order than the plain version's
``sum(-1)`` (lanes of kSt states, then pairs of lanes), and an f32 FMA
is emulated by an f64 product and sum rounded once to f32.  bf16 u: y
before its one rounding within 2e-5 of the plain version fed the
bf16-rounded u in f32, and y rounded to bf16 within 2e-2 (one bf16 ulp,
``chip_smoke.py`` ``SCAN_TOL``) of the plain version's.  The final state
against ``mamba_chunked``'s, which sums by an associative scan: 2e-5 as
well (``tests/test_torch_mamba.py`` allows the plain version 2e-4
there).
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
from repro.models import mamba as JM
from repro_torch.kernels import mamba_scan as MK
from repro_torch.kernels import ref as R

F32 = np.float32
TOL = 2e-5
SRC = Path(MK.__file__).parent / "csrc" / "mamba_scan.cu"


def source_geometry() -> dict:
    """kThreads, kChunk and kStates as csrc/mamba_scan.cu builds them."""
    src = SRC.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kThreads", "kChunk", "kStates")}


GEOMETRY = source_geometry()


def lanes_of(ds: int, states: int) -> int:
    return ds // states if ds > states else 1


def fma(a, b, c):
    """f32 fmaf: the exact product and sum, rounded once (to f64 first:
    the product of two f32 is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


class Strided:
    """A tensor as the kernel sees it: a flat buffer, an element offset and
    its (b, t) strides with a unit stride on the last dim."""

    def __init__(self, x: np.ndarray, width: int = 0, col: int = 0):
        """``x`` [b, T, n], placed at column ``col`` of rows ``width`` wide
        (0: rows of n, contiguous) of a buffer of random values."""
        b, T, n = x.shape
        width = width or n
        rng = np.random.default_rng(n + width)
        full = rng.standard_normal((b, T, width)).astype(x.dtype)
        full[..., col:col + n] = x
        self.flat, self.off = full.reshape(-1), col
        self.st = (T * width, width)


def lane_walk(u, dt, B, C, A, D, geometry=GEOMETRY):
    """(y [b, T, di] f32 before its rounding, h_T [b, di, ds]) as
    csrc/mamba_scan.cu computes them.  u, dt, B, C: ``Strided``; A [di,
    ds], D [di]."""
    threads, chunk = geometry["kThreads"], geometry["kChunk"]
    b = u.flat.size // u.st[0]
    T = u.st[0] // u.st[1]
    di, ds = A.shape
    L = lanes_of(ds, geometry["kStates"])
    st = ds // L                                 # states a lane
    cpb = threads // L                           # channels a block
    blocks = -(-di // cpb)
    rounds = L.bit_length() - 1
    mine = chunk // L
    y = np.zeros((b, T, di), F32)
    h_out = np.zeros((b, di, ds), F32)
    for bi in range(b):
        for blk in range(blocks):
            d0 = blk * cpb
            nch = min(cpb, di - d0)
            c = np.arange(cpb)                  # channel in the block
            live = c < nch
            Ab = np.zeros((cpb, ds), F32)
            Ab[live] = A[d0:d0 + nch]
            Ab = Ab.reshape(cpb, L, st)
            Db = np.zeros(cpb, F32)
            Db[live] = D[d0:d0 + nch]
            h = np.zeros((cpb, L, st), F32)
            for t0 in range(0, T, chunk):
                # stage: rows of the chunk's steps, zeros past T and di
                i = np.arange(chunk)
                ok_t = t0 + i < T
                t_safe = np.where(ok_t, t0 + i, 0)

                def rows(x, cols, ok_c):
                    at = (x.off + bi * x.st[0] + t_safe[:, None] * x.st[1]
                          + cols[None, :])
                    ok = ok_t[:, None] & ok_c[None, :]
                    return np.where(ok, x.flat[np.where(ok, at, 0)], 0)
                su = rows(u, d0 + c, live).astype(F32)
                sdt = rows(dt, d0 + c, live).astype(F32)
                s = np.arange(ds)
                sb = rows(B, s, np.ones(ds, bool)).astype(F32)
                sc = rows(C, s, np.ones(ds, bool)).astype(F32)
                # the steps: each lane its st states, its partial y a step
                p = np.zeros((cpb, L, chunk), F32)
                for k in range(chunk):
                    dtv = sdt[k][:, None, None]
                    du = (sdt[k] * su[k]).astype(F32)[:, None, None]
                    e = np.exp((dtv * Ab).astype(F32)).astype(F32)
                    bq = sb[k].reshape(1, L, st)
                    cq = sc[k].reshape(1, L, st)
                    h = fma(e, h, (du * bq).astype(F32))
                    acc = np.zeros((cpb, L), F32)
                    for e_ in range(st):
                        acc = fma(h[..., e_], cq[..., e_], acc)
                    p[..., k] = acc
                # the transposed butterfly: round r keeps the lower or
                # upper half of the remaining steps (bit r of the lane)
                # and adds the half lane xor 2^r sends
                for r in range(rounds):
                    half = chunk >> (r + 1)
                    nxt = p.copy()
                    for q in range(L):
                        upper = (q >> r) & 1
                        mate = p[:, q ^ (1 << r)]
                        # the mate, on the other side, sends this side's half
                        send = mate[:, half:2 * half] if upper else \
                            mate[:, :half]
                        keep = p[:, q, half:2 * half] if upper else \
                            p[:, q, :half]
                        nxt[:, q, :half] = (keep + send).astype(F32)
                    p = nxt
                # lane q ends with steps mine0 .. mine0 + mine - 1
                for q in range(L):
                    mine0 = sum(((q >> r) & 1) * (chunk >> (r + 1))
                                for r in range(rounds))
                    for j in range(mine):
                        k = mine0 + j
                        if t0 + k >= T:
                            continue           # an identity step: not stored
                        yv = fma(Db, su[k], p[:, q, j])
                        y[bi, t0 + k, d0:d0 + nch] = yv[:nch]
            h_out[bi, d0:d0 + nch] = h.reshape(cpb, ds)[:nch]
    return y, h_out


def inputs(b, T, di, ds, seed=0):
    """The reference test_mamba_scan's distributions."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, T, di)) * 0.4).astype(F32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, di)))).astype(F32)
    B = (rng.standard_normal((b, T, ds)) * 0.4).astype(F32)
    C = (rng.standard_normal((b, T, ds)) * 0.4).astype(F32)
    A = (-np.exp(rng.standard_normal((di, ds)) * 0.3)).astype(F32)
    D = rng.standard_normal(di).astype(F32)
    return u, dt, B, C, A, D


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want, F32), rtol=tol,
                               atol=tol)


def _steps():
    c = GEOMETRY["kChunk"]
    return [1, c - 1, c, c + 1, 37, 300]


def _channels(ds):
    return GEOMETRY["kThreads"] // lanes_of(ds, GEOMETRY["kStates"])


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("ds,T", [(ds, T) for ds in MK.STATE_DIMS
                                  for T in _steps()])
def test_lane_walk_matches_plain_and_reference(ds, T, layout):
    """The shipped geometry over T below, at, just past and many times the
    chunk, and a di one block and a ragged block wide, with B and C as
    column views of an x_proj output [dt_r | B | C] ("strided") or
    contiguous: y and h_T within 2e-5 of the plain version and of the JAX
    reference."""
    di = _channels(ds) + (_channels(ds) // 2 + 3)   # a ragged second block
    u, dt, B, C, A, D = inputs(2, T, di, ds, seed=T + ds)
    if layout == "strided":
        Bs, Cs = Strided(B, 40 + 2 * ds, 40), Strided(C, 40 + 2 * ds, 40 + ds)
    else:
        Bs, Cs = Strided(B), Strided(C)
    y, h = lane_walk(Strided(u), Strided(dt), Bs, Cs, A, D)
    plain, h_plain = (x.numpy() for x in R.mamba_scan(
        *map(torch.from_numpy, (u, dt, B, C, A, D))))
    ref = np.asarray(JR.mamba_scan(*map(jnp.asarray, (u, dt, B, C, A, D))))
    _close(y, plain)
    _close(y, ref)
    _close(h, h_plain)


@pytest.mark.parametrize("ds", MK.STATE_DIMS)
def test_lane_walk_bf16_u_rounds_y_once(ds):
    """bf16 u (the serving path's): the kernel widens u to f32, computes
    in f32 and rounds y once."""
    u, dt, B, C, A, D = inputs(2, 50, _channels(ds) + 8, ds, seed=ds)
    u16 = torch.from_numpy(u).to(torch.bfloat16)
    uf = u16.float().numpy()
    y, h = lane_walk(Strided(uf), Strided(dt), Strided(B), Strided(C), A, D)
    tB, tC, tA, tD, tdt = map(torch.from_numpy, (B, C, A, D, dt))
    plain32, h32 = R.mamba_scan(u16.float(), tdt, tB, tC, tA, tD)
    _close(y, plain32.numpy())
    _close(h, h32.numpy())
    plain16, _ = R.mamba_scan(u16, tdt, tB, tC, tA, tD)
    got16 = torch.from_numpy(y).to(torch.bfloat16).float().numpy()
    _close(got16, plain16.float().numpy(), 2e-2)


@pytest.mark.parametrize("s,chunk", [(37, 8), (64, 16), (5, 16)])
def test_lane_walk_final_state_matches_mamba_chunked(s, chunk):
    """The reference's own scan inputs of one mamba layer (the reduced
    jamba config, f32): the walk's final state equals the ssm state of the
    reference's chunked associative scan, as the plain version's does."""
    rcfg = ref_get_reduced("jamba-v0.1-52b").replace(
        compute_dtype="float32", scan_chunk=chunk)
    p = JM.init_mamba(jax.random.PRNGKey(s), rcfg)
    x = jnp.asarray(np.random.default_rng(s).standard_normal(
        (2, s, rcfg.d_model)).astype(F32) * 0.5)
    u, _, _, dt_r, B, C = JM._ssm_inputs(p, x, rcfg)
    dt = jax.nn.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    _, st = JM.mamba_chunked(p, x, rcfg)
    a = [np.array(v, F32) for v in (u, dt, B, C)]
    A = (-np.exp(np.array(p["a_log"], F32))).astype(F32)
    D = np.array(p["d_skip"], F32)
    y, h = lane_walk(*map(Strided, a), A, D)
    _close(h, st.ssm)
    plain, h_plain = R.mamba_scan(*map(torch.from_numpy, (*a, A, D)))
    _close(h, h_plain.numpy())
    _close(y, plain.numpy())


@pytest.mark.parametrize("threads,chunk,states", [(128, 16, 4),
                                                  (128, 8, 8),
                                                  (64, 16, 16)])
def test_lane_walk_any_geometry_matches_plain(threads, chunk, states):
    """Other block sizes, chunk lengths and states a lane (the variants
    measured on the card: 4, 2 and 1 lanes a channel at ds 16) compute
    the same scan."""
    geometry = {"kThreads": threads, "kChunk": chunk, "kStates": states}
    u, dt, B, C, A, D = inputs(1, 45, 70, 16, seed=threads + chunk)
    y, h = lane_walk(*map(Strided, (u, dt, B, C)), A, D, geometry)
    plain, h_plain = R.mamba_scan(*map(torch.from_numpy, (u, dt, B, C, A,
                                                          D)))
    _close(y, plain.numpy())
    _close(h, h_plain.numpy())


def test_identity_steps_leave_the_state_unchanged():
    """Steps with u = dt = B = C = 0 (how the kernel pads the last chunk)
    multiply h by exp(0) = 1 and add nothing: the state after them is the
    state before them, bit for bit."""
    u, dt, B, C, A, D = inputs(1, 20, 40, 16, seed=5)
    _, h = lane_walk(*map(Strided, (u, dt, B, C)), A, D)
    pad = lambda x: np.concatenate([x, np.zeros_like(x[:, :7])], 1)
    _, h_padded = lane_walk(*map(Strided, map(pad, (u, dt, B, C))), A, D)
    assert np.array_equal(h, h_padded)


def test_geometry_is_the_wrappers():
    """The wrapper's channels a block (its grid-size check) are the
    kernel's: kThreads / lanes a channel at each state dim."""
    assert {ds: _channels(ds) for ds in MK.STATE_DIMS} == MK._CHANNELS
