"""Port parity: the blocked exact top-k (repro_torch.kernels.topk_mask's
two kernels and core/compression's selection around them) against the reference's, on numpy
inputs made from a seed.

Tolerance: none.  The plain B6 (packed words and counts) and B7 (kept and
residual) equal the reference's jnp oracles and its Pallas kernels run in
interpret mode bit for bit, the words compared as u32 patterns.
``select_topk``, ``blocked_topk_sparsify`` and ``compress_flat`` return
the reference's indices, kept values, residuals, q and scales bit for bit
on every branch: the blocked one where the sampled bracket holds (2^20,
2,105,344 and 5,242,880 elements), the sort where it misses (2^24 at
density 0.05).  Each case asserts the branch both packages took: the
reference's from its bracket (its own magnitude bits, constants and
formula; ``select_topk`` and ``blocked_topk_sparsify`` read the same one)
and, where it holds, by its Pallas launches (B6 then B7); the port's by
counting its calls of B6, B7 and the sort.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.kernels import ops as RK
from repro.kernels import ref as RR
from repro.kernels import topk_mask as RT
from repro.kernels import vc_asgd_update as RV
from repro_torch.core import compression as PC
from repro_torch.kernels import ops as PK
from repro_torch.kernels import ref as PR
from repro_torch.kernels import topk_mask as TM

torch.set_num_threads(2)

BENCH_N, BENCH_LOGICAL = 2_105_344, 2_101_504   # the bench model's bus
RAGGED_N = (1 << 20) + 4128                     # not a tile multiple


def _u32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _bytes(a) -> bytes:
    return a.numpy().tobytes() if isinstance(a, torch.Tensor) \
        else np.asarray(a).tobytes()


def _bus(n: int, seed: int, ties: bool = False) -> np.ndarray:
    """N(0, 0.02^2) f32; ``ties``: N(0, 1) rounded to quarters, so
    thousands of elements share each magnitude, across tiles and across
    the selection boundary."""
    x = np.random.default_rng(seed).standard_normal(n)
    return (np.round(4 * x) / 4 if ties else 0.02 * x).astype(np.float32)


@pytest.fixture
def spy(monkeypatch):
    """Counts the port's calls of B6, B7 and the stable sort."""
    calls = {"stats": 0, "exact": 0, "sort": 0}

    def counting(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(PK, "blocked_topk_stats",
                        counting("stats", PK.blocked_topk_stats))
    monkeypatch.setattr(PK, "threshold_sparsify_exact",
                        counting("exact", PK.threshold_sparsify_exact))
    monkeypatch.setattr(PC, "sort_topk", counting("sort", PC.sort_topk))
    return calls


def _ref_lo(x: np.ndarray, k: int) -> int:
    """The reference's sampled bracket (topk_mask.py:224-230)."""
    bits = RC._magnitude_bits(jnp.asarray(x))
    n = x.size
    sample = jnp.sort(bits[::n // RC._SAMPLE][:RC._SAMPLE])
    frac = k / n
    sigma = int((RC._SAMPLE * frac * (1.0 - frac)) ** 0.5) + 1
    off = min(RC._SAMPLE - 1, (RC._SAMPLE * k) // n + 6 * sigma + 64)
    return int(sample[RC._SAMPLE - 1 - off])


# ---------------------------------------------------------------------------
# the plain B6 and B7 against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ties", [(1 << 20, False), (1 << 20, True),
                                    (RAGGED_N, False)],
                         ids=["2^20", "2^20-ties", "ragged"])
def test_plain_stats_equal_reference(n, ties):
    x = _bus(n, 1, ties)
    k = int(n * 0.05)
    lo = _ref_lo(x, k)
    assert lo == int(PC.bracket(torch.from_numpy(x), k)[0])
    pw, pc = PR.blocked_topk_stats(torch.from_numpy(x), lo)
    assert pw.dtype == pc.dtype == torch.int32
    assert tuple(pw.shape) == (-(-n // TM.BLOCK), TM.WORDS)
    for rw, rc in (RR.blocked_topk_stats(jnp.asarray(x), lo),
                   RK.blocked_topk_stats(jnp.asarray(x), lo)):
        assert np.array_equal(_u32(pw), _u32(rw))
        assert _bytes(pc) == _bytes(rc)
    assert int(pc.sum()) == int((np.abs(x).view(np.int32) >= lo).sum())


@pytest.mark.parametrize("n,ties", [(1 << 20, False), (1 << 20, True),
                                    (RAGGED_N, True)],
                         ids=["2^20", "2^20-ties", "ragged-ties"])
def test_plain_exact_emit_equals_reference(n, ties):
    """B7's inputs are the reference's own refinement of the same bus."""
    x = _bus(n, 2, ties)
    k = int(n * 0.05)
    xj = jnp.asarray(x)
    words, counts = RK.blocked_topk_stats(xj, _ref_lo(x, k))
    nb = words.shape[0]
    tau, budget, tie_start = RT._refine(xj, words, counts, k,
                                        k + RC._MARGIN, nb)
    if ties:     # ties at tau span tiles and are cut by the budget
        assert int(budget) < int((np.abs(x) == np.float32(tau)).sum())
        assert len(set(np.asarray(tie_start).tolist())) > 2
    pk, pr = PR.threshold_sparsify_exact(
        torch.from_numpy(x), torch.tensor(np.asarray(tau)),
        torch.from_numpy(np.array(tie_start)), int(budget))
    for rk, rr in (RR.threshold_sparsify_exact(xj, tau, tie_start, budget),
                   RK.threshold_sparsify_exact(xj, tau, tie_start, budget)):
        assert _bytes(pk) == _bytes(rk) and _bytes(pr) == _bytes(rr)
    assert int((pk != 0).sum()) == k
    assert torch.equal(pk + pr, torch.from_numpy(x))   # -0.0 == 0.0


def test_popcount_and_sort_route():
    w = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x12345678],
                     dtype=torch.int64)
    assert PC.popcount(w).tolist() == [0, 1, 32, 2, 13]
    x = torch.tensor([0.5, -2.0, 2.0, 0.0, -0.5, 2.0])
    assert PC.sort_topk(x, 4).tolist() == [0, 1, 2, 5]


# ---------------------------------------------------------------------------
# select_topk / blocked_topk_sparsify / compress_flat against the reference
# ---------------------------------------------------------------------------

CASES = [(1 << 20, 0.05, True), (1 << 20, 0.01, True),
         (BENCH_N, 0.05, True), (BENCH_N, 0.01, True),
         (5 << 20, 0.05, True), (5 << 20, 0.01, True),
         (1 << 24, 0.05, False)]
IDS = [f"{n}-{d}" for n, d, _ in CASES]


def _ref_sparsify(x: np.ndarray, xj, k: int, ridx: np.ndarray):
    """(bracket held, kept, residual) of the reference's
    blocked_topk_sparsify.  Where its bracket holds, the function itself
    runs and must launch B6 then B7.  On a miss it runs select_topk's sort
    and scatters (topk_mask.py:234-237): built here from the reference's
    own select_topk indices, because its interpret-mode stats pass over
    2^24 elements alone takes ~12 s on a CPU."""
    lo = _ref_lo(x, k)
    c_lo = int(jnp.sum(RC._magnitude_bits(xj) >= lo))
    holds = k <= c_lo <= k + RC._MARGIN and lo > 0
    if not holds:
        kept = jnp.zeros_like(xj).at[ridx].set(xj[ridx])
        return False, kept, xj - kept
    RV.reset_launch_count()
    kept, res = RK.blocked_topk_sparsify(xj, k)
    assert RV.launch_count() == 2
    return True, kept, res


@pytest.mark.parametrize("n,density,holds", CASES, ids=IDS)
def test_select_and_sparsify_equal_reference(spy, n, density, holds):
    x = _bus(n, n % 1000 + int(density * 100))
    k = int(n * density)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ridx = np.asarray(RC.select_topk(xj, k))
    ref_holds, rk, rr = _ref_sparsify(x, xj, k, ridx)
    assert ref_holds == holds

    pidx = PC.select_topk(xt, k)
    assert pidx.dtype == torch.int32 and pidx.numel() == k
    assert _bytes(pidx) == _bytes(ridx)
    assert spy == {"stats": 1, "exact": 0, "sort": 0 if holds else 1}

    pk, pr = PC.blocked_topk_sparsify(xt, k)
    assert _bytes(pk) == _bytes(rk) and _bytes(pr) == _bytes(rr)
    assert spy == {"stats": 2, "exact": 1 if holds else 0,
                   "sort": 0 if holds else 2}


@pytest.mark.parametrize("n,density", [(1 << 20, 0.05), (BENCH_N, 0.01)],
                         ids=["2^20-0.05", "bench-0.01"])
def test_select_topk_ties_equal_reference(spy, n, density):
    x = _bus(n, 3, ties=True)
    k = int(n * density)
    ridx = np.asarray(RC.select_topk(jnp.asarray(x), k))
    pidx = PC.select_topk(torch.from_numpy(x), k)
    assert _bytes(pidx) == _bytes(ridx)
    assert spy == {"stats": 1, "exact": 0, "sort": 0}
    # the k-th magnitude is shared by elements left out: the lowest win
    mag = np.abs(x)
    tau = mag[ridx].min()
    assert (mag == tau).sum() > (mag[ridx] == tau).sum()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_compress_flat_bench_bus_equals_reference(spy, ties):
    """The pod runtime's bus: k from the logical 2,101,504 parameters,
    selection over the padded 2,105,344, with an error-feedback carry."""
    tail = np.arange(BENCH_N) < BENCH_LOGICAL
    delta = _bus(BENCH_N, 4, ties) * tail
    res = (0.1 * _bus(BENCH_N, 5)) * tail
    ref_p, ref_r = RC.compress_flat(jnp.asarray(delta), density=0.05,
                                    logical_n=BENCH_LOGICAL,
                                    residual=jnp.asarray(res))
    p, r = PC.compress_flat(torch.from_numpy(delta), density=0.05,
                            logical_n=BENCH_LOGICAL,
                            residual=torch.from_numpy(res))
    assert spy == {"stats": 1, "exact": 1, "sort": 0}
    assert p.values.numel() == int(BENCH_LOGICAL * 0.05) == 105_075
    for f in ("values", "scales", "indices"):
        assert _bytes(getattr(p, f)) == _bytes(getattr(ref_p, f)), f
    assert p.shape == ref_p.shape == (BENCH_N,)
    assert _bytes(r) == _bytes(ref_r)
    assert _bytes(PC.decompress_flat(p)) == _bytes(RC.decompress_flat(ref_p))


def test_all_zero_bus_misses_the_bracket(spy):
    """lo = 0 counts every element: the bracket misses, the sort keeps
    indices 0..k-1 (the reference's lowest-index rule)."""
    z = torch.zeros(1 << 20)
    assert PC.select_topk(z, 1000).tolist() == list(range(1000))
    assert spy == {"stats": 1, "exact": 0, "sort": 1}
    p, r = PC.compress_flat(z, density=0.001)
    assert p.indices.tolist() == list(range(1048))
    assert torch.equal(r, z) and spy["exact"] == 0


def test_small_branch_conditions_keep_the_sort(spy):
    """Each of the reference's small-branch conditions (:111) keeps the
    global sort and never reaches B6: n % 32, n < 2^20, k + 2^15 >= n."""
    odd = _bus((1 << 20) + 1, 6)
    big_k = (1 << 20) - 10
    for x, k in ((odd, 3000), (odd[:(1 << 20) - 32], 3000),
                 (odd[:1 << 20], big_k)):
        ridx = np.asarray(RC.select_topk(jnp.asarray(x), k))
        assert _bytes(PC.select_topk(torch.from_numpy(x), k)) == _bytes(ridx)
    assert spy == {"stats": 0, "exact": 0, "sort": 3}
