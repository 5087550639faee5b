"""Port parity: repro_torch.core.compression against repro.core.compression,
on numpy inputs made from a seed.

Tolerance: none — ``compress_flat``'s values, scales and indices are
equal and its residual is bit-equal; ``decompress_flat`` is bit-equal;
the plain int8 codec (B9/B10) equals the reference's Pallas kernels run
in interpret mode, and the plain sparse-body pack (B12) equals the
reference's ``ref.pack_body`` byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.kernels import quantize as RQ
from repro.kernels import ref as RR
from repro.kernels import sparse_pack as RS
from repro_torch.convert import compressed_from_reference
from repro_torch.core import compression as PC
from repro_torch.kernels import ref as PR

torch.set_num_threads(2)

N_LOGICAL, N_PADDED = 13130, 16384         # the MLP's bus


def _bytes(a) -> bytes:
    return a.numpy().tobytes() if isinstance(a, torch.Tensor) \
        else np.asarray(a).tobytes()


def _delta(seed, n=N_PADDED, logical=N_LOGICAL, scale=1e-2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32) * np.float32(scale)
            * (np.arange(n) < logical))


def _both(delta, residual=None, **kw):
    ref = RC.compress_flat(jnp.asarray(delta),
                           residual=None if residual is None
                           else jnp.asarray(residual), **kw)
    port = PC.compress_flat(torch.from_numpy(delta),
                            residual=None if residual is None
                            else torch.from_numpy(residual), **kw)
    return ref, port


def _assert_same(ref, port):
    (rp, rres), (pp, pres) = ref, port
    for f in ("values", "scales", "indices"):
        a, b = getattr(rp, f), getattr(pp, f)
        assert np.asarray(a).dtype == b.numpy().dtype, f
        assert _bytes(a) == _bytes(b), f
    assert (rp.shape, rp.density, rp.block) == (pp.shape, pp.density,
                                                pp.block)
    assert _bytes(rres) == _bytes(pres)
    assert _bytes(RC.decompress_flat(rp)) == _bytes(PC.decompress_flat(pp))


@pytest.mark.parametrize("density,k", [(0.05, 656), (0.1, 1313)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_flat_bit_equal(density, k, with_residual):
    res = _delta(99, scale=3e-3) if with_residual else None
    ref, port = _both(_delta(int(density * 100)), res, density=density,
                      logical_n=N_LOGICAL)
    assert port[0].values.numel() == k
    _assert_same(ref, port)
    assert PC.payload_bytes(port[0]) == RC.payload_bytes(ref[0])
    assert PC.compression_ratio(port[0]) == RC.compression_ratio(ref[0])


def test_magnitude_ties_lowest_index_wins():
    # 40 entries share the largest magnitude (both signs), 30 are kept
    d = _delta(7)
    tie = np.random.default_rng(8).choice(N_LOGICAL, 40, replace=False)
    d[tie] = np.where(np.arange(40) % 2, 0.5, -0.5).astype(np.float32)
    ref, port = _both(d, density=30 / N_LOGICAL, logical_n=N_LOGICAL)
    assert port[0].values.numel() == 30
    kept = port[0].indices.numpy()
    assert np.array_equal(kept, np.sort(tie)[:30])
    _assert_same(ref, port)


@pytest.mark.parametrize("case", ["all-zero", "k=1", "k=n"])
def test_compress_flat_edges(case):
    d = np.zeros(N_PADDED, np.float32) if case == "all-zero" else _delta(11)
    kw = {"all-zero": dict(density=0.05, logical_n=N_LOGICAL),
          "k=1": dict(density=1e-6, logical_n=N_LOGICAL),
          "k=n": dict(density=1.0)}[case]
    ref, port = _both(d, **kw)
    assert port[0].values.numel() == {"all-zero": 656, "k=1": 1,
                                      "k=n": N_PADDED}[case]
    _assert_same(ref, port)


@pytest.mark.parametrize("k", [1, 255, 256, 656, 1313, 4096])
def test_plain_codec_equals_reference_pallas_interpret(k):
    """q and the dequantized values are exact against the reference's
    Pallas kernels in interpret mode.  The scales are bit-exact against
    the jnp oracle (``ref.quantize_int8``, the form ``compress_flat``
    ships); XLA compiles the interpret-mode kernel's ``max / 127`` as a
    reciprocal multiply, 1 ulp off that oracle for some blocks, which the
    reference's own test allows (tests/test_kernels.py, rtol 1e-6)."""
    x = np.random.default_rng(k).standard_normal(k).astype(np.float32) * 4
    x[k // 2] = 0.0
    rq, rs = RQ.quantize_int8(jnp.asarray(x), interpret=True)
    pq, ps = PR.quantize_int8(torch.from_numpy(x))
    assert _bytes(rq) == _bytes(pq)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-6)
    oq, os_ = RR.quantize_int8(jnp.asarray(x))
    assert _bytes(oq) == _bytes(pq) and _bytes(os_) == _bytes(ps)
    rd = RQ.dequantize_int8(jnp.asarray(pq.numpy()), jnp.asarray(ps.numpy()),
                            k, interpret=True)
    assert _bytes(rd) == _bytes(PR.dequantize_int8(pq, ps, k))
    # the compression module's codec (what ops routes on the CPU) too
    cq, cs = PC.quantize_int8(torch.from_numpy(x))
    assert torch.equal(cq, pq) and torch.equal(cs, ps)


def test_quantize_half_way_values_round_to_even():
    # scale = 127/127 = 1: x/scale lands exactly on .5 boundaries
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                 np.float32)
    rq, _ = RQ.quantize_int8(jnp.asarray(x), interpret=True)
    pq, _ = PR.quantize_int8(torch.from_numpy(x))
    assert pq.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert _bytes(rq) == _bytes(pq)


@pytest.mark.parametrize("k", [1, 656, 1313])
def test_plain_pack_body_equals_reference(k):
    d = _delta(k)
    rp, _ = RC.compress_flat(jnp.asarray(d), density=k / N_LOGICAL,
                             logical_n=N_LOGICAL)
    pp = compressed_from_reference(rp, "cpu")
    want = RR.pack_body(rp.values, rp.scales, rp.indices)
    assert _bytes(PR.pack_body(pp.values, pp.scales, pp.indices)) \
        == _bytes(want)
    assert _bytes(want) == _bytes(RS.pack_body(rp.values, rp.scales,
                                               rp.indices, interpret=True))


def test_compressed_from_reference_round_trips():
    rp, _ = RC.compress_flat(jnp.asarray(_delta(3)), density=0.05,
                             logical_n=N_LOGICAL)
    pp = compressed_from_reference(rp, "cpu")
    assert (pp.values.dtype, pp.scales.dtype, pp.indices.dtype) == (
        torch.int8, torch.float32, torch.int32)
    assert _bytes(PC.decompress_flat(pp)) == _bytes(RC.decompress_flat(rp))
