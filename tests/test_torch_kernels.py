"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips without a GPU
(decided inside the fixture, never at import); run them on a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Tolerance: none — Eq. 1, Eq. 2, Adam and the elastic EASGD round are
bit-exact against the plain versions on the same CUDA tensors (both sides
spell out separate f32 multiplies and adds and IEEE division/sqrt); the
int8 quantize/dequantize and the sparse-body pack are bit-exact too (IEEE
division, round half to even, byte copies).  Flash attention (B13) sums
in another order than the plain version's matmuls and scales the dot
product where the plain version divides it: 2e-5 in f32 (the reference's
own blocked-vs-plain tolerance) and tests/test_kernels.py::TOL in bf16
(2e-2, outputs rounded to bf16) on the SIMT route; on the wgmma route
(bf16 at hd 128), which also rounds P to bf16 for the P.V product, the
bound its source states: 5e-3 plus one bf16 ulp of |plain| (2^-7
relative).  The WKV6 recurrence (B14) likewise sums in another order: 2e-5 in f32 (the reference's test_wkv6 tolerance), 2e-2
on bf16 outputs.  The selective scan (B15) fuses its multiply-adds where
the plain version rounds each product: 2e-5 on y in f32 and on the f32
final state (the reference's test_mamba_scan tolerance), 2e-2 on y
rounded to bf16.  The blocked top-k passes (B6, B7) are bit-exact: packed
words, counts, kept and residual equal the plain versions' (integer
compares and one IEEE subtraction), and the whole selection on the card
equals the CPU's.  Kill-and-restore training on the card (B3 every
step) is bit-equal to the uninterrupted run, and its one-pass train
records restore across devices bit for bit and re-save byte for byte.
The probe fleets (sharded bus, tier, subscribers, bf16 handouts) on the
card equal the CPU run bit for bit, bus included, with B1 once a fold;
an edge aggregator on the card leaves the hub where a flat hub lands.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as C
from repro_torch.core.flat import BLOCK
from repro_torch.kernels import flash_attention as FK
from repro_torch.kernels import launches as LA
from repro_torch.kernels import mamba_scan as MK
from repro_torch.kernels import quantize as QK
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as WK
from repro_torch.kernels import sparse_pack as SK
from repro_torch.kernels import topk_mask as TK
from repro_torch.kernels import vc_asgd_update as VK

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if b.dtype == torch.bfloat16
                              else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 2 / 3, 0.999])
def test_lerp_bit_exact(dev, dtype, alpha):
    s, c = _rand(dev, 3 * BLOCK, dtype=dtype), _rand(dev, 3 * BLOCK,
                                                     dtype=dtype, seed=1)
    VK.reset_launch_count()
    out = VK.vc_asgd_lerp_flat(s, c, alpha)
    assert VK.launch_count("vc_asgd_lerp_flat") == 1
    assert _bits_equal(out, R.vc_asgd_lerp(s, c, alpha))


# B2's client counts: each count of its own instance (1-8, weights by
# value) and its generic instance (9 and up, weights from an array)
EQ2_COUNTS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 33, 511]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EQ2_COUNTS)
def test_assimilate_bit_exact(dev, dtype, n):
    s = _rand(dev, 2 * BLOCK, dtype=dtype)
    c = _rand(dev, n, 2 * BLOCK, dtype=dtype, seed=2)
    w = [0.3 ** n] + [0.7 * 0.3 ** (n - 1 - j) for j in range(n)]
    VK.reset_launch_count()
    out = VK.assimilate_flat(s, c, w)
    assert VK.launch_count("assimilate_flat") == 1
    assert _bits_equal(out, R.assimilate(s, c, w))


# buses for B2's covering grid (64-thread blocks, one pack a thread): one
# BLOCK (8 or 16 blocks), 2^20 -/+ one BLOCK (either side of a power of
# two of blocks) and 2^23 + 3 BLOCKs (many waves of the 132 SMs); a large
# count only where its [n, N] matrix stays under 4 GB
EQ2_SIZES = [BLOCK, (1 << 20) - BLOCK, (1 << 20) + BLOCK, (1 << 23) + 3 * BLOCK]
EQ2_SIZE_CASES = [(n, size) for n in EQ2_COUNTS for size in EQ2_SIZES
                  if (n + 2) * size * 4 <= 4 << 30]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,size", EQ2_SIZE_CASES, ids=str)
def test_assimilate_bus_sizes_bit_exact(dev, dtype, n, size):
    s = _rand(dev, size, dtype=dtype, seed=40)
    c = _rand(dev, n, size, dtype=dtype, seed=41)
    s0, c0 = s.clone(), c.clone()
    w = [0.9 ** n] + [0.1 * 0.9 ** (n - 1 - j) for j in range(n)]
    VK.reset_launch_count()
    out = VK.assimilate_flat(s, c, w)
    assert VK.launch_count() == VK.launch_count("assimilate_flat") == 1
    assert out.data_ptr() not in (s.data_ptr(), c.data_ptr())
    assert _bits_equal(out, R.assimilate(s, c, w))
    torch.cuda.synchronize()
    assert _bits_equal(s, s0) and _bits_equal(c, c0)


def test_assimilate_rejects_bad_counts(dev):
    s = _rand(dev, BLOCK)
    with pytest.raises(ValueError):
        VK.assimilate_flat(s, _rand(dev, 4, BLOCK), [0.2] * 4)
    with pytest.raises(ValueError):
        VK.assimilate_flat(s, _rand(dev, VK.MAX_CLIENTS + 1, BLOCK),
                           [0.001] * (VK.MAX_CLIENTS + 2))
    with pytest.raises(ValueError):
        VK.assimilate_flat(s, _rand(dev, 2, BLOCK)[:, :BLOCK // 2],
                           [0.4, 0.3, 0.3])


def test_masked_island_fold_bf16_server_on_card(dev):
    """The pod runtime's masked Eq. 2 with a bf16 server and f32 islands
    (two dead, holding inf and nan) runs through B2 in f32 on the card
    and equals the CPU's fold bit for bit."""
    from repro_torch.runtime import vc_runtime as PV
    n, size = 4, 3 * BLOCK
    s = _rand(dev, size, seed=50).to(torch.bfloat16)
    isl = _rand(dev, n, size, seed=51)
    isl[1, ::5] = float("inf")
    isl[3, 1::5] = float("nan")
    alive = torch.tensor([True, False, True, False])
    w, w_s = PV.island_weights(n, 0.9, alive)
    VK.reset_launch_count()
    got = PV.assimilate_flat(s, isl, w, w_s)
    assert VK.launch_count("assimilate_flat") == 1
    want = PV.assimilate_flat(s.cpu(), isl.cpu(), w, w_s)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _bits_equal(got.cpu(), want)


@pytest.mark.parametrize("t,wd", [(1, 0.0), (3, 0.0), (50, 0.01)])
def test_adam_bit_exact(dev, t, wd):
    p, g, m = (_rand(dev, 2 * BLOCK, seed=k) for k in range(3))
    v = _rand(dev, 2 * BLOCK, seed=3).abs()
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
    c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
    VK.reset_launch_count()
    got = VK.adam_update_flat(p, g, m, v, 1e-3, 0.9, 0.999, 1e-8, wd, c1, c2)
    assert VK.launch_count("adam_update_flat") == 1
    want = R.adam_update(p, g, m, v, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                         c1=c1, c2=c2, weight_decay=wd)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


def test_wrappers_reject_bad_buffers(dev):
    s = _rand(dev, BLOCK)
    with pytest.raises(ValueError):
        VK.vc_asgd_lerp_flat(_rand(dev, BLOCK + 4), _rand(dev, BLOCK + 4), 0.5)
    with pytest.raises(ValueError):
        VK.vc_asgd_lerp_flat(s, s.to(torch.bfloat16), 0.5)
    with pytest.raises(ValueError):
        VK.vc_asgd_lerp_flat(_rand(dev, BLOCK + 1)[1:], s, 0.5)  # misaligned
    with pytest.raises(ValueError):
        VK.assimilate_flat(s, _rand(dev, BLOCK, 2).t(), [0.4, 0.3, 0.3])
    with pytest.raises(ValueError):
        VK.adam_update_flat(s, s.to(torch.bfloat16), s, s, 1e-3, 0.9, 0.999,
                            1e-8, 0.0, 0.1, 0.1)


def test_inputs_never_written(dev):
    s, c = _rand(dev, BLOCK), _rand(dev, BLOCK, seed=4)
    s0, c0 = s.clone(), c.clone()
    VK.vc_asgd_lerp_flat(s, c, 0.5)
    VK.assimilate_flat(s, c[None], [0.5, 0.5])
    VK.adam_update_flat(s, c, c, c.abs(), 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1,
                        0.1)
    torch.cuda.synchronize()
    assert torch.equal(s, s0) and torch.equal(c, c0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
def test_easgd_elastic_bit_exact(dev, dtype, n):
    c = _rand(dev, 2 * BLOCK, dtype=dtype, seed=5)
    x = _rand(dev, n, 2 * BLOCK, dtype=dtype, seed=6)
    VK.reset_launch_count()
    kc, kx = VK.easgd_elastic_flat(c, x, 0.05)
    assert VK.launch_count("easgd_elastic_flat") == 1
    pc, px = R.easgd_elastic(c, x, 0.05)
    assert _bits_equal(kc, pc) and _bits_equal(kx, px)


@pytest.mark.parametrize("k", [1, 255, 256, 656, 1313, 70000, 105_075,
                               6_710_886])
def test_quantize_dequantize_bit_exact(dev, k):
    x = _rand(dev, k, seed=k) * 0.01
    x[k // 2] = 0.0
    VK.reset_launch_count()
    q, s = QK.quantize_int8(x)
    pq, ps = R.quantize_int8(x)
    assert torch.equal(q, pq) and _bits_equal(s, ps)
    d = QK.dequantize_int8(q, s, k)
    assert _bits_equal(d, R.dequantize_int8(q, s, k))
    assert VK.launch_counts()["quantize_int8"] == 1
    assert VK.launch_counts()["dequantize_int8"] == 1


@pytest.mark.parametrize("block", [256, 100, 64])
@pytest.mark.parametrize("off", range(4))
@pytest.mark.parametrize("k", [4096 + r for r in range(16)])
def test_quantize_x_at_element_offsets_bit_exact(dev, k, off, block):
    """B9 at tests/test_torch_quantize_walk.py's shapes: every k mod 16, x
    a view 0-3 elements past a 16-byte boundary (1-3: the value loads),
    the wire's block and two generic ones, in ONE launch."""
    base = _rand(dev, k + 8, seed=k + off) * 0.01
    lead = (off - base.data_ptr() // 4) % 4
    x = base[lead:lead + k]
    assert x.data_ptr() % 16 == 4 * off
    VK.reset_launch_count()
    q, s = QK.quantize_int8(x, block)
    assert VK.launch_count() == VK.launch_counts()["quantize_int8"] == 1
    pq, ps = R.quantize_int8(x, block)
    assert torch.equal(q, pq) and _bits_equal(s, ps)


def test_quantize_rejects_bad_inputs(dev):
    x = _rand(dev, 300)
    for bad in (x.double(), x.cpu(), x.view(3, 100), x[::2],
                torch.zeros(0, device=dev)):
        with pytest.raises(ValueError):
            QK.quantize_int8(bad)
    with pytest.raises(ValueError):
        QK.quantize_int8(x, 0)


# B10's payloads: a k for each length of the head and the tail, the
# wire's k = 656 and 1,313, and a multi-group bus
DEQUANT_KS = [1, 7, 15, 16, 17, 31, 255, 256, 257, 271, 656, 1313, 70_001]


@pytest.mark.parametrize("off", range(16))
@pytest.mark.parametrize("k", DEQUANT_KS)
def test_dequantize_q_at_every_byte_offset_bit_exact(dev, k, off):
    """q a view starting ``off`` bytes past a 16-byte boundary: the head
    up to the boundary, packs that straddle two groups and the tail, each
    bit-equal to the plain version, in ONE launch."""
    g = torch.Generator(device=dev).manual_seed(100 * k + off)
    base = torch.randint(-127, 128, (k + 32,), generator=g, device=dev,
                         dtype=torch.int8)
    lead = (off - base.data_ptr()) % 16
    q = base[lead:lead + k]
    assert q.data_ptr() % 16 == off
    s = torch.rand(-(-k // 256), generator=g, device=dev) * 0.01
    VK.reset_launch_count()
    d = QK.dequantize_int8(q, s, k)
    assert VK.launch_count() == VK.launch_counts()["dequantize_int8"] == 1
    assert d.dtype == torch.float32 and d.shape == (k,)
    assert _bits_equal(d, R.dequantize_int8(q, s, k))


@pytest.mark.parametrize("off", [0, 3, 8])
@pytest.mark.parametrize("block", [1, 3, 16, 100, 255, 512])
def test_dequantize_other_block_sizes_bit_exact(dev, block, off):
    """The generic instance (any block but the wire's 256), q aligned and
    not: groups shorter than a pack, and groups that do not divide it."""
    k = 1000
    g = torch.Generator(device=dev).manual_seed(block + off)
    q = torch.randint(-127, 128, (k + off,), generator=g, device=dev,
                      dtype=torch.int8)[off:]
    s = torch.rand(-(-k // block), generator=g, device=dev)
    d = QK.dequantize_int8(q, s, k, block)
    assert _bits_equal(d, R.dequantize_int8(q, s, k, block))


def test_quantize_rounds_half_to_even(dev):
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                     device=dev)
    q, s = QK.quantize_int8(x)
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126] and s.item() == 1.0


# B12's payloads: every k mod 4 (the scales and index sections' shift),
# both seams, k = 1,313 and 105,075 of the port's paths
PACK_KS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 655, 656, 657, 658, 659, 660, 1313,
           4097, 105_075]


@pytest.mark.parametrize("k", PACK_KS)
def test_pack_body_bytes_equal(dev, k):
    q, s = QK.quantize_int8(_rand(dev, k, seed=k))
    idx = torch.arange(k, dtype=torch.int32, device=dev) * 3 + 1
    VK.reset_launch_count()
    body = SK.pack_body(q, s, idx)
    assert VK.launch_counts()["pack_body"] == 1
    assert body.dtype == torch.uint8 and torch.equal(body,
                                                     R.pack_body(q, s, idx))


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("k", PACK_KS)
def test_pack_body_q_at_byte_offsets_bytes_equal(dev, k, off):
    """q a slice of a larger int8 buffer, starting 1-3 bytes past a 4-byte
    boundary: the word-wide pack reads it through aligned words."""
    q0, s = QK.quantize_int8(_rand(dev, k + off, seed=k + off))
    q = q0[off:]
    s = s[:-(-k // 256)]
    idx = torch.arange(k, dtype=torch.int32, device=dev) * 5 + 2
    assert q.data_ptr() % 4 == (q0.data_ptr() + off) % 4
    VK.reset_launch_count()
    body = SK.pack_body(q, s, idx)
    assert VK.launch_count() == VK.launch_counts()["pack_body"] == 1
    assert torch.equal(body, R.pack_body(q, s, idx))


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("ng", [1, 2, 3, 4])
@pytest.mark.parametrize("k", range(1, 10))
def test_pack_body_every_seam_layout_bytes_equal(dev, k, ng, off):
    """Small bodies where the two seams share words or the last word: k
    1-9, ng 1-4 (every k and ng mod 4), q at byte offsets 0-3."""
    g = torch.Generator(device=dev).manual_seed(100 * k + 10 * ng + off)
    q = torch.randint(-127, 128, (k + off,), generator=g, device=dev,
                      dtype=torch.int8)[off:]
    s = torch.rand(ng, generator=g, device=dev)
    idx = torch.randint(0, 1 << 30, (k,), generator=g, device=dev,
                        dtype=torch.int32)
    assert torch.equal(SK.pack_body(q, s, idx), R.pack_body(q, s, idx))


EASGD_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EASGD_COUNTS)
def test_easgd_every_replica_count_bit_exact(dev, dtype, n):
    """B5 at each replica count of its own instances (1-8) and on its
    generic one (9, 17): through the wrapper on a 3-BLOCK bus, and through
    its C entry on a bus of whole 16-byte packs that is no multiple of the
    covering grid's 64-pack chunk, the outputs inside larger buffers: the
    last block's threads past the bus store nothing."""
    c = _rand(dev, 3 * BLOCK, dtype=dtype, seed=n)
    x = _rand(dev, n, 3 * BLOCK, dtype=dtype, seed=n + 1)
    VK.reset_launch_count()
    kc, kx = VK.easgd_elastic_flat(c, x, 0.05)
    assert VK.launch_count("easgd_elastic_flat") == VK.launch_count() == 1
    pc, px = R.easgd_elastic(c, x, 0.05)
    assert _bits_equal(kc, pc) and _bits_equal(kx, px)
    V = 16 // c.element_size()
    N = V * (64 * 5 + 37)
    c, x = c[:N].clone(), x[:, :N].contiguous()
    pc, px = R.easgd_elastic(c, x, 0.05)
    co = torch.full((N + 64 * V,), 7.0, dtype=dtype, device=dev)
    xo = torch.full((n * N + 64 * V,), 7.0, dtype=dtype, device=dev)
    LA.launch("easgd_elastic_flat", VK._error_string,
              VK._entry("easgd", dtype), c.get_device(), c.data_ptr(),
              x.data_ptr(), co.data_ptr(), xo.data_ptr(), 0.05, n, N)
    torch.cuda.synchronize()
    assert _bits_equal(co[:N], pc) and _bits_equal(xo[:n * N].view(n, N), px)
    assert (co[N:] == 7.0).all() and (xo[n * N:] == 7.0).all()


def test_scheme_wrappers_reject_bad_inputs(dev):
    c = _rand(dev, BLOCK)
    with pytest.raises(ValueError):
        VK.easgd_elastic_flat(c, _rand(dev, BLOCK, 2).t(), 0.1)
    with pytest.raises(ValueError):
        VK.easgd_elastic_flat(c, _rand(dev, 2, BLOCK).to(torch.bfloat16), 0.1)
    with pytest.raises(ValueError):
        QK.quantize_int8(_rand(dev, 4, 4))
    with pytest.raises(ValueError):
        QK.quantize_int8(torch.zeros(0, device=dev))
    q, s = QK.quantize_int8(_rand(dev, 300))
    with pytest.raises(ValueError):
        QK.dequantize_int8(q, s[:1], 300)
    with pytest.raises(ValueError):
        SK.pack_body(q, s, torch.zeros(300, dtype=torch.int64, device=dev))
    idx = torch.zeros(300, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        SK.pack_body(q.cpu(), s, idx)
    with pytest.raises(ValueError):
        SK.pack_body(q, s, idx[:299])
    with pytest.raises(ValueError):
        SK.pack_body(q.view(3, 100), s, idx)


def _bus(dev, n, ties=False, seed=0):
    """N(0, 0.02^2), or N(0, 1) rounded to quarters (ties across tiles and
    across the selection boundary)."""
    x = _rand(dev, n, seed=seed)
    return torch.round(4 * x) / 4 if ties else 0.02 * x


@pytest.mark.parametrize("n,ties", [(1 << 20, False), (1 << 20, True),
                                    ((1 << 20) + 4128, False),
                                    (2_105_344, False), (100, False)])
def test_topk_stats_bit_exact(dev, n, ties):
    x = _bus(dev, n, ties)
    lo = C.bracket(x, max(1, n // 20)) if n >= C.SAMPLE else 1 << 29
    TK.blocked_topk_stats(x, lo)            # warm: the build
    VK.reset_launch_count()
    words, counts = TK.blocked_topk_stats(x, lo)
    assert VK.launch_count("blocked_topk_stats") == 1
    pw, pc = R.blocked_topk_stats(x, lo)
    torch.cuda.synchronize()
    assert torch.equal(words, pw) and torch.equal(counts, pc)


@pytest.mark.parametrize("as_tensor", [True, False])
@pytest.mark.parametrize("n", [2_105_344, (1 << 20) + 4128, 1 << 27])
def test_topk_stats_lo_as_tensor_and_int_bit_exact(dev, n, as_tensor):
    """B6 at the bench bus, a ragged bus and 2^27, with ``lo`` as the
    path's device int32 [1] (read by the kernel) and as a number (by
    value), in ONE launch each."""
    x = _bus(dev, n, seed=3)
    lo = C.bracket(x, n // 20)
    arg = lo if as_tensor else int(lo)
    VK.reset_launch_count()
    words, counts = TK.blocked_topk_stats(x, arg)
    assert VK.launch_count() == VK.launch_counts()["blocked_topk_stats"] == 1
    pw, pc = R.blocked_topk_stats(x, lo)
    torch.cuda.synchronize()
    assert torch.equal(words, pw) and torch.equal(counts, pc)


def test_topk_stats_rejects_bad_inputs(dev):
    x = _rand(dev, 3 * TK.BLOCK)
    lo = torch.ones(1, dtype=torch.int32, device=dev)
    for bad in (x.double(), x.cpu(), x.view(3, -1), x[::2],
                torch.zeros(0, device=dev)):
        with pytest.raises(ValueError):
            TK.blocked_topk_stats(bad, lo)
    for bad_lo in (lo.cpu(), lo.long(), lo.float(),
                   torch.ones(2, dtype=torch.int32, device=dev), 1 << 31,
                   -(1 << 31) - 1):
        with pytest.raises(ValueError):
            TK.blocked_topk_stats(x, bad_lo)
    with pytest.raises(TypeError):
        TK.blocked_topk_stats(x, 1.5)


@pytest.mark.parametrize("n,ties", [(1 << 20, True), ((1 << 20) + 4128, True),
                                    (2_105_344, False)])
def test_topk_exact_emit_bit_exact(dev, n, ties):
    """tau is a magnitude that many elements share; the budget cuts its
    ties in the middle of the bus."""
    x = _bus(dev, n, ties, seed=1)
    mag = x.abs()
    tau = mag.sort(descending=True).values[n // 20].reshape(1)
    tie = torch.nn.functional.pad(mag == tau, (0, (-n) % TK.BLOCK))
    per = tie.reshape(-1, TK.BLOCK).sum(1, dtype=torch.int32)
    tie_start = torch.cumsum(per, 0, dtype=torch.int32) - per
    budget = torch.tensor([int(per.sum()) // 2], dtype=torch.int32,
                          device=dev)
    VK.reset_launch_count()
    kept, res = TK.threshold_sparsify_exact(x, tau, tie_start, budget)
    assert VK.launch_count("threshold_sparsify_exact") == 1
    pk, pr = R.threshold_sparsify_exact(x, tau, tie_start, budget)
    torch.cuda.synchronize()
    assert _bits_equal(kept, pk) and _bits_equal(res, pr)


@pytest.mark.parametrize("n,density", [(1 << 20, 0.05), (2_105_344, 0.01),
                                       (1 << 24, 0.05)])
def test_blocked_selection_card_equals_cpu(dev, n, density):
    x = _bus(dev, n, seed=2)
    k = int(n * density)
    VK.reset_launch_count()
    idx, kept, res = C.exact_topk(x, k, emit=True)
    counts = VK.launch_counts()
    want = C.sort_topk(x.cpu(), k)
    assert torch.equal(idx.cpu(), want)
    if n == 1 << 24:                        # the bracket misses
        assert kept is None and counts["blocked_topk_stats"] == 1
        assert counts["threshold_sparsify_exact"] == 0
        return
    assert counts["blocked_topk_stats"] == counts[
        "threshold_sparsify_exact"] == 1
    pk, pr = C.blocked_topk_sparsify(x.cpu(), k)
    assert _bits_equal(kept.cpu(), pk) and _bits_equal(res.cpu(), pr)


def test_topk_wrappers_reject_bad_inputs(dev):
    x = _rand(dev, 3 * TK.BLOCK)
    ts = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TK.blocked_topk_stats(x.double(), 1)
    with pytest.raises(ValueError):
        TK.blocked_topk_stats(x[::2], 1)
    with pytest.raises(ValueError):
        TK.blocked_topk_stats(x, torch.ones(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        TK.threshold_sparsify_exact(x, 1.0, ts[:2], 0)
    with pytest.raises(ValueError):
        TK.threshold_sparsify_exact(x, torch.ones(1, device=dev).double(),
                                    ts, 0)


@pytest.mark.parametrize("form", ["tensors", "numbers"])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [2_105_344, (1 << 20) + 4131, 1001, 19])
def test_topk_exact_emit_scalars_and_offsets_bit_exact(dev, n, off, form):
    """B7 with tau and the budget as device tensors (read by the kernel)
    and as numbers (by value), x at element offsets 0-3 from a 16-byte
    boundary (1-3 take the value-by-value path) on a tie-heavy bus whose
    budget cuts the ties of tau, n mod 4 = 0-3, in ONE launch each."""
    base = _bus(dev, n + 8, ties=True, seed=n)
    lead = (off - base.data_ptr() // 4) % 4
    x = base[lead:lead + n]
    assert x.data_ptr() % 16 == 4 * off
    mag = x.abs()
    tau = mag.sort(descending=True).values[n // 20].reshape(1)
    tie = torch.nn.functional.pad(mag == tau, (0, (-n) % TK.BLOCK))
    per = tie.reshape(-1, TK.BLOCK).sum(1, dtype=torch.int32)
    tie_start = torch.cumsum(per, 0, dtype=torch.int32) - per
    budget = torch.tensor([int(per.sum()) // 2], dtype=torch.int32,
                          device=dev)
    t, b = (tau, budget) if form == "tensors" else (float(tau), int(budget))
    VK.reset_launch_count()
    kept, res = TK.threshold_sparsify_exact(x, t, tie_start, b)
    assert VK.launch_count("threshold_sparsify_exact") == VK.launch_count() \
        == 1
    pk, pr = R.threshold_sparsify_exact(x, tau, tie_start, budget)
    torch.cuda.synchronize()
    assert _bits_equal(kept, pk) and _bits_equal(res, pr)


def test_topk_exact_rejects_bad_inputs(dev):
    x = _rand(dev, 3 * TK.BLOCK)
    ts = torch.zeros(3, dtype=torch.int32, device=dev)
    tau = torch.ones(1, device=dev)
    bud = torch.ones(1, dtype=torch.int32, device=dev)
    for bad in (x.double(), x.cpu(), x.view(3, -1), x[::2],
                torch.zeros(0, device=dev)):
        with pytest.raises(ValueError):
            TK.threshold_sparsify_exact(bad, tau, ts, bud)
    for bad_tau in (tau.cpu(), tau.double(), torch.ones(2, device=dev)):
        with pytest.raises(ValueError):
            TK.threshold_sparsify_exact(x, bad_tau, ts, bud)
    for bad_bud in (bud.cpu(), bud.long(), bud.float(),
                    torch.ones(2, dtype=torch.int32, device=dev), 1 << 31,
                    -(1 << 31) - 1):
        with pytest.raises(ValueError):
            TK.threshold_sparsify_exact(x, tau, ts, bad_bud)
    with pytest.raises(TypeError):
        TK.threshold_sparsify_exact(x, tau, ts, 1.5)
    for bad_ts in (ts.cpu(), ts.long(), ts[:2], ts.view(1, 3),
                   torch.zeros(6, dtype=torch.int32, device=dev)[::2]):
        with pytest.raises(ValueError):
            TK.threshold_sparsify_exact(x, tau, bad_ts, bud)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WGMMA_TOL = dict(atol=5e-3, rtol=2 ** -7)


def _attn_tol(q) -> dict:
    """assert_close's tolerances for the route that takes ``q``."""
    if FK.route(q) == "wgmma":
        return WGMMA_TOL
    return dict(atol=ATTN_TOL[q.dtype], rtol=ATTN_TOL[q.dtype])


def _attn_case(dev, b, h, kvh, sq, skv, hd, dtype, seed=0, qk=0.5):
    """q, k at qk N(0,1) (0.5: a flat softmax; 2: a peaked one whose row
    max moves between kv tiles), v at N(0,1)."""
    q = (_rand(dev, b, h, sq, hd, seed=seed) * qk).to(dtype)
    k = (_rand(dev, b, kvh, skv, hd, seed=seed + 1) * qk).to(dtype)
    v = _rand(dev, b, kvh, skv, hd, seed=seed + 2).to(dtype)
    return q, k, v


# the four shapes of chip_smoke's phase 6, cut down: (a) internlm2's
# prefill (GQA 2, hd 128, causal, bf16); (b) gemma3's local layers (hd
# 256, GQA 2, window, ragged); (c) non-causal cross attention with a
# softcap in f32, ragged both ways; (d) h == kvh at hd 16
ATTN_CASES = {
    "a-internlm2": dict(shape=(2, 4, 2, 300, 300, 128), dtype=torch.bfloat16,
                        causal=True, window=None, softcap=None),
    "b-gemma3-local": dict(shape=(1, 8, 4, 333, 333, 256),
                           dtype=torch.bfloat16, causal=True, window=100,
                           softcap=None),
    "c-softcap-f32": dict(shape=(1, 4, 4, 133, 217, 64), dtype=torch.float32,
                          causal=False, window=None, softcap=50.0),
    "d-mha-hd16": dict(shape=(2, 4, 4, 100, 100, 16), dtype=torch.float32,
                       causal=True, window=None, softcap=None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_matches_plain(dev, case):
    c = ATTN_CASES[case]
    q, k, v = _attn_case(dev, *c["shape"], c["dtype"])
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    VK.reset_launch_count()
    got = FK.flash_attention(q, k, v, **kw)
    assert VK.launch_count("flash_attention") == 1
    assert LA.route_counts("flash_attention")[FK.route(q)] == 1
    want = R.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(q))


@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_every_head_dim_on_strided_views(dev, hd, dtype):
    """The model's layout: [b, s, h, hd] projections read through
    transposed views (no copy), causal with a window, sq = 70 (ragged)."""
    g = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn(2, 70, 6, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 70, 3, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 70, 3, hd, generator=g, device=dev).to(dtype)
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    got = FK.flash_attention(qv, kv, vv, causal=True, window=33)
    want = R.attention(qv, kv, vv, causal=True, window=33)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(qv))
    assert got.transpose(1, 2).is_contiguous()     # [b, s, h, hd] buffer


# B13's wgmma route (bf16 at hd 128): (b, h, kvh, sq, skv, causal, window,
# softcap, qk) at internlm2's cut shape (GQA 2), jamba's GQA 4, non-causal
# sq != skv, window 33 and softcap 50, and both prefills' full shapes with
# peaked scores (q, k at 2 N(0,1)), each also on [b, s, h, hd] views
WGMMA_CASES = {
    "internlm2-cut": (2, 4, 2, 300, 300, True, None, None, 0.5),
    "jamba-gqa4": (1, 32, 8, 520, 520, True, None, None, 0.5),
    "noncausal-cross": (1, 4, 2, 133, 517, False, None, None, 0.5),
    "window-33": (2, 4, 2, 300, 300, True, 33, None, 0.5),
    "softcap-50": (2, 4, 2, 300, 300, True, None, 50.0, 0.5),
    "noncausal-window-softcap": (1, 4, 4, 333, 333, False, 100, 20.0, 0.5),
    "internlm2-prefill-peaked": (4, 16, 8, 2048, 2048, True, None, None,
                                 2.0),
    "jamba-prefill-peaked": (4, 32, 8, 2048, 2048, True, None, None, 2.0),
}


@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd-view"])
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_flash_attention_wgmma_route_matches_plain(dev, case, strided):
    b, h, kvh, sq, skv, causal, window, softcap, qk = WGMMA_CASES[case]
    q, k, v = _attn_case(dev, b, h, kvh, sq, skv, 128, torch.bfloat16,
                         qk=qk)
    if strided:         # the model's [b, s, h, hd] buffers, read in place
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    VK.reset_launch_count()
    got = FK.flash_attention(q, k, v, **kw)
    assert VK.launch_count("flash_attention") == 1
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 0}
    want = R.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **WGMMA_TOL)
    assert got.transpose(1, 2).is_contiguous()


# the wgmma forward at hd 64 (granite's head dim): (b, h, kvh, sq, skv,
# causal, window, softcap, qk), granite's prefill with peaked scores, on
# [b, s, h, hd] views too
WGMMA_HD64_CASES = {
    "granite-cut": (2, 16, 8, 300, 300, True, None, None, 0.5),
    "noncausal-cross": (1, 4, 2, 133, 517, False, None, None, 0.5),
    "window-33-peaked": (2, 4, 2, 300, 300, True, 33, None, 2.0),
    "softcap-50": (2, 4, 2, 300, 300, True, None, 50.0, 0.5),
    "granite-prefill-peaked": (4, 16, 8, 2048, 2048, True, None, None, 2.0),
}


@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd-view"])
@pytest.mark.parametrize("case", list(WGMMA_HD64_CASES))
def test_flash_attention_wgmma_route_hd64_matches_plain(dev, case, strided):
    b, h, kvh, sq, skv, causal, window, softcap, qk = WGMMA_HD64_CASES[case]
    q, k, v = _attn_case(dev, b, h, kvh, sq, skv, 64, torch.bfloat16, qk=qk)
    if strided:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    LA.reset_launch_count()
    got = FK.flash_attention(q, k, v, **kw)
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 0}
    want = R.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **WGMMA_TOL)
    # the SIMT kernel, still built for bf16 at hd 64, on the same inputs
    simt = FK.flash_attention(q, k, v, kernel="simt", **kw)
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 1}
    torch.testing.assert_close(simt.float(), want.float(),
                               atol=ATTN_TOL[torch.bfloat16],
                               rtol=ATTN_TOL[torch.bfloat16])


# the wgmma forward at stablelm-3b's hd 80 (hd 128's instance on tiles
# zero-filled past column 80) and gemma3-4b's hd 256 (64-key tiles):
# (b, h, kvh, sq, skv, causal, window, softcap, qk), each model's prefill
# with peaked scores among them, on [b, s, h, hd] views too
WGMMA_HD80_256_CASES = {
    "cut": (2, 8, 4, 300, 300, True, None, None, 0.5),
    "noncausal-cross": (1, 4, 2, 133, 517, False, None, None, 0.5),
    "window-33-peaked": (2, 4, 2, 300, 300, True, 33, None, 2.0),
    "softcap-50": (2, 4, 2, 300, 300, True, None, 50.0, 0.5),
    "one-token": (1, 2, 1, 1, 1, True, None, None, 0.5),
}
WGMMA_PREFILLS = {80: (4, 32, 32, 2048, 2048, True, None, None, 2.0),
                  256: (4, 8, 4, 2048, 2048, True, None, None, 2.0)}


@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd-view"])
@pytest.mark.parametrize("case", list(WGMMA_HD80_256_CASES) + ["prefill"])
@pytest.mark.parametrize("hd", [80, 256])
def test_flash_attention_wgmma_route_hd80_hd256_matches_plain(dev, hd, case,
                                                             strided):
    shape = (WGMMA_PREFILLS[hd] if case == "prefill"
             else WGMMA_HD80_256_CASES[case])
    b, h, kvh, sq, skv, causal, window, softcap, qk = shape
    q, k, v = _attn_case(dev, b, h, kvh, sq, skv, hd, torch.bfloat16, qk=qk)
    if strided:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    LA.reset_launch_count()
    got = FK.flash_attention(q, k, v, **kw)
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 0}
    want = R.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **WGMMA_TOL)
    assert got.transpose(1, 2).is_contiguous()
    # the SIMT kernel, still built for bf16 at hd 80 and 256, beside it
    simt = FK.flash_attention(q, k, v, kernel="simt", **kw)
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 1}
    torch.testing.assert_close(simt.float(), want.float(),
                               atol=ATTN_TOL[torch.bfloat16],
                               rtol=ATTN_TOL[torch.bfloat16])


# whisper-tiny's attention on the wgmma route (MHA, 6 / 6 heads, hd 64,
# not causal): the encoder's self-attention over 1,500 frames (its last
# 128-key tile holds 92), the decoder's cross-attention of the serving
# prompt's 376 rows and of the training step's 128 rows against them:
# (b, sq, skv), q and k flat and peaked, on [b, s, h, hd] views too
WHISPER_FWD = {"encoder": (4, 1500, 1500), "cross-serve": (4, 376, 1500),
               "cross-train": (8, 128, 1500)}


@pytest.mark.parametrize("qk", [0.5, 2.0], ids=["flat", "peaked"])
@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd-view"])
@pytest.mark.parametrize("case", list(WHISPER_FWD))
def test_flash_attention_wgmma_at_whispers_shapes(dev, case, strided, qk):
    b, sq, skv = WHISPER_FWD[case]
    q, k, v = _attn_case(dev, b, 6, 6, sq, skv, 64, torch.bfloat16, qk=qk)
    if strided:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    LA.reset_launch_count()
    got = FK.flash_attention(q, k, v, causal=False)
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 0}
    want = R.attention(q, k, v, causal=False)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **WGMMA_TOL)
    simt = FK.flash_attention(q, k, v, causal=False, kernel="simt")
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 1}
    torch.testing.assert_close(simt.float(), want.float(),
                               atol=ATTN_TOL[torch.bfloat16],
                               rtol=ATTN_TOL[torch.bfloat16])


def test_flash_attention_lse_is_the_rows_log2_sum_exp(dev):
    """The wgmma forward's lse (under autograd) is each row's base-2
    log-sum-exp of the scaled scores, and writing it changes no bit of
    the output, at every head dim of the route."""
    import math
    for hd in FK.WGMMA_HEAD_DIMS:
        q, k, v = _attn_case(dev, 2, 4, 2, 300, 300, hd, torch.bfloat16,
                             qk=2.0)
        lse = FK.lse_buffer(q)
        o = FK.flash_attention(q, k, v, causal=True, window=40, lse=lse)
        assert torch.equal(o, FK.flash_attention(q, k, v, causal=True,
                                                 window=40))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k.float().repeat_interleave(2, 1)) / math.sqrt(hd)
        i = torch.arange(300, device=dev)
        vis = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 40)
        want = torch.logsumexp(s.masked_fill(~vis, -torch.inf), -1) / \
            math.log(2.0)
        got = lse.view(2, 4, FK.lse_ld(300))[:, :, :300]
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="wgmma"):
        FK.flash_attention(q.float(), k.float(), v.float(), lse=lse)
    q, k, v = _attn_case(dev, 2, 4, 2, 300, 300, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="not built"):
        FK.flash_attention(q, k, v, kernel="simt")          # bf16 at hd 128


def test_flash_attention_wgmma_route_refuses_what_tma_cannot_address(dev):
    q, k, v = _attn_case(dev, 1, 4, 2, 64, 64, 128, torch.bfloat16)
    bad = torch.zeros(1, 4, 64, 132, dtype=torch.bfloat16,
                      device=dev)[..., :128]
    VK.reset_launch_count()
    with pytest.raises(ValueError, match="TMA"):
        FK.flash_attention(bad, k, v)
    assert VK.launch_count("flash_attention") == 0


def test_flash_attention_rejects_what_it_does_not_take(dev):
    q, k, v = _attn_case(dev, 1, 4, 2, 16, 16, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        FK.flash_attention(q, k, v)
    q, k, v = _attn_case(dev, 1, 4, 2, 16, 16, 64, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        FK.flash_attention(q, k, v)
    q, k, v = _attn_case(dev, 1, 4, 2, 16, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention(q, k.cpu(), v)


def _wkv_case(dev, b, h, T, hd, dtype=torch.float32, strided=False,
              seed=0):
    """The reference test_wkv6's distributions (w in (0.35, 0.95)); with
    ``strided``, [b, h, T, hd] views of [b, T, h, hd] buffers, as the
    model passes its projections."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, T, h, hd) if strided else (b, h, T, hd)
    rnd = lambda: torch.randn(*shape, generator=g, device=dev)
    r, k, v = rnd() * 0.4, rnd() * 0.4, rnd()
    w = torch.sigmoid(rnd()) * 0.6 + 0.35
    ts = [t.to(dtype) for t in (r, k, v, w)]
    if strided:
        ts = [t.transpose(1, 2) for t in ts]
    return (*ts, torch.randn(h, hd, generator=g, device=dev) * 0.2)


@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("hd,T", [(16, 37), (64, 300), (64, 1), (16, 1),
                                  (64, 15), (64, 16), (64, 17), (16, 300)])
def test_wkv6_matches_plain(dev, hd, T, strided):
    """B14 at the reduced (hd 16, ragged T) and published (hd 64) head
    dims: 2e-5 in f32 (the reference's test_wkv6 tolerance; the kernel
    sums each out_t[j] in another order than the plain version)."""
    args = _wkv_case(dev, 2, 4, T, hd, strided=strided, seed=hd + T)
    VK.reset_launch_count()
    out, S = WK.wkv6(*args)
    assert VK.launch_count("wkv6") == 1
    want, S_want = R.wkv6(*args)
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert out.transpose(1, 2).is_contiguous()     # [b, T, h, hd] buffer
    assert S.dtype == torch.float32 and tuple(S.shape) == (2, 4, hd, hd)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(S, S_want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", WK.HEAD_DIMS)
def test_wkv6_every_head_dim_in_bf16_storage(dev, hd):
    """bf16 r/k/v/w, f32 math: out rounded to bf16 (2e-2, as B13), the
    f32 final state within 2e-5."""
    args = _wkv_case(dev, 1, 3, 50, hd, dtype=torch.bfloat16, seed=hd)
    out, S = WK.wkv6(*args)
    want, S_want = R.wkv6(*args)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(S, S_want, rtol=2e-5, atol=2e-5)


def _wkv6_f64(r, k, v, w, u):
    """The recurrence step by step in f64: the truth the f32 forms are
    measured against where their own rounding exceeds 2e-5."""
    b, h, T, hd = r.shape
    S = torch.zeros(b, h, hd, hd, dtype=torch.float64, device=r.device)
    rf, kf, vf, wf = (t.double() for t in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(((S + u.double()[None, :, :, None] * kv)
                     * rf[:, :, t, :, None]).sum(dim=2))
        S = wf[:, :, t, :, None] * S + kv
    return torch.stack(outs, dim=2), S


@pytest.mark.parametrize("decay", ["zero", "denormal", "near_one"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37, 300])
@pytest.mark.parametrize("hd", WK.HEAD_DIMS)
def test_wkv6_decays_at_zero_denormal_and_near_one(dev, hd, T, decay):
    """w with exact zeros and denormals (1e-40) on 30% of its entries, or
    1 - 2^-20 everywhere, over T at and around the chunk: finite, and
    within 2e-5 of the plain version.  With w near 1 at T = 300 the state
    sums 300 steps undecayed and the plain version itself is up to 5e-5
    from the f64 truth: there the kernel is held to the truth, no farther
    from it than the plain version is."""
    r, k, v, w, u = _wkv_case(dev, 2, 3, T, hd, seed=T + hd)
    if decay == "near_one":
        w = torch.full_like(w, 1.0 - 2.0 ** -20)
    else:
        hit = torch.rand(w.shape, generator=torch.Generator(
            device=dev).manual_seed(T), device=dev) < 0.3
        w = torch.where(hit, torch.tensor(
            0.0 if decay == "zero" else 1e-40, device=dev), w)
    VK.reset_launch_count()
    out, S = WK.wkv6(r, k, v, w, u)
    assert VK.launch_count("wkv6") == 1
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(S).all())
    want, S_want = R.wkv6(r, k, v, w, u)
    if decay == "near_one" and T == 300:
        o64, s64 = _wkv6_f64(r, k, v, w, u)
        for got, plain, truth in ((out, want, o64), (S, S_want, s64)):
            assert float((got.double() - truth).abs().max()) <= \
                max(float((plain.double() - truth).abs().max()), 2e-5)
        return
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(S, S_want, rtol=2e-5, atol=2e-5)


def test_wkv6_rejects_what_it_does_not_take(dev):
    r, k, v, w, u = _wkv_case(dev, 1, 2, 8, 48)
    with pytest.raises(ValueError, match="head dim"):
        WK.wkv6(r, k, v, w, u)
    r, k, v, w, u = _wkv_case(dev, 1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        WK.wkv6(r, k, v, w, u)
    r, k, v, w, u = _wkv_case(dev, 1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        WK.wkv6(r, k, v, w, u.cpu())
    with pytest.raises(ValueError, match="contiguous float32"):
        WK.wkv6(r, k, v, w, u.to(torch.bfloat16))


def _scan_case(dev, b, T, di, ds, dtype=torch.float32, strided=False,
               seed=0):
    """The reference test_mamba_scan's distributions; with ``strided``, B
    and C are the column views of an x_proj output [dt_r | B | C]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    u = (rnd(b, T, di) * 0.4).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, T, di))
    if strided:
        xdbc = rnd(b, T, 32 + 2 * ds) * 0.4
        B, C = xdbc[..., 32:32 + ds], xdbc[..., 32 + ds:]
    else:
        B, C = rnd(b, T, ds) * 0.4, rnd(b, T, ds) * 0.4
    A = -torch.exp(rnd(di, ds) * 0.3)
    return u, dt, B, C, A, torch.ones(di, device=dev)


@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("di,ds,T", [(128, 4, 37), (256, 16, 300),
                                     (512, 16, 1), (200, 16, 17),
                                     (100, 16, 33), (37, 4, 15),
                                     (130, 4, 300), (72, 16, 16),
                                     (36, 16, 47)])
def test_mamba_scan_matches_plain(dev, di, ds, T, strided):
    """B15 at jamba's reduced (ds 4) and published (ds 16) state dims,
    T below, at and past the 16-step chunk and ragged, and a di that is no
    multiple of a block's channels (64 at ds 16, 128 at ds 4), odd (rows
    staged value by value) or of whole 16-byte pieces: 2e-5 on y and h_T
    in f32."""
    args = _scan_case(dev, 2, T, di, ds, strided=strided, seed=di + T)
    VK.reset_launch_count()
    y, h = MK.mamba_scan(*args)
    assert VK.launch_count("mamba_scan") == 1
    want, h_want = R.mamba_scan(*args)
    assert y.dtype == torch.float32 and y.is_contiguous()
    assert tuple(y.shape) == (2, T, di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, di, ds)
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h, h_want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ds", MK.STATE_DIMS)
def test_mamba_scan_bf16_u_rounds_y_once(dev, ds):
    """bf16 u, f32 math: y rounded to bf16 (2e-2, as B13), the f32 final
    state within 2e-5."""
    args = _scan_case(dev, 2, 50, 256, ds, dtype=torch.bfloat16,
                      strided=True, seed=ds)
    y, h = MK.mamba_scan(*args)
    want, h_want = R.mamba_scan(*args)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(h, h_want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("di,T", [(200, 37), (36, 20), (8192, 5)])
def test_mamba_scan_bf16_ragged_di_and_offset_u(dev, di, T):
    """bf16 u at a di of whole 16-byte pieces (200), one that is not (36,
    value by value) and jamba's, and the same u as a view one element into
    its buffer (no row on a 16-byte boundary): y within 2e-2 of the plain
    version and equal to the aligned call's, h_T within 2e-5."""
    u, dt, B, C, A, D = _scan_case(dev, 2, T, di, 16, dtype=torch.bfloat16,
                                   strided=True, seed=di + T)
    y, h = MK.mamba_scan(u, dt, B, C, A, D)
    want, h_want = R.mamba_scan(u, dt, B, C, A, D)
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(h, h_want, rtol=2e-5, atol=2e-5)
    buf = torch.cat([u.new_zeros(1), u.reshape(-1)])
    y1, h1 = MK.mamba_scan(buf[1:].view(u.shape), dt, B, C, A, D)
    assert torch.equal(y1, y) and torch.equal(h1, h)


def test_mamba_scan_rejects_what_it_does_not_take(dev):
    u, dt, B, C, A, D = _scan_case(dev, 1, 8, 128, 16)
    with pytest.raises(ValueError, match="state dim"):
        MK.mamba_scan(u, dt, B[..., :8], C[..., :8], A[:, :8].contiguous(),
                      D)
    with pytest.raises(ValueError, match="u dtype"):
        MK.mamba_scan(u.half(), dt, B, C, A, D)
    with pytest.raises(ValueError, match="CUDA"):
        MK.mamba_scan(u, dt, B, C, A.cpu(), D)
    with pytest.raises(ValueError, match="contiguous float32"):
        MK.mamba_scan(u, dt, B, C, A, D.to(torch.bfloat16))


# ---- B4 (DC-ASGD lerp), B1's per-tensor entry, B8 (threshold), B11 ----
# All bit-exact against the plain versions: separate IEEE f32 operations
# in the same order on both sides (B4, B1), a compare and one subtraction
# (B8), B9's division and rounding plus byte copies (B11).

RAGGED = [(17,), (255, 9), (3, 5, 7, 11), (1,), (BLOCK + 3,)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [BLOCK, 16 * BLOCK])
def test_dc_lerp_flat_bit_exact(dev, dtype, n):
    s, c, g, b = (_rand(dev, n, dtype=dtype, seed=10 + i) for i in range(4))
    VK.reset_launch_count()
    out = VK.vc_asgd_dc_lerp_flat(s, c, g, b, 0.9, 0.05)
    assert VK.launch_count("vc_asgd_dc_lerp_flat") == 1
    assert VK.launch_count() == 1
    assert _bits_equal(out, R.vc_asgd_dc_lerp(s, c, g, b, 0.9, 0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_per_tensor_lerps_ragged_bit_exact(dev, dtype, shape):
    s, c, g, b = (_rand(dev, *shape, dtype=dtype, seed=20 + i)
                  for i in range(4))
    VK.reset_launch_count()
    lerp = VK.vc_asgd_lerp(s, c, 0.95)
    dc = VK.vc_asgd_dc_lerp(s, c, g, b, 0.95, 0.04)
    assert VK.launch_counts()["vc_asgd_lerp_flat"] == 1
    assert VK.launch_counts()["vc_asgd_dc_lerp_flat"] == 1
    assert lerp.shape == dc.shape == s.shape
    assert _bits_equal(lerp, R.vc_asgd_lerp(s, c, 0.95))
    assert _bits_equal(dc, R.vc_asgd_dc_lerp(s, c, g, b, 0.95, 0.04))


# ---- B1 and B3 as unrolled streaming passes ----------------------------
# Sizes that leave a remainder in the unrolled loop: a few BLOCKs (fewer
# packs than a wave has threads: each thread takes at most one) and buses
# above 2^20 that are no multiple of a chunk (a wave's threads times the
# unroll: whole chunks, then the chunk where a thread's packs run out).

STREAM_SIZES = [BLOCK, 3 * BLOCK, 13 * BLOCK, (1 << 23) + 5 * BLOCK,
                (1 << 25) + 7 * BLOCK]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", STREAM_SIZES)
def test_lerp_flat_streaming_sizes_bit_exact(dev, dtype, n):
    s, c = _rand(dev, n, dtype=dtype, seed=30), _rand(dev, n, dtype=dtype,
                                                      seed=31)
    s0, c0 = s.clone(), c.clone()
    for alpha in (0.0, 2 / 3, 0.95, 1.0):
        VK.reset_launch_count()
        out = VK.vc_asgd_lerp_flat(s, c, alpha)
        assert VK.launch_count() == VK.launch_count("vc_asgd_lerp_flat") == 1
        assert out.data_ptr() not in (s.data_ptr(), c.data_ptr())
        assert _bits_equal(out, R.vc_asgd_lerp(s, c, alpha))
    torch.cuda.synchronize()
    assert _bits_equal(s, s0) and _bits_equal(c, c0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", STREAM_SIZES)
def test_adam_streaming_sizes_bit_exact(dev, dtype, n):
    p = _rand(dev, n, dtype=dtype, seed=32)
    g, m = _rand(dev, n, seed=33), _rand(dev, n, seed=34)
    v = _rand(dev, n, seed=35).abs()
    before = [t.clone() for t in (p, g, m, v)]
    for t, wd in ((1, 0.0), (3, 0.0), (50, 0.0), (1, 0.01), (3, 0.01),
                  (50, 0.01)):
        c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
        c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
        VK.reset_launch_count()
        got = VK.adam_update_flat(p, g, m, v, 1e-3, 0.9, 0.999, 1e-8, wd,
                                  c1, c2)
        assert VK.launch_count() == VK.launch_count("adam_update_flat") == 1
        assert not {o.data_ptr() for o in got} & {
            x.data_ptr() for x in (p, g, m, v)}
        want = R.adam_update(p, g, m, v, lr=1e-3, b1=0.9, b2=0.999,
                             eps=1e-8, c1=c1, c2=c2, weight_decay=wd)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and _bits_equal(a, b)
    torch.cuda.synchronize()
    assert all(_bits_equal(x, y) for x, y in zip((p, g, m, v), before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [((1 << 20) + 5,), (4097, 1031), (3, 7)],
                         ids=str)
def test_per_tensor_lerp_streaming_ragged_bit_exact(dev, dtype, shape):
    s, c = (_rand(dev, *shape, dtype=dtype, seed=36 + i) for i in range(2))
    s0 = s.clone()
    VK.reset_launch_count()
    out = VK.vc_asgd_lerp(s, c, 0.9)
    assert VK.launch_count() == 1
    assert out.shape == s.shape and _bits_equal(out, R.vc_asgd_lerp(s, c,
                                                                    0.9))
    assert _bits_equal(s, s0)


def test_raw_stream_handle_is_the_current_stream(dev):
    idx = torch.cuda.current_device()
    assert LA._current_device() == idx
    assert LA._raw_stream(idx) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert LA._raw_stream(idx) == side.cuda_stream
        assert LA._raw_stream(idx) == torch.cuda.current_stream().cuda_stream
    assert LA._raw_stream(idx) == torch.cuda.current_stream().cuda_stream


def test_kernels_launch_on_a_non_default_stream(dev):
    """Inputs written on a side stream behind a ~50 ms sleep: a kernel
    launched anywhere but on that stream would read them unwritten."""
    n = 4 * BLOCK
    s, c = _rand(dev, n, seed=40), _rand(dev, n, seed=41)
    p, g, m = (_rand(dev, n, seed=42 + i) for i in range(3))
    v = _rand(dev, n, seed=45).abs()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        c_late, g_late = torch.mul(c, 1.0), torch.mul(g, 1.0)
        out = VK.vc_asgd_lerp_flat(s, c_late, 0.3)
        got = VK.adam_update_flat(p, g_late, m, v, 1e-3, 0.9, 0.999, 1e-8,
                                  0.0, 0.5, 0.25)
    side.synchronize()
    assert _bits_equal(out, R.vc_asgd_lerp(s, c, 0.3))
    want = R.adam_update(p, g, m, v, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                         c1=0.5, c2=0.25)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))


def test_lerp_wrappers_reject_bad_inputs(dev):
    s = _rand(dev, 100)
    with pytest.raises(ValueError, match="shape"):
        VK.vc_asgd_lerp(s, _rand(dev, 10, 10), 0.5)
    with pytest.raises(ValueError, match="aligned"):
        VK.vc_asgd_lerp(_rand(dev, 101)[1:], s, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        VK.vc_asgd_dc_lerp(s, s, _rand(dev, 200)[::2], s, 0.5)
    with pytest.raises(ValueError, match="dtype"):
        VK.vc_asgd_dc_lerp(s, s, s, s.double(), 0.5)
    with pytest.raises(ValueError, match="BLOCK"):
        VK.vc_asgd_dc_lerp_flat(s, s, s, s, 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2_105_344, 9000, 7, 1 << 20])
def test_threshold_sparsify_bit_exact(dev, dtype, n):
    x = (_rand(dev, n, seed=n) * 0.02).to(dtype)
    x[::11] = -0.0
    for tau in (0.01, torch.tensor([0.03], device=dev)):
        VK.reset_launch_count()
        kept, res = TK.threshold_sparsify(x, tau)
        assert VK.launch_count("threshold_sparsify") == VK.launch_count() == 1
        pk, pr = R.threshold_sparsify(x, tau)
        assert _bits_equal(kept, pk) and _bits_equal(res, pr)
        assert torch.equal(kept.float() + res.float(), x.float())


def test_threshold_sparsify_rejects_bad_inputs(dev):
    x = _rand(dev, 1000)
    with pytest.raises(ValueError, match="dtype"):
        TK.threshold_sparsify(x.double(), 0.1)
    with pytest.raises(ValueError, match="aligned"):
        TK.threshold_sparsify(_rand(dev, 1001)[1:], 0.1)
    with pytest.raises(ValueError):
        TK.threshold_sparsify(x, torch.ones(2, device=dev))


@pytest.mark.parametrize("k", [1, 656, 1000, 1313, 105_075])
def test_quantize_pack_bytes_equal(dev, k):
    sel = _rand(dev, k, seed=k) * 0.01
    sel[k // 3] = 0.0
    idx = (torch.arange(k, dtype=torch.int32, device=dev) * 19 + 3)
    VK.reset_launch_count()
    body, q, s = SK.quantize_pack(sel, idx)
    assert VK.launch_count("quantize_pack") == VK.launch_count() == 1
    pb, pq, ps = R.quantize_pack(sel, idx)
    assert torch.equal(body, pb) and torch.equal(q, pq) and _bits_equal(s, ps)
    # B12 of B9's payload: the same body
    q9, s9 = QK.quantize_int8(sel)
    assert torch.equal(SK.pack_body(q9, s9, idx), body)


@pytest.mark.parametrize("k", [4096 + r for r in range(16)])
def test_quantize_pack_every_k_mod_16_bytes_equal(dev, k):
    """Every k mod 16: the value section's last lane, the scale and index
    sections' shifts and the seam words."""
    sel = _rand(dev, k, seed=k) * 0.01
    sel[256:512] = 0.0                          # an all-zero group
    idx = torch.randint(0, 2 ** 31 - 1, (k,), device=dev, dtype=torch.int32)
    body, q, s = SK.quantize_pack(sel, idx)
    pb, pq, ps = R.quantize_pack(sel, idx)
    assert torch.equal(body, pb) and torch.equal(q, pq) and _bits_equal(s, ps)


@pytest.mark.parametrize("so,io", [(1, 0), (0, 1), (2, 3), (3, 2)])
@pytest.mark.parametrize("k", [7, 1000, 1313, 105_075])
def test_quantize_pack_operands_off_16_byte_boundaries(dev, k, so, io):
    """sel and idx as views so and io elements into their buffers (not
    16-byte aligned): the value-by-value loads, the same bytes."""
    sel = (_rand(dev, k + so, seed=k + so) * 0.01)[so:]
    idx = torch.randint(0, 2 ** 31 - 1, (k + io,), device=dev,
                        dtype=torch.int32)[io:]
    body, q, s = SK.quantize_pack(sel, idx)
    pb, pq, ps = R.quantize_pack(sel, idx)
    assert torch.equal(body, pb) and torch.equal(q, pq) and _bits_equal(s, ps)


@pytest.mark.parametrize("block,k", [(100, 1000), (64, 333), (512, 1100),
                                     (100, 7)])
def test_quantize_pack_generic_block_bytes_equal(dev, block, k):
    """Any block but the wire's 256 takes the generic instance."""
    sel = _rand(dev, k, seed=block) * 0.01
    idx = torch.arange(k, dtype=torch.int32, device=dev) * 5
    body, q, s = SK.quantize_pack(sel, idx, block)
    pb, pq, ps = R.quantize_pack(sel, idx, block)
    assert q.numel() == -(-k // block) * block
    assert torch.equal(body, pb) and torch.equal(q, pq) and _bits_equal(s, ps)


def test_quantize_pack_rejects_bad_inputs(dev):
    sel = _rand(dev, 300)
    idx = torch.arange(300, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        SK.quantize_pack(sel, idx[:299])
    with pytest.raises(ValueError):
        SK.quantize_pack(sel, idx.long())
    with pytest.raises(ValueError):
        SK.quantize_pack(sel.reshape(3, 100), idx)


# ---------------------------------------------------------------------------
# kill-and-restore training on the card (chip_smoke.py phase 11a): B3
# every step; the one-pass train record across devices
# ---------------------------------------------------------------------------

def _preemptible(tmp_path, name, device, kills=()):
    from repro_torch.core.preemption import KillSchedule
    from repro_torch.core.simulator import run_preemptible_training
    from repro_torch.core.tasks import MLPTask, make_classification_data
    return run_preemptible_training(
        MLPTask(), make_classification_data(), steps=40, batch=64,
        ckpt_every=10, ckpt_dir=tmp_path / name, seed=0, device=device,
        kill_schedule=KillSchedule.at(*kills) if kills else None)


def test_kill_and_restore_bit_equal_on_card(dev, tmp_path):
    clean = _preemptible(tmp_path, "clean", "cuda")
    VK.reset_launch_count()
    killed = _preemptible(tmp_path, "killed", "cuda", kills=(13, 27))
    assert VK.launch_count("adam_update_flat") == 40 + 10
    assert (killed.restores, killed.recomputed_steps) == (2, 10)
    assert killed.trajectory() == clean.trajectory()
    assert _bits_equal(killed.final_params.buf, clean.final_params.buf)


def test_train_record_crosses_devices_bit_exact(dev, tmp_path):
    from repro_torch.checkpoint import (load_train_checkpoint,
                                        save_train_checkpoint)
    card = _preemptible(tmp_path, "card", "cuda", kills=(13,))
    host = _preemptible(tmp_path, "host", "cpu")
    for src, other in (("card", "cpu"), ("host", "cuda")):
        path = tmp_path / src / "ckpt_00000040.msgpack"
        like = (card if src == "card" else host).final_params
        fp, opt, _ = load_train_checkpoint(path, like)       # like's device
        fo, oo, extra = load_train_checkpoint(path, like, device=other)
        assert fo.buf.device.type == other and opt.step == oo.step == 40
        for a, b in ((fp.buf, fo.buf), (opt.m, oo.m), (opt.v, oo.v)):
            assert _bits_equal(a.cpu(), b.cpu())
        assert _bits_equal(fp.buf.cpu(), like.buf.cpu())
        save_train_checkpoint(tmp_path / f"{src}-again.msgpack", fo, oo,
                              extra)
        assert (tmp_path / f"{src}-again.msgpack").read_bytes() == \
            path.read_bytes()


# ---------------------------------------------------------------------------
# the rest of the simulator on the card: fleets, the sharded bus, the tier,
# subscribers (B1 every fold)
# ---------------------------------------------------------------------------

_FLEET = dict(n_param_servers=2, n_clients=120, tasks_per_client=1,
              n_shards=240, max_epochs=2, local_steps=1, timeout_s=1800.0,
              preemptible=True, mean_lifetime_s=5400.0,
              restart_delay_s=120.0, subtask_compute_s=120.0,
              server_proc_s=0.05, seed=7)


@pytest.mark.parametrize("overrides", [
    dict(), dict(bus_shards=4, seed=11), dict(aggregators=4),
    dict(bus_shards=2, subscribers=30, handout_dtype="bfloat16")])
def test_probe_fleet_on_card_equals_cpu(dev, overrides):
    from repro_torch.core.baselines import VCASGD
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.scenarios.probe import ProbeTask, make_probe_data
    cfg = SimConfig(**{**_FLEET, **overrides})
    runs = {}
    for device in ("cuda", "cpu"):
        VK.reset_launch_count()
        res = run_simulation(ProbeTask(), make_probe_data(cfg.n_shards,
                                                          seed=cfg.seed),
                             VCASGD(0.95), cfg, device=device)
        runs[device] = (res, VK.launch_counts())
    (g, counts), (c, counts_cpu) = runs["cuda"], runs["cpu"]
    assert g.scheme_state.params.buf.device.type == "cuda"
    assert counts["vc_asgd_lerp_flat"] == g.results_assimilated > 0
    assert sum(counts.values()) == counts["vc_asgd_lerp_flat"]
    assert sum(counts_cpu.values()) == 0
    for f in ("wall_time_s", "results_assimilated", "preemptions",
              "handout_frames", "handout_bytes", "events_processed",
              "agg_flushes", "sub_pulls", "sub_bytes_served",
              "handout_unique_bytes_encoded", "final_accuracy"):
        assert getattr(g, f) == getattr(c, f), f
    assert [p.acc_mean for p in g.points] == [p.acc_mean for p in c.points]
    assert _bits_equal(g.scheme_state.params.buf.cpu(),
                       c.scheme_state.params.buf)


def test_tier_on_card_bit_identical_to_flat_hub(dev):
    from repro_torch.core import flat as F
    from repro_torch.core.baselines import VCASGD
    from repro_torch.protocol import Aggregator, Coordinator
    from repro_torch.transfer import wire
    fp = F.flatten({"w": _rand(dev, 64, 32)})
    flat_hub = Coordinator(VCASGD(0.9), fp)
    hub = Coordinator(VCASGD(0.9), fp)
    agg = Aggregator(VCASGD(0.9), hub, agg_id=0)
    up = agg.open_window(round=0)
    VK.reset_launch_count()
    for i in range(5):
        for c in (flat_hub, agg):
            lease = c.issue(cid=i, uid=i, round=0, base=c.state.params)
            c.submit(lease, lease.base.buf + (i + 1) * 0.25)
            c.assimilate(lease, c.deliver(lease), server_version=i)
    assert VK.launch_count("vc_asgd_lerp_flat") == 10
    agg.flush()
    hub.assimilate(up, hub.deliver(up), server_version=0)
    assert hub.state.params.buf.device.type == "cuda"
    assert hub.frames[wire.KIND_AGG] == 1
    assert _bits_equal(hub.state.params.buf, flat_hub.state.params.buf)


# B13's backward: the hand-written kernel against the autograd of the
# plain forward (f32 arithmetic on the same inputs).  f32: within 5e-5
# (1 + |plain|) — every sum in f32 in another order (measured 1e-5 at
# [1, 8/2, 2048, 128]); bf16: within 2e-2 (1 + |plain|) — the gradients
# are stored in bf16, o enters delta in bf16 and the wgmma forward rounds
# P to bf16 (measured 1.3e-2 at hd 128).
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _bwd_inputs(dev, b, h, kvh, s, hd, dtype, seed):
    q, k, v = (_rand(dev, b, s, n, hd, dtype=dtype, seed=seed + i)
               .transpose(1, 2) for i, n in enumerate((h, kvh, kvh)))
    return q, k, v, _rand(dev, b, h, s, hd, dtype=dtype, seed=seed + 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 63, 16, True, None),
                                   (1, 8, 2, 128, 64, True, 48),
                                   (2, 4, 4, 1, 128, True, None),
                                   (1, 16, 8, 300, 128, False, None),
                                   (1, 8, 2, 200, 80, True, 64),
                                   (1, 4, 2, 200, 256, True, 64),
                                   (2, 8, 4, 63, 256, True, None),
                                   (1, 2, 1, 333, 256, False, None)])
def test_flash_attention_bwd_matches_plain_autograd(dev, dtype, shape):
    b, h, kvh, s, hd, causal, window = shape
    q, k, v, do = _bwd_inputs(dev, b, h, kvh, s, hd, dtype, sum(shape[:5]))
    o = FK.flash_attention(q, k, v, causal=causal, window=window)
    LA.reset_launch_count()
    got = FK.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = FK.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   window=window)
    route = FK.bwd_route(q)              # bf16 at hd 64, 80, 128, 256: wgmma
    assert LA.route_counts("flash_attention_bwd") == {
        r: 2 * (r == route) for r in ("wgmma", "simt")}
    req = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(R.attention(*req, causal=causal,
                                           window=window), req, do.float())
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)                 # the same bits every run
        err = ((g.float() - w).abs() / (1 + w.abs())).max()
        assert float(err) <= BWD_TOL[dtype], float(err)


def test_flash_attention_autograd_runs_both_kernels(dev):
    q, k, v, do = _bwd_inputs(dev, 2, 4, 2, 96, 128, torch.bfloat16, 7)
    req = [t.detach().requires_grad_(True) for t in (q, k, v)]
    LA.reset_launch_count()
    from repro_torch.kernels import ops
    out = ops.flash_attention(*req, causal=True)
    grads = torch.autograd.grad(out, req, do)
    torch.cuda.synchronize()
    assert LA.launch_count("flash_attention") == 1
    assert LA.launch_count("flash_attention_bwd") == 1
    o = FK.flash_attention(q, k, v, causal=True)
    for g, w in zip(grads, FK.flash_attention_bwd(q, k, v, o, do)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(*req, causal=True, softcap=30.0)


@pytest.mark.parametrize("shape", [(2, 4, 2, 63, 64, None),
                                   (1, 8, 2, 300, 64, 48),
                                   (8, 16, 8, 128, 64, None),
                                   (1, 16, 4, 333, 128, None),
                                   (8, 16, 8, 128, 128, 48),
                                   (8, 32, 32, 128, 80, None),
                                   (1, 8, 2, 333, 80, 48),
                                   (8, 8, 4, 128, 256, None),
                                   (1, 8, 2, 333, 256, 48),
                                   (2, 4, 4, 1, 256, None)])
def test_flash_attention_bwd_wgmma_route_against_simt_and_formula(dev,
                                                                   shape):
    """The wgmma backward (bf16 at hd 64, 80, 128 and 256) given the
    forward's lse equals its run that recomputes it, bit for bit, and
    stays within BWD_TOL of the plain formula on the same o, as the SIMT
    kernel does on the same inputs (causal, granite's, internlm2's,
    stablelm-3b's and gemma3-4b's training shapes among them)."""
    b, h, kvh, s, hd, window = shape
    q, k, v, do = _bwd_inputs(dev, b, h, kvh, s, hd, torch.bfloat16,
                              sum(shape[:5]))
    lse = FK.lse_buffer(q)
    o = FK.flash_attention(q, k, v, causal=True, window=window, lse=lse)
    LA.reset_launch_count()
    got = FK.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
    assert LA.launch_count("flash_attention") == 0
    again = FK.flash_attention_bwd(q, k, v, o, do, window=window)
    simt = FK.flash_attention_bwd(q, k, v, o, do, window=window,
                                  kernel="simt")
    assert LA.route_counts("flash_attention_bwd") == {"wgmma": 2, "simt": 1}
    plain = R.attention_bwd(q.float(), k.float(), v.float(), o.float(),
                            do.float(), window=window)
    for g, a, sm, w in zip(got, again, simt, plain):
        assert torch.equal(g, a)
        for x in (g, sm):
            err = ((x.float() - w).abs() / (1 + w.abs())).max()
            assert float(err) <= BWD_TOL[torch.bfloat16], float(err)


# whisper-tiny's training attention on the wgmma backward (MHA, 6 / 6
# heads, hd 64, not causal), at the training shapes: the encoder's
# [8, 6/6, 1,500, 64] and the cross-attention's 128 decoder rows against
# 1,500 frames; (b, sq, skv), inputs in the model's [b, s, h, hd] layout
WHISPER_BWD = {"encoder": (8, 1500, 1500), "cross-train": (8, 128, 1500)}


@pytest.mark.parametrize("case", list(WHISPER_BWD))
def test_flash_attention_bwd_wgmma_at_whispers_shapes(dev, case):
    """The wgmma backward against the SIMT kernel and the plain formula
    on the same o, bit-equal run to run, and under autograd
    (``FlashAttention``: one forward and one backward launch, both
    wgmma) equal to the direct call."""
    from repro_torch.kernels import ops
    b, sq, skv = WHISPER_BWD[case]
    q, k, v = (_rand(dev, b, n, 6, 64, dtype=torch.bfloat16, seed=i)
               .transpose(1, 2) for i, n in enumerate((sq, skv, skv)))
    do = _rand(dev, b, 6, sq, 64, dtype=torch.bfloat16, seed=3)
    lse = FK.lse_buffer(q)
    o = FK.flash_attention(q, k, v, causal=False, lse=lse)
    LA.reset_launch_count()
    got = FK.flash_attention_bwd(q, k, v, o, do, causal=False, lse=lse)
    again = FK.flash_attention_bwd(q, k, v, o, do, causal=False, lse=lse)
    simt = FK.flash_attention_bwd(q, k, v, o, do, causal=False,
                                  kernel="simt")
    assert LA.route_counts("flash_attention_bwd") == {"wgmma": 2, "simt": 1}
    plain = R.attention_bwd(q.float(), k.float(), v.float(), o.float(),
                            do.float(), causal=False)
    for g, a, sm, w in zip(got, again, simt, plain):
        assert g.shape == w.shape and torch.equal(g, a)
        for x in (g, sm):
            err = ((x.float() - w).abs() / (1 + w.abs())).max()
            assert float(err) <= BWD_TOL[torch.bfloat16], float(err)
    req = [t.detach().requires_grad_(True) for t in (q, k, v)]
    LA.reset_launch_count()
    grads = torch.autograd.grad(ops.flash_attention(*req, causal=False),
                                req, do)
    torch.cuda.synchronize()
    assert LA.route_counts("flash_attention") == {"wgmma": 1, "simt": 0}
    assert LA.route_counts("flash_attention_bwd") == {"wgmma": 1, "simt": 0}
    for gr, g in zip(grads, got):
        assert torch.equal(gr, g)


def test_wgmma_kernels_launch_from_a_thread_with_no_cuda_work(dev):
    """The wgmma forward and backward encode their tensor maps with
    cuTensorMapEncodeTiled, which needs a current context: a fresh
    thread, as PyTorch's autograd worker is when B13's backward is the
    first CUDA work of its graph, gets the same results as this one."""
    import threading
    q, k, v, do = _bwd_inputs(dev, 2, 4, 2, 200, 64, torch.bfloat16, 5)
    lse = FK.lse_buffer(q)
    o = FK.flash_attention(q, k, v, causal=True, lse=lse)
    want = FK.flash_attention_bwd(q, k, v, o, do, lse=lse)
    got = {}

    def run():
        got["o"] = FK.flash_attention(q, k, v, causal=True)
        got["g"] = FK.flash_attention_bwd(q, k, v, o, do, lse=lse)
        torch.cuda.synchronize()
    for _ in range(2):
        got.clear()
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and set(got) == {"o", "g"}
        assert torch.equal(got["o"], o)
        for a, b in zip(got["g"], want):
            assert torch.equal(a, b)


# B14's and B15's backward kernels against their plain backwards
# (ref.wkv6_bwd / ref.mamba_scan_bwd, explicit reverse recurrences), per
# element: |kernel - plain| <= atol + rtol |plain| with atol scaled by
# the tensor's largest |plain|.  Both sum in f32 in other orders (the
# kernels' states from the forward's chunk checkpoints, their row and
# column sums by butterflies and warps).  bf16 u: du rounded once to bf16
# on both sides (one bf16 ulp, 2^-8 relative, as 2e-2 above).
SCAN_BWD_TOL = (1e-5, 1e-4)
SCAN_BWD_BF16 = 2e-2


def _close_bwd(got, want, what, tol=SCAN_BWD_TOL):
    for name, g, w in zip(what, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype)
        g, w = g.float(), w.float()
        atol = tol[0] * max(float(w.abs().max()), 1.0)
        err = (g - w).abs() - (atol + tol[1] * w.abs())
        assert bool(torch.isfinite(g).all()), name
        assert float(err.max()) <= 0.0, (name, float((g - w).abs().max()))


@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("hd,T", [(16, 1), (16, 17), (16, 63), (64, 63),
                                  (64, 128), (64, 300), (16, 300)])
def test_wkv6_bwd_matches_plain_and_repeats_bit_equal(dev, hd, T, strided):
    """B14's backward (csrc/wkv6_bwd.cu) from the forward's chunk states:
    dr, dk, dv, dw and du within SCAN_BWD_TOL of the plain backward, with
    30% of the decays exactly 0 at T 63 and 300; a second run bit-equal
    (no atomics); ONE backward launch and the forward's one."""
    r, k, v, w, u = _wkv_case(dev, 2, 3, T, hd, strided=strided, seed=T)
    if T in (63, 300):
        hit = torch.rand(w.shape, generator=torch.Generator(
            device=dev).manual_seed(T), device=dev) < 0.3
        w = torch.where(hit, torch.zeros((), device=dev), w)
    do = _rand(dev, 2, 3, T, hd, seed=T + 1)
    states = WK.chunk_states(r)
    VK.reset_launch_count()
    out, _ = WK.wkv6(r, k, v, w, u, states=states)
    got = WK.wkv6_bwd(r, k, v, w, u, do, states)
    again = WK.wkv6_bwd(r, k, v, w, u, do, states)
    assert VK.launch_count("wkv6") == 1 and VK.launch_count("wkv6_bwd") == 2
    torch.testing.assert_close(out, R.wkv6(r, k, v, w, u)[0], rtol=2e-5,
                               atol=2e-5)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert got[0].transpose(1, 2).is_contiguous()     # [b, T, h, hd]
    _close_bwd(got, R.wkv6_bwd(r, k, v, w, u, do), "rkvwu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("di,ds,T", [(128, 4, 37), (200, 16, 128),
                                     (100, 16, 17), (37, 4, 300),
                                     (64, 16, 1), (130, 4, 16)])
def test_mamba_scan_bwd_matches_plain_and_repeats_bit_equal(dev, di, ds, T,
                                                            dtype):
    """B15's backward (csrc/mamba_scan_bwd.cu) from the forward's chunk
    states, B and C as column views of an x_proj output, di no multiple of
    a block's channels: du, ddt, dB, dC, dA, dD within SCAN_BWD_TOL of the
    plain backward (du in bf16 within SCAN_BWD_BF16); a second run
    bit-equal; dB and dC contiguous."""
    u, dt, B, C, A, D = _scan_case(dev, 2, T, di, ds, dtype=dtype,
                                   strided=True, seed=di + T)
    D = _rand(dev, di, seed=3)
    dy = _rand(dev, 2, T, di, dtype=dtype, seed=T)
    h_ck = MK.chunk_states(u, ds)
    VK.reset_launch_count()
    MK.mamba_scan(u, dt, B, C, A, D, h_ck=h_ck)
    got = MK.mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
    again = MK.mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
    assert VK.launch_count("mamba_scan") == 1
    assert VK.launch_count("mamba_scan_bwd") == 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert got[2].is_contiguous() and got[3].is_contiguous()
    want = R.mamba_scan_bwd(u, dt, B, C, A, D, dy)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=SCAN_BWD_BF16, atol=SCAN_BWD_BF16)
        got, want = got[1:], want[1:]
    _close_bwd(got, want, ["u", "dt", "B", "C", "A", "D"][-len(got):])


# the backwards at rwkv6's and jamba's training shapes, at a long sequence
# (b * h = 128 < 132 SMs for B14) and at a few (b, h) / channels
WKV_BWD_SIZES = {"train": (8, 32, 128), "long": (4, 32, 2048),
                 "few heads": (2, 3, 100)}
SCAN_BWD_SIZES = {"train": (8, 128, 8192, torch.bfloat16),
                  "long": (2, 2048, 8192, torch.bfloat16),
                  "few channels": (1, 300, 1000, torch.float32)}


@pytest.mark.parametrize("size", list(WKV_BWD_SIZES))
def test_wkv6_bwd_at_path_sizes(dev, size):
    """B14's backward at hd 64 where rwkv6's training and longer sequences
    take it: within SCAN_BWD_TOL of the plain backward, bit-equal run to
    run."""
    b, h, T = WKV_BWD_SIZES[size]
    r, k, v, w, u = _wkv_case(dev, b, h, T, 64, strided=True, seed=T)
    do = _rand(dev, b, h, T, 64, seed=T + 1)
    states = WK.chunk_states(r)
    WK.wkv6(r, k, v, w, u, states=states)
    got = WK.wkv6_bwd(r, k, v, w, u, do, states)
    again = WK.wkv6_bwd(r, k, v, w, u, do, states)
    for g, a in zip(got, again):
        assert _bits_equal(g, a)
    _close_bwd(got, R.wkv6_bwd(r, k, v, w, u, do), "rkvwu")


@pytest.mark.parametrize("size", list(SCAN_BWD_SIZES))
def test_mamba_scan_bwd_at_path_sizes(dev, size):
    """B15's backward at ds 16 where jamba's training and longer sequences
    take it (B and C column views of an x_proj output): within
    SCAN_BWD_TOL of the plain backward (bf16 du within SCAN_BWD_BF16),
    bit-equal run to run."""
    b, T, di, dtype = SCAN_BWD_SIZES[size]
    u, dt, B, C, A, D = _scan_case(dev, b, T, di, 16, dtype=dtype,
                                   strided=True, seed=di + T)
    D = _rand(dev, di, seed=3)
    dy = _rand(dev, b, T, di, dtype=dtype, seed=T)
    h_ck = MK.chunk_states(u, 16)
    MK.mamba_scan(u, dt, B, C, A, D, h_ck=h_ck)
    got = MK.mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
    again = MK.mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
    for g, a in zip(got, again):
        assert _bits_equal(g, a)
    want = R.mamba_scan_bwd(u, dt, B, C, A, D, dy)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=SCAN_BWD_BF16, atol=SCAN_BWD_BF16)
        got, want = got[1:], want[1:]
    _close_bwd(got, want, ["u", "dt", "B", "C", "A", "D"][-len(got):])


@pytest.mark.parametrize("hd", WK.HEAD_DIMS)
def test_wkv6_bwd_inputs_off_16_bytes(dev, hd):
    """Inputs whose rows are not on 16 bytes (views one element into
    their buffers) take the kernel's 4-byte staging copies: the same
    limits as the aligned ones."""
    b, h, T = 2, 3, 45

    def off16(x):               # x's values one element into a buffer
        y = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
        return y.copy_(x)
    r, k, v, w, _ = _wkv_case(dev, b, h, T, hd, seed=hd)
    r, k, v, w = (off16(x) for x in (r, k, v, w))
    do = off16(_rand(dev, b, h, T, hd, seed=8))
    u = _rand(dev, h, hd, seed=9) * 0.2
    assert all(x.data_ptr() % 16 for x in (r, k, v, w, do))
    states = WK.chunk_states(r)
    WK.wkv6(r, k, v, w, u, states=states)
    got = WK.wkv6_bwd(r, k, v, w, u, do, states)
    _close_bwd(got, R.wkv6_bwd(r, k, v, w, u, do), "rkvwu")


@pytest.mark.parametrize("ds", MK.STATE_DIMS)
def test_mamba_scan_bwd_rows_off_16_bytes(dev, ds):
    """B and C column views one element off 16 bytes, u and dt views one
    element into their buffers: the kernel's plain staging loads, the
    same limits."""
    b, T, di = 2, 40, 100
    g = torch.Generator(device=dev).manual_seed(ds)
    xdbc = torch.randn(b, T, 33 + 2 * ds, generator=g, device=dev) * 0.4
    B, C = xdbc[..., 33:33 + ds], xdbc[..., 33 + ds:]
    u = (torch.randn(b * T * di + 1, generator=g, device=dev)
         * 0.4)[1:].view(b, T, di)
    dt = torch.nn.functional.softplus(torch.randn(
        b * T * di + 1, generator=g, device=dev))[1:].view(b, T, di)
    A = -torch.exp(torch.randn(di, ds, generator=g, device=dev) * 0.3)
    D = torch.randn(di, generator=g, device=dev)
    dy = torch.randn(b, T, di, generator=g, device=dev)
    assert B.data_ptr() % 16 and u.data_ptr() % 16 and dt.data_ptr() % 16
    h_ck = MK.chunk_states(u, ds)
    MK.mamba_scan(u, dt, B, C, A, D, h_ck=h_ck)
    got = MK.mamba_scan_bwd(u, dt, B, C, A, D, dy, h_ck)
    _close_bwd(got, R.mamba_scan_bwd(u, dt, B, C, A, D, dy),
               ["u", "dt", "B", "C", "A", "D"])


def _grads(fn, args, cot):
    req = [a.detach().clone().requires_grad_(True) for a in args]
    out, _ = fn(*req)
    return out, torch.autograd.grad(out, req, cot)


@pytest.mark.parametrize("hd", WK.HEAD_DIMS)
def test_wkv6_function_matches_autograd_of_plain(dev, hd):
    """``ops.wkv6`` under autograd on the card (``WKV6``: the forward that
    writes the chunk states, then the backward kernel) against autograd
    of the plain forward, on the model's strided [b, T, h, hd] views;
    under no_grad the serving path: one forward launch, no backward, no
    grad_fn."""
    from repro_torch.kernels import ops
    args = _wkv_case(dev, 2, 4, 40, hd, strided=True, seed=hd)
    do = _rand(dev, 2, 4, 40, hd, seed=7)
    VK.reset_launch_count()
    out, got = _grads(ops.wkv6, args, do)
    assert VK.launch_count("wkv6") == 1 and VK.launch_count("wkv6_bwd") == 1
    want_out, want = _grads(R.wkv6, args, do)
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    _close_bwd(got, want, "rkvwu")
    VK.reset_launch_count()
    with torch.no_grad():
        o, S = ops.wkv6(*(a.requires_grad_(True) for a in args))
    assert o.grad_fn is None and S.grad_fn is None
    assert VK.launch_counts() == {**dict.fromkeys(VK.KERNELS, 0), "wkv6": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", MK.STATE_DIMS)
def test_mamba_scan_function_matches_autograd_of_plain(dev, ds, dtype):
    """``ops.mamba_scan`` under autograd on the card (``MambaScan``)
    against autograd of the plain forward, B and C as column views of an
    x_proj output (their gradients land in it); under no_grad the serving
    path: one forward launch, no backward."""
    from repro_torch.kernels import ops
    args = _scan_case(dev, 2, 40, 96, ds, dtype=dtype, strided=True, seed=ds)
    dy = _rand(dev, 2, 40, 96, dtype=dtype, seed=5)
    xdbc = args[2]._base.detach().clone().requires_grad_(True)
    leaves = [args[i].detach().clone().requires_grad_(True)
              for i in (0, 1, 4, 5)]

    def grads(fn):
        u, dt, A, D = leaves
        y, _ = fn(u, dt, xdbc[..., 32:32 + ds], xdbc[..., 32 + ds:], A, D)
        return torch.autograd.grad(y, [*leaves, xdbc], dy)
    VK.reset_launch_count()
    got = grads(ops.mamba_scan)
    assert VK.launch_count("mamba_scan") == 1
    assert VK.launch_count("mamba_scan_bwd") == 1
    want = grads(R.mamba_scan)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=SCAN_BWD_BF16, atol=SCAN_BWD_BF16)
        got, want = got[1:], want[1:]
    _close_bwd(got, want, ["u", "dt", "A", "D", "x_proj"][-len(got):])
    VK.reset_launch_count()
    with torch.no_grad():
        y, h = ops.mamba_scan(*(a.requires_grad_(True) for a in args))
    assert y.grad_fn is None and h.grad_fn is None
    assert VK.launch_counts() == {**dict.fromkeys(VK.KERNELS, 0),
                                  "mamba_scan": 1}


def test_scan_backwards_reject_what_they_do_not_take(dev):
    r, k, v, w, u = _wkv_case(dev, 1, 2, 20, 64, dtype=torch.bfloat16)
    do = _rand(dev, 1, 2, 20, 64)
    with pytest.raises(ValueError, match="float32"):
        WK.wkv6_bwd(r, k, v, w, u, do, WK.chunk_states(r))
    r, k, v, w, u = _wkv_case(dev, 1, 2, 20, 64)
    with pytest.raises(ValueError, match="chunk_states"):
        WK.wkv6_bwd(r, k, v, w, u, do, WK.chunk_states(r)[:, :1])
    args = _scan_case(dev, 1, 20, 64, 16)
    with pytest.raises(ValueError, match="dy"):
        MK.mamba_scan_bwd(*args, _rand(dev, 1, 64, 20).transpose(1, 2),
                          MK.chunk_states(args[0], 16))
    with pytest.raises(ValueError, match="chunk_states"):
        MK.mamba_scan_bwd(*args, _rand(dev, 1, 20, 64),
                          MK.chunk_states(args[0], 4))


# ---------------------------------------------------------------------------
# the sharded flat bus and B13 over context-parallel chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_flat_ops_launch_once_a_shard_bit_equal(dev, n_shards):
    """Each sharded op launches its kernel once a shard, at the shard's
    segment offset of the bus, and gathers to the whole-bus call's bits."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.runtime import sharding as S
    n = 8 * 3 * BLOCK
    s = _rand(dev, n, seed=1)
    cl = s + 0.01 * _rand(dev, 4, n, seed=2)
    g, v = 0.01 * _rand(dev, n, seed=3), _rand(dev, n, seed=4).abs()
    mesh = make_pod_mesh(n_shards, device=dev)
    sh = S.shard_buf(s, mesh)
    assert [t.data_ptr() for t in sh.shards] == [
        s.data_ptr() + 4 * i * (n // n_shards) for i in range(n_shards)]
    w = [0.2, 0.1, 0.15, 0.25, 0.3]
    adam = (1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.001)
    cases = {
        "vc_asgd_lerp_flat": (lambda: [S.sharded_lerp_flat(
            sh, cl[0], 0.7, mesh)], lambda: [ops.fused_lerp_flat(
                s, cl[0], 0.7)]),
        "assimilate_flat": (lambda: [S.sharded_assimilate_flat(
            sh, cl, w, mesh)], lambda: [ops.fused_assimilate_flat(s, cl, w)]),
        "adam_update_flat": (lambda: list(S.sharded_adam_update_flat(
            sh, g, g, v, *adam, mesh)), lambda: list(ops.fused_adam_flat(
                s, g, g, v, *adam))),
        "easgd_elastic_flat": (lambda: list(S.sharded_easgd_flat(
            sh, cl[:3], 0.3, mesh)), lambda: list(ops.fused_easgd_flat(
                s, cl[:3], 0.3)))}
    for name, (sharded, whole) in cases.items():
        VK.reset_launch_count()
        got = sharded()
        assert VK.launch_counts() == {**dict.fromkeys(VK.KERNELS, 0),
                                      name: n_shards}
        for a, b in zip(got, whole()):
            assert torch.equal(S.gather_flat(a), b), name


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 64)])
def test_flash_attention_over_cp_chunks_equals_one_chunk(dev, dtype, hd):
    """``blocked_attention`` over 4 contiguous chunks is one B13 call on
    the [b, h, P*sl, hd] view: the P = 1 call's bits, forward and (under
    autograd) backward; the strided layout has no kernel and raises."""
    from repro_torch.models import layers as L
    b, P, sl, h, kvh = 2, 4, 128, 8, 4
    q = _rand(dev, b, P * sl, h, hd, dtype=dtype, seed=5)
    k = _rand(dev, b, P * sl, kvh, hd, dtype=dtype, seed=6)
    v = _rand(dev, b, P * sl, kvh, hd, dtype=dtype, seed=7)
    pos = np.arange(P * sl).reshape(P, sl)

    def run(chunks, window):
        qq, kk, vv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        qc = qq.reshape(b, P, sl, h, hd) if chunks else qq[:, None]
        o = L.blocked_attention(qc, kk, vv, causal=True, window=window,
                                q_positions=pos if chunks else None)
        o.float().square().sum().backward()
        return [o.reshape(b, P * sl, h, hd).detach(), qq.grad, kk.grad,
                vv.grad]

    for window in (None, 200):
        VK.reset_launch_count()
        got = run(True, window)
        assert VK.launch_count("flash_attention") == 1
        assert VK.launch_count("flash_attention_bwd") == 1
        for a, w_ in zip(got, run(False, window)):
            assert torch.equal(a, w_)
    with pytest.raises(NotImplementedError, match="no kernel"):
        L.blocked_attention(q.reshape(b, P, sl, h, hd), k, v, causal=True,
                            q_positions=L.strided_positions(P, sl))
