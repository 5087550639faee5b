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
