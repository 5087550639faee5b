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
(2e-2, outputs rounded to bf16).  The WKV6 recurrence (B14) likewise sums
in another order: 2e-5 in f32 (the reference's test_wkv6 tolerance), 2e-2
on bf16 outputs.  The selective scan (B15) fuses its multiply-adds where
the plain version rounds each product: 2e-5 on y in f32 and on the f32
final state (the reference's test_mamba_scan tolerance), 2e-2 on y
rounded to bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.flat import BLOCK
from repro_torch.kernels import flash_attention as FK
from repro_torch.kernels import mamba_scan as MK
from repro_torch.kernels import quantize as QK
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as WK
from repro_torch.kernels import sparse_pack as SK
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4, 9])
def test_assimilate_bit_exact(dev, dtype, n):
    s = _rand(dev, 2 * BLOCK, dtype=dtype)
    c = _rand(dev, n, 2 * BLOCK, dtype=dtype, seed=2)
    w = [0.3 ** n] + [0.7 * 0.3 ** (n - 1 - j) for j in range(n)]
    VK.reset_launch_count()
    out = VK.assimilate_flat(s, c, w)
    assert VK.launch_count("assimilate_flat") == 1
    assert _bits_equal(out, R.assimilate(s, c, w))


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


@pytest.mark.parametrize("k", [1, 255, 256, 656, 1313, 70000])
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


def test_quantize_rounds_half_to_even(dev):
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                     device=dev)
    q, s = QK.quantize_int8(x)
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126] and s.item() == 1.0


@pytest.mark.parametrize("k", [1, 656, 1313, 4097])
def test_pack_body_bytes_equal(dev, k):
    q, s = QK.quantize_int8(_rand(dev, k, seed=k))
    idx = torch.arange(k, dtype=torch.int32, device=dev) * 3 + 1
    VK.reset_launch_count()
    body = SK.pack_body(q, s, idx)
    assert VK.launch_counts()["pack_body"] == 1
    assert body.dtype == torch.uint8 and torch.equal(body,
                                                     R.pack_body(q, s, idx))


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


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_case(dev, b, h, kvh, sq, skv, hd, dtype, seed=0):
    q = (_rand(dev, b, h, sq, hd, seed=seed) * 0.5).to(dtype)
    k = (_rand(dev, b, kvh, skv, hd, seed=seed + 1) * 0.5).to(dtype)
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
    want = R.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = ATTN_TOL[c["dtype"]]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert got.transpose(1, 2).is_contiguous()     # [b, s, h, hd] buffer


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
@pytest.mark.parametrize("hd,T", [(16, 37), (64, 300), (64, 1)])
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
                                     (512, 16, 1), (200, 16, 17)])
def test_mamba_scan_matches_plain(dev, di, ds, T, strided):
    """B15 at jamba's reduced (ds 4, ragged T) and published (ds 16)
    state dims, and a di that is not a multiple of the block's 128
    channels: 2e-5 on y and h_T in f32."""
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
