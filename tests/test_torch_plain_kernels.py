"""Port parity: the plain versions of B4 (DC-ASGD's corrected lerp), B8 (the
threshold pass) and B11 (quantize + pack) against the reference's jnp
oracles (``repro.kernels.ref``) and its Pallas kernels in interpret mode
(``repro.kernels.ops``), on numpy inputs made from a seed; and the port's
``ops`` routes for them on the CPU.

Tolerances:
* B4: bit-exact against the eager ``ref.vc_asgd_dc_lerp``; against the
  interpret-mode kernel 4 * tests/test_kernels.py::TOL (the reference's
  own kernel-vs-oracle tolerance, :49): XLA compiles the kernel's
  ``lam*g*g*(s-b)`` chain into fused, contracted arithmetic, a few ulps
  off the separate IEEE operations.
* B8: bit-exact in f32 against both, signed zeros included.  In bf16 the
  port follows the Pallas kernel (|x| compared in f32 against an f32
  tau) and is bit-exact against it; the jnp oracle compares in bf16
  against tau rounded to bf16, a different cut for a tau between two
  bf16 values (pinned below).
* B11: bit-exact against ``ref.quantize_pack``.  Against the
  interpret-mode kernel q is exact, the scales within 1 ulp (XLA turns
  ``max / 127`` into a reciprocal multiply, ROADMAP queue C) and the body
  exact outside its scale section.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RK
from repro.kernels import ref as RR
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as PR
from repro_torch.kernels import sparse_pack as SK
from repro_torch.kernels import topk_mask as TK
from repro_torch.kernels import vc_asgd_update as VK

torch.set_num_threads(2)

TOL = {"float32": 2e-6, "bfloat16": 2e-2}        # tests/test_kernels.py:20
SHAPES = [(17,), (513,), (255, 9), (64, 129), (3, 5, 7, 11), (16384,)]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _bits(a) -> bytes:
    return _f32(a).view(np.int32).tobytes()


def _arrays(shape, dtype, seed, n=4):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_dc_lerp_matches_reference(shape, dtype):
    j, t = _arrays(shape, dtype, seed=len(shape) + shape[0])
    got = PR.vc_asgd_dc_lerp(*t, 0.9, 0.05)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    assert _bits(got) == _bits(RR.vc_asgd_dc_lerp(*j, 0.9, 0.05))
    np.testing.assert_allclose(_f32(got),
                               _f32(RK.fused_dc_lerp(*j, 0.9, 0.05)),
                               rtol=4 * TOL[dtype], atol=4 * TOL[dtype])
    assert torch.equal(ops.fused_dc_lerp(*t, 0.9, 0.05), got)


@pytest.mark.parametrize("alpha,lam", [(0.0, 0.04), (0.5, 0.0),
                                       (0.95, 0.04), (1.0, 1.5)])
def test_plain_dc_lerp_flat_scalars(alpha, lam):
    j, t = _arrays((2 * 8192,), "float32", seed=3)
    got = ops.fused_dc_lerp_flat(*t, alpha, lam)
    assert _bits(got) == _bits(RR.vc_asgd_dc_lerp(*j, alpha, lam))
    np.testing.assert_allclose(
        _f32(got), _f32(RK.fused_dc_lerp_flat(*j, alpha, lam)),
        rtol=4 * TOL["float32"], atol=4 * TOL["float32"])
    if lam == 0.0:         # no correction: Eq. 1 itself, bit for bit
        assert torch.equal(got, PR.vc_asgd_lerp(t[0], t[1], alpha))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_per_tensor_lerp_matches_reference(shape, dtype):
    j, t = _arrays(shape, dtype, seed=7, n=2)
    got = ops.fused_lerp(*t, 0.95)
    assert _bits(got) == _bits(RR.vc_asgd_lerp(*j, 0.95))
    np.testing.assert_allclose(_f32(got), _f32(RK.fused_lerp(*j, 0.95)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("tau", [0.0, 0.01, 0.5, 1.3, 10.0])
@pytest.mark.parametrize("n", [1, 7, 1000, 9000, 3 * 8192])
def test_plain_threshold_matches_reference_f32(n, tau):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[::7] = -0.0
    x[1::11] = 0.0
    kt, rt = PR.threshold_sparsify(torch.from_numpy(x), tau)
    for kj, rj in (RR.threshold_sparsify(jnp.asarray(x), tau),
                   RK.threshold_sparsify(jnp.asarray(x), tau)):
        assert _bits(kt) == _bits(kj) and _bits(rt) == _bits(rj)
    assert np.array_equal(kt.numpy() + rt.numpy(), x)
    ko, ro = ops.threshold_sparsify(torch.from_numpy(x), tau)
    assert torch.equal(ko, kt) and torch.equal(ro, rt)


def test_plain_threshold_signed_zeros():
    """x - x is +0.0 where x is kept; (-0.0) - 0.0 is -0.0 where not."""
    x = torch.tensor([-0.0, 0.0, -2.0, 2.0, -0.5])
    kept, res = PR.threshold_sparsify(x, 1.0)
    assert kept.tolist() == [0.0, 0.0, -2.0, 2.0, 0.0]
    assert torch.signbit(res).tolist() == [True, False, False, False, True]
    assert not torch.signbit(kept[kept == 0]).any()
    kept, res = PR.threshold_sparsify(x, 0.0)        # all kept
    assert torch.signbit(kept).tolist() == [True, False, True, False, True]
    assert not torch.signbit(res).any()


def test_plain_threshold_bf16_follows_the_kernel_not_the_oracle():
    """tau = 1.003 lies between the bf16 values 1.0 and 1.0078125 and
    rounds to 1.0 in bf16: the jnp oracle keeps |x| = 1.0, the Pallas
    kernel (f32 compare) and the port do not."""
    x = np.array([1.0, -1.0, 1.0078125, 0.5, -2.0], np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    tau = 1.003
    assert float(jnp.bfloat16(tau)) == 1.0
    kt, rt = PR.threshold_sparsify(xt, tau)
    kk, rk = RK.threshold_sparsify(xj, tau)
    ko, _ = RR.threshold_sparsify(xj, tau)
    assert kt.dtype == torch.bfloat16
    assert _bits(kt) == _bits(kk) and _bits(rt) == _bits(rk)
    assert _f32(kt).tolist() == [0.0, 0.0, 1.0078125, 0.0, -2.0]
    assert _f32(ko).tolist() == [1.0, -1.0, 1.0078125, 0.0, -2.0]


@pytest.mark.parametrize("n", [1000, 3 * 8192 + 5])
def test_plain_threshold_bf16_bit_exact_vs_kernel(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    for tau in (0.01, 0.37, 1.0):
        kt, rt = PR.threshold_sparsify(xt, tau)
        kk, rk = RK.threshold_sparsify(xj, tau)
        assert _bits(kt) == _bits(kk) and _bits(rt) == _bits(rk)


def _payload(k, seed=0):
    rng = np.random.default_rng(seed + k)
    sel = (rng.standard_normal(k) * 0.01).astype(np.float32)
    sel[k // 3] = 0.0
    idx = np.sort(rng.choice(1 << 22, k, replace=False)).astype(np.int32)
    return sel, idx


@pytest.mark.parametrize("k", [1, 255, 256, 656, 1000, 1313, 4096])
def test_plain_quantize_pack_matches_reference(k):
    sel, idx = _payload(k)
    ng = -(-k // 256)
    bt, qt, st = PR.quantize_pack(torch.from_numpy(sel),
                                  torch.from_numpy(idx))
    assert bt.numel() == 5 * k + 4 * ng and qt.numel() == ng * 256
    bo, qo, so = RR.quantize_pack(jnp.asarray(sel), jnp.asarray(idx))
    assert bt.numpy().tobytes() == np.asarray(bo).tobytes()
    assert qt.numpy().tobytes() == np.asarray(qo).tobytes()
    assert st.numpy().tobytes() == np.asarray(so).tobytes()
    bp, qp, sp = RK.fused_quantize_pack(jnp.asarray(sel), jnp.asarray(idx))
    assert qt.numpy().tobytes() == np.asarray(qp).tobytes()
    ulps = np.abs(st.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(sp).view(np.int32)).max()
    assert ulps <= 1
    body = np.ones(bt.numel(), bool)
    body[k:k + 4 * ng] = False               # the scale section
    assert np.array_equal(bt.numpy()[body], np.asarray(bp)[body])
    # B12 of B9's payload is the same body
    q9, s9 = PR.quantize_int8(torch.from_numpy(sel))
    assert torch.equal(PR.pack_body(q9, s9, torch.from_numpy(idx)), bt)
    got = ops.fused_quantize_pack(torch.from_numpy(sel),
                                  torch.from_numpy(idx))
    assert all(torch.equal(a, b) for a, b in zip(got, (bt, qt, st)))


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_new_wrappers_refuse_cpu_tensors_and_cpu_route_never_builds(no_build):
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        VK.vc_asgd_lerp(x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        VK.vc_asgd_dc_lerp(x, x, x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        VK.vc_asgd_dc_lerp_flat(x, x, x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        TK.threshold_sparsify(x, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        SK.quantize_pack(x, torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.threshold_sparsify(x.to("meta"), 0.1)
    VK.reset_launch_count()
    ops.fused_dc_lerp(x, x, x, x, 0.5)
    ops.fused_quantize_pack(x, torch.zeros(64, dtype=torch.int32))
    ops.threshold_sparsify(x, 0.1)
    assert VK.launch_count() == 0
