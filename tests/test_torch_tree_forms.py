"""Port parity: the tree forms against the reference, on numpy inputs made
from a seed — ``core/vc_asgd.py``'s Eq. 1 / Eq. 2 on parameter trees, the
delta forms, ``dc_asgd_gradient`` and the invariants; ``compress_delta``,
``topk_mask`` and ``compress_tree_global``; the tree Adam with
``flat_opt_from_tree``; and ``compressed_assimilate_per_leaf`` on the
bench model (the port's bench's per-leaf baseline).

Tolerance: none, except ``tree_norm`` (rtol 1e-6: XLA's f32 reduction
order is not reproduced).  Eq. 1, its delta form, Eq. 2, DC-ASGD's
gradient, the payloads, residuals and masks, the Adam steps and the
per-leaf compressed round are bit-exact against the reference's eager
paths, where tests/test_flat.py pins the flat-vs-tree bits too (Eq. 2,
the delta form, Adam).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.core import flat as RF
from repro.core import vc_asgd as RV
from repro.optim import optimizers as RO
from repro.runtime import vc_runtime as RVR
from repro_torch.core import compression as PC
from repro_torch.core import flat as PF
from repro_torch.core import vc_asgd as PV
from repro_torch.kernels import vc_asgd_update as VK
from repro_torch.optim import optimizers as PO
from repro_torch.runtime import vc_runtime as PVR

torch.set_num_threads(2)

SHAPES = {"a": (17,), "b": {"w": (255, 9), "u": (3, 5, 7, 11)},
          "c": (64, 129)}
# benchmarks/kernel_bench.py:111: 6 leaf shapes x 4 repeats
BENCH_SIZES = [(256, 256), (1024, 64), (64,), (512, 512), (128, 1024),
               (1024,)]


def _tree(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return build(shapes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _ref(tree, dtype=jnp.float32):
    return _map(lambda a: jnp.asarray(a, dtype), tree)


def _port(tree, dtype=torch.float32):
    return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                .to(dtype), tree)


def _leaves_bytes(tree) -> list:
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _leaves_bytes(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy().tobytes()]
    return [np.asarray(tree.astype(jnp.float32)).tobytes()]


def _same(ref_tree, port_tree):
    assert _leaves_bytes(ref_tree) == _leaves_bytes(port_tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.95, 1.0])
def test_tree_eq1_bit_exact(alpha, dtype):
    s, c = _tree(0), _tree(1)
    ref = RV.vc_asgd_update(_ref(s, getattr(jnp, dtype)),
                            _ref(c, getattr(jnp, dtype)), alpha)
    VK.reset_launch_count()
    port = PV.vc_asgd_update(_port(s, getattr(torch, dtype)),
                             _port(c, getattr(torch, dtype)), alpha)
    assert VK.launch_count() == 0                # the CPU: plain versions
    assert port["b"]["w"].dtype == getattr(torch, dtype)
    _same(ref, port)


@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_delta_forms_bit_exact(alpha):
    s, d = _tree(2), _tree(3, scale=0.01)
    _same(RV.vc_asgd_update_delta(_ref(s), _ref(d), alpha),
          PV.vc_asgd_update_delta(_port(s), _port(d), alpha))
    rfp, pfp = RF.flatten(_ref(s)), PF.flatten(_port(s))
    rdb, pdb = RF.flatten(_ref(d)).buf, PF.flatten(_port(d)).buf
    ref = RV.vc_asgd_update_delta_flat(rfp, rdb, alpha)
    port = PV.vc_asgd_update_delta_flat(pfp, pdb, alpha)
    assert np.asarray(ref.buf).tobytes() == port.buf.numpy().tobytes()
    port2 = PV.vc_asgd_update_delta_flat(pfp, pfp.with_buf(pdb), alpha)
    assert torch.equal(port2.buf, port.buf)
    # the flat delta form is the tree delta form on the bus
    tree = PV.vc_asgd_update_delta(_port(s), _port(d), alpha)
    assert torch.equal(PF.flatten(tree).buf, port.buf)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_tree_eq2_bit_exact_and_equal_to_flat(n):
    s = _tree(4)
    cs = [_tree(10 + j) for j in range(n)]
    ref = RV.assimilate_many(_ref(s), [_ref(c) for c in cs], 0.9)
    port = PV.assimilate_many(_port(s), [_port(c) for c in cs], 0.9)
    _same(ref, port)
    fp = PF.flatten(_port(s))
    flat = PV.assimilate_many_flat(
        fp, [PF.flatten(_port(c)) for c in cs], 0.9)
    assert torch.equal(PF.flatten(port).buf, flat.buf)
    assert PV.assimilate_many(_port(s), [], 0.9)["a"] is not None


def test_dc_asgd_gradient_and_invariants():
    g, wn, wb = _tree(5, scale=0.1), _tree(6), _tree(7)
    _same(RV.dc_asgd_gradient(_ref(g), _ref(wn), _ref(wb), 0.05),
          PV.dc_asgd_gradient(_port(g), _port(wn), _port(wb), 0.05))
    for n in (1, 4, 9):
        for alpha in (0.0, 0.5, 0.99):
            assert (PV.is_convex_combination(n, alpha)
                    == RV.is_convex_combination(n, alpha))
    t = _tree(8)
    np.testing.assert_allclose(float(PV.tree_norm(_port(t))),
                               float(RV.tree_norm(_ref(t))), rtol=1e-6)
    assert (float(PV.tree_max_abs(_port(t)))
            == float(RV.tree_max_abs(_ref(t))))
    assert PV.tree_max_abs(_port(t, torch.bfloat16)).dtype == torch.float32


@pytest.mark.parametrize("n,k", [(1000, 50), (300, 300), (1 << 20, 52428)])
def test_topk_mask_equals_reference(n, k):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[::5] = np.round(x[::5])                 # magnitude ties
    shape = (n // 4, 4)
    ref = np.asarray(RC.topk_mask(jnp.asarray(x.reshape(shape)), k))
    port = PC.topk_mask(torch.from_numpy(x.reshape(shape)), k)
    assert port.shape == shape and port.dtype == torch.bool
    assert int(port.sum()) == k
    assert np.array_equal(ref, port.numpy())


@pytest.mark.parametrize("shape", [(1000,), (255, 9), (3, 5, 7, 11)])
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_compress_delta_equals_reference(shape, density):
    d = (np.random.default_rng(len(shape)).standard_normal(shape)
         * 0.01).astype(np.float32)
    rp, rr = RC.compress_delta(jnp.asarray(d), density=density)
    pp, pr = PC.compress_delta(torch.from_numpy(d), density=density)
    assert pp.shape == rp.shape == shape and pr.shape == shape
    for f in ("values", "scales", "indices"):
        assert (np.asarray(getattr(rp, f)).tobytes()
                == getattr(pp, f).numpy().tobytes())
    assert np.asarray(rr).tobytes() == pr.numpy().tobytes()
    assert (np.asarray(RC.decompress_delta(rp)).tobytes()
            == PC.decompress_delta(pp).numpy().tobytes())


def test_compress_tree_global_equals_reference():
    t = _tree(9, scale=0.01)
    res0 = np.random.default_rng(1).standard_normal(16384).astype(
        np.float32) * np.float32(0.001)
    for residual in (None, res0):
        rp, rr, rspec = RC.compress_tree_global(
            _ref(t), density=0.1,
            residual=None if residual is None else jnp.asarray(residual))
        pp, pr, pspec = PC.compress_tree_global(
            _port(t), density=0.1,
            residual=None if residual is None else torch.from_numpy(residual))
        assert pspec.meta() == rspec.meta()
        for f in ("values", "scales", "indices"):
            assert (np.asarray(getattr(rp, f)).tobytes()
                    == getattr(pp, f).numpy().tobytes())
        assert np.asarray(rr).tobytes() == pr.numpy().tobytes()
        back = PF.unflatten(PF.FlatParams(PC.decompress_flat(pp), pspec))
        ref_back = RF.unflatten(RF.FlatParams(RC.decompress_flat(rp), rspec))
        _same(ref_back, back)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_tree_adam_bit_exact_and_lifts_onto_the_bus(wd):
    """Three tree steps against the reference's eager tree Adam, then the
    state lifted onto the bus continues on the flat path exactly as the
    tree path does."""
    params = _tree(11)
    ropt, popt = RO.Adam(lr=1e-3, weight_decay=wd), PO.Adam(
        lr=1e-3, weight_decay=wd)
    rp, pp = _ref(params), _port(params)
    rs, ps = ropt.init(rp), popt.init(pp)
    assert ps.step == 0 and ps.m["b"]["w"].dtype == torch.float32
    for step in range(3):
        g = _tree(20 + step, scale=0.1)
        rp, rs = ropt.update(_ref(g), rs, rp)
        pp, ps = popt.update(_port(g), ps, pp)
        _same(rp, pp)
        _same(rs.m, ps.m)
        _same(rs.v, ps.v)
        assert ps.step == int(rs.step) == step + 1
    spec = PF.tree_spec(pp)
    fos = PO.flat_opt_from_tree(ps, spec)
    rfos = RO.flat_opt_from_tree(rs, RF.tree_spec(rp))
    assert fos.step == 3
    assert fos.m.numpy().tobytes() == np.asarray(rfos.m).tobytes()
    assert fos.v.numpy().tobytes() == np.asarray(rfos.v).tobytes()
    g = _tree(30, scale=0.1)
    fp, fos = popt.update_flat(PF.flatten_like(_port(g), spec), fos,
                               PF.flatten(pp))
    pp, ps = popt.update(_port(g), ps, pp)
    assert torch.equal(fp.buf, PF.flatten(pp).buf)
    assert torch.equal(fos.m, PF.flatten_like(ps.m, spec))
    assert torch.equal(fos.v, PF.flatten_like(ps.v, spec))


def _bench_model(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {f"layer{rep}/p{i}": rng.standard_normal(shp).astype(np.float32)
            for rep in range(4) for i, shp in enumerate(BENCH_SIZES)}


def test_compressed_assimilate_per_leaf_bench_model():
    """The reference's bench baseline on its bench model (24 leaves,
    2,101,504 parameters, 4 islands, density 0.05): two rounds with the
    residuals carried and island 2 dead in the second; server and
    residuals bit for bit."""
    server = _bench_model(0)
    r_srv, p_srv = _ref(server), _port(server)
    r_res = p_res = None
    for rnd, dead in enumerate((None, 2)):
        rng = np.random.default_rng(50 + rnd)
        isl = {k: np.stack([v + np.float32(0.01) * rng.standard_normal(
            v.shape).astype(np.float32) for _ in range(4)])
            for k, v in server.items()}
        alive = np.ones(4, bool)
        if dead is not None:
            alive[dead] = False
        r_srv, r_res = RVR.compressed_assimilate_per_leaf(
            r_srv, _ref(isl), 0.9, jnp.asarray(alive), density=0.05,
            residuals=r_res)
        VK.reset_launch_count()
        p_srv, p_res = PVR.compressed_assimilate_per_leaf(
            p_srv, _port(isl), 0.9, torch.from_numpy(alive), density=0.05,
            residuals=p_res, device="cpu")
        assert VK.launch_count() == 0
        assert p_res["layer0/p0"].shape == (4, 256, 256)
        _same(r_srv, p_srv)
        _same(r_res, p_res)


def test_compressed_assimilate_per_leaf_needs_a_device():
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    server = {"w": torch.zeros(8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PVR.compressed_assimilate_per_leaf(
            server, {"w": torch.zeros(2, 8)}, 0.9, torch.ones(2, dtype=bool))
    assert resolve_device("cpu").type == "cpu"
