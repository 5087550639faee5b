"""Port parity: repro_torch.runtime.vc_runtime (and the batched flat bus it
rides) against repro.runtime.vc_runtime, on numpy inputs made from a
seed.

Tolerance: none.  ``island_weights`` equals the reference's f32 weights
bit for bit.  The masked Eq. 2 (``assimilate_flat``, in B2's order, the
reference's kernel route) and the redistribution equal the reference's
bit for bit.  ``compressed_assimilate`` on the bench model of
``benchmarks/kernel_bench.py:370-383`` (24 leaves, 2,101,504 parameters
on a 2,105,344-element bus, 4 islands, density 0.05), over 3 rounds with
the residuals carried and a dead island, returns the reference's server
and residuals bit for bit.  Every frame the transport carried equals the
reference's byte for byte outside the header's residual-norm field and
the crc (XLA's f32 reduction order cannot be reproduced bit for bit; the
norms are held within 2 f32 ulps, tests/test_torch_protocol.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.launch.mesh import compat_make_mesh
from repro.runtime import sharding as RS
from repro.runtime import vc_runtime as RV
from repro.transfer.transport import LoopbackTransport as RefLoopback
from repro_torch.core import flat as PF
from repro_torch.runtime import vc_runtime as PV
from repro_torch.transfer.transport import LoopbackTransport

torch.set_num_threads(2)

# benchmarks/kernel_bench.py:370-376: 6 leaf shapes x 4 repeats
SIZES = [(256, 256), (1024, 64), (64,), (512, 512), (128, 1024), (1024,)]
BENCH_N, BENCH_PADDED = 2_101_504, 2_105_344
_NORM, _CRC = slice(36, 40), slice(64, 68)


class RefRecording(RefLoopback):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


class PortRecording(LoopbackTransport):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


def _bytes(a) -> bytes:
    return a.numpy().tobytes() if isinstance(a, torch.Tensor) \
        else np.asarray(a).tobytes()


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def _bench_model(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {f"layer{rep}/p{i}": rng.standard_normal(shp).astype(np.float32)
            for rep in range(4) for i, shp in enumerate(SIZES)}


def _islands(server: dict, n: int, seed: int) -> dict:
    """``n`` islands = server + 0.01 N(0, 1), stacked island-major."""
    rng = np.random.default_rng(seed)
    return {k: np.stack([v + np.float32(0.01)
                         * rng.standard_normal(v.shape).astype(np.float32)
                         for _ in range(n)])
            for k, v in server.items()}


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("alpha", [0.8, 0.9, 0.95])
@pytest.mark.parametrize("n_pods", range(1, 9))
def test_island_weights_bit_equal(n_pods, alpha):
    for dead in (None, 0, n_pods - 1):
        alive = np.ones(n_pods, bool)
        if dead is not None:
            alive[dead] = False
        rw, rws = RV.island_weights(n_pods, alpha, jnp.asarray(alive))
        pw, pws = PV.island_weights(n_pods, alpha, torch.from_numpy(alive))
        assert pw.dtype == pws.dtype == torch.float32 and pws.dim() == 0
        assert _bytes(pw) == _bytes(rw) and _bytes(pws) == _bytes(rws)


def _eq2_inputs(n=4, width=3 * 8192, dead=(2,)):
    rng = np.random.default_rng(7)
    s = rng.standard_normal(width).astype(np.float32)
    isl = rng.standard_normal((n, width)).astype(np.float32)
    alive = np.ones(n, bool)
    for j in dead:
        alive[j] = False
        isl[j, ::5] = np.inf                    # a crashed island
        isl[j, 1::5] = np.nan
    return s, isl, alive


def _ref_fold(s, isl, alive, n):
    """The reference's Eq. 2 in B2's order (server first, then the islands
    in arrival order), what its ``use_kernel=True`` route computes.  Its
    Pallas form fails under the installed jax, so this is the reference's
    jnp form of the same fold (runtime/sharding.py:414-417) on a 1-device
    mesh, fed the islands masked as its ``assimilate_flat`` masks them."""
    rw, rws = RV.island_weights(n, 0.9, jnp.asarray(alive))
    masked = jnp.where(rw.reshape(-1, 1) > 0.0,
                       jnp.asarray(isl).astype(jnp.float32), 0.0)
    mesh = compat_make_mesh((1,), ("pod",))
    return RS.sharded_assimilate_flat(jnp.asarray(s), masked,
                                      [rws] + [rw[j] for j in range(n)],
                                      mesh, "pod")


def _port_eq2(s, isl, alive, n):
    pw, pws = PV.island_weights(n, 0.9, torch.from_numpy(alive))
    return PV.assimilate_flat(torch.from_numpy(s), torch.from_numpy(isl),
                              pw, pws)


def test_masked_assimilate_flat_equals_reference():
    """A dead island holding inf and nan: the server stays finite and
    equals the reference's fold bit for bit.  The reference's default jnp
    path sums the weighted islands before adding the server's term; that
    association differs from the fold by rounding only, held here within
    4 f32 ulps of the largest term."""
    s, isl, alive = _eq2_inputs()
    got = _port_eq2(s, isl, alive, 4)
    assert bool(torch.isfinite(got).all())
    assert _bytes(got) == _bytes(_ref_fold(s, isl, alive, 4))
    rw, rws = RV.island_weights(4, 0.9, jnp.asarray(alive))
    jnp_path = np.asarray(RV.assimilate_flat(jnp.asarray(s), jnp.asarray(isl),
                                             rw, rws))
    scale = np.abs(np.where(alive[:, None], isl, 0.0)).max() + np.abs(s).max()
    assert np.abs(got.numpy() - jnp_path).max() <= 4 * np.spacing(
        np.float32(scale))


def test_masked_assimilate_flat_kernel_route_equals_reference_fold(
        monkeypatch):
    """The one route is B2 (``ops.fused_assimilate_flat``, its plain
    version on the CPU), called once: a bf16 server and 8 islands, 3 of
    them dead, stored in the server's dtype as the reference's fold."""
    calls = []
    fused = PV.K.fused_assimilate_flat
    monkeypatch.setattr(PV.K, "fused_assimilate_flat",
                        lambda *a: calls.append(1) or fused(*a))
    s, isl, alive = _eq2_inputs(n=8, dead=(0, 4, 7))
    s16 = torch.from_numpy(s).to(torch.bfloat16)
    pw, pws = PV.island_weights(8, 0.9, torch.from_numpy(alive))
    got = PV.assimilate_flat(s16, torch.from_numpy(isl), pw, pws)
    assert calls == [1] and got.dtype == torch.bfloat16
    want = _ref_fold(jnp.asarray(s16.float().numpy()).astype(jnp.bfloat16),
                     isl, alive, 8)
    assert _bytes(got.view(torch.int16)) \
        == np.asarray(want).view(np.int16).tobytes()


@pytest.mark.parametrize("dead", [(), (0,), (3,), (1, 2), (0, 1, 2, 3)],
                         ids=["none", "first", "last", "middle", "all"])
def test_masked_assimilate_flat_every_dead_set(dead):
    """Any set of dead islands, crashed with inf and nan, against the
    reference's fold; with every island dead the server comes back as it
    was (w_s = 1)."""
    s, isl, alive = _eq2_inputs(dead=dead)
    got = _port_eq2(s, isl, alive, 4)
    assert bool(torch.isfinite(got).all())
    assert _bytes(got) == _bytes(_ref_fold(s, isl, alive, 4))
    if len(dead) == 4:
        assert _bytes(got) == _bytes(s)


def test_redistribute_and_batched_bus_equal_reference():
    server = _bench_model(1)
    isl = _islands(server, 3, 2)
    rbuf, rspec = RF.flatten_batched(_ref(isl))
    pbuf, pspec = PF.flatten_batched(_port(isl))
    assert pspec.meta() == rspec.meta()
    assert (pspec.n, pspec.padded) == (BENCH_N, BENCH_PADDED)
    assert _bytes(pbuf) == _bytes(rbuf)
    back = PF.unflatten_batched(pbuf, pspec, dtype=torch.bfloat16)
    want = RF.unflatten_batched(rbuf, rspec, dtype=jnp.bfloat16)
    for k in server:
        assert back[k].dtype == torch.bfloat16
        assert _bytes(back[k].view(torch.int16)) \
            == np.asarray(want[k]).view(np.int16).tobytes()
    s = np.arange(2 * 8192, dtype=np.float32)
    got = PV.redistribute_flat(torch.from_numpy(s), 3)
    assert _bytes(got) == _bytes(RV.redistribute_flat(jnp.asarray(s), 3))
    got[0, 0] = -1.0                          # each island owns its copy
    assert got[1, 0] == 0.0 and s[0] == 0.0


def _masked(frame: bytes) -> bytes:
    b = bytearray(frame)
    b[_NORM] = bytes(4)
    b[_CRC] = bytes(4)
    return bytes(b)


def test_compressed_assimilate_bench_model_three_rounds():
    """3 rounds, residuals carried, island 2 dead in round 2: server and
    residuals bit for bit, frames byte for byte but the norm and crc."""
    server = _bench_model(0)
    rs, ps = _ref(server), _port(server)
    rres = pres = None
    rt, pt = RefRecording(), PortRecording()
    for rnd in range(3):
        isl = _islands(server, 4, 10 + rnd)
        alive = np.array([True, True, rnd != 1, True])
        rs, rres = RV.compressed_assimilate(
            rs, _ref(isl), 0.9, jnp.asarray(alive), density=0.05,
            residuals=rres, transport=rt)
        ps, pres = PV.compressed_assimilate(
            ps, _port(isl), 0.9, torch.from_numpy(alive), density=0.05,
            residuals=pres, transport=pt, device="cpu")
        for k in server:
            assert ps[k].dtype == torch.float32 and pres[k].dtype == torch.float32
            assert tuple(pres[k].shape) == (4,) + server[k].shape
            assert _bytes(ps[k]) == _bytes(rs[k]), (rnd, k)
            assert _bytes(pres[k]) == _bytes(rres[k]), (rnd, k)
        server = {k: np.asarray(v) for k, v in rs.items()}
    assert len(pt.sent) == len(rt.sent) == 12
    assert vars(pt.stats) == vars(rt.stats)
    for pf, rf in zip(pt.sent, rt.sent):
        assert len(pf) == 68 + 5 * 105_075 + 4 * 411
        assert _masked(pf) == _masked(rf)
        assert _ulps(np.frombuffer(pf[_NORM], np.float32)[0],
                     np.frombuffer(rf[_NORM], np.float32)[0]) <= 2


def test_compressed_assimilate_without_transport_and_bf16_server():
    """No transport: the payload goes straight to decompression; a bf16
    server comes back in bf16 (Eq. 2 in f32, one rounding at the end)."""
    server = {k: v for k, v in list(_bench_model(5).items())[:6]}
    isl = _islands(server, 2, 6)
    alive = np.array([True, True])
    rs, rres = RV.compressed_assimilate(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), _ref(server)),
        _ref(isl), 0.95, jnp.asarray(alive), density=0.01)
    ps, pres = PV.compressed_assimilate(
        {k: v.to(torch.bfloat16) for k, v in _port(server).items()},
        _port(isl), 0.95, torch.from_numpy(alive), density=0.01,
        device="cpu")
    for k in server:
        assert ps[k].dtype == torch.bfloat16
        assert _bytes(ps[k].view(torch.int16)) \
            == np.asarray(rs[k]).view(np.int16).tobytes()
        assert _bytes(pres[k]) == _bytes(rres[k])
