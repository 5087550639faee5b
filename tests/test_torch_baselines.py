"""Port parity: the six schemes of repro_torch.core.baselines beyond VC-ASGD
against repro.core.baselines, driven through the same state and payloads.

Each test starts both packages from ONE state (``state_from_reference``
carries the reference's params, replicas, backups and barrier buffers
across) and runs the same script of ``on_issue`` / ``handout`` /
``encode_payload`` / ``assimilate`` / ``drop_client`` calls.

Tolerance: none.  The elementwise schemes (Downpour, DC-ASGD, persistent
EASGD, compressed VC-ASGD) are bit-exact by construction (the
reference's operation order, f32-rounded scalars).  The two reductions
were measured bit-exact too and are held so: SyncBSP's mean (a sum from
zero in arrival order, then one IEEE division) and the pod's elastic
round (B5's replica sum from zero in slot order) against the reference's
``stack(...).mean(axis=0)`` and ``ref.easgd_elastic``'s ``sum(axis=0)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as RB
from repro.core import flat as RF
from repro.kernels import ref as RR
from repro.protocol.types import Lease as RLease
from repro.protocol.types import ResultMeta as RMeta
from repro_torch.convert import state_from_reference
from repro_torch.core import baselines as PB
from repro_torch.core import flat as PF
from repro_torch.kernels import ref as PR
from repro_torch.protocol.types import Lease as PLease
from repro_torch.protocol.types import ResultMeta as PMeta

torch.set_num_threads(2)


def _bytes(a) -> bytes:
    return a.numpy().tobytes() if isinstance(a, torch.Tensor) \
        else np.asarray(a).tobytes()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((40, 30)).astype(np.float32),
            "b": rng.standard_normal(30).astype(np.float32)}


class Pair:
    """One scheme in both packages, from one state."""

    def __init__(self, ref_scheme, port_scheme, seed=0):
        t = _tree(seed)
        self.r, self.p = ref_scheme, port_scheme
        self.rfp = RF.flatten({k: jnp.asarray(v) for k, v in t.items()})
        self.pfp = PF.flatten({k: torch.from_numpy(v) for k, v in t.items()})
        self.rs = self.r.init_state(self.rfp)
        self.ps = state_from_reference(self.rs, self.p.init_state(self.pfp),
                                       "cpu")

    def buf(self, seed, scale=1.0):
        n = self.rfp.spec.padded
        x = (np.random.default_rng(seed).standard_normal(n).astype(np.float32)
             * np.float32(scale) * (np.arange(n) < self.rfp.spec.n))
        return x

    def base(self, seed):
        """The same reconstruction base as FlatParams in both."""
        x = self.buf(seed)
        return (self.rfp.with_buf(jnp.asarray(x)),
                self.pfp.with_buf(torch.from_numpy(x)))

    def meta(self, cid, shard=0, base=(None, None), epoch=1):
        return (RMeta(cid=cid, unit_uid=cid, epoch=epoch, shard=shard,
                      read_version=0, server_version=0, base=base[0]),
                PMeta(cid=cid, unit_uid=cid, epoch=epoch, shard=shard,
                      read_version=0, server_version=0, base=base[1]))

    def assimilate(self, payload, meta):
        rp, pp = payload
        self.rs = self.r.assimilate(self.rs, rp, meta[0])
        self.ps = self.p.assimilate(self.ps, pp, meta[1])

    def encode(self, trained_seed, base, residual=(None, None)):
        x = self.buf(trained_seed)
        return (self.r.encode_payload(jnp.asarray(x), base[0], residual[0]),
                self.p.encode_payload(torch.from_numpy(x), base[1],
                                      residual[1]))

    def assert_params(self):
        assert _bytes(self.ps.params.buf) == _bytes(self.rs.params.buf)
        assert self.ps.version == self.rs.version


def test_downpour_bit_exact():
    pr = Pair(RB.Downpour(server_lr=0.5), PB.Downpour(server_lr=0.5))
    base = pr.base(1)
    (rd, rres), (pd, pres) = pr.encode(2, base)
    assert rres is None and pres is None and _bytes(rd) == _bytes(pd)
    pr.assimilate((rd, pd), pr.meta(0))
    pr.assimilate((jnp.asarray(pr.buf(3, 1e-2)),
                   torch.from_numpy(pr.buf(3, 1e-2))), pr.meta(1))
    pr.assert_params()
    assert pr.ps.version == 2


def test_dcasgd_backups_and_compensation_bit_exact():
    pr = Pair(RB.DCASGD(server_lr=0.5, lam=0.05),
              PB.DCASGD(server_lr=0.5, lam=0.05))
    for cid, seed in ((0, 4), (1, 5), (0, 6)):     # latest handout wins
        rb, pb = pr.base(seed)
        args = dict(cid=cid, uid=seed, round=1, shard=0, read_version=0,
                    issued_at=0.0)
        pr.r.on_issue(pr.rs, RLease(base=rb, **args))
        pr.p.on_issue(pr.ps, PLease(base=pb, **args))
    assert set(pr.ps.backups) == set(pr.rs.backups) == {0, 1}
    assert _bytes(pr.ps.backups[0].buf) == _bytes(pr.rs.backups[0].buf)
    for cid, seed in ((0, 7), (2, 8), (1, 9)):     # cid 2: no backup
        d = pr.buf(seed, 0.3)
        pr.assimilate((jnp.asarray(d), torch.from_numpy(d)), pr.meta(cid))
        pr.assert_params()
    pr.r.drop_client(pr.rs, 1)
    pr.p.drop_client(pr.ps, 1)
    assert set(pr.ps.backups) == set(pr.rs.backups)


def test_easgd_persistent_replicas_bit_exact():
    pr = Pair(RB.EASGDPersistent(beta=0.05), PB.EASGDPersistent(beta=0.05))
    assert PB.EASGDPersistent.requires_all_clients
    assert PB.EASGDPersistent.has_local_replicas
    for cid, seed in ((0, 10), (1, 11), (0, 12)):
        x = pr.buf(seed)
        pr.assimilate((jnp.asarray(x), torch.from_numpy(x)), pr.meta(cid))
        pr.assert_params()
        for c in (0, 1, 2):
            r = pr.r.handout(pr.rs, c, pr.rs.params)
            p = pr.p.handout(pr.ps, c, pr.ps.params)
            assert _bytes(p.buf) == _bytes(r.buf)
    pr.r.drop_client(pr.rs, 0)
    pr.p.drop_client(pr.ps, 0)
    assert set(pr.ps.replicas) == set(pr.rs.replicas) == {1}
    assert pr.p.handout(pr.ps, 0, pr.ps.params) is pr.ps.params


@pytest.mark.parametrize("density", [0.05, 0.1])
def test_compressed_vcasgd_encode_and_assimilate_bit_exact(density):
    pr = Pair(RB.CompressedVCASGD(0.95, density=density),
              PB.CompressedVCASGD(0.95, density=density))
    res = (None, None)
    for cid, seed in ((0, 13), (0, 14), (1, 15)):
        base = pr.base(seed + 100)
        (rp, rres), (pp, pres) = pr.encode(seed, base, res)
        for f in ("values", "scales", "indices"):
            assert _bytes(getattr(pp, f)) == _bytes(getattr(rp, f)), f
        assert _bytes(pres) == _bytes(rres)
        res = (rres, pres) if cid == 0 else (None, None)
        pr.assimilate((rp, pp), pr.meta(cid, base=base))
        pr.assert_params()
    # a payload without a lease base reconstructs from the server params
    (rp, _), (pp, _) = pr.encode(16, pr.base(17))
    pr.assimilate((rp, pp), pr.meta(2))
    pr.assert_params()


def _pod_pair(density=None):
    return Pair(RB.EASGDFlatPod(n_replicas=3, beta=0.05,
                                compress_density=density),
                PB.EASGDFlatPod(n_replicas=3, beta=0.05,
                                compress_density=density))


def _assert_pod(pr):
    pr.assert_params()
    assert _bytes(pr.ps.replicas) == _bytes(pr.rs.replicas)
    assert set(pr.ps.pending) == set(pr.rs.pending)
    assert pr.ps.lost == pr.rs.lost
    assert pr.ps.slot_owner == pr.rs.slot_owner


def test_easgd_flat_pod_barrier_and_redrop_bit_exact():
    pr = _pod_pair()
    for cid, seed in ((1, 20), (0, 21)):
        x = pr.buf(seed)
        pr.assimilate((jnp.asarray(x), torch.from_numpy(x)), pr.meta(cid))
    _assert_pod(pr)
    assert pr.ps.version == 0                       # barrier not reached
    # preemption: the slot's pending row is dropped, the barrier re-waits
    pr.r.drop_client(pr.rs, 1)
    pr.p.drop_client(pr.ps, 1)
    _assert_pod(pr)
    assert pr.ps.lost == {1} and set(pr.ps.pending) == {0}
    assert pr.p.handout(pr.ps, 1, None) is pr.ps.params  # back to center
    for cid, seed in ((2, 22), (1, 23)):
        x = pr.buf(seed)
        pr.assimilate((jnp.asarray(x), torch.from_numpy(x)), pr.meta(cid))
    _assert_pod(pr)
    assert pr.ps.version == 1 and not pr.ps.pending   # one elastic round
    for c in (0, 1, 2):
        assert _bytes(pr.p.handout(pr.ps, c, None).buf) \
            == _bytes(pr.r.handout(pr.rs, c, None).buf)


def test_easgd_flat_pod_slot_collision_raises():
    pr = _pod_pair()
    x = pr.buf(30)
    pr.assimilate((jnp.asarray(x), torch.from_numpy(x)), pr.meta(0))
    with pytest.raises(ValueError, match="collides"):
        pr.p.assimilate(pr.ps, torch.from_numpy(x), pr.meta(3)[1])  # slot 0
    with pytest.raises(ValueError, match="collides"):
        pr.p.handout(pr.ps, 6, None)
    with pytest.raises(ValueError, match="collides"):
        pr.r.handout(pr.rs, 3, None)                  # the reference too


def test_easgd_flat_pod_compressed_bit_exact():
    pr = _pod_pair(density=0.1)
    res = {}
    for rnd in range(2):
        for cid in (2, 0, 1):
            base = pr.base(40 + 10 * rnd + cid)
            r = res.get(cid, (None, None))
            (rp, rres), (pp, pres) = pr.encode(50 + 10 * rnd + cid, base, r)
            assert _bytes(pp.values) == _bytes(rp.values)
            assert _bytes(pres) == _bytes(rres)
            res[cid] = (rres, pres)
            pr.assimilate((rp, pp), pr.meta(cid, base=base))
            _assert_pod(pr)
    assert pr.ps.version == 2
    # dense pods ship the trained buffer itself
    (rb, rn), (pb, pn) = _pod_pair().encode(60, pr.base(61))
    assert rn is None and pn is None and _bytes(pb) == _bytes(rb)


def test_sync_bsp_mean_bit_exact():
    pr = Pair(RB.SyncBSP(5), PB.SyncBSP(5))
    assert PB.SyncBSP.requires_all_clients
    assert not PB.SyncBSP.has_local_replicas
    for rnd in range(2):
        for shard in (3, 0, 4, 1, 2):               # arrival order != shard
            x = pr.buf(70 + 10 * rnd + shard)
            pr.assimilate((jnp.asarray(x), torch.from_numpy(x)),
                          pr.meta(shard % 3, shard=shard))
            assert list(pr.ps.pending) == list(pr.rs.pending)
        pr.assert_params()
    assert pr.ps.version == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3])
def test_plain_easgd_elastic_equals_reference_oracle(dtype, n):
    rng = np.random.default_rng(n)
    c = rng.standard_normal(2 * 8192).astype(np.float32)
    x = rng.standard_normal((n, 2 * 8192)).astype(np.float32)
    rc, rx = RR.easgd_elastic(jnp.asarray(c, dtype), jnp.asarray(x, dtype),
                              0.05)
    tdt = getattr(torch, dtype)
    pc, px = PR.easgd_elastic(torch.from_numpy(c).to(tdt),
                              torch.from_numpy(x).to(tdt), 0.05)
    view = np.uint16 if dtype == "bfloat16" else np.uint32
    itv = torch.int16 if dtype == "bfloat16" else torch.int32
    assert pc.view(itv).numpy().tobytes() == np.asarray(rc).view(view).tobytes()
    assert px.view(itv).numpy().tobytes() == np.asarray(rx).view(view).tobytes()
    # the port's scheme-level entry routes CPU tensors to the same version
    ec, ex = PB.easgd_elastic_update(torch.from_numpy(c), torch.from_numpy(x),
                                     0.05)
    rc32, rx32 = RB.easgd_elastic_update(jnp.asarray(c), jnp.asarray(x), 0.05)
    assert _bytes(ec) == _bytes(rc32) and _bytes(ex) == _bytes(rx32)
