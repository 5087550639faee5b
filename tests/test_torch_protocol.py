"""Port parity: the plain-bus Coordinator against repro.protocol's, driven
through the same scripted issue / submit / deliver / assimilate / drop /
expire / drop_client schedule.

Tolerance: none — every frame either transport carried is compared byte
for byte, the server bus after the Eq. 1 folds bit for bit, and the lease
counters exactly.  Lease misuse raises ``LeaseError`` in both.

Under ``CompressedVCASGD`` (sparse upload frames with error feedback) the
one exception is the header's ``res_norm`` field: the reference takes the
residual's l2 norm with ``jnp.linalg.norm``, the port with
``torch.linalg.vector_norm``, two reductions whose summation order need
not agree.  Sparse frames are compared with that 4-byte field and the crc
masked, and the norms are held within 1e-6 relative; everything else —
payload bytes, lengths, the ledger's shape, the server bus — is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core.baselines import CompressedVCASGD as RefCompressed
from repro.core.baselines import VCASGD as RefVCASGD
from repro.protocol import Coordinator as RefCoordinator
from repro.protocol import LeaseError as RefLeaseError
from repro.transfer.transport import LoopbackTransport as RefLoopback
from repro_torch.core import flat as PF
from repro_torch.core.baselines import VCASGD, CompressedVCASGD
from repro_torch.protocol import Coordinator, LeaseError
from repro_torch.transfer.transport import LoopbackTransport

torch.set_num_threads(2)


class RefRecording(RefLoopback):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


class PortRecording(LoopbackTransport):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((40, 30)).astype(np.float32),
            "b": rng.standard_normal(30).astype(np.float32)}


def _both():
    t0 = _tree(0)
    ref = RefCoordinator(RefVCASGD(alpha=0.9),
                         RF.flatten({k: jnp.asarray(v) for k, v in t0.items()}),
                         transport=RefRecording(), timeout_s=100.0)
    port = Coordinator(VCASGD(alpha=0.9),
                       PF.flatten({k: torch.from_numpy(v) for k, v in t0.items()}),
                       transport=PortRecording(), timeout_s=100.0)
    return ref, port


def _run_schedule(c, to_buf):
    """issue 4 leases over 2 clients; 2 results assimilated (one after a
    store version moved), one dropped, one expired; then client 1 is
    preempted holding a fresh lease.  Returns the leases."""
    base = c.state.params
    l0 = c.issue(cid=0, uid=0, round=1, base=base, now=0.0)
    l1 = c.issue(cid=1, uid=1, round=1, base=base, now=1.0)
    l2 = c.issue(cid=0, uid=2, round=1, base=base, now=2.0, deadline=50.0)
    l3 = c.issue(cid=1, uid=3, round=1, base=base, now=3.0)
    for lease, seed in ((l0, 10), (l1, 11), (l3, 13)):
        c.submit(lease, to_buf(np.random.default_rng(seed).standard_normal(
            base.spec.padded).astype(np.float32) * (np.arange(
                base.spec.padded) < base.spec.n)))
    c.assimilate(l0, c.deliver(l0), server_version=0)
    c.assimilate(l1, c.deliver(l1), server_version=1)
    c.drop(l3)
    c.drop(l3)                                  # idempotent
    expired = c.expire(60.0)
    l4 = c.issue(cid=1, uid=4, round=2, base=c.state.params, now=61.0)
    c.drop_client(1)
    return l0, l2, l4, expired


def test_scripted_schedule_frames_and_state_match_reference():
    ref, port = _both()
    r = _run_schedule(ref, jnp.asarray)
    p = _run_schedule(port, torch.from_numpy)
    assert port.transport.sent == ref.transport.sent      # every frame
    assert len(port.transport.sent) == 8                  # 5 handouts + 3 results
    assert (port.state.params.buf.numpy().tobytes()
            == np.asarray(ref.state.params.buf).tobytes())
    assert port.state.version == ref.state.version == 2
    for f in ("assimilated", "dropped", "expired", "handout_frames",
              "handout_bytes", "frames", "in_flight"):
        assert getattr(port, f) == getattr(ref, f), f
    assert vars(port.wire_stats) == vars(ref.wire_stats)
    assert [l.key for l in p[3]] == [l.key for l in r[3]] == [(0, 2)]
    for rl, pl in zip(r[:3], p[:3]):
        assert (pl.status, pl.base is None) == (rl.status, rl.base is None)
    assert port.handout_cache.encodes == ref.handout_cache.encodes


def test_lease_misuse_raises_like_reference():
    ref, port = _both()
    for c, err, to_buf in ((ref, RefLeaseError, jnp.asarray),
                           (port, LeaseError, torch.from_numpy)):
        lease = c.issue(cid=0, uid=0, round=1, base=c.state.params)
        with pytest.raises(err):
            c.issue(cid=0, uid=0, round=1, base=c.state.params)
        with pytest.raises(err):
            c.deliver(lease)                    # nothing in flight yet
        c.submit(lease, to_buf(np.zeros(c.state.params.spec.padded,
                                        np.float32)))
        with pytest.raises(err):
            c.submit(lease, to_buf(np.zeros(1, np.float32)))
        c.assimilate(lease, c.deliver(lease), server_version=0)
        with pytest.raises(err):                # exactly once
            c.assimilate(lease, None, server_version=0)


def test_handout_base_is_decoded_copy_on_bus_device():
    _, port = _both()
    lease = port.issue(cid=0, uid=0, round=1, base=port.state.params)
    assert lease.base.buf is not port.state.params.buf
    assert torch.equal(lease.base.buf, port.state.params.buf)
    assert lease.handout_bytes == 68 + 4 * port.state.params.spec.padded


_NORM = slice(36, 40)                   # res_norm f32 in the v2 header
_CRC = slice(64, 68)


def _masked(frame: bytes) -> bytes:
    b = bytearray(frame)
    if b[6] == 1:                       # sparse: mask norm and crc
        b[_NORM] = bytes(4)
        b[_CRC] = bytes(4)
    return bytes(b)


def _compressed_pair():
    t0 = _tree(1)
    ref = RefCoordinator(RefCompressed(0.95, density=0.05),
                         RF.flatten({k: jnp.asarray(v) for k, v in t0.items()}),
                         transport=RefRecording())
    port = Coordinator(CompressedVCASGD(0.95, density=0.05),
                       PF.flatten({k: torch.from_numpy(v)
                                   for k, v in t0.items()}),
                       transport=PortRecording())
    return ref, port


def _compressed_schedule(c, to_buf):
    """Clients 0-2 train from their leases; client 0 submits twice (its
    residual carries), client 1 is preempted with a residual and comes
    back.  Returns the ledger readings after each step."""
    ledger = []
    n = c.state.params.spec.padded
    mask = np.arange(n) < c.state.params.spec.n

    def train(lease, seed):
        base = np.asarray(lease.base.buf)
        step = np.random.default_rng(seed).standard_normal(n).astype(
            np.float32) * np.float32(1e-2) * mask
        c.submit(lease, to_buf(base + step))
        ledger.append((c.residual_norm(lease.cid), c.residual_mass()))

    uid = iter(range(100))
    leases = [c.issue(cid=cid, uid=next(uid), round=1, base=c.state.params)
              for cid in (0, 1, 2)]
    for lease, seed in zip(leases, (20, 21, 22)):
        train(lease, seed)
    for lease in leases[:2]:
        c.assimilate(lease, c.deliver(lease), server_version=0)
    again = c.issue(cid=0, uid=next(uid), round=2, base=c.state.params)
    train(again, 23)                    # residual of client 0 carried
    c.drop_client(1)                    # forgets client 1's residual
    ledger.append((c.residual_norm(1), c.residual_mass()))
    c.drop(leases[2])
    back = c.issue(cid=1, uid=next(uid), round=2, base=c.state.params)
    train(back, 24)                     # starts without a residual
    for lease in (again, back):
        c.assimilate(lease, c.deliver(lease), server_version=1)
    return ledger


def test_compressed_schedule_ledger_and_frames_match_reference():
    ref, port = _compressed_pair()
    r = _compressed_schedule(ref, jnp.asarray)
    p = _compressed_schedule(port, torch.from_numpy)
    assert len(port.transport.sent) == len(ref.transport.sent) == 10
    assert [_masked(f) for f in port.transport.sent] == \
        [_masked(f) for f in ref.transport.sent]
    sparse = [(pf, rf) for pf, rf in zip(port.transport.sent,
                                         ref.transport.sent) if pf[6] == 1]
    assert len(sparse) == 5
    for pf, rf in sparse:
        pn, rn = (np.frombuffer(f[_NORM], np.float32)[0] for f in (pf, rf))
        assert rn > 0 and abs(pn - rn) <= 1e-6 * rn
    for (pn, pm), (rn, rm) in zip(p, r):
        assert pn == pytest.approx(rn, rel=1e-6, abs=0.0)
        assert pm == pytest.approx(rm, rel=1e-6, abs=0.0)
    # after the preemption: client 1's norm is gone from the running mass,
    # which is client 0's latest norm plus client 2's
    assert p[4][0] == 0.0
    assert p[4][1] == pytest.approx(p[3][0] + p[2][0], rel=1e-6)
    assert set(port._residuals) == set(ref._residuals) == {0, 1, 2}
    for cid in (0, 1, 2):
        assert np.abs(port._residuals[cid].numpy()
                      - np.asarray(ref._residuals[cid])).max() == 0.0
    assert (port.state.params.buf.numpy().tobytes()
            == np.asarray(ref.state.params.buf).tobytes())
    for f in ("assimilated", "dropped", "frames", "in_flight"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.frames[1] == 4 and vars(port.wire_stats) == vars(ref.wire_stats)


def test_sparse_delivery_lands_on_bus_device():
    _, port = _compressed_pair()
    lease = port.issue(cid=0, uid=0, round=1, base=port.state.params)
    port.submit(lease, lease.base.buf + 0.25)
    payload = port.deliver(lease)
    for t in (payload.values, payload.scales, payload.indices):
        assert t.device == port.state.params.buf.device
    assert port.residual_norm(0) > 0.0 and port.residual_norm(7) == 0.0
