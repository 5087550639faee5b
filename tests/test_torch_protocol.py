"""Port parity: the plain-bus Coordinator against repro.protocol's, driven
through the same scripted issue / submit / deliver / assimilate / drop /
expire / drop_client schedule.

Tolerance: none — every frame either transport carried is compared byte
for byte, the server bus after the Eq. 1 folds bit for bit, and the lease
counters exactly.  Lease misuse raises ``LeaseError`` in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core.baselines import VCASGD as RefVCASGD
from repro.protocol import Coordinator as RefCoordinator
from repro.protocol import LeaseError as RefLeaseError
from repro.transfer.transport import LoopbackTransport as RefLoopback
from repro_torch.core import flat as PF
from repro_torch.core.baselines import VCASGD
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
