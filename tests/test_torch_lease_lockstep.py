"""The lease API and its no-leak guarantee, held to the reference's.

Both Coordinators, under ``CompressedVCASGD(0.9, density=0.1)``, are
driven in lockstep through the reference's random preemption schedule
(``tests/test_protocol.py::_random_preemption_run``: issue / submit /
deliver + assimilate / drop / drop_client / expire), with ``renew`` as a
seventh operation (to a finite deadline, or to an infinite one a fifth
of the time).  One numpy rng draws every operation, and both sides get
the same inputs.  After every step, exactly:
* each live lease's status, ``terminal`` and ``released``, in both;
* the keys ``expire`` returned, the registry size (= the leases the
  schedule still holds), the transport's in-flight frames, the residual
  ledger's keys, the server bus (bytes) and every residual (bytes);
* every frame either transport carried, byte for byte outside the
  sparse header's residual-norm field and the crc;
* the port's residual norm (the ledger's and the frame header's) equals
  the correctly rounded norm of its residual: the exact sum of squares
  (``math.fsum`` of exact f64 squares), its square root rounded to f32.
  The reference's header norm is an f32 sum in XLA's order and is not
  compared (ROADMAP queue C, C4).
Then the total drain: every client preempted, nothing left anywhere.
25 seeds x 120 steps, and a hypothesis case of 10 seeds x 60 steps.
Also the reference's ``test_renew_extends_deadline``, a renewal to an
infinite deadline, and ``params_for_client``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import flat as RF
from repro.core.baselines import CompressedVCASGD as RefCompressed
from repro.protocol import Coordinator as RefCoordinator
from repro.transfer.transport import LoopbackTransport as RefLoopback
from repro_torch.core import flat as PF
from repro_torch.core.baselines import (VCASGD, CompressedVCASGD,
                                        EASGDFlatPod)
from repro_torch.protocol import (LEASE_EXPIRED, LEASE_IN_FLIGHT,
                                  LEASE_ISSUED, Coordinator, LeaseError)
from repro_torch.transfer.transport import LoopbackTransport

torch.set_num_threads(2)

_NORM = slice(36, 40)                   # res_norm f32 in the v2 header
_CRC = slice(64, 68)
N_CLIENTS = 4


class RefRecording(RefLoopback):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


class PortRecording(LoopbackTransport):
    def send(self, frame):
        self.sent = getattr(self, "sent", []) + [bytes(frame)]
        return super().send(frame)


def _masked(frame: bytes) -> bytes:
    b = bytearray(frame)
    if b[6] == 1:                       # sparse: mask norm and crc
        b[_NORM] = bytes(4)
        b[_CRC] = bytes(4)
    return bytes(b)


def exact_norm(r: np.ndarray) -> float:
    """The correctly rounded l2 norm of an f32 vector: f32 squares are
    exact in f64, ``fsum`` adds them exactly, one sqrt, one f32 round."""
    r64 = np.asarray(r, np.float64)
    return float(np.float32(math.sqrt(math.fsum(r64 * r64))))


def _pair(seed: int):
    w = np.random.default_rng(seed).standard_normal((64, 32)).astype(
        np.float32)
    rfp, pfp = RF.flatten({"w": jnp.asarray(w)}), PF.flatten(
        {"w": torch.from_numpy(w)})
    ref = RefCoordinator(RefCompressed(0.9, density=0.1), rfp,
                         timeout_s=30.0, transport=RefRecording())
    port = Coordinator(CompressedVCASGD(0.9, density=0.1), pfp,
                       timeout_s=30.0, transport=PortRecording())
    return ref, port, rfp, pfp


def _check(ref, port, live) -> None:
    assert len(ref.leases) == len(port.leases) == len(live)
    for rl, pl in live:
        assert (pl.key, pl.status) == (rl.key, rl.status)
        assert not pl.terminal and not rl.terminal
        assert not pl.released and not rl.released
    assert port.transport.in_flight == ref.transport.in_flight == sum(
        1 for _, pl in live if pl.status == LEASE_IN_FLIGHT)
    assert set(port._residuals) == set(ref._residuals)
    assert len(port._residuals) <= N_CLIENTS
    for cid, r in port._residuals.items():
        assert r.numpy().tobytes() == np.asarray(ref._residuals[cid]).tobytes()
        assert port._res_norms[cid] == exact_norm(r.numpy())
    assert port.residual_mass() == pytest.approx(
        sum(port._res_norms.values()), rel=1e-12, abs=0.0)
    assert (port.state.params.buf.numpy().tobytes()
            == np.asarray(ref.state.params.buf).tobytes())
    assert port.state.version == ref.state.version
    assert [_masked(f) for f in port.transport.sent] == \
        [_masked(f) for f in ref.transport.sent]


def lockstep_run(seed: int, steps: int = 120) -> dict:
    """Drive both coordinators through the random schedule; returns how
    often each operation ran."""
    rng = np.random.default_rng(seed)
    ref, port, rfp, pfp = _pair(seed)
    base = np.asarray(rfp.buf)          # every lease hands out the initial fp
    uid, now, version = 0, 0.0, 0
    live = []                                   # (ref lease, port lease)
    ran = dict.fromkeys(("issue", "submit", "assimilate", "drop",
                         "drop_client", "expire", "renew"), 0)

    def pick(status=None):
        cand = [p for p in live if status is None or p[1].status == status]
        return cand[int(rng.integers(0, len(cand)))] if cand else None

    for _ in range(steps):
        now += float(rng.exponential(4.0))
        op = rng.integers(0, 7)
        if op == 0 or not live:                 # issue to a random client
            cid = int(rng.integers(0, N_CLIENTS))
            live.append(tuple(c.issue(cid=cid, uid=uid, round=0, base=fp,
                                      now=now)
                              for c, fp in ((ref, rfp), (port, pfp))))
            uid += 1
            ran["issue"] += 1
        elif op == 1:                           # client uploads
            pair = pick(LEASE_ISSUED)
            if pair is not None:
                trained = base + np.float32(rng.standard_normal())
                ref.submit(pair[0], jnp.asarray(trained))
                port.submit(pair[1], torch.from_numpy(trained.copy()))
                header_norm = np.frombuffer(port.transport.sent[-1][_NORM],
                                            np.float32)[0]
                assert header_norm == exact_norm(
                    port._residuals[pair[1].cid].numpy())
                ran["submit"] += 1
        elif op == 2:                           # delivery + assimilation
            pair = pick(LEASE_IN_FLIGHT)
            if pair is not None:
                for c, lease in zip((ref, port), pair):
                    c.assimilate(lease, c.deliver(lease),
                                 server_version=version)
                version += 1
                live.remove(pair)
                ran["assimilate"] += 1
        elif op == 3:                           # result discarded in flight
            pair = pick()
            if pair is not None:
                ref.drop(pair[0])
                port.drop(pair[1])
                live.remove(pair)
                ran["drop"] += 1
        elif op == 4:                           # client preempted
            cid = int(rng.integers(0, N_CLIENTS))
            ref.drop_client(cid)
            port.drop_client(cid)
            live = [p for p in live if not p[1].terminal]
            ran["drop_client"] += 1
        elif op == 5:                           # deadline sweep
            r_out, p_out = ref.expire(now), port.expire(now)
            assert [l.key for l in p_out] == [l.key for l in r_out]
            assert all(l.status == LEASE_EXPIRED and l.released
                       for l in p_out)
            live = [p for p in live if not p[1].terminal]
            ran["expire"] += 1
        else:                                   # client asks for more time
            pair = pick()
            if pair is not None:
                deadline = (math.inf if rng.random() < 0.2
                            else now + float(rng.exponential(30.0)))
                for c, lease in zip((ref, port), pair):
                    assert c.renew(lease, deadline) is lease
                    assert lease.deadline == deadline
                ran["renew"] += 1
        for rl, pl in live:
            assert pl.terminal == rl.terminal
        _check(ref, port, live)
    # total drain: every client preempted -> every buffer released
    for cid in range(N_CLIENTS):
        ref.drop_client(cid)
        port.drop_client(cid)
    for rl, pl in live:
        assert pl.terminal and pl.released and rl.released
        assert pl.status == rl.status
    assert port.leases == {} and port._residuals == {}
    assert port.residual_mass() == 0.0
    assert port.transport.in_flight == ref.transport.in_flight == 0
    assert vars(port.wire_stats) == vars(ref.wire_stats)
    stats = port.wire_stats
    assert stats.frames_sent == stats.frames_recv + stats.frames_dropped
    for f in ("assimilated", "dropped", "expired", "frames",
              "handout_frames", "handout_bytes"):
        assert getattr(port, f) == getattr(ref, f), f
    _check(ref, port, [])
    return ran


@pytest.mark.parametrize("seed", range(25))
def test_random_schedule_with_renew_lockstep(seed):
    ran = lockstep_run(seed, steps=120)
    assert min(ran.values()) > 0                # every operation ran


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 16))
def test_property_random_schedule_lockstep(seed):
    lockstep_run(seed, steps=60)


def _vc():
    fp = PF.flatten({"w": torch.from_numpy(np.random.default_rng(0)
                                           .standard_normal((64, 32))
                                           .astype(np.float32))})
    return Coordinator(VCASGD(0.9), fp, timeout_s=10.0), fp


def test_renew_extends_deadline():
    coord, fp = _vc()
    lease = coord.issue(cid=0, uid=1, round=0, base=fp, now=0.0)
    coord.renew(lease, deadline=50.0)
    assert coord.expire(now=20.0) == []            # renewed past the timeout
    assert coord.expire(now=60.0) == [lease]
    assert lease.terminal and lease.released
    with pytest.raises(LeaseError):                # terminal leases can't renew
        coord.renew(lease, deadline=99.0)


def test_renew_to_infinite_deadline_never_expires():
    coord, fp = _vc()
    lease = coord.issue(cid=0, uid=1, round=0, base=fp, now=0.0)
    heap = len(coord._lease_heap)
    coord.renew(lease, deadline=math.inf)
    assert len(coord._lease_heap) == heap          # no entry for inf
    assert coord.expire(now=1e12) == []            # the old entry is dead
    assert not lease.terminal and coord.in_flight == 1
    coord.renew(lease, deadline=5.0)               # and back to finite
    assert coord.expire(now=6.0) == [lease]


def test_params_for_client_delegates_to_handout():
    fp = PF.flatten({"w": torch.arange(12, dtype=torch.float32)})
    vc = VCASGD(0.9)
    state = vc.init_state(fp)
    assert vc.params_for_client(state) is state.params
    assert vc.params_for_client(state, cid=3) is state.params
    pod = EASGDFlatPod(n_replicas=2, beta=0.1)
    ps = pod.init_state(fp)
    assert pod.params_for_client(ps) is ps.params
    got = pod.params_for_client(ps, cid=1)
    assert torch.equal(got.buf, pod.handout(ps, 1, ps.params).buf)
