"""The download leg of the port: the version-vector delta ledger, the
content-addressed frame cache, bf16 handout frames and the read-only
subscriber service (``protocol/handout.py``), against the reference's
``tests/test_handout.py`` and the ledger half of ``tests/test_scenarios.py``
(with its pending-queue oracle).

Tolerance: none.  Every frame is compared byte for byte — with a fresh
per-client encode and with the reference Coordinator's frame for the same
schedule — and every handed-out base bit for bit with the server bus (or
its bf16 image).  torch's f32 -> bf16 cast on the CPU is held to
``ml_dtypes``' (jnp.bfloat16) round-to-nearest-even bit for bit, ties and
subnormals included.
"""
from __future__ import annotations

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.core import flat as RF
from repro.core.baselines import VCASGD as RefVCASGD
from repro.protocol import Coordinator as RefCoordinator
from repro.transfer.transport import LoopbackTransport as RefLoopback
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flat as F
from repro_torch.core.baselines import VCASGD
from repro_torch.core.work_generator import PendingQueue, WorkUnit
from repro_torch.protocol import Coordinator, HandoutService
from repro_torch.transfer import wire
from repro_torch.transfer.handout_cache import HandoutCache, chunk_hash
from repro_torch.transfer.transport import LoopbackTransport

torch.set_num_threads(2)


def _np(seed=0, shape=(40, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(seed=0, shape=(40, 16), n_shards=8):
    tree = {"w": torch.from_numpy(_np(seed, shape))}
    return (F.flatten(tree) if n_shards <= 1
            else F.flatten_sharded(tree, n_shards))


def _bf16_image(buf: torch.Tensor) -> np.ndarray:
    return buf.to(torch.bfloat16).to(torch.float32).numpy()


def _oracle_frames(coord, rnd):
    """Fresh per-client encode of every chunk straight from the wire
    module."""
    buf = coord.state.params.buf
    spec = coord.state.params.spec
    n = spec.n_shards if isinstance(spec, F.ShardedTreeSpec) else 1
    out = []
    for i in range(n):
        seg = buf if n == 1 else buf[slice(*spec.shard_bounds(i))]
        if coord.handout_dtype == "bfloat16":
            seg = seg.to(torch.bfloat16)
        out.append(wire.encode_dense(seg, round=rnd) if n == 1
                   else wire.encode_shard(seg, shard=i, n_shards=n,
                                          round=rnd))
    return out


# ---------------------------------------------------------------------------
# bf16 rounding: torch's cast against ml_dtypes'
# ---------------------------------------------------------------------------

def test_bf16_cast_is_ml_dtypes_round_to_nearest_even():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint64).astype(
        np.uint32)
    # exact ties (low 16 bits 0x8000) on even and odd bf16 mantissas,
    # subnormals, the largest finite values, signed zeros and infinities
    ties = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    sub = rng.integers(0, 1 << 23, 4096).astype(np.uint32)
    special = np.array([0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
                        0x7F800000, 0xFF800000, 0x00008000, 0x00018000,
                        0x3F808000, 0x3F818000, 0x007FFFFF], np.uint32)
    x = np.concatenate([bits, ties, sub, sub | np.uint32(0x80000000),
                        special]).view(np.float32)
    x = x[~np.isnan(x)]
    port = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(port, ref)


# ---------------------------------------------------------------------------
# the frame cache (the port's copy) and the Coordinator's use of it
# ---------------------------------------------------------------------------

def test_cache_second_identical_request_is_free():
    cache = HandoutCache()
    data = np.arange(8, dtype=np.float32)
    calls = []

    def enc():
        calls.append(1)
        return b"frame-bytes"

    f1, fresh1 = cache.get(round=0, chunk=0, version=1, data=data, encode=enc)
    f2, fresh2 = cache.get(round=0, chunk=0, version=1, data=data, encode=enc)
    assert (fresh1, fresh2) == (True, False)
    assert f1 == f2 == b"frame-bytes" and len(calls) == 1
    assert cache.dedup_ratio == 2.0
    assert chunk_hash(data) != chunk_hash(data + 1)


def test_second_client_same_round_costs_zero_encodes():
    fp = _params()
    n = fp.spec.n_shards
    coord = Coordinator(VCASGD(0.9), fp, timeout_s=1e9)
    l1 = coord.issue(cid=0, uid=1, round=0, base=fp)
    assert coord.handout_cache.encodes == n
    l2 = coord.issue(cid=1, uid=2, round=0, base=fp)
    assert coord.handout_cache.encodes == n and coord.handout_cache.hits == n
    assert l1.handout_bytes == l2.handout_bytes == n * wire.shard_frame_bytes(
        fp.spec.shard_len)
    assert torch.equal(l1.base.buf, l2.base.buf)
    coord.drop(l1), coord.drop(l2)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_handout_frames_match_oracle_and_reference_under_random_schedule(
        dtype, n_shards):
    """Random mutate / handout / drop / checkpoint / restore schedules:
    every chunk frame equals a fresh encode and the reference
    Coordinator's frame for the same schedule, every base equals the bus
    (or its bf16 image), and a restore forces a full re-download."""
    for seed in (1, 7):
        rng = np.random.default_rng(seed)
        fp = _params(seed, n_shards=n_shards)
        tree = {"w": jnp.asarray(_np(seed))}
        rfp = (RF.flatten(tree) if n_shards == 1
               else RF.flatten_sharded(tree, n_shards))
        coord = Coordinator(VCASGD(0.9), fp, timeout_s=1e9,
                            handout_dtype=dtype)
        ref = RefCoordinator(RefVCASGD(0.9), rfp, timeout_s=1e9,
                             handout_dtype=dtype)
        mgr = CheckpointManager(tempfile.mkdtemp(prefix="handout_t_"),
                                async_save=False)
        uid, rnd, saved = 0, 0, False
        for _ in range(40):
            op = rng.random()
            if op < 0.45:
                uid += 1
                cid = uid % 4
                lease = coord.issue(cid=cid, uid=uid, round=rnd,
                                    base=coord.state.params)
                rl = ref.issue(cid=cid, uid=uid, round=rnd,
                               base=ref.state.params)
                assert (lease.handout_frames, lease.handout_bytes) == (
                    rl.handout_frames, rl.handout_bytes)
                want = (_bf16_image(coord.state.params.buf)
                        if coord.handout_dtype == "bfloat16"
                        else coord.state.params.buf.numpy())
                np.testing.assert_array_equal(lease.base.buf.numpy(), want)
                np.testing.assert_array_equal(lease.base.buf.numpy(),
                                              np.asarray(rl.base.buf))
                for i, oracle in enumerate(_oracle_frames(coord, rnd)):
                    frame, _ = coord._chunk_frame(i, rnd)
                    assert frame == oracle == ref._chunk_frame(i, rnd)[0]
                if rng.random() < 0.5:               # mutate: fold it in
                    d = float(rng.integers(1, 8)) / 8
                    coord.submit(lease, lease.base.buf + d)
                    coord.assimilate(lease, coord.deliver(lease),
                                     server_version=coord.state.version)
                    ref.submit(rl, rl.base.buf + d)
                    ref.assimilate(rl, ref.deliver(rl),
                                   server_version=ref.state.version)
                else:
                    coord.drop(lease), ref.drop(rl)
            elif op < 0.6:
                rnd += 1
            elif op < 0.75 or not saved:
                coord.save_checkpoint(mgr, step=rnd + 1)
                saved = True
            else:                                    # restore: rounds rewind
                coord.restore_checkpoint(mgr)
                rnd = 0
                uid += 1
                lease = coord.issue(cid=uid % 4, uid=uid, round=rnd,
                                    base=coord.state.params)
                assert lease.handout_frames == n_shards
                coord.drop(lease)
                ref = RefCoordinator(RefVCASGD(0.9), RF.FlatParams(
                    jnp.asarray(coord.state.params.buf.numpy()), rfp.spec),
                    timeout_s=1e9, handout_dtype=dtype)
        assert coord.handout_cache.hits > 0


def test_cache_bounded_across_rounds():
    fp = _params()
    n = fp.spec.n_shards
    coord = Coordinator(VCASGD(0.9), fp, timeout_s=1e9)
    cache = coord.handout_cache
    for rnd in range(12):
        for cid in range(3):
            lease = coord.issue(cid=cid, uid=rnd * 3 + cid + 1, round=rnd,
                                base=coord.state.params)
            if cid == 0:
                coord.submit(lease, lease.base.buf + 0.1)
                coord.assimilate(lease, coord.deliver(lease),
                                 server_version=coord.state.version)
            else:
                coord.drop(lease)
        assert cache.frames_held <= n * cache.keep_rounds
    assert cache.watermark == 12 - cache.keep_rounds and cache.evicted > 0


# ---------------------------------------------------------------------------
# bf16 download frames
# ---------------------------------------------------------------------------

def test_bf16_handout_reconstruction_is_bf16_exact():
    fp = _params()
    coord = Coordinator(VCASGD(0.9), fp, timeout_s=1e9, handout_dtype="bf16")
    assert coord.handout_dtype == "bfloat16"
    lease = coord.issue(cid=0, uid=1, round=0, base=fp)
    np.testing.assert_array_equal(lease.base.buf.numpy(), _bf16_image(fp.buf))
    # unchanged chunks come from the held copy, changed ones from bf16
    # frames: both the bf16 image of the f32 master
    coord.submit(lease, lease.base.buf + 0.125)
    coord.assimilate(lease, coord.deliver(lease),
                     server_version=coord.state.version)
    l2 = coord.issue(cid=0, uid=2, round=1, base=coord.state.params)
    np.testing.assert_array_equal(l2.base.buf.numpy(),
                                  _bf16_image(coord.state.params.buf))
    assert coord.state.params.buf.dtype == torch.float32    # f32 master
    coord.drop(l2)


def test_bf16_halves_handout_bytes_and_bad_dtype_refused():
    fp = _params()
    sl, n = fp.spec.shard_len, fp.spec.n_shards
    a = Coordinator(VCASGD(0.9), fp).issue(cid=0, uid=1, round=0, base=fp)
    b = Coordinator(VCASGD(0.9), fp, handout_dtype="bfloat16").issue(
        cid=0, uid=1, round=0, base=fp)
    assert a.handout_bytes == n * wire.shard_frame_bytes(sl)
    assert b.handout_bytes == n * wire.shard_frame_bytes(sl, "bfloat16")
    assert b.handout_bytes < 0.55 * a.handout_bytes
    with pytest.raises(ValueError, match="handout_dtype"):
        Coordinator(VCASGD(0.9), fp, handout_dtype="int8")


# ---------------------------------------------------------------------------
# HandoutService
# ---------------------------------------------------------------------------

def test_service_fresh_then_caught_up_then_delta():
    fp = _params()
    n = fp.spec.n_shards
    coord = Coordinator(VCASGD(0.9), fp, timeout_s=1e9)
    svc = HandoutService(coord, transport=LoopbackTransport())
    s1 = svc.pull(0, coord.state.params, round=0)
    assert s1.fresh and s1.frames == n
    s2 = svc.pull(0, coord.state.params, round=0)
    assert s2.frames == 0 and s2.bytes == 0
    lease = coord.issue(cid=0, uid=1, round=0, base=coord.state.params)
    nudged = lease.base.buf.clone()
    lo, hi = fp.spec.shard_bounds(2)
    nudged[lo:hi] += 1.0
    coord.submit(lease, nudged)
    coord.assimilate(lease, coord.deliver(lease),
                     server_version=coord.state.version)
    s3 = svc.pull(0, coord.state.params, round=1)
    assert 1 <= s3.frames < n
    before = coord.handout_cache.encodes
    s4 = svc.pull(1, coord.state.params, round=1)
    assert s4.frames == n
    assert coord.handout_cache.encodes == before + (n - s3.frames)
    assert svc.subscribers == 2
    svc.drop_subscriber(0)
    assert svc.subscribers == 1
    s5 = svc.pull(0, coord.state.params, round=1)
    assert s5.fresh and s5.frames == n
    assert svc.transport.stats.frames_recv == svc.frames_served
    svc.reset()
    assert svc.subscribers == 0 and svc.pulls == 5


def test_service_dense_single_chunk_delta_and_shared_vectors():
    coord = Coordinator(VCASGD(0.9), _params(n_shards=1), timeout_s=1e9)
    svc = HandoutService(coord)
    assert svc.pull(0, coord.state.params, round=0).frames == 1
    assert svc.pull(0, coord.state.params, round=0).frames == 0
    for s in range(1, 64):
        svc.pull(s, coord.state.params, round=0)
    assert len({id(v) for v in svc._sub_vec.values()}) == 1


# ---------------------------------------------------------------------------
# the version-vector ledger against the byte-map oracle
# ---------------------------------------------------------------------------

class ByteMapOracle:
    """The per-client held-bytes algorithm the ledger replaced: one full
    byte copy per client, a per-shard compare on every handout."""

    def __init__(self):
        self.held = {}

    def handout(self, cid, buf, spec):
        prev = self.held.get(cid)
        sent = []
        for i in range(spec.n_shards):
            lo, hi = spec.shard_bounds(i)
            if prev is not None and np.array_equal(buf[lo:hi], prev[lo:hi]):
                continue
            sent.append((i, buf[lo:hi].tobytes()))
        held = prev.copy() if prev is not None else np.zeros_like(buf)
        for i, _ in sent:
            lo, hi = spec.shard_bounds(i)
            held[lo:hi] = buf[lo:hi]
        self.held[cid] = held
        return sent


class RecordingTransport(LoopbackTransport):
    def __init__(self):
        super().__init__()
        self.sent_frames = []

    def send(self, frame):
        self.sent_frames.append(bytes(frame))
        return super().send(frame)


def _mutate(fp, shard_ids, stamp):
    """Never-repeating stamps into the given shards (a float bus never
    reverts bytes; the ledger's over-send on a revert is out of
    contract)."""
    buf = fp.buf.clone()
    for s in shard_ids:
        lo, hi = fp.spec.shard_bounds(s)
        buf[lo:hi] = float(stamp) + s * 0.001
    return F.FlatParams(buf, fp.spec)


def _run_schedule(n_shards, schedule):
    fp = F.flatten_sharded({"w": torch.zeros(n_shards * 8)}, n_shards)
    transport = RecordingTransport()
    coord = Coordinator(VCASGD(0.95), fp, transport=transport)
    oracle = ByteMapOracle()
    uid, stamp = 0, 1
    for op, arg in schedule:
        if op == "mutate":
            fp = _mutate(fp, arg, stamp)
            stamp += 1
        elif op == "drop":
            coord.drop_client(arg)
            oracle.held.pop(arg, None)
        else:
            n_before = len(transport.sent_frames)
            lease = coord.issue(cid=arg, uid=uid, round=0, base=fp)
            uid += 1
            got = []
            for fr in transport.sent_frames[n_before:]:
                msg = wire.decode(fr)
                assert msg.kind == wire.KIND_SHARD
                got.append((msg.shard, msg.payload.numpy().tobytes()))
            assert got == oracle.handout(arg, fp.buf.numpy(), fp.spec)
            assert torch.equal(lease.base.buf, fp.buf)
            coord.drop(lease)


def test_version_vector_matches_byte_map_deterministic():
    _run_schedule(6, [
        ("handout", 0), ("handout", 0), ("mutate", [2, 4]), ("handout", 0),
        ("handout", 1), ("mutate", [0]), ("handout", 1), ("handout", 0),
        ("drop", 0), ("handout", 0), ("mutate", [1, 2, 3]), ("handout", 1),
        ("drop", 1), ("mutate", [5]), ("handout", 1)])


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_version_vector_matches_byte_map_property(data):
    n_shards = data.draw(st.integers(min_value=2, max_value=8))
    n_clients = data.draw(st.integers(min_value=1, max_value=4))
    ops = data.draw(st.lists(st.tuples(
        st.sampled_from(["handout", "mutate", "drop"]),
        st.integers(min_value=0, max_value=9)), min_size=1, max_size=40))
    schedule = []
    for op, x in ops:
        if op in ("handout", "drop"):
            schedule.append((op, x % n_clients))
        else:
            schedule.append((op, sorted({x % n_shards,
                                         (x * 7 + 1) % n_shards})))
    _run_schedule(n_shards, schedule)


def test_version_vector_full_redownload_after_restore(tmp_path):
    fp = F.flatten_sharded({"w": torch.zeros(32)}, 4)
    coord = Coordinator(VCASGD(0.95), fp, transport=RecordingTransport())
    l0 = coord.issue(cid=0, uid=0, round=0, base=fp)
    assert l0.handout_frames == 4
    coord.drop(l0)
    l1 = coord.issue(cid=0, uid=1, round=0, base=fp)
    assert l1.handout_frames == 0
    coord.drop(l1)
    mgr = CheckpointManager(tmp_path, async_save=False)
    coord.save_checkpoint(mgr, step=1)
    assert coord.restore_checkpoint(mgr) == 1
    l2 = coord.issue(cid=0, uid=2, round=0, base=fp)
    assert l2.handout_frames == 4


def test_ledger_frames_equal_the_references_on_a_shared_schedule():
    """The same mutate / handout / drop_client schedule through both
    Coordinators: every frame on the wire byte for byte."""
    n = 5
    fp = F.flatten_sharded({"w": torch.zeros(n * 8)}, n)
    rfp = RF.flatten_sharded({"w": jnp.zeros(n * 8)}, n)
    pt, rt = RecordingTransport(), RefLoopback()
    sent = []
    rt.send = (lambda f, _s=rt.send: (sent.append(bytes(f)), _s(f))[1])
    coord = Coordinator(VCASGD(0.95), fp, transport=pt)
    ref = RefCoordinator(RefVCASGD(0.95), rfp, transport=rt)
    rng = np.random.default_rng(3)
    for uid in range(40):
        if rng.random() < 0.3:
            fp = _mutate(fp, sorted({int(rng.integers(n))}), uid + 1)
            rfp = RF.FlatParams(jnp.asarray(fp.buf.numpy()), rfp.spec)
        cid = int(rng.integers(3))
        if rng.random() < 0.1:
            coord.drop_client(cid), ref.drop_client(cid)
        coord.drop(coord.issue(cid=cid, uid=uid, round=uid // 10, base=fp))
        ref.drop(ref.issue(cid=cid, uid=uid, round=uid // 10, base=rfp))
    assert pt.sent_frames == sent and len(sent) > n


# ---------------------------------------------------------------------------
# the scheduler's pending queue against the sorted-list selection
# ---------------------------------------------------------------------------

def _unit(uid, shard, epoch=1):
    return WorkUnit(uid=uid, epoch=epoch, shard=shard, param_version=-1)


def test_pending_queue_matches_sorted_oracle_deterministic():
    rng = np.random.default_rng(0)
    q, shadow, uid = PendingQueue(), [], 0
    for _ in range(300):
        op = rng.integers(3)
        if op == 0 or not shadow:
            u = _unit(uid, int(rng.integers(8)))
            uid += 1
            q.append(u)
            shadow.append(u)
        elif op == 1:
            cache = set(int(s) for s in rng.choice(
                8, size=int(rng.integers(4)), replace=False))
            k = int(rng.integers(1, 4))
            want = sorted(shadow,
                          key=lambda u: (u.shard not in cache, u.uid))[:k]
            assert [u.uid for u in q.select(cache, k)] == [u.uid for u in want]
            for u in want:
                shadow.remove(u)
        else:
            q.remove(shadow.pop(int(rng.integers(len(shadow)))))
        assert len(q) == len(shadow)
        assert sorted(u.uid for u in q) == sorted(u.uid for u in shadow)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 7),
                          st.integers(1, 3)), min_size=1, max_size=60))
def test_pending_queue_matches_sorted_oracle_property(ops):
    q, shadow, uid = PendingQueue(), [], 0
    for op, shard, k in ops:
        if op == 0 or not shadow:
            u = _unit(uid, shard)
            uid += 1
            q.append(u)
            shadow.append(u)
        elif op == 1:
            cache = {shard, (shard + 3) % 8}
            want = sorted(shadow,
                          key=lambda u: (u.shard not in cache, u.uid))[:k]
            assert [u.uid for u in q.select(cache, k)] == [u.uid for u in want]
            for u in want:
                shadow.remove(u)
        else:
            q.remove(shadow.pop(shard % len(shadow)))
