"""The aggregation tier (``repro_torch/protocol/aggregator.py``) and the
lease-lifecycle guards that ship with it, against the reference's
``tests/test_aggregator.py`` (all but its broker test: the port has no
cross-process transport yet).

Tolerance: none.  The tier's claim is BIT identity: an aggregator that
folds a window and flushes ONE merged v3 frame leaves the hub exactly
where a flat hub folding the same arrivals lands (uint32 views compared),
and the port's hub lands where the reference's hub does on the same
inputs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro.core.baselines import VCASGD as RefVCASGD
from repro.protocol import Aggregator as RefAggregator
from repro.protocol import Coordinator as RefCoordinator
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flat as F
from repro_torch.core.baselines import CompressedVCASGD, SyncBSP, VCASGD
from repro_torch.protocol import (LEASE_DROPPED, Aggregator, Coordinator,
                                  LeaseError)
from repro_torch.transfer import wire

torch.set_num_threads(2)


def _np(seed=0, shape=(64, 32)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(seed=0, shape=(64, 32)):
    return F.flatten({"w": torch.from_numpy(_np(seed, shape))})


def _bits(buf):
    return np.asarray(buf.detach().cpu() if isinstance(buf, torch.Tensor)
                      else buf).view(np.uint32)


# ---------------------------------------------------------------------------
# the tier: bit identity, exactly-once upstream, no-leak failure
# ---------------------------------------------------------------------------

def test_tier_protocol_bit_identical_to_flat_and_to_the_reference():
    """Hub + aggregator folding a window then flushing == a flat hub
    folding the same five arrivals, to the bit, with ONE upstream frame;
    and the reference's hub + aggregator on the same inputs land on the
    same bits."""
    fp = _params()
    flat_hub = Coordinator(VCASGD(0.9), fp)
    hub = Coordinator(VCASGD(0.9), fp)
    agg = Aggregator(VCASGD(0.9), hub, agg_id=0)
    rfp = RF.flatten({"w": jnp.asarray(_np())})
    rhub = RefCoordinator(RefVCASGD(0.9), rfp)
    ragg = RefAggregator(RefVCASGD(0.9), rhub, agg_id=0)
    up, rup = agg.open_window(round=0), ragg.open_window(round=0)
    for i in range(5):
        fl = flat_hub.issue(cid=i, uid=i, round=0,
                            base=flat_hub.state.params)
        flat_hub.submit(fl, fl.base.buf + (i + 1) * 0.25)
        flat_hub.assimilate(fl, flat_hub.deliver(fl), server_version=i)
        el = agg.issue(cid=i, uid=i, round=0, base=agg.state.params)
        agg.submit(el, el.base.buf + (i + 1) * 0.25)
        agg.assimilate(el, agg.deliver(el), server_version=i)
        rl = ragg.issue(cid=i, uid=i, round=0, base=ragg.state.params)
        ragg.submit(rl, rl.base.buf + (i + 1) * 0.25)
        ragg.assimilate(rl, ragg.deliver(rl), server_version=i)
    assert agg.window_merged == 5
    assert agg.window_retention == ragg.window_retention == pytest.approx(
        0.9 ** 5)
    assert agg.flush() is up and ragg.flush() is rup
    assert not agg.window_open and agg.flushes == 1
    assert up.frame_bytes == rup.frame_bytes == wire.agg_frame_bytes(
        fp.spec.padded)
    hub.assimilate(up, hub.deliver(up), server_version=0)
    rhub.assimilate(rup, rhub.deliver(rup), server_version=0)
    np.testing.assert_array_equal(_bits(flat_hub.state.params.buf),
                                  _bits(hub.state.params.buf))
    np.testing.assert_array_equal(_bits(hub.state.params.buf),
                                  _bits(rhub.state.params.buf))
    assert hub.frames[wire.KIND_AGG] == 1 and hub.assimilated == 1
    assert agg.transport.in_flight == 0 and hub.transport.in_flight == 0


def test_aggregate_fold_corrects_a_moved_hub_like_the_reference():
    """W' = M + (1 - w)(W - B) when the hub moved after the window opened:
    keep formed once in f32, separate multiply and add — bit-equal to the
    reference's numpy and jnp forms."""
    fp, rfp = _params(1), RF.flatten({"w": jnp.asarray(_np(1))})
    hub, rhub = (Coordinator(VCASGD(0.8), fp),
                 RefCoordinator(RefVCASGD(0.8), rfp))
    agg = Aggregator(VCASGD(0.8), hub, agg_id=3)
    ragg = RefAggregator(RefVCASGD(0.8), rhub, agg_id=3)
    up, rup = agg.open_window(round=0), ragg.open_window(round=0)
    for c, r, d in ((agg, ragg, 0.5), (hub, rhub, -0.75)):
        # one edge fold, and one flat result the hub folds meanwhile
        lease = c.issue(cid=9, uid=1, round=0, base=c.state.params)
        rl = r.issue(cid=9, uid=1, round=0, base=r.state.params)
        c.submit(lease, lease.base.buf + d)
        r.submit(rl, rl.base.buf + d)
        c.assimilate(lease, c.deliver(lease), server_version=0)
        r.assimilate(rl, r.deliver(rl), server_version=0)
    agg.flush(), ragg.flush()
    hub.assimilate(up, hub.deliver(up), server_version=1)
    rhub.assimilate(rup, rhub.deliver(rup), server_version=1)
    np.testing.assert_array_equal(_bits(hub.state.params.buf),
                                  _bits(rhub.state.params.buf))
    # and on a numpy bus (the reference's fleet path)
    rnp = RefCoordinator(RefVCASGD(0.8), RF.FlatParams(
        np.asarray(rfp.buf), rfp.spec))
    ragg2 = RefAggregator(RefVCASGD(0.8), rnp, agg_id=3)
    rup2 = ragg2.open_window(round=0)
    for c, d in ((ragg2, 0.5), (rnp, -0.75)):
        rl = c.issue(cid=9, uid=1, round=0, base=c.state.params)
        c.submit(rl, np.asarray(rl.base.buf) + np.float32(d))
        c.assimilate(rl, c.deliver(rl), server_version=0)
    ragg2.flush()
    rnp.assimilate(rup2, rnp.deliver(rup2), server_version=1)
    np.testing.assert_array_equal(_bits(hub.state.params.buf),
                                  _bits(rnp.state.params.buf))


def test_preempted_client_mid_window_exactly_once_upstream():
    fp = _params()
    hub = Coordinator(VCASGD(0.9), fp)
    agg = Aggregator(VCASGD(0.9), hub, agg_id=0)
    up = agg.open_window(round=0)
    keep = agg.issue(cid=0, uid=1, round=0, base=agg.state.params)
    dead = agg.issue(cid=1, uid=2, round=0, base=agg.state.params)
    agg.submit(keep, keep.base.buf + 1.0)
    agg.submit(dead, dead.base.buf + 99.0)    # uploaded, never delivered
    agg.drop_client(1)                        # preempted mid-upload
    assert dead.status == LEASE_DROPPED and dead.released
    agg.assimilate(keep, agg.deliver(keep), server_version=0)
    assert agg.window_merged == 1 and agg.in_flight == 0
    assert agg.flush() is up
    hub.assimilate(up, hub.deliver(up), server_version=0)
    assert hub.assimilated == 1 and hub.frames[wire.KIND_AGG] == 1
    with pytest.raises(LeaseError):           # the window is consumed
        agg.flush()
    ref = Coordinator(VCASGD(0.9), fp)
    rl = ref.issue(cid=0, uid=1, round=0, base=fp)
    ref.submit(rl, rl.base.buf + 1.0)
    ref.assimilate(rl, ref.deliver(rl), server_version=0)
    np.testing.assert_array_equal(_bits(hub.state.params.buf),
                                  _bits(ref.state.params.buf))
    assert agg.transport.in_flight == 0 and hub.transport.in_flight == 0


def test_empty_window_flush_never_counts_as_a_result():
    fp = _params()
    hub = Coordinator(VCASGD(0.9), fp)
    agg = Aggregator(VCASGD(0.9), hub, agg_id=0)
    agg.open_window(round=0)
    lease = agg.issue(cid=0, uid=1, round=0, base=agg.state.params)
    agg.submit(lease, lease.base.buf + 1.0)
    agg.drop(lease)
    assert agg.flush() is None
    assert hub.assimilated == 0 and hub.dropped == 1
    assert hub.in_flight == 0 and hub.transport.in_flight == 0
    assert torch.equal(hub.state.params.buf, fp.buf)


def test_aggregator_fail_releases_everything():
    fp = _params()
    hub = Coordinator(CompressedVCASGD(0.9, density=0.05), fp)
    agg = Aggregator(CompressedVCASGD(0.9, density=0.05), hub, agg_id=7)
    agg.open_window(round=0)
    for i in range(3):
        lease = agg.issue(cid=i, uid=i, round=0, base=agg.state.params)
        agg.submit(lease, lease.base.buf + 1.0)
        if i == 0:
            agg.assimilate(lease, agg.deliver(lease), server_version=0)
    assert agg.residual_mass() > 0.0 and agg.in_flight == 2
    assert hub.in_flight == 1
    agg.fail()
    assert agg.in_flight == 0 and agg.residual_mass() == 0.0
    assert not agg.window_open and hub.in_flight == 0
    assert agg.transport.in_flight == 0 and hub.transport.in_flight == 0
    assert not agg._client_vec
    up2 = agg.open_window(round=1)
    assert up2.uid == 1                       # window uids stay monotone


def test_barrier_scheme_rejected_at_construction():
    hub = Coordinator(VCASGD(0.9), _params())
    with pytest.raises(ValueError, match="requires every client"):
        Aggregator(SyncBSP(4), hub, agg_id=0)


def test_fold_without_open_window_rejected():
    fp = _params()
    hub = Coordinator(VCASGD(0.9), fp)
    agg = Aggregator(VCASGD(0.9), hub, agg_id=0)
    lease = agg.issue(cid=0, uid=1, round=0, base=agg.state.params)
    agg.submit(lease, lease.base.buf + 1.0)
    with pytest.raises(LeaseError, match="no open window"):
        agg.assimilate(lease, agg.deliver(lease), server_version=0)
    with pytest.raises(LeaseError):
        agg.flush()
    up = agg.open_window(round=0)
    with pytest.raises(LeaseError, match="already holds"):
        agg.open_window(round=0)
    hub.drop(up)


def test_retention_is_the_references_alpha():
    from repro.protocol.types import ResultMeta as RefMeta
    from repro_torch.protocol import ResultMeta
    for gamma in (None, 0.7):
        port, ref = VCASGD(0.9, staleness_gamma=gamma), RefVCASGD(
            0.9, staleness_gamma=gamma)
        for sv in (0, 3):
            kw = dict(cid=0, unit_uid=0, epoch=2, shard=0, read_version=0,
                      server_version=sv)
            assert port.assimilation_retention(ResultMeta(**kw)) == \
                ref.assimilation_retention(RefMeta(**kw))
    from repro_torch.core.baselines import Downpour
    assert Downpour().assimilation_retention(None) == 1.0


# ---------------------------------------------------------------------------
# the lease-lifecycle guards
# ---------------------------------------------------------------------------

def test_lease_heap_bounded_under_inf_timeout():
    fp = _params()
    coord = Coordinator(VCASGD(0.9), fp, timeout_s=math.inf)
    for i in range(64):
        lease = coord.issue(cid=0, uid=i, round=0, base=coord.state.params)
        coord.submit(lease, lease.base.buf + 1.0)
        coord.assimilate(lease, coord.deliver(lease), server_version=i)
    assert coord.in_flight == 0 and coord.assimilated == 64
    assert len(coord._lease_heap) == 0
    live = coord.issue(cid=0, uid=999, round=0, base=coord.state.params)
    coord.renew(live, deadline=math.inf)
    assert len(coord._lease_heap) == 0
    finite = coord.issue(cid=1, uid=1000, round=0, base=coord.state.params,
                         now=0.0, deadline=5.0)
    assert len(coord._lease_heap) == 1
    assert coord.expire(now=10.0) == [finite]
    coord.drop(live)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_upload_leg_shard_frame_terminates_lease(n_shards):
    """A structurally valid SHARD frame on the UPLOAD leg (shard frames
    are download-only) raises WireError AND terminates the lease; the
    coordinator then runs the next round end to end."""
    fp = _params()
    coord = Coordinator(VCASGD(0.9), fp)
    lease = coord.issue(cid=0, uid=1, round=0, base=fp)
    coord.submit(lease, fp.buf + 1.0)
    evil = wire.encode_shard(fp.buf, shard=0, n_shards=n_shards)
    coord.transport._inflight[lease.msg_id] = evil
    with pytest.raises(wire.WireError, match="upload"):
        coord.deliver(lease)
    assert lease.status == LEASE_DROPPED and lease.released
    assert coord.in_flight == 0 and coord.dropped == 1
    l2 = coord.issue(cid=0, uid=2, round=0, base=coord.state.params)
    coord.submit(l2, l2.base.buf + 1.0)
    coord.assimilate(l2, coord.deliver(l2), server_version=0)
    assert coord.assimilated == 1


def test_restore_checkpoint_drops_leases_and_resets_ledgers(tmp_path):
    fp = F.flatten_sharded({"w": torch.from_numpy(_np())}, 2)
    coord = Coordinator(CompressedVCASGD(0.9, density=0.05), fp)
    mgr = CheckpointManager(tmp_path, async_save=False)
    l1 = coord.issue(cid=0, uid=1, round=0, base=fp)
    coord.submit(l1, l1.base.buf + 1.0)
    coord.assimilate(l1, coord.deliver(l1), server_version=0)
    coord.save_checkpoint(mgr, step=1)
    l2 = coord.issue(cid=1, uid=2, round=0, base=coord.state.params)
    coord.submit(l2, l2.base.buf + 2.0)
    coord.assimilate(l2, coord.deliver(l2), server_version=1)
    l3 = coord.issue(cid=1, uid=3, round=0, base=coord.state.params)
    coord.submit(l3, l3.base.buf + 3.0)
    l4 = coord.issue(cid=2, uid=4, round=0, base=coord.state.params)
    assert coord.in_flight == 2 and coord.residual_mass() > 0.0
    assert coord._client_vec
    restored_version = coord.state.version
    assert coord.restore_checkpoint(mgr) == 1
    assert coord.in_flight == 0 and len(coord._lease_heap) == 0
    assert coord.transport.in_flight == 0
    assert coord.residual_mass() == 0.0 and not coord._client_vec
    assert l3.released and l4.released
    assert coord.state.version < restored_version
    assert isinstance(coord.state.params.spec, F.ShardedTreeSpec)
    with pytest.raises(LeaseError):
        coord.assimilate(l3, fp.buf + 3.0, server_version=0)
    l5 = coord.issue(cid=0, uid=5, round=1, base=coord.state.params)
    assert l5.handout_frames == 2              # full re-download
    coord.submit(l5, l5.base.buf + 1.0)
    coord.assimilate(l5, coord.deliver(l5), server_version=0)


def test_sim_tier_fleet_churn_accounting():
    """A preemptible probe fleet behind 4 aggregators: every result is
    assimilated once, every flush is one hub KIND_AGG frame, the tier
    survives churn and the edges carry the per-client traffic."""
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.scenarios.probe import ProbeTask, make_probe_data
    cfg = SimConfig(n_param_servers=2, n_clients=120, tasks_per_client=1,
                    n_shards=240, max_epochs=2, local_steps=1,
                    timeout_s=1800.0, preemptible=True,
                    mean_lifetime_s=5400.0, restart_delay_s=120.0,
                    subtask_compute_s=120.0, server_proc_s=0.05, seed=7,
                    aggregators=4)
    res = run_simulation(ProbeTask(), make_probe_data(240, seed=7),
                         VCASGD(0.95), cfg, device="cpu")
    assert res.epochs_done == 2 and res.results_assimilated == 480
    assert res.wire_agg_frames == res.agg_flushes > 0
    assert res.preemptions > 0
    assert res.edge_wire.frames_sent > res.wire.frames_sent


def test_protocol_exports_are_the_references():
    import torch.utils._pytree as pytree
    from dataclasses import dataclass
    import repro.protocol as RP
    import repro_torch.protocol as PP
    assert set(PP.__all__) == set(RP.__all__)

    @PP.scheme_state
    @dataclass
    class PodLike:
        _tree_fields = ("params", "replicas")
        params: object
        replicas: object
        version: int = 0

    leaves, spec = pytree.tree_flatten(PodLike(torch.ones(3), [torch.zeros(2)],
                                               version=4))
    assert len(leaves) == 2
    back = pytree.tree_unflatten([x + 1 for x in leaves], spec)
    assert back.version == 4 and torch.equal(back.params, torch.full((3,), 2.))
