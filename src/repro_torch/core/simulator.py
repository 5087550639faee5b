"""Discrete-event simulator of the VC training system (§III, §IV) — port
of the flat-hub path of ``repro/core/simulator.py``.

Pn parameter servers share an eventual or strong ParameterStore; Cn
heterogeneous preemptible clients train Tn subtasks each; a BOINC-style
scheduler reassigns timed-out units; every handout and every result is a
real wire frame through the ``Coordinator``.  The event loop, its rng
streams and its tie-breaking are the reference's, line for line, so the
event trace (times, frames, bytes, preemptions, reassignments, lease
counters) is identical to the reference's for the same config and seed.

ACCURACY IS REAL: clients run actual training (``MLPTask.client_train``
on the flat bus, one fused Adam launch per step on the card) and the
server folds each result with the scheme's own rule (Eq. 1 is one fused
lerp launch per result; compressed uploads ride sparse frames); only
wall-clock time is simulated.  The data goes to ``device`` once, at the
start.

Not ported yet (raise ``NotImplementedError``): the aggregation tier
(``aggregators > 0``), read-only subscribers (``subscribers > 0``), a
sharded server bus (``bus_shards > 1``) and bf16 handout frames.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.consistency import EventualStore, StoreStats, StrongStore
from repro_torch.core.preemption import PreemptionModel, make_fleet
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.work_generator import WorkGenerator, split_dataset
from repro_torch.device import resolve_device
from repro_torch.protocol import Coordinator, ServerScheme, as_flat, as_tree
from repro_torch.transfer import wire
from repro_torch.transfer.transport import Transport, TransportStats


@dataclass
class SimConfig:
    n_param_servers: int = 3          # Pn
    n_clients: int = 3                # Cn
    tasks_per_client: int = 4         # Tn
    n_shards: int = 50                # paper: 50 CIFAR subsets
    max_epochs: int = 40
    target_accuracy: Optional[float] = None
    local_steps: int = 60             # client minibatch steps per subtask
    timeout_s: float = 1800.0
    consistency: str = "eventual"     # "eventual" (Redis) | "strong" (MySQL)
    preemptible: bool = False
    mean_lifetime_s: float = 5400.0
    restart_delay_s: float = 120.0
    # transfer-size overrides (paper calibration); None = real frame bytes
    param_bytes: Optional[float] = None
    shard_bytes: float = 3.9e6
    model_bytes: float = 269e3
    upload_bytes: Optional[float] = None
    server_proc_s: float = 2.0
    subtask_compute_s: float = 180.0
    seed: int = 0
    bus_shards: int = 1               # >1: not ported yet
    eval_stride: int = 1
    fleet_fn: Optional[Callable] = None
    aggregators: int = 0              # >0: not ported yet
    handout_dtype: str = "float32"    # bf16: not ported yet
    subscribers: int = 0              # >0: not ported yet


@dataclass
class EpochPoint:
    epoch: int
    t_complete: float
    acc_mean: float
    acc_min: float
    acc_max: float
    acc_std: float


@dataclass
class SimResult:
    points: List[EpochPoint]
    wall_time_s: float
    epochs_done: int
    final_accuracy: float
    store_stats: StoreStats
    reassignments: int
    preemptions: int
    results_assimilated: int
    cost_hours: float = 0.0
    wire: Optional[TransportStats] = None
    wire_dense_frames: int = 0
    wire_sparse_frames: int = 0
    handout_frames: int = 0
    handout_bytes: int = 0
    leases_expired: int = 0
    leases_dropped: int = 0
    events_processed: int = 0
    scheme_state: Any = None
    # client minibatch steps trained (results discarded later included):
    # one fused Adam launch each on the card
    client_steps: int = 0

    def acc_at_time(self, t: float) -> float:
        """Accuracy of the LATEST epoch completed at or before ``t``."""
        acc = 0.0
        for p in self.points:
            if p.t_complete <= t:
                acc = p.acc_mean
        return acc


# event kinds; the monotone seq is the explicit same-timestamp tie-breaker
_BOOT = 0
_RESPAWN = 1
_DISPATCH = 2               # client pulls new work (post-commit)
_UPLOAD = 3                 # client finished local training; starts upload
_ARRIVE = 4                 # result lands at the web server


def _pick_server(ps_busy) -> int:
    """Earliest-free parameter server; ties break to the lowest index."""
    return min(range(len(ps_busy)), key=lambda i: (ps_busy[i], i))


def _check_ported(cfg: SimConfig) -> None:
    later = [("aggregators", cfg.aggregators > 0, "the aggregation-tier"),
             ("subscribers", cfg.subscribers > 0, "the handout-serving"),
             ("bus_shards", cfg.bus_shards > 1, "the sharded-bus")]
    for name, on, slice_ in later:
        if on:
            raise NotImplementedError(
                f"SimConfig.{name}={getattr(cfg, name)} is not ported yet: "
                f"it comes with {slice_} slice of the port")


def run_simulation(task, data, scheme: ServerScheme, cfg: SimConfig, *,
                   device="cuda", params0=None,
                   transport: Optional[Transport] = None) -> SimResult:
    """Run the VC training system to ``cfg.max_epochs`` (or the target
    accuracy) on ``device``.  ``params0`` (a tree or FlatParams) replaces
    ``task.init_params(cfg.seed)`` as the initial server copy."""
    _check_ported(cfg)
    dev = resolve_device(device)

    split = split_dataset(len(data.x_train), cfg.n_shards, seed=cfg.seed)
    shards = [torch.from_numpy(np.flatnonzero(split.shard_index == s)).to(dev)
              for s in range(cfg.n_shards)]
    x_train = torch.from_numpy(data.x_train).to(dev)
    y_train = torch.from_numpy(data.y_train).to(dev, torch.int64)
    x_val = torch.from_numpy(data.x_val).to(dev)
    y_val = torch.from_numpy(data.y_val).to(dev, torch.int64)

    gen = WorkGenerator(cfg.n_shards, local_steps=cfg.local_steps,
                        max_epochs=cfg.max_epochs)
    sched = Scheduler(gen, timeout_s=cfg.timeout_s,
                      tasks_per_client=cfg.tasks_per_client)

    if cfg.fleet_fn is not None:
        fleet = cfg.fleet_fn(cfg)
    else:
        pre = PreemptionModel(mean_lifetime_s=cfg.mean_lifetime_s,
                              restart_delay_s=cfg.restart_delay_s,
                              enabled=cfg.preemptible)
        fleet = make_fleet(cfg.n_clients, seed=cfg.seed, preemption=pre)
    for c in fleet:
        c.spawn(0.0)

    # server state rides the flat bus: the store versions ONE contiguous
    # buffer, and every Eq. 1 update is one fused pass over it
    if params0 is None:
        params0 = task.init_params(cfg.seed, device=dev)
    params0 = as_flat(params0)
    params0 = params0.with_buf(params0.buf.to(dev))
    eventual = cfg.consistency == "eventual"
    store = EventualStore(params0) if eventual else StrongStore(params0)
    coord = Coordinator(scheme, params0, transport=transport,
                        timeout_s=cfg.timeout_s,
                        handout_dtype=cfg.handout_dtype)
    ps_busy = [0.0] * cfg.n_param_servers

    epoch_accs: Dict[int, List[float]] = {}
    points: List[EpochPoint] = []

    events: List[Tuple[float, int, int, int]] = []
    payloads: Dict[int, tuple] = {}
    eid = itertools.count()
    preemptions = 0
    assimilated = 0
    events_processed = 0
    client_steps = 0

    def push(t, kind, cid, payload=None):
        seq = next(eid)
        if payload is not None:
            payloads[seq] = payload
        heapq.heappush(events, (t, seq, kind, cid))

    # preemption heap: (alive_until, spawn_generation, cid)
    preempt_heap: List[Tuple[float, int, int]] = []
    spawn_gen = [0] * cfg.n_clients
    preemptible = cfg.preemptible

    def track_spawn(c):
        spawn_gen[c.cid] += 1
        if preemptible and c.alive_until < math.inf:
            heapq.heappush(preempt_heap,
                           (c.alive_until, spawn_gen[c.cid], c.cid))

    for c in fleet:
        track_spawn(c)

    def dispatch(cid: int, now: float):
        """Client pulls work; each unit's lease is issued HERE, its
        handout crossing the transport as a real dense frame."""
        client = fleet[cid]
        units = sched.request_work(cid, now)
        for unit in units:
            unit.param_version = store.version
            base_fp, _ = store.read_at(now)
            lease = coord.issue(cid=cid, uid=unit.uid, round=unit.epoch,
                                shard=unit.shard, read_version=store.version,
                                base=base_fp, now=now,
                                deadline=unit.deadline)
            dl_bytes = (cfg.param_bytes if cfg.param_bytes is not None
                        else lease.handout_bytes) + cfg.model_bytes
            dl = client.transfer_time(dl_bytes)
            comp = client.compute_time(cfg.subtask_compute_s)
            push(now + dl + comp, _UPLOAD, cid, (unit, lease))

    for c in fleet:
        push(0.001 * c.cid, _BOOT, c.cid)

    t_now = 0.0
    hard_stop = 10 ** 9
    target_hit = False

    while events and not target_hit:
        if gen.exhausted:
            break
        t_now, seq, kind, cid = heapq.heappop(events)
        if t_now > hard_stop:
            break
        events_processed += 1

        # preemption sweep: every client whose lifetime expired, in
        # ascending-cid order
        if preemptible and preempt_heap and preempt_heap[0][0] <= t_now:
            dead: List[int] = []
            while preempt_heap and preempt_heap[0][0] <= t_now:
                _, g, dcid = heapq.heappop(preempt_heap)
                if g == spawn_gen[dcid]:
                    dead.append(dcid)
            dead.sort()
            for dcid in dead:
                c = fleet[dcid]
                lost = sched.fail_client(dcid, t_now)
                if lost:
                    preemptions += 1
                coord.drop_client(dcid)
                c.spawn(t_now + c.preemption.restart_delay_s)
                track_spawn(c)
                push(t_now + c.preemption.restart_delay_s, _RESPAWN, dcid)

        # timeout sweep: scheduler requeue and lease expiry key off the
        # same deadlines
        sched.expire_timeouts(t_now)
        coord.expire(t_now)

        if kind <= _DISPATCH:           # boot / respawn / dispatch
            dispatch(cid, t_now)
            continue

        if kind == _UPLOAD:
            unit, lease = payloads.pop(seq)
            client = fleet[cid]
            if cfg.preemptible and client.alive_until <= t_now:
                continue                # died mid-compute
            if unit.uid not in sched.inflight:
                dispatch(cid, t_now)    # timed out and reassigned
                continue

            # ---- client-side REAL training on the flat bus ---------------
            idx = shards[unit.shard]
            steps = unit.local_steps * max(1, len(idx) // task.batch)
            seed = cfg.seed * 1000003 + unit.uid
            trained_buf = task.client_train(
                lease.base, x_train[idx], y_train[idx], steps=steps,
                seed=seed)
            client_steps += steps

            # ---- the wire: REAL bytes, REAL upload time ------------------
            coord.submit(lease, trained_buf)
            ul = client.transfer_time(cfg.upload_bytes
                                      if cfg.upload_bytes is not None
                                      else lease.frame_bytes)
            push(t_now + ul, _ARRIVE, cid, (unit, lease))
            continue

        if kind == _ARRIVE:
            unit, lease = payloads.pop(seq)
            client = fleet[cid]
            if cfg.preemptible and client.alive_until <= t_now:
                coord.drop(lease)       # died mid-upload
                continue
            if unit.uid not in sched.inflight:
                coord.drop(lease)       # timed out and reassigned
                dispatch(cid, t_now)
                continue
            sched.complete(unit.uid, t_now)
            payload_w = coord.deliver(lease)

            # ---- server-side assimilation (Eq. 1) ------------------------
            ps = _pick_server(ps_busy)
            t_free = max(t_now, ps_busy[ps])
            server_version = store.version
            if eventual:
                snap, _ = store.read_at(t_free)
                state = coord.assimilate(lease, payload_w,
                                         server_version=server_version,
                                         t_arrival=t_now,
                                         params_override=snap)
                t_commit = store.commit(t_free, t_free + cfg.server_proc_s,
                                        state.params)
            else:
                def txn(head):
                    st = coord.assimilate(lease, payload_w,
                                          server_version=server_version,
                                          t_arrival=t_now,
                                          params_override=head)
                    return st.params
                t_commit = store.transact(t_free + cfg.server_proc_s, txn)
            ps_busy[ps] = t_commit
            assimilated += 1

            if assimilated % cfg.eval_stride == 0:
                acc = task.evaluate(as_tree(store.head()), x_val, y_val)
                epoch_accs.setdefault(unit.epoch, []).append(acc)

            if gen.complete(unit):
                accs = np.array(epoch_accs.get(unit.epoch) or [0.0])
                points.append(EpochPoint(
                    epoch=unit.epoch, t_complete=t_commit,
                    acc_mean=float(accs.mean()), acc_min=float(accs.min()),
                    acc_max=float(accs.max()), acc_std=float(accs.std())))
                epoch_accs.pop(unit.epoch, None)
                scheme.on_epoch(coord.state, gen.epoch)
                if (cfg.target_accuracy is not None
                        and accs.mean() >= cfg.target_accuracy):
                    target_hit = True
            push(t_commit, _DISPATCH, cid)

    final_acc = task.evaluate(as_tree(store.head()), x_val, y_val)
    return SimResult(
        points=points, wall_time_s=t_now,
        epochs_done=len(points), final_accuracy=final_acc,
        store_stats=store.stats, reassignments=sched.reassignments,
        preemptions=preemptions, results_assimilated=assimilated,
        cost_hours=t_now / 3600.0, wire=coord.wire_stats,
        wire_dense_frames=coord.frames[wire.KIND_DENSE],
        wire_sparse_frames=coord.frames[wire.KIND_SPARSE],
        handout_frames=coord.handout_frames,
        handout_bytes=coord.handout_bytes,
        leases_expired=coord.expired, leases_dropped=coord.dropped,
        events_processed=events_processed,
        scheme_state=coord.state, client_steps=client_steps)
