"""Discrete-event simulator of the VC training system (§III, §IV) — port
of ``repro/core/simulator.py``.

Pn parameter servers share an eventual or strong ParameterStore; Cn
heterogeneous preemptible clients train Tn subtasks each; a BOINC-style
scheduler reassigns timed-out units; every handout and every result is a
real wire frame through the ``Coordinator``.  The event loop, its rng
streams and its tie-breaking are the reference's, line for line, so the
event trace (times, frames, bytes, preemptions, reassignments, lease
counters) is identical to the reference's for the same config and seed.

Every option of the reference's ``SimConfig`` runs:
* ``bus_shards > 1`` lays the server bus out sharded, so handouts ship as
  per-shard delta frames through the version-vector ledger;
* ``aggregators = N`` puts N edge ``Aggregator``s between the clients and
  the hub: client cid leases from aggregator cid % N, each edge folds its
  window's arrivals with the scheme's own assimilate and ships ONE merged
  KIND_AGG frame upstream per flush;
* ``subscribers = N`` adds N read-only model pullers served from the
  hub's content-addressed frame cache (``HandoutService``), on their own
  rng stream, so the trainer trace does not move;
* ``handout_dtype="bfloat16"`` ships half-width download frames.

ACCURACY IS REAL: clients run actual training (``MLPTask.client_train``
on the flat bus, one fused Adam launch per step on the card) and the
server folds each result with the scheme's own rule (Eq. 1 is one fused
lerp launch per result, at the hub or at an edge); only wall-clock time
is simulated.  ``scenarios/probe.py::ProbeTask`` speaks the same task
protocol with a one-slot nudge in place of training.  The data goes to
``device`` once, at the start, and the bus lives there.

Beside the event loop: ``run_preemptible_training`` (the kill-and-restore
harness of the one-pass train checkpoints) and ``run_single_instance``
(the paper's Fig. 6 serial baseline).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flat as F
from repro_torch.core.consistency import EventualStore, StoreStats, StrongStore
from repro_torch.core.preemption import (LatencyModel, PreemptionModel,
                                         make_fleet)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.work_generator import WorkGenerator, split_dataset
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Adam
from repro_torch.protocol import (Aggregator, Coordinator, HandoutService,
                                  ServerScheme, as_flat, as_tree)
from repro_torch.runtime.train import make_flat_train_step
from repro_torch.transfer import wire
from repro_torch.transfer.transport import (LoopbackTransport, Transport,
                                            TransportStats)


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
    # shard count of the server bus (1 = dense handout frames; >1 puts the
    # version-vector delta-handout ledger in the path)
    bus_shards: int = 1
    # evaluate every k-th assimilation (1 = every one)
    eval_stride: int = 1
    # custom fleet: cfg -> list[ClientModel] (the scenario
    # registry's preemption models and tiers); None = make_fleet
    fleet_fn: Optional[Callable] = None
    # edge aggregators (0 = flat: every client leases from the hub)
    aggregators: int = 0
    # download-leg frame dtype: "float32" or "bfloat16"
    handout_dtype: str = "float32"
    # read-only subscribers served from the hub's frame cache (0 = off)
    subscribers: int = 0
    # arrival process: "flash" (the crowd re-pulls within sub_jitter_s of
    # each sub_interval_s tick), "uniform" / "lognormal" (independent
    # re-pull intervals of mean sub_interval_s)
    sub_lag: str = "flash"
    sub_interval_s: float = 600.0
    sub_jitter_s: float = 30.0
    # serial read frontends: per-pull service = overhead + encode time of
    # the bytes THIS pull was first to request; then the subscriber link
    sub_frontends: int = 4
    sub_serve_overhead_s: float = 0.001
    sub_encode_gbps: float = 1.0
    sub_bandwidth_gbps: float = 0.3


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
    # client minibatch steps asked of ``task.client_train`` (results
    # discarded later included): one fused Adam launch each on the card
    # for an MLPTask; a ProbeTask's nudge launches nothing.
    client_steps: int = 0
    # ---- aggregation tier (cfg.aggregators > 0): ``wire`` / ``handout_*``
    # cover the HUB transport only; ``edge_wire`` sums the edges'
    aggregators: int = 0
    agg_flushes: int = 0              # merged frames shipped upstream
    wire_agg_frames: int = 0          # KIND_AGG frames the hub assimilated
    edge_wire: Optional[TransportStats] = None
    # ---- handout serving: the hub's whole download leg ------------------
    handout_unique_bytes_encoded: int = 0
    handout_bytes_served: int = 0
    handout_dedup_ratio: float = 0.0
    subscribers: int = 0
    sub_pulls: int = 0
    sub_frames_served: int = 0
    sub_bytes_served: int = 0
    sub_latency_p50_s: float = 0.0
    sub_latency_p99_s: float = 0.0

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
_AGG_ARRIVE = 5             # merged edge frame lands at the hub (tier mode)
_WINDOW_OPEN = 6            # aggregator handout downloaded; window usable
_SUB_PULL = 7               # read-only subscriber pulls the model


def _pick_server(ps_busy) -> int:
    """Earliest-free parameter server; ties break to the lowest index."""
    return min(range(len(ps_busy)), key=lambda i: (ps_busy[i], i))


def _shard_rows(shard_index: np.ndarray, n_shards: int, dev):
    """Row indices of every data shard, ascending within a shard (what
    ``np.flatnonzero(shard_index == s)`` gives), as views of ONE device
    tensor: one host->device copy however many shards there are."""
    order = np.argsort(shard_index, kind="stable")
    bounds = np.searchsorted(shard_index[order], np.arange(n_shards + 1))
    rows = torch.from_numpy(order).to(dev)
    return [rows[bounds[s]:bounds[s + 1]] for s in range(n_shards)]


def _initial_bus(task, cfg: SimConfig, params0, dev) -> F.FlatParams:
    """The server's initial bus on ``dev``: ``params0`` (a tree or a
    FlatParams) or the task's init, laid out sharded when
    ``cfg.bus_shards > 1``."""
    n = cfg.bus_shards
    if params0 is None:
        params0 = task.init_params(cfg.seed, device=dev)
    if isinstance(params0, F.FlatParams):
        if n > 1 and getattr(params0.spec, "n_shards", 1) != n:
            raise ValueError(f"params0's layout is not the {n}-shard bus "
                             f"cfg.bus_shards asks for")
        fp = params0
    else:
        fp = F.flatten_sharded(params0, n) if n > 1 else as_flat(params0)
    return fp.with_buf(fp.buf.to(dev))


def _sum_stats(stats) -> TransportStats:
    out = TransportStats()
    for s in stats:
        out.frames_sent += s.frames_sent
        out.bytes_sent += s.bytes_sent
        out.frames_recv += s.frames_recv
        out.bytes_recv += s.bytes_recv
        out.frames_dropped += s.frames_dropped
        out.bytes_dropped += s.bytes_dropped
    return out


def run_simulation(task, data, scheme: ServerScheme, cfg: SimConfig, *,
                   device="cuda", params0=None,
                   transport: Optional[Transport] = None) -> SimResult:
    """Run the VC training system to ``cfg.max_epochs`` (or the target
    accuracy) on ``device``.  ``params0`` (a tree or FlatParams) replaces
    the task's initial params as the initial server copy."""
    dev = resolve_device(device)

    split = split_dataset(len(data.x_train), cfg.n_shards, seed=cfg.seed)
    shards = _shard_rows(split.shard_index, cfg.n_shards, dev)
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
    params0 = _initial_bus(task, cfg, params0, dev)
    eventual = cfg.consistency == "eventual"
    store = EventualStore(params0) if eventual else StrongStore(params0)
    coord = Coordinator(scheme, params0, transport=transport,
                        timeout_s=cfg.timeout_s,
                        handout_dtype=cfg.handout_dtype)
    ps_busy = [0.0] * cfg.n_param_servers

    def evaluate(fp: F.FlatParams) -> float:
        return task.evaluate(as_tree(fp), x_val, y_val)

    # ---- the aggregation tier (cfg.aggregators > 0) ------------------------
    # Each edge is a real Aggregator over its own loopback transport; the
    # hub transport carries only upstream window handouts and merged
    # frames.  A window admits one dispatch per assigned client and
    # flushes when every lease it issued has terminated; pulls against a
    # closed or full window are deferred and drained when the next window
    # opens.  Upstream transfers draw from a per-aggregator rng stream
    # (never the clients') through the LatencyModel at 10 Gbps.
    n_agg = cfg.aggregators
    aggs: List[Aggregator] = []
    if n_agg:
        aggs = [Aggregator(scheme, coord, agg_id=a,
                           transport=LoopbackTransport(),
                           timeout_s=cfg.timeout_s,
                           handout_dtype=cfg.handout_dtype)
                for a in range(n_agg)]
        agg_lat = LatencyModel()
        agg_rngs = [np.random.default_rng((cfg.seed, 0xA66, a))
                    for a in range(n_agg)]
        fan = [0] * n_agg               # clients assigned per aggregator
        for c in fleet:
            fan[c.cid % n_agg] += 1
        agg_open = [False] * n_agg      # window accepting dispatches
        agg_disp = [0] * n_agg          # dispatches admitted this window
        agg_rv = [0] * n_agg            # store version of the window base
        agg_busy = [0.0] * n_agg        # serial fold chain (like a PS)
        agg_deferred: List[List[int]] = [[] for _ in range(n_agg)]
        agg_def_set: List[set] = [set() for _ in range(n_agg)]
    upstream_live = 0                   # merged frames in flight to the hub
    pending_rolls: List[int] = []       # epochs rolled, awaiting hub commit

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

    def maybe_flush(a: int, now: float):
        """Flush aggregator ``a``'s window iff it is open, admitted a
        dispatch, and every lease it issued has terminated.  The merged
        frame's upstream transfer is timed off its real length; a window
        whose every result was lost flushes to nothing and reopens."""
        nonlocal upstream_live
        agg = aggs[a]
        if not agg_open[a] or agg_disp[a] == 0 or agg.in_flight != 0:
            return
        agg_open[a] = False
        t_flush = max(now, agg_busy[a])
        up = agg.flush(now=t_flush)
        if up is None:
            reopen_window(a, t_flush)
            return
        ul = agg_lat.sample(agg_rngs[a], up.frame_bytes, 10.0)
        upstream_live += 1
        push(t_flush + ul, _AGG_ARRIVE, a, (up,))

    def reopen_window(a: int, t: float):
        """Take aggregator ``a``'s next upstream lease (the store snapshot
        at ``t``, over the hub transport; never times out) and schedule
        _WINDOW_OPEN once its handout lands at the edge."""
        agg = aggs[a]
        base_fp, _ = store.read_at(t)
        up = agg.open_window(round=gen.epoch, now=t, base=base_fp,
                             read_version=store.version, deadline=math.inf)
        agg_rv[a] = store.version
        dl = agg_lat.sample(agg_rngs[a], up.handout_bytes, 10.0)
        push(t + dl, _WINDOW_OPEN, a)

    def dispatch(cid: int, now: float):
        """Client pulls work; each unit's lease is issued HERE, its
        handout crossing the transport as real frames."""
        client = fleet[cid]
        if n_agg:
            # the client leases from ITS aggregator, against the edge's
            # live fold state; a closed or full window defers the pull
            a = cid % n_agg
            agg = aggs[a]
            if not agg_open[a] or agg_disp[a] >= fan[a]:
                if cid not in agg_def_set[a]:
                    agg_def_set[a].add(cid)
                    agg_deferred[a].append(cid)
                return
            units = sched.request_work(cid, now)
            if units:
                agg_disp[a] += 1
            for unit in units:
                unit.param_version = agg_rv[a]
                lease = agg.issue(cid=cid, uid=unit.uid, round=unit.epoch,
                                  shard=unit.shard,
                                  read_version=agg.state.version,
                                  base=agg.state.params, now=now,
                                  deadline=unit.deadline)
                dl_bytes = (cfg.param_bytes if cfg.param_bytes is not None
                            else lease.handout_bytes) + cfg.model_bytes
                dl = client.transfer_time(dl_bytes)
                comp = client.compute_time(cfg.subtask_compute_s)
                push(now + dl + comp, _UPLOAD, cid, (unit, lease))
            if not units and agg.window_merged:
                # an empty pull must not wedge folded results in a window
                # nothing else will close
                maybe_flush(a, now)
            return
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

    # ---- read-only subscribers (cfg.subscribers > 0) -----------------------
    # Served from the hub's frame cache through HandoutService, on a
    # dedicated rng stream: the trainer trace is identical with them on.
    n_sub = cfg.subscribers
    service: Optional[HandoutService] = None
    sub_lat: List[float] = []
    if n_sub:
        service = HandoutService(coord)
        sub_rng = np.random.default_rng((cfg.seed, 0x5EB5))
        sub_busy = [0.0] * max(cfg.sub_frontends, 1)
        sub_encode_bps = cfg.sub_encode_gbps * 1e9 / 8.0
        sub_bw_bps = cfg.sub_bandwidth_gbps * 1e9 / 8.0

        def next_pull(now: float) -> float:
            if cfg.sub_lag == "flash":
                k = math.floor(now / cfg.sub_interval_s) + 1
                return (k * cfg.sub_interval_s
                        + cfg.sub_jitter_s * float(sub_rng.random()))
            if cfg.sub_lag == "lognormal":
                # heavy-tailed lag, mean sub_interval_s (mu = ln m - s^2/2)
                return now + float(sub_rng.lognormal(
                    math.log(cfg.sub_interval_s) - 0.5, 1.0))
            return now + cfg.sub_interval_s * (0.5 + float(sub_rng.random()))

        for s_id in range(n_sub):
            t0 = (cfg.sub_jitter_s * float(sub_rng.random())
                  if cfg.sub_lag == "flash"
                  else cfg.sub_interval_s * float(sub_rng.random()))
            push(t0, _SUB_PULL, s_id)

    if n_agg:
        # first windows open at t=0 (W0 is resident at the edge), so boot
        # pulls are admitted at the instants the flat engine dispatches
        # them; aggregators with no assigned clients never open
        for a in range(n_agg):
            if fan[a] == 0:
                continue
            base_fp, _ = store.read_at(0.0)
            aggs[a].open_window(round=0, now=0.0, base=base_fp,
                                read_version=store.version,
                                deadline=math.inf)
            agg_rv[a] = store.version
            agg_open[a] = True

    def epoch_point(e: int, t_commit: float) -> None:
        """Summarize epoch ``e`` into its EpochPoint at ``t_commit`` and
        release its per-result list."""
        nonlocal target_hit
        accs = np.array(epoch_accs.get(e) or [0.0])
        points.append(EpochPoint(
            epoch=e, t_complete=t_commit,
            acc_mean=float(accs.mean()), acc_min=float(accs.min()),
            acc_max=float(accs.max()), acc_std=float(accs.std())))
        epoch_accs.pop(e, None)
        scheme.on_epoch(coord.state, gen.epoch)
        if (cfg.target_accuracy is not None
                and accs.mean() >= cfg.target_accuracy):
            target_hit = True

    def hub_fold(lease, payload_w, t_now: float) -> float:
        """Deliver-side assimilation at the hub on the earliest-free PS
        through the consistency store; returns the commit time."""
        ps = _pick_server(ps_busy)
        t_free = max(t_now, ps_busy[ps])
        server_version = store.version
        if eventual:
            snap, _ = store.read_at(t_free)
            state = coord.assimilate(lease, payload_w,
                                     server_version=server_version,
                                     t_arrival=t_now, params_override=snap)
            t_commit = store.commit(t_free, t_free + cfg.server_proc_s,
                                    state.params)
        else:
            def txn(head):
                st = coord.assimilate(lease, payload_w,
                                      server_version=server_version,
                                      t_arrival=t_now, params_override=head)
                return st.params
            t_commit = store.transact(t_free + cfg.server_proc_s, txn)
        ps_busy[ps] = t_commit
        return t_commit

    t_now = 0.0
    hard_stop = 10 ** 9
    target_hit = False

    # flat mode drains as the historical loop (upstream_live stays 0);
    # tier mode pops on until the in-flight merged frames land, every
    # other post-exhaustion event discarded unprocessed
    while events and not target_hit:
        if gen.exhausted and upstream_live == 0:
            break
        t_now, seq, kind, cid = heapq.heappop(events)
        if t_now > hard_stop:
            break
        events_processed += 1
        if gen.exhausted and kind != _AGG_ARRIVE:
            payloads.pop(seq, None)
            continue

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
                # the client's leases, residual and version vector are
                # held by its aggregator in tier mode
                if n_agg:
                    aggs[dcid % n_agg].drop_client(dcid)
                    maybe_flush(dcid % n_agg, t_now)
                else:
                    coord.drop_client(dcid)
                c.spawn(t_now + c.preemption.restart_delay_s)
                track_spawn(c)
                push(t_now + c.preemption.restart_delay_s, _RESPAWN, dcid)

        # timeout sweep: scheduler requeue and lease expiry key off the
        # same deadlines
        sched.expire_timeouts(t_now)
        coord.expire(t_now)
        if n_agg:
            for a in range(n_agg):
                if aggs[a].expire(t_now):
                    maybe_flush(a, t_now)

        if kind == _SUB_PULL:
            # pull whatever chunks moved since this subscriber's last
            # pull; latency = wait for a frontend + overhead + encode time
            # of the bytes this pull was first to want + the downlink
            snap, _ = store.read_at(t_now)
            st_p = service.pull(cid, snap, round=gen.epoch)
            fe = _pick_server(sub_busy)
            t_done = (max(t_now, sub_busy[fe]) + cfg.sub_serve_overhead_s
                      + st_p.encoded_bytes / sub_encode_bps)
            sub_busy[fe] = t_done
            sub_lat.append(t_done + st_p.bytes / sub_bw_bps - t_now)
            push(next_pull(t_now), _SUB_PULL, cid)
            continue

        if kind <= _DISPATCH:           # boot / respawn / dispatch
            dispatch(cid, t_now)
            continue

        if kind == _WINDOW_OPEN:
            # the edge's fresh window base landed: admit pulls again and
            # drain the deferred clients in the order they asked
            a = cid
            agg_open[a] = True
            agg_disp[a] = 0
            drain = agg_deferred[a]
            agg_deferred[a] = []
            agg_def_set[a].clear()
            for dcid in drain:
                dispatch(dcid, t_now)
            continue

        if kind == _AGG_ARRIVE:
            # ONE merged frame lands at the hub and takes a flat result's
            # PS + store path; the scheme folds it with
            # assimilate_aggregate (W' = M + (1 - w)(W - B))
            a = cid
            (up,) = payloads.pop(seq)
            upstream_live -= 1
            payload_w = coord.deliver(up)
            t_commit = hub_fold(up, payload_w, t_now)
            # validation reads the HUB store; epoch points emit at the
            # first hub commit after the generator rolled
            if coord.assimilated % cfg.eval_stride == 0:
                epoch_accs.setdefault(up.round, []).append(
                    evaluate(store.head()))
            while pending_rolls:
                epoch_point(pending_rolls.pop(0), t_commit)
            if not gen.exhausted:
                reopen_window(a, t_commit)
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
            # (over the client's EDGE transport in tier mode)
            srv = aggs[cid % n_agg] if n_agg else coord
            srv.submit(lease, trained_buf)
            ul = client.transfer_time(cfg.upload_bytes
                                      if cfg.upload_bytes is not None
                                      else lease.frame_bytes)
            push(t_now + ul, _ARRIVE, cid, (unit, lease))
            continue

        if kind == _ARRIVE:
            unit, lease = payloads.pop(seq)
            client = fleet[cid]
            if n_agg:
                # the result lands at the client's EDGE: folded into the
                # window by the scheme's own assimilate on the edge's
                # serial chain; terminating the lease can close the window
                a = cid % n_agg
                agg = aggs[a]
                if cfg.preemptible and client.alive_until <= t_now:
                    agg.drop(lease)
                    maybe_flush(a, t_now)
                    continue
                if unit.uid not in sched.inflight:
                    agg.drop(lease)
                    maybe_flush(a, t_now)
                    dispatch(cid, t_now)
                    continue
                sched.complete(unit.uid, t_now)
                payload_w = agg.deliver(lease)
                t_free = max(t_now, agg_busy[a])
                agg.assimilate(lease, payload_w,
                               server_version=agg.state.version,
                               t_arrival=t_now)
                t_commit = t_free + cfg.server_proc_s
                agg_busy[a] = t_commit
                assimilated += 1
                if gen.complete(unit):
                    # the hub has not seen it yet: the EpochPoint emits at
                    # the next merged-frame commit
                    pending_rolls.append(unit.epoch)
                push(t_commit, _DISPATCH, cid)
                maybe_flush(a, t_commit)
                continue
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
            t_commit = hub_fold(lease, payload_w, t_now)
            assimilated += 1

            if assimilated % cfg.eval_stride == 0:
                epoch_accs.setdefault(unit.epoch, []).append(
                    evaluate(store.head()))

            if gen.complete(unit):
                epoch_point(unit.epoch, t_commit)
            push(t_commit, _DISPATCH, cid)

    edge_stats: Optional[TransportStats] = None
    if n_agg:
        # windows still open at exit are abandoned as a lost aggregator
        # would be: everything releases through the protocol
        for agg in aggs:
            if agg.in_flight or agg.window_open:
                agg.fail()
        edge_stats = _sum_stats(agg.wire_stats for agg in aggs)

    final_acc = evaluate(store.head())
    cache = coord.handout_cache
    return SimResult(
        points=points, wall_time_s=t_now,
        epochs_done=len(points), final_accuracy=final_acc,
        store_stats=store.stats, reassignments=sched.reassignments,
        preemptions=preemptions, results_assimilated=assimilated,
        cost_hours=t_now / 3600.0, wire=coord.wire_stats,
        wire_dense_frames=(coord.frames[wire.KIND_DENSE]
                           + sum(a.frames[wire.KIND_DENSE] for a in aggs)),
        wire_sparse_frames=(coord.frames[wire.KIND_SPARSE]
                            + sum(a.frames[wire.KIND_SPARSE] for a in aggs)),
        handout_frames=coord.handout_frames,
        handout_bytes=coord.handout_bytes,
        leases_expired=coord.expired + sum(a.expired for a in aggs),
        leases_dropped=coord.dropped + sum(a.dropped for a in aggs),
        events_processed=events_processed,
        scheme_state=coord.state, client_steps=client_steps,
        aggregators=n_agg,
        agg_flushes=sum(a.flushes for a in aggs),
        wire_agg_frames=coord.frames[wire.KIND_AGG],
        edge_wire=edge_stats,
        handout_unique_bytes_encoded=int(cache.encoded_bytes),
        handout_bytes_served=int(cache.served_bytes),
        handout_dedup_ratio=float(cache.dedup_ratio),
        subscribers=n_sub,
        sub_pulls=service.pulls if service else 0,
        sub_frames_served=service.frames_served if service else 0,
        sub_bytes_served=service.bytes_served if service else 0,
        sub_latency_p50_s=(float(np.percentile(sub_lat, 50))
                           if sub_lat else 0.0),
        sub_latency_p99_s=(float(np.percentile(sub_lat, 99))
                           if sub_lat else 0.0))


@dataclass
class PreemptibleTrainResult:
    """Trajectory of ``run_preemptible_training``: ``losses[step]`` is the
    loss of global step ``step`` (a recomputed step overwrites it with the
    same value), so two runs compare at matching steps however often
    either was killed."""
    losses: Dict[int, float]
    restores: int
    recomputed_steps: int
    steps_done: int
    final_params: Any                      # FlatParams

    def trajectory(self) -> List[Tuple[int, float]]:
        return sorted(self.losses.items())


def step_batch_indices(seed: int, step: int, batch: int, n: int
                       ) -> torch.Tensor:
    """Row indices of global step ``step``'s minibatch in
    ``run_preemptible_training``: drawn on a CPU generator keyed by
    ``(seed + 987654, step)`` alone, so a restored run draws the lost
    steps' batches again."""
    key = np.random.SeedSequence((seed + 987654, step)).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(key))
    return torch.randint(0, n, (batch,), generator=gen)


def run_preemptible_training(task, data, *, steps: int = 40, batch: int = 64,
                             ckpt_every: int = 10, ckpt_dir,
                             kill_schedule=None, seed: int = 0, on_step=None,
                             device="cuda") -> PreemptibleTrainResult:
    """Kill-and-restore harness on the flat bus: the correctness argument
    for the one-pass train checkpoints (checkpoint/store.py).

    Params and Adam state are three lanes of one layout, one fused Adam
    launch a step on the card, written as ONE record every
    ``ckpt_every`` steps (synchronously: the resume guarantee is only as
    strong as the last committed record).  Before each step listed in
    ``kill_schedule`` (core/preemption.py::KillSchedule) every in-memory
    tensor is dropped and training resumes from the last record.
    Batches are keyed by the global step (``step_batch_indices``), so
    the loss at every step equals the uninterrupted run's.  A record
    already in ``ckpt_dir`` is resumed from."""
    dev = resolve_device(device)
    fp0 = as_flat(task.init_params(seed, device=dev))
    opt = Adam(lr=task.lr)
    fos0 = opt.init_flat(fp0)
    step_fn = make_flat_train_step(lambda p, b: task.loss(p, b[0], b[1]),
                                   opt)
    x_train = torch.from_numpy(data.x_train).to(dev)
    y_train = torch.from_numpy(data.y_train).to(dev, torch.int64)

    def batch_for(step: int):
        idx = step_batch_indices(seed, step, batch, len(data.x_train)).to(dev)
        return x_train[idx], y_train[idx]

    mgr = CheckpointManager(ckpt_dir, async_save=False)
    (fp, fos), _, step = mgr.restore_train_or_init(fp0, lambda: (fp0, fos0))
    kills = list(kill_schedule.kill_steps) if kill_schedule is not None else []
    losses: Dict[int, float] = {}
    restores = recomputed = 0
    max_reached = step
    while step < steps:
        if kills and step == kills[0]:
            kills.pop(0)
            # preemption: the last one-pass record is the only survivor
            del fp, fos
            (fp, fos), _, step = mgr.restore_train_or_init(
                fp0, lambda: (fp0, fos0))
            restores += 1
            continue
        fp, fos, loss = step_fn(fp, fos, batch_for(step))
        if step < max_reached:
            recomputed += 1
        losses[step] = float(loss)
        step += 1
        max_reached = max(max_reached, step)
        if step % ckpt_every == 0:
            mgr.save_train(step, fp, fos, {"step": step})
        if on_step is not None:
            on_step(step)              # host hook (pacing, a kill harness)
    return PreemptibleTrainResult(losses=losses, restores=restores,
                                  recomputed_steps=recomputed,
                                  steps_done=max_reached, final_params=fp)


def run_single_instance(task, data, *, max_epochs: int = 40,
                        steps_per_epoch: int = 100, seed: int = 0,
                        epoch_time_s: float = 1200.0,
                        device="cuda") -> SimResult:
    """The paper's Fig. 6 baseline: serial training on one standard
    instance, ``steps_per_epoch`` Adam steps an epoch (fresh moments each,
    as a client's subtask) on the whole training set, one fused Adam
    launch a step on the card."""
    dev = resolve_device(device)
    fp = as_flat(task.init_params(seed, device=dev))
    x_train = torch.from_numpy(data.x_train).to(dev)
    y_train = torch.from_numpy(data.y_train).to(dev, torch.int64)
    x_val = torch.from_numpy(data.x_val).to(dev)
    y_val = torch.from_numpy(data.y_val).to(dev, torch.int64)
    points = []
    for e in range(1, max_epochs + 1):
        fp = fp.with_buf(task.client_train(fp, x_train, y_train,
                                           steps=steps_per_epoch,
                                           seed=seed + e))
        acc = task.evaluate(as_tree(fp), x_val, y_val)
        points.append(EpochPoint(epoch=e, t_complete=e * epoch_time_s,
                                 acc_mean=acc, acc_min=acc, acc_max=acc,
                                 acc_std=0.0))
    return SimResult(points=points, wall_time_s=max_epochs * epoch_time_s,
                     epochs_done=max_epochs,
                     final_accuracy=points[-1].acc_mean,
                     store_stats=StoreStats(), reassignments=0, preemptions=0,
                     results_assimilated=max_epochs,
                     client_steps=max_epochs * steps_per_epoch)
