"""VC coordinator runtime (port of ``repro/launch/vc_serve.py``): the SAME
protocol objects the simulator drives, run against the wall clock, with
payload bytes crossing a REAL OS process boundary on both legs
(``transfer/transport.py::ProcessTransport``).

``core/simulator.py`` and this loop differ ONLY in where time comes from
and where clients run: issue / submit / deliver / assimilate, the
residual ledger, the wire framing (per-shard handout frames on the
download leg, dense / sparse result frames on the upload leg) and the
checkpoint hooks are the same code.  Clients train on the card: each
trains the DECODED handout (``lease.base``) for 4 Adam steps, one fused
Adam launch a step, and the hub and every edge fold each result with the
Eq. 1 kernel.

Resume is exact: a restarted server picks up at the checkpointed round
and uid (persisted in the checkpoint's ``extra``), so lease rounds, wire
headers and checkpoint steps are monotone across kills — step k+1 never
overwrites steps 1..k.

``--tier N`` puts N edge aggregators between the clients and the hub, a
real 2-level round: every aggregator runs over its OWN ProcessTransport
(client payloads cross one process boundary to the edge, ONE merged
``KIND_AGG`` frame per aggregator crosses another to the hub).
``--subscribers N`` has N read-only subscribers pull the model after
each round through the hub's content-addressed frame cache, every frame
crossing the hub's broker.

  PYTHONPATH=src python -m repro_torch.launch.vc_serve --rounds 4 --clients 3
  PYTHONPATH=src python -m repro_torch.launch.vc_serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.vc_serve --smoke --tier \\
      --subscribers 16 --density 0.05 --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without
a GPU.  ``main(argv)`` returns 0; ``run(argv, task=..., params0=...)``
does the work and returns a ``ServeRun`` (the protocol objects and each
round's host-clock phase times), so a caller can hand in its own task
and initial tree.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flat as F
from repro_torch.core.baselines import CompressedVCASGD, VCASGD
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.device import resolve_device
from repro_torch.protocol import (Aggregator, Coordinator, HandoutService,
                                  as_tree)
from repro_torch.transfer import wire
from repro_torch.transfer.transport import ProcessTransport

STEPS = 4                 # Adam steps a client runs on one lease


def _check(cond: bool, what: str) -> None:
    """End-of-run invariant check that survives ``python -O`` (a bare
    assert is compiled away, which is exactly when a silent protocol leak
    would go unnoticed in production)."""
    if not cond:
        raise SystemExit(f"[vc-serve] INVARIANT VIOLATED: {what}")


@dataclass
class ServeRun:
    """One run: its protocol objects after the last round (their
    transports closed), the uid the next run continues at, and each
    round's host-clock times in seconds — ``wall``, ``train`` (the
    clients' ``client_train`` calls), ``submit``, ``fold`` (drop,
    deliver, assimilate, flush, expire), ``ckpt`` (the checkpoint write),
    ``eval``, ``serve`` (the subscribers' pulls) and ``rpc`` (time inside
    broker RPCs on every transport, the prefetch thread's included, so it
    overlaps ``train``)."""
    coord: Coordinator
    aggs: List[Aggregator]
    service: Optional[HandoutService]
    start: int
    next_uid: int
    ckpt_dir: str
    accuracy: List[float] = field(default_factory=list)
    rounds: List[Dict[str, float]] = field(default_factory=list)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.vc_serve")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the server bus into N contiguous "
                         "segments: handouts ship as per-shard delta "
                         "frames (a client re-fetches only segments that "
                         "changed since its last handout)")
    ap.add_argument("--density", type=float, default=None,
                    help="compress payloads to this top-k density "
                         "(sparse wire frames)")
    ap.add_argument("--tier", type=int, nargs="?", const=1, default=0,
                    help="insert N edge aggregators (default 1 when the "
                         "flag is given bare): clients lease from their "
                         "aggregator, each aggregator submits ONE merged "
                         "v3 frame upstream per round over its own "
                         "process transport")
    ap.add_argument("--subscribers", type=int, default=0,
                    help="after each round, N read-only subscribers pull "
                         "the model through the content-addressed handout "
                         "cache — every served frame crosses the broker")
    ap.add_argument("--handout-dtype", default="float32",
                    choices=["float32", "f32", "bfloat16", "bf16"],
                    help="download-leg frame dtype: bf16 halves handout "
                         "bytes (f32 masters, bf16-exact reconstruction)")
    ap.add_argument("--timeout-s", type=float, default=600.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny configuration for the fast test gate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def run(argv=None, *, task: Optional[MLPTask] = None, params0=None
        ) -> ServeRun:
    """Parse ``argv`` and serve.  ``task`` replaces the default
    ``MLPTask`` (e.g. one with other minibatch draws); ``params0`` (a tree
    of arrays or tensors) replaces its seeded initial params."""
    args = _parser().parse_args(argv)
    if args.smoke:
        args.rounds, args.clients, args.shards = 2, 2, 2
    dev = resolve_device(args.device)

    task = task if task is not None else MLPTask()
    data = make_classification_data(n_train=600 if args.smoke else 3000,
                                    n_val=150 if args.smoke else 600,
                                    seed=args.seed)
    # the data crosses to the device once; every client samples from it
    x_train = torch.from_numpy(data.x_train).to(dev)
    y_train = torch.from_numpy(data.y_train).to(dev, torch.int64)
    x_val = torch.from_numpy(data.x_val).to(dev)
    y_val = torch.from_numpy(data.y_val).to(dev, torch.int64)
    if params0 is None:
        tree0 = task.init_params(args.seed, device=dev)
    else:
        tree0 = F.tree_map(lambda a: a.to(dev) if torch.is_tensor(a)
                           else torch.from_numpy(np.array(a)).to(dev),
                           params0)
    params0 = (F.flatten(tree0) if args.shards <= 1
               else F.flatten_sharded(tree0, args.shards))
    scheme = (VCASGD(0.9) if args.density is None
              else CompressedVCASGD(0.9, density=args.density))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="vc_serve_")
    mgr = CheckpointManager(ckpt_dir, async_save=False)

    with contextlib.ExitStack() as stack:
        transport = stack.enter_context(ProcessTransport())
        coord = Coordinator(scheme, params0, transport=transport,
                            timeout_s=args.timeout_s,
                            handout_dtype=args.handout_dtype)
        resumed = coord.restore_checkpoint(mgr)
        # checkpoint step k holds rounds 0..k-1, so a restarted server
        # continues at round k with the persisted next uid — rounds, wire
        # headers and checkpoint steps stay monotone, nothing is
        # overwritten
        start = 0 if resumed is None else resumed
        uid = int(coord.restored_extra.get("next_uid", 0))
        if resumed is not None:
            print(f"[vc-serve] resumed server v{coord.state.version} "
                  f"from checkpoint step {resumed} "
                  f"(continuing at round {start}, uid {uid})")
        # the aggregation tier: each edge aggregator speaks the same
        # protocol downward (to its clients) and upward (to the hub), over
        # its OWN process transport
        aggs = []
        for a in range(args.tier):
            at = stack.enter_context(ProcessTransport())
            aggs.append(Aggregator(scheme, coord, agg_id=a, transport=at,
                                   timeout_s=args.timeout_s,
                                   handout_dtype=args.handout_dtype))
        transports = [transport] + [a.transport for a in aggs]
        # read-only subscribers: served from the hub's frame cache, every
        # frame crossing the SAME broker process the lease traffic uses
        service = (HandoutService(coord, transport=transport)
                   if args.subscribers > 0 else None)
        out = ServeRun(coord=coord, aggs=aggs, service=service, start=start,
                       next_uid=uid, ckpt_dir=ckpt_dir)
        print(f"[vc-serve] scheme={scheme.name} clients={args.clients} "
              f"shards={args.shards} broker pid={transport.broker_pid} "
              f"(frames cross a real process boundary)"
              + (f" tier={len(aggs)} aggregators, broker pids "
                 f"{[a.transport.broker_pid for a in aggs]}" if aggs
                 else ""))
        # handout prefetch: one worker thread issues the NEXT lease
        # (handout encode + broker round-trips) while the CURRENT client
        # trains and submits.  Every handout in a round reads the same
        # server state (the fold happens only after the round's last
        # submit).  submit(cid) writes its own lease, the residual ledger
        # and the transport; issue(cid + 1) touches neither of the first
        # two, and the transport's lock serialises its socket and stats
        # (the lease registry is a dict both use by their own keys), so
        # uids, seeds, frames and bytes are those of the serial order.
        # The pipeline stops at the round boundary: round R+1's first
        # handout reads round R's assimilated params.
        pool = stack.enter_context(ThreadPoolExecutor(max_workers=1))
        for rnd in range(start, start + args.rounds):
            t0 = time.perf_counter()
            rpc0 = sum(t.rpc_s for t in transports)
            tm = dict.fromkeys(("train", "submit", "fold", "ckpt", "eval",
                                "serve"), 0.0)
            for agg in aggs:
                agg.open_window(round=rnd, now=time.monotonic())

            def _issue(cid: int, u: int):
                # the runtime's "store head" is the live state; the
                # handout crosses the broker as per-shard frames.  In
                # tier mode the client leases from ITS aggregator, whose
                # window state is the decoded hub handout.
                srv = aggs[cid % len(aggs)] if aggs else coord
                lease = srv.issue(cid=cid, uid=u, round=rnd, shard=cid,
                                  read_version=srv.state.version,
                                  base=srv.state.params,
                                  now=time.monotonic())
                return srv, lease

            leases = []
            nxt = pool.submit(_issue, 0, uid)
            for cid in range(args.clients):
                srv, lease = nxt.result()
                if cid + 1 < args.clients:
                    # encode the next handout while THIS client trains
                    nxt = pool.submit(_issue, cid + 1, uid + cid + 1)
                # client-side REAL training from the DECODED handout
                ts = time.perf_counter()
                trained = task.client_train(
                    lease.base, x_train, y_train, steps=STEPS,
                    seed=args.seed * 1000003 + lease.uid)
                tm["train"] += time.perf_counter() - ts
                ts = time.perf_counter()
                srv.submit(lease, trained)
                tm["submit"] += time.perf_counter() - ts
                leases.append((srv, lease))
            uid += args.clients
            ts = time.perf_counter()
            # one straggler per round is "preempted" mid-upload: its lease
            # is dropped, its bytes wasted — assimilation shrugs it off
            if args.clients > 1 and rnd % 2 == 1:
                srv, lease = leases.pop()
                srv.drop(lease)
            for srv, lease in leases:
                payload = srv.deliver(lease)
                srv.assimilate(lease, payload,
                               server_version=srv.state.version,
                               t_arrival=time.monotonic())
            # tier flush: each aggregator ships ONE merged v3 frame (its
            # fold state + summed client weight) upstream; the hub adopts
            # it via assimilate_aggregate
            for agg in aggs:
                up = agg.flush(now=time.monotonic())
                if up is not None:
                    coord.assimilate(up, coord.deliver(up),
                                     server_version=coord.state.version,
                                     t_arrival=time.monotonic())
                agg.expire(time.monotonic())
            coord.expire(time.monotonic())
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tm["fold"] = time.perf_counter() - ts
            ts = time.perf_counter()
            coord.save_checkpoint(mgr, step=rnd + 1,
                                  extra={"next_uid": uid})
            tm["ckpt"] = time.perf_counter() - ts
            ts = time.perf_counter()
            acc = task.evaluate(as_tree(coord.state.params), x_val, y_val)
            tm["eval"] = time.perf_counter() - ts
            out.accuracy.append(acc)
            s = coord.wire_stats
            up_frames = coord.frames[wire.KIND_AGG]
            print(f"[vc-serve] round {rnd}: acc={acc:.3f} "
                  f"server v{coord.state.version} "
                  f"wire {s.bytes_sent / 1e6:.2f}MB sent "
                  f"(handout {coord.handout_bytes / 1e6:.2f}MB in "
                  f"{coord.handout_frames} frames, "
                  f"{s.frames_dropped} frames dropped) "
                  f"residual mass {coord.residual_mass():.2f} "
                  + (f"upstream agg frames {up_frames} " if aggs else "")
                  + f"[{time.perf_counter() - t0:.2f}s]", flush=True)
            # the read path: every subscriber pulls the round's model
            # through the content-addressed cache — cached frames cross
            # the REAL broker, but the encode happens at most once per
            # (round, chunk, content)
            if service is not None:
                ts = time.perf_counter()
                lat = []
                for sub in range(args.subscribers):
                    tp = time.monotonic()
                    service.pull(sub, coord.state.params, round=rnd)
                    lat.append(time.monotonic() - tp)
                lat.sort()
                p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                c = coord.handout_cache
                tm["serve"] = time.perf_counter() - ts
                print(f"[vc-serve] serve: round {rnd} "
                      f"{args.subscribers} subscribers "
                      f"{service.bytes_served / 1e6:.2f}MB served "
                      f"({c.encoded_bytes / 1e6:.2f}MB unique encoded, "
                      f"dedup {c.dedup_ratio:.1f}x) "
                      f"p99 {p99 * 1e3:.2f}ms", flush=True)
            tm["wall"] = time.perf_counter() - t0
            tm["rpc"] = sum(t.rpc_s for t in transports) - rpc0
            out.rounds.append(tm)
        s = coord.wire_stats
        _check(s.frames_sent == s.frames_recv + s.frames_dropped,
               f"hub frame conservation: {s.frames_sent} sent != "
               f"{s.frames_recv} recv + {s.frames_dropped} dropped")
        _check(coord.in_flight == 0,
               f"{coord.in_flight} hub leases still live at shutdown")
        _check(transport.in_flight == 0,
               f"{transport.in_flight} frames stranded in the hub broker")
        for agg in aggs:
            es = agg.wire_stats
            _check(es.frames_sent == es.frames_recv + es.frames_dropped,
                   f"agg {agg.agg_id} frame conservation violated")
            _check(agg.in_flight == 0 and not agg.window_open,
                   f"agg {agg.agg_id} still holds leases/window")
            _check(agg.transport.in_flight == 0,
                   f"frames stranded in agg {agg.agg_id}'s broker")
        out.next_uid = uid
        print(f"[vc-serve] done: {coord.assimilated} results assimilated, "
              f"{coord.dropped} dropped, next uid {uid}, "
              f"checkpoints in {ckpt_dir}", flush=True)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
