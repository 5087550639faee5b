"""BOINC-style scheduler (§II-C, §III-B): timeout reassignment, reliability
tracking, sticky-file shard affinity, per-client concurrency caps (Tn).

Hot-path note: the simulator calls ``expire_timeouts``/``next_deadline`` on
every event pop, so both are O(1) when nothing is due — a lazy min-heap of
``(deadline, seq, uid)`` replaces the old full scans of ``inflight``.  Heap
entries are validated by uid liveness (uids are never reused and a unit's
deadline never changes after assignment).  Expired hits are replayed in
assignment order (``seq``), which is exactly the old dict-insertion-order
iteration, so requeue ordering — and therefore every downstream trace — is
bit-identical.

Copied unchanged from ``repro/core/scheduler.py`` (numpy and the standard library
only): the port keeps its own copy so that it never imports the
reference, and every numpy rng stream stays identical.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.core.work_generator import WorkGenerator, WorkUnit


@dataclass
class Assignment:
    unit: WorkUnit
    cid: int
    t_assigned: float
    deadline: float
    seq: int = 0                 # assignment order (monotone)


class Scheduler:
    """Tracks in-flight workunits; the simulator drives it with events.

    * ``timeout_s``: if a result is not back in time, the unit is requeued
      (the paper's configurable time limit).
    * reliability: EMA of per-client success; unreliable clients are given
      work last (the paper: "assign subtasks to more reliable clients").
    * sticky affinity: prefer giving a client shards whose files it already
      holds (BOINC sticky files -> no re-download).
    """

    def __init__(self, gen: WorkGenerator, *, timeout_s: float = 1800.0,
                 tasks_per_client: int = 2, reliability_decay: float = 0.8):
        self.gen = gen
        self.timeout_s = timeout_s
        self.tasks_per_client = tasks_per_client
        self.rel_decay = reliability_decay
        self.inflight: Dict[int, Assignment] = {}      # uid -> assignment
        self.client_load: Dict[int, int] = {}
        self.client_rel: Dict[int, float] = {}
        self.client_cache: Dict[int, Set[int]] = {}    # cid -> cached shards
        self.reassignments = 0
        self.results_ok = 0
        self._seq = 0                                  # assignment counter
        self._dl_heap: List = []                       # (deadline, seq, uid)
        self._cid_uids: Dict[int, Dict[int, None]] = {}  # cid -> live uids

    # -- assignment ----------------------------------------------------------
    def request_work(self, cid: int, now: float) -> List[WorkUnit]:
        """Client asks for work (BOINC pull model). Returns <= free-slot units,
        sticky-affine first."""
        free = self.tasks_per_client - self.client_load.get(cid, 0)
        out: List[WorkUnit] = []
        if free <= 0 or not self.gen.pending:
            return out
        cache = self.client_cache.setdefault(cid, set())
        for unit in self.gen.pending.select(cache, free):
            unit.deadline = now + self.timeout_s
            self._seq += 1
            self.inflight[unit.uid] = Assignment(unit, cid, now, unit.deadline,
                                                 seq=self._seq)
            heapq.heappush(self._dl_heap, (unit.deadline, self._seq, unit.uid))
            self._cid_uids.setdefault(cid, {})[unit.uid] = None
            self.client_load[cid] = self.client_load.get(cid, 0) + 1
            cache.add(unit.shard)
            out.append(unit)
        return out

    def _drop(self, asg: Assignment) -> None:
        del self.inflight[asg.unit.uid]
        cid_map = self._cid_uids.get(asg.cid)
        if cid_map is not None:
            cid_map.pop(asg.unit.uid, None)

    # -- result & failure paths ----------------------------------------------
    def complete(self, uid: int, now: float) -> Optional[WorkUnit]:
        asg = self.inflight.get(uid)
        if asg is None:
            return None                                 # already timed out
        self._drop(asg)
        self.client_load[asg.cid] -= 1
        r = self.client_rel.get(asg.cid, 1.0)
        self.client_rel[asg.cid] = self.rel_decay * r + (1 - self.rel_decay)
        self.results_ok += 1
        return asg.unit

    def fail_client(self, cid: int, now: float) -> List[WorkUnit]:
        """Preemption/crash: every unit on that client is requeued now."""
        uids = list(self._cid_uids.get(cid, ()))        # assignment order
        lost = [self.inflight[uid] for uid in uids]
        for a in lost:
            self._drop(a)
            self.gen.requeue(a.unit)
            self.reassignments += 1
        self.client_load[cid] = 0
        r = self.client_rel.get(cid, 1.0)
        self.client_rel[cid] = self.rel_decay * r       # decay toward 0
        return [a.unit for a in lost]

    def expire_timeouts(self, now: float) -> List[WorkUnit]:
        """Requeue every in-flight unit past its deadline (§III-B)."""
        heap = self._dl_heap
        if not heap or heap[0][0] > now:
            # O(1) fast path unless the root is stale; pop stale roots so
            # the heap stays honest for next_deadline()
            while heap and heap[0][2] not in self.inflight:
                heapq.heappop(heap)
                if heap and heap[0][0] <= now:
                    break
            if not heap or heap[0][0] > now:
                return []
        hits: List[Assignment] = []
        while heap and heap[0][0] <= now:
            _, _, uid = heapq.heappop(heap)
            asg = self.inflight.get(uid)
            if asg is not None:
                hits.append(asg)
        hits.sort(key=lambda a: a.seq)                  # old insertion order
        for a in hits:
            self._drop(a)
            self.client_load[a.cid] = max(0, self.client_load[a.cid] - 1)
            r = self.client_rel.get(a.cid, 1.0)
            self.client_rel[a.cid] = self.rel_decay * r
            self.gen.requeue(a.unit)
            self.reassignments += 1
        return [a.unit for a in hits]

    def next_deadline(self) -> float:
        heap = self._dl_heap
        while heap and heap[0][2] not in self.inflight:
            heapq.heappop(heap)
        return heap[0][0] if heap else math.inf
