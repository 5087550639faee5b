"""Work generator (§III-A): splits one DL training job into data-parallel
training subtasks (BOINC "workunits"), tracks epochs, and decides the split.

A subtask = (data shard, model + server parameter snapshot version, training
recipe).  An epoch completes when every subtask of that epoch has been
assimilated; the generator then emits the next epoch's subtasks (with the
current server parameter version) until the stop criterion is met.

``PendingQueue`` is the fleet-scale hot-path structure: the scheduler's
sticky-first pick used to ``sorted()`` the whole pending list per request
(O(P log P) per dispatch — quadratic over a run), which dominated the
per-event cost at 10k+ clients.  The queue keeps uid-ordered min-heaps
(global + per-shard, lazily invalidated) so one selection is
O(|cache| + log P) while returning EXACTLY the units the old
``sorted(key=(shard not in cache, uid))[:k]`` returned.

Copied unchanged from ``repro/core/work_generator.py`` (numpy and the standard library
only): the port keeps its own copy so that it never imports the
reference, and every numpy rng stream stays identical.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class WorkUnit:
    uid: int
    epoch: int
    shard: int                   # index into the dataset split
    param_version: int           # server version the client starts from
    replicas: int = 1            # computational redundancy (§II-C)
    deadline: float = math.inf   # absolute sim-time deadline (scheduler sets)
    local_steps: int = 1         # client-side passes over the shard


class PendingQueue:
    """Uid-ordered pending units with O(|cache| + log P) sticky-first picks.

    Invariant (relied on for bit-identity with the old list version): units
    are appended in strictly increasing uid order (``_emit_epoch`` and
    ``requeue`` both mint fresh, monotone uids), so "list order" and "uid
    order" coincide and a lazy min-heap reproduces the old stable sort.
    Heap entries are invalidated lazily: a uid is live iff it is still in
    ``_units`` (uids are never reused across assignments)."""

    __slots__ = ("_units", "_all", "_by_shard")

    def __init__(self) -> None:
        self._units: Dict[int, WorkUnit] = {}     # uid -> unit (uid order)
        self._all: List[int] = []                 # uid min-heap (lazy)
        self._by_shard: Dict[int, List[int]] = {} # shard -> uid heap (lazy)

    def append(self, unit: WorkUnit) -> None:
        self._units[unit.uid] = unit
        heapq.heappush(self._all, unit.uid)
        heapq.heappush(self._by_shard.setdefault(unit.shard, []), unit.uid)

    def remove(self, unit: WorkUnit) -> None:
        del self._units[unit.uid]                 # heaps clean up lazily

    def __len__(self) -> int:
        return len(self._units)

    def __bool__(self) -> bool:
        return bool(self._units)

    def __iter__(self):
        return iter(self._units.values())

    def _peek(self, heap: List[int]) -> Optional[int]:
        while heap and heap[0] not in self._units:
            heapq.heappop(heap)
        return heap[0] if heap else None

    def peek_shard(self, shard: int) -> Optional[int]:
        """Smallest pending uid carrying ``shard`` (None if none)."""
        heap = self._by_shard.get(shard)
        if heap is None:
            return None
        uid = self._peek(heap)
        if uid is None:
            del self._by_shard[shard]             # keep the index bounded
        return uid

    def select(self, cache: Iterable[int], k: int) -> List[WorkUnit]:
        """Pop up to ``k`` units, sticky-first: units whose shard is in
        ``cache`` (snapshot at call entry — exactly like the old one-shot
        sort key) ordered by uid, then the rest by uid."""
        out: List[WorkUnit] = []
        if k <= 0 or not self._units:
            return out
        cache0 = tuple(cache)                     # stickiness snapshot
        while len(out) < k and self._units:
            best: Optional[int] = None
            for s in cache0:
                uid = self.peek_shard(s)
                if uid is not None and (best is None or uid < best):
                    best = uid
            if best is None:
                # no sticky unit pending -> global min is non-sticky
                best = self._peek(self._all)
                if best is None:
                    break
            out.append(self._units.pop(best))
        return out

    def prune_stale_epochs(self, epoch: int) -> None:
        """Drop every pending unit not belonging to ``epoch`` (leftover
        replicas of a finished epoch)."""
        stale = [uid for uid, u in self._units.items() if u.epoch != epoch]
        for uid in stale:
            del self._units[uid]


@dataclass
class Split:
    n_shards: int
    shard_index: np.ndarray      # [n_samples] -> shard id
    shard_sizes: np.ndarray      # [n_shards]


def split_dataset(n_samples: int, n_shards: int, *, seed: int = 0,
                  shuffle: bool = True) -> Split:
    """Deterministic near-even split; shuffled so shards are iid (the paper
    splits CIFAR10's 50k train rows into 50 shards of 1000)."""
    idx = np.arange(n_samples)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(n_samples)
    shard_of = np.zeros(n_samples, np.int32)
    bounds = np.linspace(0, n_samples, n_shards + 1).astype(int)
    for s in range(n_shards):
        shard_of[idx[bounds[s]:bounds[s + 1]]] = s
    sizes = np.bincount(shard_of, minlength=n_shards)
    return Split(n_shards, shard_of, sizes)


def auto_split(n_samples: int, n_clients: int, tasks_per_client: int,
               min_shard: int = 64) -> int:
    """The paper's "best possible split" heuristic (§III-A): enough subtasks
    to keep every client slot busy ~2 rounds per epoch, but never shards so
    small that the client step is dominated by transfer overhead."""
    want = max(n_clients * tasks_per_client * 2, 1)
    cap = max(n_samples // min_shard, 1)
    return int(min(want, cap))


class WorkGenerator:
    """Epoch bookkeeping over subtasks.  The scheduler pulls from
    ``pending``; the parameter server calls ``complete(uid)`` after
    assimilation.  ``next_epoch`` rolls the epoch when all shards of the
    current epoch are assimilated."""

    def __init__(self, n_shards: int, *, replicas: int = 1,
                 local_steps: int = 1, max_epochs: int = 10 ** 6):
        self.n_shards = n_shards
        self.replicas = replicas
        self.local_steps = local_steps
        self.max_epochs = max_epochs
        self.epoch = 1
        self._uid = 0
        self.pending = PendingQueue()
        self.done_shards: set[int] = set()
        self.completed_units: Dict[int, WorkUnit] = {}
        self._emit_epoch()

    def _emit_epoch(self) -> None:
        for s in range(self.n_shards):
            for _ in range(self.replicas):
                self.pending.append(WorkUnit(
                    uid=self._uid, epoch=self.epoch, shard=s,
                    param_version=-1, replicas=self.replicas,
                    local_steps=self.local_steps))
                self._uid += 1

    def complete(self, unit: WorkUnit) -> bool:
        """Mark a shard's result assimilated. Returns True if this completed
        the epoch (and the next epoch was emitted)."""
        self.completed_units[unit.uid] = unit
        if unit.epoch != self.epoch:
            return False                   # stale replica of an old epoch
        self.done_shards.add(unit.shard)
        if len(self.done_shards) == self.n_shards:
            self.epoch += 1
            self.done_shards = set()
            # drop leftover replicas of the finished epoch
            self.pending.prune_stale_epochs(self.epoch)
            if self.epoch <= self.max_epochs:
                self._emit_epoch()
            return True
        return False

    def requeue(self, unit: WorkUnit) -> None:
        """Timeout reassignment (§III-B): the shard goes back to pending
        unless the epoch already finished without it (replica quorum)."""
        if unit.epoch == self.epoch and unit.shard not in self.done_shards:
            self.pending.append(WorkUnit(
                uid=self._uid, epoch=unit.epoch, shard=unit.shard,
                param_version=-1, replicas=unit.replicas,
                local_steps=unit.local_steps))
            self._uid += 1

    @property
    def exhausted(self) -> bool:
        return self.epoch > self.max_epochs
