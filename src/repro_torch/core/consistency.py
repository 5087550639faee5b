"""Parameter stores with strong vs eventual consistency (§III-D, §IV-D).

The paper stores the whole parameter set as one value in Redis (eventual,
main-memory) and compares against MySQL LONGBLOB (strong).  Measured
per-update latencies: 0.87 s (Redis) vs 1.29 s (MySQL) — strong consistency
serializes concurrent parameter-server transactions; eventual consistency
lets them proceed concurrently and occasionally loses an update
(last-writer-wins clobbers a racing commit), which SGD-family training
tolerates (Downpour/Adam/Petuum evidence cited in the paper).

Semantics here are faithful:

* ``EventualStore`` — a parameter server reads a snapshot when it starts
  processing; its later write clobbers any commit that landed in between
  (those updates are LOST — really lost: future reads never see them).
  Writes never queue.
* ``StrongStore`` — serializable read-modify-write: the transaction takes a
  global lock, so the base of every update is the latest head and nothing
  is ever lost — but commits queue behind each other (1.29 s each).

Copied unchanged from ``repro/core/consistency.py`` (numpy and the standard library
only): the port keeps its own copy so that it never imports the
reference, and every numpy rng stream stays identical.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

# measured per-update transaction latencies from §IV-D
REDIS_UPDATE_S = 0.87
MYSQL_UPDATE_S = 1.29


@dataclass
class StoreStats:
    updates: int = 0
    lost_updates: int = 0
    total_latency_s: float = 0.0
    queue_wait_s: float = 0.0


class EventualStore:
    """Last-writer-wins with snapshot reads (Redis analog)."""

    def __init__(self, params: Any, update_latency_s: float = REDIS_UPDATE_S,
                 history: int = 64):
        self._hist: List[Tuple[float, Any]] = [(-1e18, params)]
        self._times: List[float] = [-1e18]      # parallel commit times
        self._hist_cap = history
        self.update_latency_s = update_latency_s
        self.stats = StoreStats()
        self.version = 0

    def read_at(self, t: float) -> Tuple[Any, int]:
        """Snapshot: the latest value committed at or before t (bisect
        over the parallel times list; the oldest retained entry when
        everything is newer — same as the old linear scan)."""
        i = bisect_right(self._times, t) - 1
        return self._hist[max(i, 0)][1], self.version

    def head(self) -> Any:
        return self._hist[-1][1]

    def commit(self, t_read: float, t_ready: float, new_params: Any
               ) -> float:
        """Write computed from a snapshot taken at t_read; lands at
        t_ready + latency.  Commits in (t_read, t_write) are clobbered."""
        t_write = t_ready + self.update_latency_s
        lost = sum(1 for tc, _ in self._hist if t_read < tc < t_write)
        self.stats.lost_updates += lost
        # drop clobbered entries: future reads must never see them
        self._hist = [(tc, p) for tc, p in self._hist if tc <= t_read]
        self._hist.append((t_write, new_params))
        self._hist = self._hist[-self._hist_cap:]
        self._times = [tc for tc, _ in self._hist]
        self.version += 1
        self.stats.updates += 1
        self.stats.total_latency_s += self.update_latency_s
        return t_write


class StrongStore:
    """Serializable transactions (MySQL analog): read-modify-write under a
    global lock; base is always the head; commits queue."""

    def __init__(self, params: Any, update_latency_s: float = MYSQL_UPDATE_S):
        self._params = params
        self.update_latency_s = update_latency_s
        self.stats = StoreStats()
        self.version = 0
        self._busy_until = -1e18

    def transact(self, t_ready: float, update_fn: Callable[[Any], Any]
                 ) -> float:
        """Acquire the lock at max(t_ready, busy), apply update_fn to the
        head, release after the transaction latency."""
        t_start = max(t_ready, self._busy_until)
        self.stats.queue_wait_s += t_start - t_ready
        self._params = update_fn(self._params)
        t_done = t_start + self.update_latency_s
        self._busy_until = t_done
        self.version += 1
        self.stats.updates += 1
        self.stats.total_latency_s += t_done - t_ready
        return t_done

    def head(self) -> Any:
        return self._params

    def read_at(self, t: float) -> Tuple[Any, int]:
        return self._params, self.version
