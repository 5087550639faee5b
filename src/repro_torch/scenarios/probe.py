"""Fleet-probe task (port of ``repro/scenarios/probe.py``): the cheapest
task that still drives the FULL protocol.

Fleet-scale simulations (10k-100k clients) measure the *system* — event
throughput, wire bytes, preemption churn, delta-handout behaviour — not
learning curves.  ``ProbeTask`` keeps the whole pipeline (flat bus,
leases, wire frames on both legs, scheme assimilation: B1 on the card)
while replacing the client's gradient computation with a deterministic
one-element nudge and the validation pass with a closed-form progress
proxy.  Every byte on the wire is still real.

The bus is ONE leaf and lives on the simulator's device (the card unless
the caller passes ``"cpu"``).  ``ProbeTask`` speaks the simulator's task
protocol, as ``MLPTask`` does (``client_train`` takes the flat lease base
and returns the trained buffer), and its buffers are bit-identical to the
reference's numpy bus:

* the nudge ``lr * sign * max(1, steps)`` is formed as a Python double,
  rounded once to f32 and added in f32 — numpy 2's rule (NEP 50) for a
  Python float added to a float32 element;
* ``evaluate`` copies the ``dim`` floats to the host (one sync) and
  takes ``np.linalg.norm`` in f32, as the reference does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.tasks import TaskData
from repro_torch.device import resolve_device


def make_probe_data(n_shards: int, seed: int = 0) -> TaskData:
    """One sample per shard: the simulator's shard slicing stays O(1) and
    the arrays stay tiny at 100k+ shards (the probe ignores the values)."""
    n = max(int(n_shards), 1)
    x = np.zeros((n, 1), np.float32)
    y = np.zeros((n,), np.int32)
    return TaskData(x_train=x, y_train=y, x_val=x[:1], y_val=y[:1])


def _nudge(dim: int, lr: float, steps: int, seed: int):
    """(slot, f32 nudge) of one client result: the seed Knuth-hashed into
    a slot and a sign."""
    h = (int(seed) * 2654435761) & 0xFFFFFFFF
    sign = 1.0 if (h >> 16) & 1 else -1.0
    return h % dim, float(np.float32(lr * sign * float(max(1, steps))))


def _progress(w: np.ndarray) -> float:
    return 1.0 - math.exp(-0.25 * float(np.linalg.norm(w)))


class ProbeTask:
    """Single-leaf surrogate task for fleet-scale simulator runs."""

    def __init__(self, dim: int = 256, lr: float = 0.05):
        self.dim = int(dim)
        self.lr = float(lr)
        self.batch = 1                        # simulator sizes steps off this

    def init_params(self, seed: int, device="cuda") -> dict:
        """Deterministic zero start (``seed`` unused)."""
        return {"w": torch.zeros((self.dim,), dtype=torch.float32,
                                 device=resolve_device(device))}

    def client_train(self, base: F.FlatParams, x, y, *, steps: int,
                     seed: int) -> torch.Tensor:
        """The trained bus: ``base``'s with one slot nudged."""
        buf = base.buf.clone()
        slot, d = _nudge(self.dim, self.lr, steps, seed)
        j = base.spec.offsets[0] + slot
        buf[j:j + 1].add_(d)
        return buf

    def evaluate(self, params: dict, x, y) -> float:
        return _progress(params["w"].detach().to("cpu").numpy())
