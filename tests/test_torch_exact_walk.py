"""B7's walk (``csrc/topk_mask.cu``, ``exact_kernel``) emulated in numpy on
a model of device memory, held bit for bit against the plain version
(``repro_torch.kernels.ref.threshold_sparsify_exact``), the JAX package's
``ref.threshold_sparsify_exact`` and its Pallas
``threshold_sparsify_exact`` (interpret mode).  No card is needed: the
kernel's walk is reproduced at the geometry it is built with (the tile
and its warps, read from the source):

* warp w of a tile owns the tile's w-th contiguous chunk; at step s lane
  l holds the float at chunk + 32 s + l, one 4-byte load (x may lie at
  any element offset), the reference's zero padding past n;
* a warp counts the ties of tau in its chunk (a popcount of each step's
  ballot) and publishes the count; after the tile's one barrier its
  first rank is ``tie_start[tile]`` plus the ties of the tile's earlier
  warps (the exclusive scan);
* each step ranks its ties by the running count plus the ties of lower
  lanes (the popcount of the step's ballot under the lane's mask), keeps
  ``|x| > tau`` and the ties ranked below the budget, and stores kept
  and the residual below n.

Every output element must be written exactly once and every load must
lie inside x.  The cases cut the budget at 0, at all the ties, inside a
warp, at a warp seam and at a tile seam, put ties in a ragged last tile,
take n < 32 and n mod 4 = 1-3, x at element offsets 1-3, tau = 0 (the
padding past n ties), a ``tie_start`` that is no true prefix of the
ties, and the path's bus (N(0, 0.02^2), a handful of ties: most warps
hold none).  The card tests (``tests/test_torch_kernels.py``) hold the
kernel itself to the plain version.

Tolerance: none (compares and one IEEE subtraction).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels import topk_mask as RT
from repro_torch.kernels import ref as R
from repro_torch.kernels import topk_mask as TK

F32 = np.float32
GRANULE = 256                  # the caching allocator's block alignment
CSRC = Path(TK.__file__).parent / "csrc"


def source_geometry() -> dict:
    """The tile and its threads as csrc/topk_mask.cu builds
    exact_kernel."""
    src = (CSRC / "topk_mask.cu").read_text()
    read = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                      src).group(1))
    block, threads = read("kBlock"), read("kTileThreads")
    warps = threads // 32
    return {"block": block, "warps": warps, "chunk": block // warps,
            "steps": block // warps // 32}


G = source_geometry()


class Memory:
    """x in device memory: an allocation at a GRANULE-aligned address with
    random bytes around it; every load is checked to lie inside x and to
    be aligned to its width."""

    def __init__(self, x: np.ndarray, offset: int, rng):
        size = -(-(4 * (offset + x.size)) // GRANULE) * GRANULE + GRANULE
        self.mem = rng.integers(0, 256, GRANULE + size, dtype=np.uint8)
        self.base = GRANULE + 4 * offset
        self.mem[self.base:self.base + 4 * x.size] = x.view(np.uint8)
        self.hi = self.base + 4 * x.size

    def f32(self, i: int) -> F32:
        addr = self.base + 4 * i
        assert addr % 4 == 0, f"a 4-byte load at {addr}"
        assert self.base <= addr and addr + 4 <= self.hi, "a load past x"
        return np.frombuffer(self.mem[addr:addr + 4].tobytes(), F32)[0]


def popc(word: int) -> int:
    return bin(word).count("1")


def ballot(pred: np.ndarray) -> int:
    """__ballot_sync over a warp's 32 lanes: bit l is lane l's pred."""
    return int((pred.astype(np.uint64) << np.arange(32, dtype=np.uint64))
               .sum())


def walk(x: np.ndarray, tau, tie_start, budget, x_off: int = 0,
         seed: int = 0):
    """(kept, residual, tie_free) as exact_kernel writes them with x
    placed ``x_off`` elements into its allocation; tie_free counts the
    warps whose chunk holds no tie of tau."""
    n = x.size
    mem = Memory(x, x_off, np.random.default_rng(seed))
    kept, res = np.zeros(n, F32), np.zeros(n, F32)
    writes = np.zeros(n, np.int64)
    tau, budget = F32(tau), int(budget)
    lanes = np.arange(32)
    tie_free = 0
    for tile in range(-(-n // G["block"])):
        # 1. every warp: its values and the ties of its chunk
        vals, warp_ties = [], []
        for w in range(G["warps"]):
            chunk = tile * G["block"] + w * G["chunk"]
            v = np.array([[mem.f32(chunk + 32 * s + l)
                           if chunk + 32 * s + l < n else F32(0.0)
                           for l in lanes] for s in range(G["steps"])], F32)
            ties = sum(popc(ballot(np.abs(v[s]) == tau))
                       for s in range(G["steps"]))
            vals.append((chunk, v))
            warp_ties.append(ties)
            tie_free += ties == 0
        # 2. the barrier, then each warp's ranked emit
        for w, (chunk, v) in enumerate(vals):
            rank0 = int(tie_start[tile]) + sum(warp_ties[:w])
            for s in range(G["steps"]):
                mag = np.abs(v[s])
                tie = mag == tau
                ball = ballot(tie)
                for l in lanes:
                    rank = rank0 + popc(ball & ((1 << int(l)) - 1))
                    keep = mag[l] > tau or (tie[l] and rank < budget)
                    k = v[s, l] if keep else F32(0.0)
                    i = chunk + 32 * s + l
                    if i < n:
                        kept[i], res[i] = k, F32(v[s, l] - k)
                        writes[i] += 1
                rank0 += popc(ball)
    assert (writes == 1).all()
    return kept, res, tie_free


# ---- the cases ----------------------------------------------------------------

def _quarters(n: int, seed: int) -> np.ndarray:
    """N(0, 1) rounded to quarters: a tenth of the elements share |x| = 1,
    in every warp."""
    x = np.random.default_rng(seed).standard_normal(n)
    return (np.round(4 * x) / 4).astype(F32)


def _prefix(x: np.ndarray, tau) -> np.ndarray:
    """Each tile's count of the ties of tau before it (the refinement's
    tie_start)."""
    nb = -(-x.size // G["block"])
    tie = np.zeros(nb * G["block"], bool)
    tie[:x.size] = np.abs(x) == F32(tau)
    per = tie.reshape(nb, -1).sum(axis=1)
    return (np.cumsum(per) - per).astype(np.int32)


def _cut(x: np.ndarray, tau, where: str) -> int:
    """A budget whose last kept tie and first dropped tie lie in one warp
    (``warp``), in two warps of one tile (``warp-seam``) or in two tiles
    (``tile-seam``)."""
    pos = np.flatnonzero(np.abs(x) == F32(tau))
    if where == "warp":
        w = pos // G["chunk"]
        b = int(np.flatnonzero((w[1:] == w[:-1]) & (w[1:] == w[len(w) // 2]))
                [1]) + 1
        assert pos[b - 1] // G["chunk"] == pos[b] // G["chunk"]
        return b
    size, at = ((G["chunk"], 3) if where == "warp-seam"
                else (G["block"], 1))
    b = int((pos < at * size).sum())
    assert pos[b - 1] // size != pos[b] // size
    if where == "warp-seam":
        assert pos[b - 1] // G["block"] == pos[b] // G["block"]
    return b


def _case(name: str):
    """(x, tau, tie_start, budget, x_off) of one case."""
    B = G["block"]
    if name.startswith("ties-"):
        x = _quarters(2 * B + 100, 1)
        tau = F32(1.0)
        total = int((np.abs(x) == tau).sum())
        budget = {"ties-budget-0": 0, "ties-budget-all": total}.get(name)
        if budget is None:
            budget = _cut(x, tau, name[len("ties-cut-"):])
        return x, tau, _prefix(x, tau), budget, 0
    if name == "ragged-last-tile":
        x = _quarters(2 * B + 777, 2)
        tau = F32(0.5)
        ts = _prefix(x, tau)
        return x, tau, ts, int(ts[-1]) + 20, 0
    if name.startswith("n-mod-4-"):
        x = _quarters(B + 4 * 37 + int(name[-1]), 3)
        x[-1] = x[-2] = x[-3] = F32(0.75)     # ties in the ragged tail
        tau = F32(0.75)
        return x, tau, _prefix(x, tau), int((np.abs(x) == tau).sum()) - 2, 0
    if name == "n-19":
        x = _quarters(19, 4)
        tau = F32(np.sort(np.abs(x))[-6])
        return x, tau, _prefix(x, tau), 1, 0
    if name.startswith("x-at-"):
        x = _quarters(B + 4 * 25 + 2, 5)
        tau = F32(0.25)
        return x, tau, _prefix(x, tau), _cut(x, tau, "warp"), int(name[-1])
    if name == "tau-zero":                      # the padding past n ties
        x = _quarters(B + 4095, 6)
        return x, F32(0.0), _prefix(x, 0.0), 300, 0
    if name == "tie-start-not-a-prefix":
        x = _quarters(3 * B, 7)
        tau = F32(1.0)
        ts = np.random.default_rng(8).integers(-500, 500, 3).astype(np.int32)
        return x, tau, ts, 150, 0
    # the path's bus: N(0, 0.02^2), tau its k-th magnitude, a handful of ties
    x = (0.02 * np.random.default_rng(9).standard_normal(2 * B + 300)
         ).astype(F32)
    x[[5, 8191, 9000, 16000]] = x[100]         # ties of tau in 2 tiles
    tau = F32(abs(x[100]))
    return x, tau, _prefix(x, tau), 2 if name == "path" else 0, 0


CASES = ["ties-budget-0", "ties-budget-all", "ties-cut-warp",
         "ties-cut-warp-seam", "ties-cut-tile-seam", "ragged-last-tile",
         "n-mod-4-1", "n-mod-4-2", "n-mod-4-3", "n-19", "x-at-1", "x-at-2",
         "x-at-3", "tau-zero", "tie-start-not-a-prefix", "path",
         "path-budget-0"]


def test_geometry_covers_the_tile():
    assert G["steps"] * 32 * G["warps"] == G["block"] == TK.BLOCK


def test_ballot_rank_is_the_exclusive_count():
    pred = np.random.default_rng(0).random(32) < 0.3
    ball = ballot(pred)
    assert [popc(ball & ((1 << l) - 1)) for l in range(32)] == \
        (np.cumsum(pred) - pred).tolist()


@pytest.mark.parametrize("name", CASES)
def test_exact_walk_equals_references(name):
    x, tau, ts, budget, off = _case(name)
    kept, res, tie_free = walk(x, tau, ts, budget, x_off=off)
    pk, pr = R.threshold_sparsify_exact(torch.from_numpy(x), float(tau),
                                        torch.from_numpy(ts), budget)
    assert kept.tobytes() == pk.numpy().tobytes()
    assert res.tobytes() == pr.numpy().tobytes()
    xj = jnp.asarray(x)
    for rk, rr in (JR.threshold_sparsify_exact(xj, tau, ts, budget),
                   RT.threshold_sparsify_exact(xj, tau, ts, budget,
                                               interpret=True)):
        assert kept.tobytes() == np.asarray(rk).tobytes()
        assert res.tobytes() == np.asarray(rr).tobytes()
    assert np.array_equal(kept + res, x)
    if name.startswith("path"):       # most warps hold no tie, some do
        assert 0 < tie_free < 3 * G["warps"]
    if name.startswith("ties-"):      # every warp holding x holds a tie
        assert tie_free == G["warps"] - 1
