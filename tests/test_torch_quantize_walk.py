"""B9's warp-a-group walk (``csrc/quantize.cu``, ``quantize_kernel``, with
the per-group part in ``csrc/quant_group.cuh``) emulated in numpy on a
model of device memory, held bit for bit against the plain version
(``repro_torch.kernels.ref.quantize_int8``) and the JAX package's
``ref.quantize_int8``.  No card is needed: the kernel's walk — warp w of
the grid quantizing group w (the warps past the last group returning),
at the wire's block of 256 a lane's 8 values as two 16-byte loads where x
is 16-byte aligned and the 8 lie below k, else value by value with the
zero padding past k, the group's max|x|, the lane's 8 q bytes as one
8-byte store (the lane across k storing only its bytes below k), lane 0
the scale; at any other block (the generic instance) a value a lane — is
reproduced at the geometry the kernel is built with (groups a block, read
from the source).  Every q byte and scale must be written exactly once,
every store must be aligned to its width, and every load must lie inside
x.  The card tests (``tests/test_torch_kernels.py``) hold the kernel
itself to the plain version.

The JAX package's Pallas ``quantize_int8`` (interpret mode, block 256
only) is held to the walk too: q equal, and the scales within one f32
ulp.  Its scale is max|x| / 127 as XLA computes it on the CPU, which is
not always the IEEE quotient the references (and the port, and this
walk) take (ROADMAP queue C; ``tests/test_torch_quantize_pack_walk.py``
holds B11 the same way).

``ops.blocked_topk_stats`` (B6's route on the CPU) is held to the JAX
package's oracle with ``lo`` as a number and as an int32 [1] tensor, the
two forms its wrapper takes.

Tolerance: none (IEEE division, round half to even, integer compares).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as RQ
from repro.kernels import ref as JR
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as QK
from repro_torch.kernels import ref as R

F32 = np.float32
GRANULE = 256                  # the caching allocator's block alignment
CSRC = Path(QK.__file__).parent / "csrc"


def source_geometry() -> dict:
    """kQuantWarps (groups a block) as csrc/quantize.cu builds it, and the
    values a lane of quant_group.cuh's 256-value walk."""
    src = (CSRC / "quantize.cu").read_text()
    walk = (CSRC / "quant_group.cuh").read_text()
    return {"warps": int(re.search(r"constexpr int kQuantWarps = (\d+);",
                                   src).group(1)),
            "lane_values": int(re.search(r"float v\[(\d+)\]\) \{",
                                         walk).group(1))}


GEOMETRY = source_geometry()


class Memory:
    """Device memory as one byte array: allocations at GRANULE-aligned
    addresses, random bytes everywhere else; every load is checked to lie
    inside [lo, hi) and to be aligned to its width."""

    def __init__(self, rng):
        self.rng = rng
        self.mem = rng.integers(0, 256, GRANULE, dtype=np.uint8)
        self.lo = self.hi = 0

    def place(self, data: np.ndarray, offset: int = 0) -> int:
        size = -(-(offset + data.size) // GRANULE) * GRANULE + GRANULE
        base = self.mem.size
        self.mem = np.concatenate(
            [self.mem, self.rng.integers(0, 256, size, dtype=np.uint8)])
        self.mem[base + offset:base + offset + data.size] = data
        self.lo, self.hi = base + offset, base + offset + data.size
        return base + offset

    def f32(self, addr: int, count: int) -> np.ndarray:
        width = 4 * count
        assert addr % width == 0, f"a {width}-byte load at {addr}"
        assert self.lo <= addr and addr + width <= self.hi, "a load past x"
        return np.frombuffer(self.mem[addr:addr + width].tobytes(), F32)


class Out:
    """An output buffer (a fresh allocation: GRANULE-aligned) that counts
    the writes to each byte."""

    def __init__(self, n: int, dtype):
        self.data = np.zeros(n, dtype)
        self.writes = np.zeros(n, np.int64)

    def store(self, i: int, values: np.ndarray) -> None:
        width = values.size * values.itemsize
        assert (i * self.data.itemsize) % width == 0, \
            f"a {width}-byte store at element {i}"
        self.data[i:i + values.size] = values
        self.writes[i:i + values.size] += 1


def quant_bytes(x: np.ndarray, s) -> np.ndarray:
    """clip(rint(x / s), -127, 127) as int8 (IEEE f32 division)."""
    r = np.rint((x.astype(F32) / F32(s)).astype(F32))
    return np.clip(r, -127, 127).astype(np.int8)


def scale_of(m):
    """max(m / 127, 1e-12) in f32, m the group's max|x|."""
    return max(F32(F32(m) / F32(127.0)), F32(1e-12))


def walk(x: np.ndarray, block: int = 256, x_off: int = 0, seed: int = 0):
    """(q, scales) as quantize_kernel writes them, with x placed ``x_off``
    elements into its allocation."""
    mem = Memory(np.random.default_rng(seed))
    x_at = mem.place(x.view(np.uint8), 4 * x_off)
    k = x.size
    ng = -(-k // block)
    warps = GEOMETRY["warps"]
    lane_n = GEOMETRY["lane_values"]
    blocks = -(-ng // warps)
    x16 = x_at % 16 == 0
    q, scales = Out(k, np.int8), Out(ng, F32)
    for g in range(blocks * warps):
        if g >= ng:
            continue                             # the whole warp returns
        if block == 256:
            lanes = []
            for lane in range(32):
                i0 = g * block + lane_n * lane
                if x16 and i0 + lane_n <= k:     # two 16-byte loads
                    v = np.concatenate([mem.f32(x_at + 4 * i0, 4),
                                        mem.f32(x_at + 4 * i0 + 16, 4)])
                else:                            # value by value, 0 past k
                    v = np.array([mem.f32(x_at + 4 * (i0 + j), 1)[0]
                                  if i0 + j < k else F32(0.0)
                                  for j in range(lane_n)], F32)
                lanes.append(v)
            s = scale_of(max(np.abs(v).max() for v in lanes))  # 5 shuffles
            for lane, v in enumerate(lanes):
                i0 = g * block + lane_n * lane
                qb = quant_bytes(v, s)
                if i0 + lane_n <= k:
                    q.store(i0, qb)              # one 8-byte store
                else:                            # the lane across k
                    for j in range(max(0, k - i0)):
                        q.store(i0 + j, qb[j:j + 1])
        else:
            lo = g * block
            vals = {j: mem.f32(x_at + 4 * (lo + j), 1)[0]
                    for j in range(block) if lo + j < k}
            s = scale_of(max((abs(v) for v in vals.values()),
                             default=F32(0.0)))
            for j, v in vals.items():            # lane j % 32, byte stores
                q.store(lo + j, quant_bytes(np.array([v], F32), s))
        scales.store(g, np.array([s], F32))     # lane 0
    assert (q.writes == 1).all(), "a q byte not written exactly once"
    assert (scales.writes == 1).all(), "a scale not written exactly once"
    return q.data, scales.data


def values(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(k) * 0.01).astype(F32)
    x[k // 3] = 0.0
    if k > 600:
        x[256:512] = 0.0                         # an all-zero group
    return x


def check(x, block=256, **at):
    q, scales = walk(x, block, **at)
    tq, ts = (t.numpy() for t in R.quantize_int8(torch.from_numpy(x), block))
    assert q.tobytes() == tq.tobytes() and scales.tobytes() == ts.tobytes()
    jq, js = (np.asarray(t) for t in JR.quantize_int8(jnp.asarray(x), block))
    assert q.tobytes() == jq.tobytes() and scales.tobytes() == js.tobytes()
    return q, scales


def test_geometry_is_read_from_the_source():
    assert GEOMETRY == {"warps": 8, "lane_values": 8}


@pytest.mark.parametrize("block", [256, 100, 64])
@pytest.mark.parametrize("x_off", range(4))
@pytest.mark.parametrize("k", [4096 + r for r in range(16)])
def test_walk_every_k_mod_16(k, x_off, block):
    """Every k mod 16 (the last lane's bytes below k), x at element
    offsets 0-3 from a 16-byte boundary (1-3: the value loads), the
    wire's block and two generic ones."""
    check(values(k, seed=k + x_off), block, x_off=x_off)


@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 15, 255, 256, 257, 656, 1313])
def test_walk_small_and_upload_leg_payloads(k):
    """One lane or one group, a group and one value, and the MLP's upload
    leg at densities 0.05 and 0.1."""
    check(values(k, seed=k))


@pytest.mark.parametrize("block,k", [(1, 5), (3, 100), (31, 1000),
                                     (33, 1000), (512, 1100)])
def test_walk_generic_block_sizes(block, k):
    """Groups shorter than a warp, not a multiple of 32, longer than 256."""
    check(values(k, seed=block + k), block, x_off=block % 4)


def test_walk_rounds_half_to_even_and_zero_groups():
    """max|x| = 127 gives the scale 1 exactly, so x = n + 1/2 lies on a
    tie: q rounds to the even neighbour.  An all-zero group takes the
    scale 1e-12 and q = 0."""
    k = 700
    x = np.zeros(k, F32)
    x[0] = 127.0
    halves = np.arange(-126, 126) + 0.5
    x[1:1 + halves.size] = halves
    x[600] = 1e-3                               # group 2: 600-699, mostly 0
    for x_off in (0, 1):
        q, scales = check(x, x_off=x_off)
        assert scales[0] == 1.0 and scales[1] == F32(1e-12)
        assert np.array_equal(q[1:1 + halves.size],
                              np.rint(halves).astype(np.int8))
        assert (q[256:512] == 0).all()


@pytest.mark.parametrize("k", [1, 255, 656, 1313] + [4096 + r
                                                       for r in range(16)])
def test_walk_matches_the_jax_pallas_kernel(k):
    """The JAX package's Pallas quantize_int8 in interpret mode: q equal,
    the scales within one ulp (see the module note)."""
    x = values(k, seed=k)
    q, scales = walk(x)
    jq, js = (np.asarray(t) for t in RQ.quantize_int8(jnp.asarray(x),
                                                      interpret=True))
    assert q.tobytes() == jq.tobytes()
    ulps = np.abs(scales.view(np.int32).astype(np.int64)
                  - js.view(np.int32)).max()
    assert ulps <= 1


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("n,frac", [(8192, 0.05), (3 * 8192 + 100, 0.2),
                                    (100, 0.5)])
def test_ops_topk_stats_lo_as_int_and_tensor(n, frac, as_tensor):
    """B6's CPU route with ``lo`` as a number and as an int32 [1] tensor,
    each equal to the JAX package's oracle."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 0.02).astype(F32)
    x[::17] = -x[::17]
    mags = np.sort(np.abs(x).view(np.uint32))
    lo = int(mags[int(n * (1 - frac))])
    arg = torch.tensor([lo], dtype=torch.int32) if as_tensor else lo
    words, counts = ops.blocked_topk_stats(torch.from_numpy(x), arg)
    jw, jc = (np.asarray(t) for t in JR.blocked_topk_stats(jnp.asarray(x),
                                                            lo))
    assert words.numpy().view(np.uint32).tobytes() == jw.tobytes()
    assert np.array_equal(counts.numpy(), jc)
    assert int(counts.sum()) == int((np.abs(x).view(np.uint32) >= lo).sum())
