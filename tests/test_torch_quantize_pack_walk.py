"""B11's warp-a-group walk (``csrc/sparse_pack.cu``,
``quantize_pack_kernel``) emulated in numpy on a model of device memory,
held byte for byte against the plain version
(``repro_torch.kernels.ref.quantize_pack``), the JAX package's
``ref.quantize_pack`` and ``pack_body(quantize_int8(sel))`` (both
packages').  No card is
needed: the kernel's walk — warp w quantizing group w (a lane's 8 values,
the group's max|x|, its 8 q bytes as one store to q and one to the body,
the lane across k storing only its q bytes, lane 0 the scale and its 4
bytes), and the same warp's 64 16-byte words of the index section (B12's
aligned 4-byte loads joined across the section's shift k mod 4, the word
holding the section's first byte and the body's last word storing only
their index bytes) — is reproduced at the geometry the kernel is built
with (groups a block, index words a lane: read from the source), for the
wire's block of 256 (the template instance) and a generic block.  Every
body byte must be written exactly once, and every aligned word read must
hold a byte of the index array.  The card tests
(``tests/test_torch_kernels.py``) hold the kernel itself to the plain
version.

The JAX package's Pallas ``quantize_pack`` (interpret mode) is held to
the walk too: q bytes equal, the body equal outside its scale section,
and the scales within one f32 ulp.  Its scale is max|x| / 127 as XLA
computes it on the CPU, which is not always the IEEE quotient the
reference's ``ref.quantize_pack`` (and the port, and this walk) take: at
k = 1,000 and 4,096 one scale differs by an ulp
(``tests/test_torch_plain_kernels.py`` holds the plain version to it the
same way).

Tolerance: none (IEEE division, round half to even, byte copies).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels import sparse_pack as RS
from repro_torch.kernels import ref as R
from repro_torch.kernels import sparse_pack as SK

F32 = np.float32
GRANULE = 256                  # the caching allocator's block alignment
CSRC = Path(SK.__file__).parent / "csrc"


def source_geometry() -> dict:
    """kGroupWarps (groups a block) and kIdxWords (index words a lane) as
    csrc/sparse_pack.cu builds them."""
    src = (CSRC / "sparse_pack.cu").read_text()
    return {key: int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
            for key, name in (("warps", "kGroupWarps"),
                              ("idx_words", "kIdxWords"))}


GEOMETRY = source_geometry()


class Memory:
    """Device memory as one byte array: allocations at GRANULE-aligned
    addresses, random bytes everywhere else."""

    def __init__(self, rng):
        self.rng = rng
        self.mem = rng.integers(0, 256, GRANULE, dtype=np.uint8)

    def place(self, data: np.ndarray, offset: int = 0) -> int:
        size = -(-(offset + data.size) // GRANULE) * GRANULE + GRANULE
        base = self.mem.size
        self.mem = np.concatenate(
            [self.mem, self.rng.integers(0, 256, size, dtype=np.uint8)])
        self.mem[base + offset:base + offset + data.size] = data
        return base + offset

    def u32(self, addr: int) -> int:
        assert addr % 4 == 0
        return int.from_bytes(self.mem[addr:addr + 4].tobytes(), "little")


class Body:
    """An output buffer that counts the writes to each byte."""

    def __init__(self, n: int):
        self.data = np.zeros(n, np.uint8)
        self.writes = np.zeros(n, np.int64)

    def store(self, at: int, data: bytes, align: int) -> None:
        assert at % align == 0, f"a {align}-byte store at byte {at}"
        self.data[at:at + len(data)] = np.frombuffer(data, np.uint8)
        self.writes[at:at + len(data)] += 1


def load_words(mem: Memory, p: int, lo: int, hi: int) -> bytes:
    """B12's load_words + join: the 16 bytes at p from the aligned 4-byte
    words at p & ~3 (a fifth when p & 3), each read holding a byte of the
    source [lo, hi)."""
    a, sh = p & ~3, 8 * (p & 3)
    n = 5 if sh else 4
    words = [mem.u32(a + 4 * j) for j in range(n)]
    for j in range(n):
        assert a + 4 * j < hi and a + 4 * j + 4 > lo, "a read past idx"
    if sh:
        words = [((words[j] | words[j + 1] << 32) >> sh) & 0xFFFFFFFF
                 for j in range(4)]
    return b"".join(w.to_bytes(4, "little") for w in words[:4])


def quant_bytes(x: np.ndarray, s) -> np.ndarray:
    """clip(rint(x / s), -127, 127) as int8 (IEEE f32 division)."""
    r = np.rint((x.astype(F32) / F32(s)).astype(F32))
    return np.clip(r, -127, 127).astype(np.int8)


def scale_of(x: np.ndarray):
    m = np.abs(x.astype(F32)).max() if x.size else F32(0)
    return max(F32(F32(m) / F32(127.0)), F32(1e-12))


def walk(sel: np.ndarray, idx: np.ndarray, block: int = 256, sel_off=0,
         idx_off=0, seed=0):
    """(body, q, scales) as quantize_pack_kernel writes them, with sel and
    idx placed ``sel_off`` / ``idx_off`` elements into their
    allocations."""
    mem = Memory(np.random.default_rng(seed))
    sel_at = mem.place(sel.view(np.uint8), 4 * sel_off)
    idx_at = mem.place(idx.view(np.uint8), 4 * idx_off)
    k = sel.size
    ng = -(-k // block)
    at, total = k + 4 * ng, 5 * k + 4 * ng
    per_warp = 32 * GEOMETRY["idx_words"]
    idx_words = -(-total // 16) - at // 16
    warps = max(ng, -(-idx_words // per_warp))
    blocks = -(-warps // GEOMETRY["warps"])
    sel16 = sel_at % 16 == 0
    body, q = Body(total), Body(ng * block)
    scales = np.zeros(ng, F32)

    def sel_value(i):
        if i >= k:
            return F32(0.0)        # the reference's zero padding
        return np.frombuffer(mem.mem[sel_at + 4 * i:sel_at + 4 * i + 4]
                             .tobytes(), F32)[0]

    def put_scale(g, s):
        scales[g] = s
        raw = np.asarray(s, F32).tobytes()
        if k % 4 == 0:
            body.store(k + 4 * g, raw, 4)
        else:
            for b in range(4):
                body.store(k + 4 * g + b, raw[b:b + 1], 1)

    for w in range(blocks * GEOMETRY["warps"]):
        if w >= warps:
            continue                            # the whole warp returns
        # the index section's words of this warp
        for lane in range(32):
            for j in range(GEOMETRY["idx_words"]):
                t = at // 16 + w * per_warp + 32 * j + lane
                lo = 16 * t
                if lo >= at and lo + 16 <= total:
                    body.store(lo, load_words(mem, idx_at + lo - at, idx_at,
                                              idx_at + 4 * k), 16)
                elif lo < total:
                    for b in range(16):
                        if at <= lo + b < total:
                            src = idx_at + lo + b - at
                            body.store(lo + b, mem.mem[src:src + 1]
                                       .tobytes(), 1)
        if w >= ng:
            continue
        g = w
        if block == 256:
            x = np.array([sel_value(g * block + i) for i in range(block)],
                         F32)
            # the 16-byte loads (sel16, whole lanes) and the value loads
            # read the same values
            assert sel16 or sel_at % 4 == 0
            s = scale_of(x)                      # 5 xor shuffles of max
            qb = quant_bytes(x, s)
            for lane in range(32):
                i0 = g * block + 8 * lane
                v = qb[8 * lane:8 * lane + 8].tobytes()
                q.store(i0, v, 8)
                if i0 + 8 <= k:
                    body.store(i0, v, 8)
                else:                            # the lane across k
                    for j in range(max(0, k - i0)):
                        body.store(i0 + j, v[j:j + 1], 1)
        else:
            x = np.array([sel_value(g * block + i) for i in range(block)],
                         F32)
            s = scale_of(x)
            qb = quant_bytes(x, s)
            for i in range(block):
                q.store(g * block + i, qb[i:i + 1].tobytes(), 1)
                if g * block + i < k:
                    body.store(g * block + i, qb[i:i + 1].tobytes(), 1)
        put_scale(g, s)
    assert (body.writes == 1).all(), "a body byte not written exactly once"
    assert (q.writes == 1).all(), "a q byte not written exactly once"
    return body.data, q.data.view(np.int8), scales


def payload(k: int, seed: int):
    rng = np.random.default_rng(seed)
    sel = (rng.standard_normal(k) * 0.01).astype(F32)
    sel[k // 3] = 0.0
    if k > 600:
        sel[256:512] = 0.0                     # an all-zero group
    idx = rng.integers(0, 2 ** 31 - 1, k).astype(np.int32)
    return sel, idx


def check(sel, idx, block=256, **at):
    body, q, scales = walk(sel, idx, block, **at)
    tb, tq, ts = (x.numpy() for x in R.quantize_pack(
        torch.from_numpy(sel), torch.from_numpy(idx), block))
    assert body.tobytes() == tb.tobytes()
    assert q.tobytes() == tq.tobytes()
    assert scales.tobytes() == ts.tobytes()
    jq, js = JR.quantize_int8(jnp.asarray(sel), block)
    jb = JR.pack_body(jq, js, jnp.asarray(idx))
    assert body.tobytes() == np.asarray(jb).tobytes()
    rb, rq, rs = (np.asarray(x) for x in JR.quantize_pack(
        jnp.asarray(sel), jnp.asarray(idx), block))
    assert (body.tobytes(), q.tobytes(), scales.tobytes()) == (
        rb.tobytes(), rq.reshape(-1).tobytes(), rs.tobytes())
    q9, s9 = R.quantize_int8(torch.from_numpy(sel), block)
    assert body.tobytes() == R.pack_body(q9, s9, torch.from_numpy(idx)
                                         ).numpy().tobytes()
    return body, q, scales


def test_geometry_is_read_from_the_source():
    assert GEOMETRY == {"warps": 8, "idx_words": 2}


@pytest.mark.parametrize("k", [4096 + r for r in range(16)])
def test_walk_every_k_mod_16(k):
    """Every k mod 16: the value section's last lane, the scale section's
    shift and the index section's shift and seams."""
    sel, idx = payload(k, seed=k)
    check(sel, idx)


@pytest.mark.parametrize("k", range(1, 16))
def test_walk_k_below_16(k):
    """One group, one body word or two: the seams share words."""
    sel, idx = payload(k, seed=k)
    check(sel, idx)


@pytest.mark.parametrize("k", [257, 300, 511, 512, 600, 767, 768])
def test_walk_fewer_than_four_groups(k):
    """ng 2-3: the scale section is shorter than a body word."""
    sel, idx = payload(k, seed=k)
    check(sel, idx)


@pytest.mark.parametrize("sel_off,idx_off", [(1, 0), (2, 3), (3, 1)])
@pytest.mark.parametrize("k", [1000, 1313])
def test_walk_sel_and_idx_off_16_byte_boundaries(k, sel_off, idx_off):
    """sel not 16-byte aligned takes the value-by-value loads; idx at any
    4-byte boundary: the same bytes."""
    sel, idx = payload(k, seed=k + sel_off)
    check(sel, idx, sel_off=sel_off, idx_off=idx_off)


@pytest.mark.parametrize("block,k", [(100, 1000), (100, 7), (64, 333),
                                     (512, 1100)])
def test_walk_generic_block(block, k):
    """The generic instance (any block but 256): byte stores, the same
    index words."""
    sel, idx = payload(k, seed=block + k)
    check(sel, idx, block)


def test_walk_rounds_half_to_even_and_zero_groups():
    """max|x| = 127 gives the scale 1 exactly, so x = n + 1/2 lies on a
    tie: q rounds to the even neighbour.  An all-zero group takes the
    scale 1e-12 and q = 0."""
    k = 700
    sel = np.zeros(k, F32)
    sel[0] = 127.0
    halves = np.arange(-126, 126) + 0.5
    sel[1:1 + halves.size] = halves
    sel[600] = 1e-3                           # group 2: 600-699, mostly 0
    idx = np.arange(k, dtype=np.int32) * 7
    body, q, scales = check(sel, idx)
    assert scales[0] == 1.0 and scales[1] == F32(1e-12)
    want = np.rint(halves).astype(np.int8)    # half to even
    assert np.array_equal(q[1:1 + halves.size], want)
    assert (q[256:512] == 0).all()


@pytest.mark.parametrize("k", [1, 255, 656, 1000, 1313, 4096, 4100])
def test_walk_matches_the_jax_pallas_kernel(k):
    """The JAX package's Pallas quantize_pack in interpret mode: q equal,
    the body equal outside the scale section, the scales within one ulp
    (see the module note)."""
    sel, idx = payload(k, seed=k)
    body, q, scales = walk(sel, idx)
    jb, jq, js = (np.asarray(x) for x in RS.quantize_pack(
        jnp.asarray(sel), jnp.asarray(idx), interpret=True))
    ng = scales.size
    assert q.tobytes() == jq.reshape(-1).tobytes()
    outside = np.ones(body.size, bool)
    outside[k:k + 4 * ng] = False
    assert np.array_equal(body[outside], jb[outside])
    ulps = np.abs(scales.view(np.int32).astype(np.int64)
                  - js.view(np.int32)).max()
    assert ulps <= 1
