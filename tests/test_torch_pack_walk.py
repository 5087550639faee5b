"""B12's word-wide pack (``csrc/sparse_pack.cu``) emulated in numpy on a
model of device memory, held byte for byte against the plain version
(``repro_torch.kernels.ref.pack_body``) and, through it, the JAX
package's ``sparse_pack.pack_body`` in interpret mode.  No card is
needed: the kernel's word walk — which output word takes which aligned
source words and which byte shift, which words take the byte-by-byte path
— is reproduced step for step, so every k mod 4 (the shift of the scales
and index sections), every ng mod 4, and q at byte offsets 0-3 are
checked here, and the card tests (``tests/test_torch_kernels.py``) hold
the kernel itself to the same plain version.

Each source lies in its own allocation of a 256-byte-granular memory
model, filled with random bytes around it: an aligned 4-byte word read
must hold at least one byte of its source (so it never leaves the
source's aligned granule), and a byte taken from outside the source
would show in the output.

Tolerance: none (byte copies).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sparse_pack as RS
from repro_torch.kernels import ref as R

GRANULE = 256                  # the caching allocator's block alignment


class Memory:
    """Device memory as one byte array: allocations at GRANULE-aligned
    addresses, random bytes everywhere else."""

    def __init__(self, rng):
        self.rng = rng
        self.mem = rng.integers(0, 256, GRANULE, dtype=np.uint8)

    def place(self, data: np.ndarray, offset: int = 0) -> int:
        """Put ``data`` at ``offset`` bytes into a fresh allocation;
        returns its address."""
        size = -(-(offset + data.size) // GRANULE) * GRANULE + GRANULE
        base = self.mem.size
        self.mem = np.concatenate(
            [self.mem, self.rng.integers(0, 256, size, dtype=np.uint8)])
        self.mem[base + offset:base + offset + data.size] = data
        return base + offset

    def words(self, addr: np.ndarray) -> np.ndarray:
        """The aligned 4-byte words at ``addr`` (each a multiple of 4),
        little-endian."""
        assert not (addr % 4).any()
        b = self.mem[addr[:, None] + np.arange(4)].astype(np.uint32)
        return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24


def funnelshift_r(lo, hi, sh):
    """``__funnelshift_r(lo, hi, sh)``: the low 32 bits of hi:lo >> sh."""
    both = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    return (both >> sh.astype(np.uint64)).astype(np.uint32)


def word_walk(mem: Memory, q_at: int, s_at: int, i_at: int, k: int,
              ng: int):
    """The body B12 writes, word by word as its threads do, and the
    number of words that took the byte-by-byte path."""
    idx_at, total = k + 4 * ng, 5 * k + 4 * ng
    words = -(-total // 16)
    lo = 16 * np.arange(words, dtype=np.int64)
    hi = lo + 16
    out = np.zeros(16 * words, np.uint8)
    sections = [(hi <= k, q_at, 0, k),                              # q
                ((lo >= k) & (hi <= idx_at), s_at, k, 4 * ng),      # scales
                ((lo >= idx_at) & (hi <= total), i_at, idx_at, 4 * k)]
    wide = np.zeros(words, bool)
    for sel, src, start, size in sections:
        t = np.nonzero(sel)[0]
        wide[t] = True
        p = src + (lo[t] - start)                     # the word's 16 bytes
        a = p & ~np.int64(3)
        sh = (8 * (p & 3)).astype(np.uint32)
        x = [mem.words(a + 4 * j) for j in range(4)]
        shifted = sh != 0
        x4 = np.zeros_like(x[0])
        x4[shifted] = mem.words(a[shifted] + 16)
        x.append(x4)
        # every aligned word read holds a byte of the source
        for j in range(5):
            read = shifted if j == 4 else np.ones_like(shifted)
            w0 = a[read] + 4 * j
            assert ((w0 < src + size) & (w0 + 4 > src)).all()
        word = np.stack([np.where(shifted, funnelshift_r(x[j], x[j + 1], sh),
                                  x[j]) for j in range(4)], axis=1)
        out.reshape(words, 16)[t] = word.astype("<u4").view(np.uint8)

    def body_byte(i):
        if i < k:
            return mem.mem[q_at + i]
        if i < idx_at:
            return mem.mem[s_at + i - k]
        return mem.mem[i_at + i - idx_at]

    narrow = np.nonzero(~wide)[0]
    for t in narrow:                        # seams and the last word's tail
        for i in range(16 * t, min(16 * t + 16, total)):
            out[i] = body_byte(i)
    return out[:total], len(narrow)


def _payload(k: int, ng: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, k, dtype=np.int8)
    s = (rng.random(ng, dtype=np.float32) * 0.01).astype(np.float32)
    idx = rng.integers(0, 2 ** 31 - 1, k, dtype=np.int32)
    return q, s, idx


def _walk(q, s, idx, q_off: int, seed: int):
    mem = Memory(np.random.default_rng(seed))
    q_at = mem.place(q.view(np.uint8), q_off)
    s_at = mem.place(s.view(np.uint8))
    i_at = mem.place(idx.view(np.uint8))
    return word_walk(mem, q_at, s_at, i_at, q.size, s.size)


def _check(k: int, ng: int):
    q, s, idx = _payload(k, ng, seed=1000 * k + ng)
    plain = R.pack_body(torch.from_numpy(q), torch.from_numpy(s),
                        torch.from_numpy(idx)).numpy()
    jax_body = np.asarray(RS.pack_body(jnp.asarray(q), jnp.asarray(s),
                                       jnp.asarray(idx)))
    assert plain.tobytes() == jax_body.tobytes()
    total = 5 * k + 4 * ng
    for q_off in range(4):
        body, narrow = _walk(q, s, idx, q_off, seed=k + q_off)
        assert body.tobytes() == plain.tobytes(), f"q at byte {q_off}"
        # at most one word a seam, and the tail
        assert narrow <= 2 + (total % 16 != 0)


@pytest.mark.parametrize("ng", [1, 2, 3, 4])
@pytest.mark.parametrize("k", range(1, 10))
def test_word_walk_small_bodies(k, ng):
    """k 1-9 and ng 1-4: every k and ng mod 4, seams sharing a word."""
    _check(k, ng)


@pytest.mark.parametrize("k", [655, 656, 657, 658, 659, 660, 1313, 4097,
                               105_075])
def test_word_walk_payload_sizes(k):
    """The port's payloads (k = 656 and 1,313 on the MLP's upload leg,
    105,075 on the bench bus) and their neighbours, ng = ceil(k / 256)."""
    _check(k, -(-k // 256))


def test_word_walk_reads_shifted_words_for_unaligned_seams():
    """At k = 657 (ng = 5) both sections after q start 1 byte past a
    4-byte word: their words take five aligned reads and a shift of 24
    bits, and each seam and the tail take the byte path."""
    k, ng = 657, 5
    q, s, idx = _payload(k, ng, seed=5)
    mem = Memory(np.random.default_rng(6))
    q_at, s_at, i_at = (mem.place(q.view(np.uint8)), mem.place(s.view(np.uint8)),
                        mem.place(idx.view(np.uint8)))
    for start, at in ((k, s_at), (k + 4 * ng, i_at)):
        first = -(-start // 16) * 16                  # first whole word
        p = at + first - start
        assert 8 * (p % 4) == 8 * ((-k) % 4) == 24
    body, narrow = word_walk(mem, q_at, s_at, i_at, k, ng)
    assert narrow == 3                 # both seams and the tail
    assert body.tobytes() == R.pack_body(torch.from_numpy(q),
                                         torch.from_numpy(s),
                                         torch.from_numpy(idx)).numpy().tobytes()
