"""B10's word walk (``csrc/quantize.cu``, ``dequantize_kernel``) emulated
in numpy on a model of device memory, held bit for bit against the plain
version (``repro_torch.kernels.ref.dequantize_int8``) and, through it,
the JAX package's ``quantize.dequantize_int8`` in interpret mode.  No
card is needed: the kernel's walk — the head of values before q's first
4-byte boundary, the whole 4-byte words after it (one aligned load each,
kDeqWords a thread a block's width apart; one scale or, where a word
straddles two groups, two), the tail, and which words store a float4
and which store value by value — is reproduced for q at every byte
offset 0-15 from a 16-byte boundary and every k mod 16, and for the
generic instance's runtime block sizes.  The card tests
(``tests/test_torch_kernels.py``) hold the kernel itself to the same
plain version.

q lies in its own allocation of a 256-byte-granular memory model, random
bytes around it: a word's aligned 4-byte load must hold only q's bytes,
and a byte taken from outside q would show in the output.

Tolerance: none (one IEEE product a value).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as RQ
from repro_torch.kernels import ref as R

GRANULE = 256                  # the caching allocator's block alignment
QBLOCK = 256                   # the wire's group (the fixed instance)


def place(rng, q: np.ndarray, offset: int):
    """q's bytes ``offset`` bytes into a fresh GRANULE-aligned allocation
    of random bytes; returns (memory, q's address)."""
    size = -(-(offset + q.size) // GRANULE) * GRANULE + GRANULE
    mem = rng.integers(0, 256, GRANULE + size, dtype=np.uint8)
    at = GRANULE + offset
    mem[at:at + q.size] = q.view(np.uint8)
    return mem, at


THREADS, WORDS = 64, 4          # kStreamThreads, kDeqWords


def word_walk(mem: np.ndarray, q_at: int, scales: np.ndarray, k: int,
              block: int):
    """out f32 [k] as the kernel writes it, the number of words, and how
    many of them stored value by value."""
    out = np.full(k, np.nan, np.float32)
    written = np.zeros(k, np.int64)
    head = min(k, (4 - q_at % 4) % 4)
    nword = (k - head) // 4
    f32 = np.float32
    blocks = max(1, -(-nword // (WORDS * THREADS)))
    seen = np.zeros(nword, np.int64)
    for b in range(blocks):
        for tid in range(THREADS):
            for u in range(WORDS):
                w = b * WORDS * THREADS + u * THREADS + tid
                if w >= nword:
                    continue
                seen[w] += 1
                i0 = head + 4 * w
                a = q_at + i0
                assert a % 4 == 0 and q_at <= a and a + 4 <= q_at + k
                qv = mem[a:a + 4].view(np.int8)          # one aligned load
                if block == QBLOCK:
                    g0, g1 = i0 >> 8, (i0 + 3) >> 8
                    s0 = scales[g0]
                    s1 = scales[g1] if g1 != g0 else s0
                    nb = (g0 + 1) * QBLOCK - i0
                    sv = [s0 if e < nb else s1 for e in range(4)]
                else:
                    g = i0 // block
                    rem = i0 - g * block
                    s = scales[g]
                    sv = []
                    for _ in range(4):
                        if rem == block:
                            rem = 0
                            g += 1
                            s = scales[g]
                        sv.append(s)
                        rem += 1
                out[i0:i0 + 4] = qv.astype(f32) * np.asarray(sv, f32)
                written[i0:i0 + 4] += 1
    assert (seen == 1).all()                      # every word once
    tail0 = head + 4 * nword
    for i in list(range(head)) + list(range(tail0, k)):   # block 0's threads
        out[i] = f32(mem[q_at + i:q_at + i + 1].view(np.int8)[0]) \
            * scales[i // block]
        written[i] += 1
    assert (written == 1).all()                   # every value once
    assert head <= 3 and k - tail0 <= 3
    return out, nword, (nword if head else 0)


def _payload(k: int, block: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, k, dtype=np.int8)
    s = (rng.random(-(-k // block)) * 0.01).astype(np.float32)
    return q, s


@functools.lru_cache(maxsize=None)
def _plain(k: int, block: int):
    q, s = _payload(k, block, seed=k * 7 + block)
    plain = R.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s), k,
                              block).numpy()
    if block == QBLOCK:
        ref = np.asarray(RQ.dequantize_int8(jnp.asarray(q), jnp.asarray(s), k))
        assert ref.tobytes() == plain.tobytes()
    return q, s, plain


@pytest.mark.parametrize("off", range(16))
@pytest.mark.parametrize("k", list(range(1, 33)) + [255, 256, 257, 656, 1313,
                                                    4097, 70_001])
def test_word_walk_every_offset_bit_exact(k, off):
    """The wire's block (256): k 1-32 (every k mod 16, heads that take
    the whole payload) and the port's payload sizes, q at every byte
    offset from a 16-byte boundary."""
    q, s, plain = _plain(k, QBLOCK)
    mem, at = place(np.random.default_rng(k + off), q, off)
    out, _, _ = word_walk(mem, at, s, k, QBLOCK)
    assert out.tobytes() == plain.tobytes()


@pytest.mark.parametrize("off", [0, 3, 8])
@pytest.mark.parametrize("block", [1, 3, 16, 100, 255, 512])
def test_word_walk_generic_block_bit_exact(block, off):
    """The generic instance: groups shorter than a word, groups that do
    not divide it, a group longer than the wire's."""
    k = 1000
    q, s, plain = _plain(k, block)
    mem, at = place(np.random.default_rng(block + off), q, off)
    out, _, _ = word_walk(mem, at, s, k, block)
    assert out.tobytes() == plain.tobytes()


def test_unaligned_words_straddle_groups_and_store_by_value():
    """q 5 bytes past a 16-byte boundary at k = 656: the head is 3 values,
    so the word over values 255-258 holds the end of group 0 and the
    start of group 1 (two scales), and every word's outputs start 3 floats
    past a 16-byte boundary (stored value by value); aligned, none of
    that.  The payload's 163 or 164 words fit one block."""
    k = 656
    q, s, plain = _plain(k, QBLOCK)
    mem, at = place(np.random.default_rng(1), q, 5)
    out, nword, by_value = word_walk(mem, at, s, k, QBLOCK)
    head = (4 - at % 4) % 4
    assert head == 3 and nword == (k - head) // 4 == 163
    straddle = [w for w in range(nword)
                if (head + 4 * w) >> 8 != (head + 4 * w + 3) >> 8]
    assert straddle and by_value == nword
    assert out.tobytes() == plain.tobytes()
    mem, at = place(np.random.default_rng(2), q, 0)
    out, nword, by_value = word_walk(mem, at, s, k, QBLOCK)
    assert nword == 164 <= WORDS * THREADS and by_value == 0
    assert out.tobytes() == plain.tobytes()
