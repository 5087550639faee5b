"""Synthetic token streams, the stub modalities' inputs and the work
generator's dataset split (port of ``repro/data/pipeline.py``), with host
prefetch.  The source is numpy in both packages, so the tokens and the
frame / patch embeddings are bit-identical to the reference's for the
same config, seed, shard and step.

The paper's work generator splits the training set into n_t subsets
(§III-A); ``ShardedTokenDataset`` is that split for LM training — each
subtask (island round) draws only from its own shard.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


class SyntheticTokenSource:
    """Deterministic, seekable synthetic corpus: a mixture of Zipfian
    unigrams and an order-2 Markov chain."""

    def __init__(self, vocab_size: int, seed: int = 0, order_dim: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        self._mix = rng.integers(1, self.vocab, size=(order_dim,))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._probs = p / p.sum()

    def sample(self, n_seqs: int, seq_len: int, offset: int = 0) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + offset)
        base = rng.choice(self.vocab, size=(n_seqs, seq_len), p=self._probs)
        # inject structure: token[t] correlates with token[t-1]
        mix = self._mix[base[:, :-1] % len(self._mix)]
        coin = rng.random((n_seqs, seq_len - 1)) < 0.35
        base[:, 1:] = np.where(coin, (base[:, :-1] + mix) % self.vocab,
                               base[:, 1:])
        return base.astype(np.int32)


@dataclass
class ShardedTokenDataset:
    """The work-generator split: n_shards disjoint sequence ranges."""
    source: SyntheticTokenSource
    n_shards: int
    seqs_per_shard: int
    seq_len: int

    def shard_batch(self, shard: int, batch: int, step: int) -> np.ndarray:
        """Deterministic int32 [batch, seq_len] batch from one shard (a
        client subtask's step), the reference's draw."""
        return self.source.sample(batch, self.seq_len,
                                  offset=shard * 10_000_019 + step)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """A float64 array rounded to bf16 as the reference's
    ``jnp.asarray(a, jnp.bfloat16)`` rounds it: through f32 (ml_dtypes
    casts a double to float, then to bf16, each to nearest even)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def make_batch_for(cfg: ModelConfig, batch: int, seq_len: int,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """One model-ready batch on the CPU (the caller moves it), the
    reference's draws: ``tokens`` int32 [batch, seq_len]; with an encoder
    also ``frame_embeds`` bf16 [batch, n_frames, d_enc], with a vision
    stub ``patch_embeds`` bf16 [batch, n_patches, vit_dim] and the tokens
    ``seq_len - n_patches`` long (the patches come first), both from
    ``np.random.default_rng(seed + 1)``."""
    src = SyntheticTokenSource(cfg.vocab_size, seed)
    out: Dict[str, torch.Tensor] = {}
    if cfg.encoder is not None:
        rng = np.random.default_rng(seed + 1)
        out["frame_embeds"] = _bf16(rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_model)))
    elif cfg.vision is not None:
        rng = np.random.default_rng(seed + 1)
        out["patch_embeds"] = _bf16(rng.standard_normal(
            (batch, cfg.vision.n_patches, cfg.vision.vit_dim)))
        seq_len -= cfg.vision.n_patches
    out["tokens"] = torch.from_numpy(src.sample(batch, seq_len))
    return out


def subtask_batches(cfg: ModelConfig, ds: ShardedTokenDataset, shard: int,
                    batch: int, n_steps: int
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches for one training subtask (the client's local steps):
    ``{"tokens": int32 [batch, seq_len]}`` on the CPU."""
    for step in range(n_steps):
        yield {"tokens": torch.from_numpy(ds.shard_batch(shard, batch, step))}


class Prefetcher:
    """Host-side double buffering: one producer thread fills a bounded
    queue from ``it`` while the caller computes.  Iterate it to the end
    (the thread ends with the source); an exception in the source is
    raised to the caller at the item where it happened."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def run():
            try:
                for item in it:
                    self._q.put((True, item))
            except Exception as e:          # handed to the consumer
                self._q.put((False, e))
            self._q.put((True, self._done))

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        ok, item = self._q.get()
        if not ok:
            raise item
        if item is self._done:
            self._t.join()
            raise StopIteration
        return item
