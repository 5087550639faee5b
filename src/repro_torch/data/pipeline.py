"""Synthetic token streams (port of ``repro/data/pipeline.py``, the tokens
branch).  The source is numpy in both packages, so the tokens are
bit-identical to the reference's for the same vocabulary and seed."""
from __future__ import annotations

from typing import Dict

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


def make_batch_for(cfg: ModelConfig, batch: int, seq_len: int,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """One model-ready batch: ``{"tokens": int32 [batch, seq_len]}`` on the
    CPU (the caller moves it).  Only token inputs are ported: a config
    with an encoder or a vision stub raises."""
    if cfg.encoder is not None or cfg.vision is not None:
        raise NotImplementedError(
            f"{cfg.arch}: encoder and vision inputs are not ported "
            f"(ROADMAP.md queue A item 11)")
    src = SyntheticTokenSource(cfg.vocab_size, seed)
    return {"tokens": torch.from_numpy(src.sample(batch, seq_len))}
