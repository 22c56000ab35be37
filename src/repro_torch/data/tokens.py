"""Synthetic LM token streams (the port of ``repro.data.tokens``, numpy
only): Zipfian unigram statistics with first-order Markov structure, so a
causal LM's loss is learnable.  Given a seed, the draws are those of the
reference bit for bit (the same ``numpy.random.Generator`` calls in the
same order)."""

from __future__ import annotations

import numpy as np

__all__ = ["TokenStream", "batches"]


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 32):
        self.vocab_size = int(vocab_size)
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks)
        self.unigram /= self.unigram.sum()
        # sparse Markov structure: each token can transition to `branch`
        # preferred successors (deterministic per seed)
        self.succ = self.rng.integers(0, self.vocab_size,
                                      size=(self.vocab_size, branch))

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens; each call continues the stream."""
        out = np.empty((batch, seq_len), dtype=np.int32)
        cur = self.rng.choice(self.vocab_size, size=batch, p=self.unigram)
        out[:, 0] = cur
        for t in range(1, seq_len):
            use_markov = self.rng.random(batch) < 0.8
            pick = self.succ[cur, self.rng.integers(0, self.succ.shape[1],
                                                    size=batch)]
            fresh = self.rng.choice(self.vocab_size, size=batch,
                                    p=self.unigram)
            cur = np.where(use_markov, pick, fresh).astype(np.int32)
            out[:, t] = cur
        return out


def batches(vocab_size: int, batch: int, seq_len: int, num_batches: int,
            seed: int = 0):
    """``num_batches`` dicts ``{"tokens": (batch, seq_len)}`` from one
    stream."""
    stream = TokenStream(vocab_size, seed)
    for _ in range(num_batches):
        yield {"tokens": stream.sample(batch, seq_len)}
