"""LM token pipeline — synthetic corpus with learnable structure (a numpy
copy of the JAX package's ``repro.data.lm``: its batches are bitwise the
reference's).

Offline container: no real corpora. The stream is a mixture of (a) a Markov
chain over the vocab (learnable bigram structure so loss visibly drops) and
(b) repeated n-gram motifs (copy structure for attention). Deterministic per
(seed, step), sharded by data-parallel rank: rank r of R draws the batch rows
[r·B/R, (r+1)·B/R) — restart-safe because batches are a pure function of the
step index (no pipeline state in checkpoints).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, n_states: int = 257):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_states = min(n_states, vocab_size)
        root = np.random.default_rng(seed)
        # sparse-ish bigram transition over a state subset of the vocab
        self._next = root.integers(0, self.n_states,
                                   size=(self.n_states, 4)).astype(np.int64)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) of shape (batch, seq_len); labels = next token."""
        rng = np.random.default_rng((self.seed, step))
        b, t = self.batch, self.seq_len
        seq = np.zeros((b, t + 1), np.int64)
        seq[:, 0] = rng.integers(0, self.n_states, b)
        branch = rng.integers(0, 4, (b, t))
        noise = rng.random((b, t)) < 0.05
        noise_tok = rng.integers(0, self.vocab_size, (b, t))
        for i in range(t):
            nxt = self._next[np.minimum(seq[:, i], self.n_states - 1),
                             branch[:, i]]
            seq[:, i + 1] = np.where(noise[:, i], noise_tok[:, i], nxt)
        return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)

    def shard_at(self, step: int, rank: int, world: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        toks, labs = self.batch_at(step)
        per = self.batch // world
        sl = slice(rank * per, (rank + 1) * per)
        return toks[sl], labs[sl]


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    pipe = TokenPipeline(vocab_size, batch, seq_len, seed)
    step = 0
    while True:
        yield pipe.batch_at(step)
        step += 1
