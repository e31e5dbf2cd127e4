"""Synthetic language-modeling dataset for the transformer LM.

Counterpart of ``theanompi_tpu/data/lm.py`` (numpy only, so the same
seed gives the same bytes in both packages): sequences follow a fixed
random successor table (``next = table[tok]`` with probability
``1 - noise``, else uniform), so a causal LM can drive its loss toward
the table's conditional entropy.  Deterministic per (seed, epoch).

Yields ``(tokens, targets)`` of shape (B, seq_len) int32, ``targets`` the
one-step shift of the same underlying sequence.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from theanompi_tpu_torch.data.base import Batch, Dataset


class SeqLM_data(Dataset):
    def __init__(self, vocab: int = 256, seq_len: int = 128,
                 n_train: int = 4096, n_val: int = 512, seed: int = 0,
                 noise: float = 0.1):
        self.n_classes = vocab
        self.vocab = vocab
        self.seq_len = seq_len
        self.sample_shape = (seq_len,)
        self.n_train = n_train
        self.n_val = n_val
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.table = rng.permutation(vocab).astype(np.int32)

    def _gen(self, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        seq = np.empty((n, self.seq_len + 1), np.int32)
        seq[:, 0] = rng.integers(0, self.vocab, n)
        for t in range(1, self.seq_len + 1):
            follow = rng.random(n) >= self.noise
            rand = rng.integers(0, self.vocab, n)
            seq[:, t] = np.where(follow, self.table[seq[:, t - 1]], rand)
        return seq[:, :-1], seq[:, 1:]

    def train_batches(self, epoch: int, global_batch: int,
                      rank: int = 0, size: int = 1) -> Iterator[Batch]:
        n = self.n_train_batches_for(epoch, global_batch, rank, size)
        for i in range(n):
            # a pure function of (seed, epoch, i, rank), as in the JAX
            # package
            ss = np.random.SeedSequence([self.seed, epoch, i, rank])
            yield self._gen(global_batch, int(ss.generate_state(1)[0]))

    def val_batches(self, global_batch: int,
                    rank: int = 0, size: int = 1) -> Iterator[Batch]:
        for i in range(self.n_val // global_batch):
            yield self._gen(global_batch, self.seed + 10**9 + i)
