"""Dataset contract.

Counterpart of ``theanompi_tpu/data/base.py``.  A dataset yields
*global* batches (size ``batch_size * n_workers``) as numpy arrays, in
an order that is a pure function of (seed, epoch).  The port runs one
process per card: rank ``r`` of ``W`` keeps rows ``[r*B/W, (r+1)*B/W)``
of every global batch (:meth:`Dataset.host_train_batches`), as a JAX
host of a multi-host mesh does, so the ranks together train on exactly
the batches a single process would.
"""

from __future__ import annotations

import abc
from typing import Iterator

import numpy as np

Batch = tuple[np.ndarray, np.ndarray]  # (images NHWC, integer labels)


class Dataset(abc.ABC):
    """Iterable source of global batches for one (model, run) pair."""

    #: per-sample shape, e.g. (224, 224, 3), NHWC
    sample_shape: tuple[int, ...]
    n_classes: int
    n_train: int
    n_val: int

    #: optional ``transform(x, rng, train) -> f32`` the model applies on
    #: the device (ops/augment.py); when set, the host iterators yield
    #: raw (e.g. uint8 store-size) images
    device_transform = None

    @abc.abstractmethod
    def train_batches(self, epoch: int, global_batch: int, rank: int = 0,
                      size: int = 1) -> Iterator[Batch]:
        """Shuffled, augmented global train batches for ``epoch``."""

    @abc.abstractmethod
    def val_batches(self, global_batch: int, rank: int = 0,
                    size: int = 1) -> Iterator[Batch]:
        """Validation batches in fixed order, no augmentation."""

    @staticmethod
    def _block_slice(batch: Batch, rank: int, size: int) -> Batch:
        x, y = batch
        if len(x) % size != 0:
            raise ValueError(
                f"global batch {len(x)} not divisible by {size} ranks")
        chunk = len(x) // size
        sl = slice(rank * chunk, (rank + 1) * chunk)
        return x[sl], y[sl]

    def host_train_batches(self, epoch: int, global_batch: int, rank: int,
                           size: int) -> Iterator[Batch]:
        """Rank ``rank``'s contiguous block of each global train batch."""
        for batch in self.train_batches(epoch, global_batch):
            yield self._block_slice(batch, rank, size)

    def host_val_batches(self, global_batch: int, rank: int,
                         size: int) -> Iterator[Batch]:
        for batch in self.val_batches(global_batch):
            yield self._block_slice(batch, rank, size)

    def n_train_batches_for(self, epoch: int, global_batch: int,
                            rank: int = 0, size: int = 1) -> int:
        """The exact number of batches ``train_batches(epoch,
        global_batch, rank, size)`` yields."""
        n_mine = (self.n_train - rank + size - 1) // size
        return n_mine // global_batch
