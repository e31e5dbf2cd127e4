"""Random-access epoch order over an ImageNet shard tree (copy of
``theanompi_tpu/ingest/order.py``).

The in-process loader (``data/imagenet.py _file_batches``) streams an
epoch: shard files arrive in the epoch's seeded order, one in-file
permutation is drawn per file from the sequential shuffle stream, and
batches are assembled across file boundaries with carried tails.  A
standalone reader cannot stream — trainers pull *batch index b* from
whichever reader owns it — so this module re-expresses the same epoch
as a random-access pure function:

* the epoch's file order, per-file permutations, and running sample
  offsets are derived once per (epoch, rank, size) from the SAME
  helpers the in-process loader uses (``epoch_file_order`` /
  ``shuffle_rng`` — data/imagenet.py), so both paths compute one
  global permutation from (seed, epoch) with zero coordination;
* batch ``b`` of global size ``B`` is the slice ``[b*B, (b+1)*B)`` of
  the concatenated permuted sample sequence, gathered straight from
  the mmap shard files with one ``np.take`` per contributing shard —
  the single-gather path, byte-identical to the streaming
  assembler's output (pinned by tests/test_torch_ingest.py).

Shard files are opened lazily through ``_load_shard`` (the port's
memory-maps ``.x.npy`` pairs) and cached for the epoch, so serving a
contiguous batch range maps each file once.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np

from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.data.imagenet import (
    _load_shard,
    epoch_file_order,
    shuffle_rng,
)


class EpochOrder:
    """One (epoch, rank, size) view of the shard tree: sharded file
    order, per-file permutations, and random-access batch assembly.

    Construction draws every per-file permutation up front (the
    shuffle stream is sequential, so permutation ``i`` depends on the
    sizes of files ``0..i-1`` — sizes come from the manifest, not from
    opening the files).  ``assemble`` is then pure in (index,
    global_batch) and thread-safe: concurrent pulls share the mmap
    cache under a lock but gather outside it.
    """

    def __init__(self, files: Sequence[str], sizes: dict[str, int],
                 seed: int, epoch: int, rank: int = 0, size: int = 1):
        self.epoch = int(epoch)
        self.rank = int(rank)
        self.size = int(size)
        self.files = epoch_file_order(files, seed, epoch, rank, size)
        rng = shuffle_rng(seed, epoch, rank)
        # one permutation per file, drawn in epoch file order — the
        # exact draws _file_batches makes as readahead yields files
        self.perms = [rng.permutation(int(sizes[f])) for f in self.files]
        # offsets[i] = first global sample position of file i
        self.offsets = np.concatenate(
            ([0], np.cumsum([len(p) for p in self.perms]))).tolist()
        self.n_samples = self.offsets[-1]
        self._lock = make_lock("EpochOrder._lock")
        self._shards: dict[int, tuple] = {}  # guarded_by: self._lock

    def n_batches(self, global_batch: int) -> int:
        """Trailing remainder dropped, exactly like the streaming
        loader (which only yields while a full batch is buffered)."""
        return self.n_samples // int(global_batch)

    def _shard(self, i: int) -> tuple:
        with self._lock:
            cached = self._shards.get(i)
        if cached is not None:
            return cached
        loaded = _load_shard(self.files[i])  # mmap (.x.npy) or read (.npz)
        with self._lock:
            # a concurrent pull may have loaded it too; keep the first
            # so both gathers read one mapping
            return self._shards.setdefault(i, loaded)

    def files_for_batches(self, lo: int, hi: int,
                          global_batch: int) -> list[int]:
        """Indices of the shard files batches ``[lo, hi)`` touch — the
        reader's prefetch walks these in order."""
        if hi <= lo:
            return []
        b = int(global_batch)
        first = bisect.bisect_right(self.offsets, lo * b) - 1
        last = bisect.bisect_left(self.offsets, min(hi * b,
                                                    self.n_samples))
        return list(range(first, min(last, len(self.files))))

    def assemble(self, index: int, global_batch: int
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Batch ``index``: positions ``[index*B, (index+1)*B)`` of the
        permuted sample sequence, one gather per contributing shard."""
        b = int(global_batch)
        if not 0 <= index < self.n_batches(b):
            raise IndexError(
                f"batch {index} out of range for epoch {self.epoch} "
                f"(rank {self.rank}/{self.size}): "
                f"{self.n_batches(b)} batches of {b}")
        start = index * b
        fi = bisect.bisect_right(self.offsets, start) - 1
        xb = None
        parts_y: list[np.ndarray] = []
        need, at, pos = b, 0, start - self.offsets[fi]
        while need:
            x, y = self._shard(fi)
            perm = self.perms[fi]
            take = min(need, len(perm) - pos)
            if take:
                sel = perm[pos:pos + take]
                if xb is None:
                    xb = np.empty((b,) + x.shape[1:], x.dtype)
                np.take(x, sel, axis=0, out=xb[at:at + take])
                parts_y.append(y[sel])
                at += take
                need -= take
            fi += 1
            pos = 0
        yb = parts_y[0] if len(parts_y) == 1 else np.concatenate(parts_y)
        return xb, yb

    def drop_shards(self) -> None:
        """Release the mmap cache (epoch rotation on the reader)."""
        with self._lock:
            self._shards.clear()
