"""ImageNet data: shard files or a deterministic synthetic pool.

Counterpart of ``theanompi_tpu/data/imagenet.py``, copied with numpy so
that both packages yield byte-identical batch streams for the same
``(seed, epoch, rank, size)``:

* shard files ``train_*``/``val_*`` in ``data_dir`` (mmap-able
  ``.x.npy``/``.y.npy`` pairs or ``.npz``; uint8 ``x`` (N, H, W, 3), int
  ``y``), read ahead by a background thread; the epoch's file order and
  in-file shuffles are pure functions of (seed, epoch, rank);
* without shards, a synthetic pool of class-patterned uint8 images
  sampled per batch from a seeded generator.

With ``augment_on_device`` (the default here) the host yields raw uint8
store images and ``device_transform`` crops, mirrors and normalizes them
on the device (ops/augment.py); a served request goes through its eval
branch.  Otherwise the host augments (data/utils.py).
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np

from theanompi_tpu_torch.data.base import Batch, Dataset
from theanompi_tpu_torch.data.utils import augment_normalize, center_normalize
from theanompi_tpu_torch.ops.augment import make_device_augment

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def readahead(items: Sequence, load: Callable, depth: int = 2) -> Iterator:
    """Yield ``load(item)`` for each item, decoding ``depth`` ahead in a
    background thread; abandoning the generator stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for it in items:
                if stop.is_set() or not put(load(it)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="readahead")
    t.start()
    try:
        while True:
            out = q.get()
            if out is sentinel:
                if err:
                    raise err[0]
                return
            yield out
    finally:
        stop.set()
        t.join(timeout=5)


def _load_shard(path: str):
    """One shard: ``*.x.npy`` pairs are memory-mapped (no decode, no
    copy), ``.npz`` is read whole."""
    if path.endswith(".x.npy"):
        x = np.load(path, mmap_mode="r")
        return x, np.load(path[: -len(".x.npy")] + ".y.npy").astype(np.int32)
    with np.load(path) as z:
        return z["x"], z["y"].astype(np.int32)


def _shard_glob(data_dir: str, prefix: str) -> list[str]:
    return sorted(
        glob.glob(os.path.join(data_dir, f"{prefix}_*.npz"))
        + glob.glob(os.path.join(data_dir, f"{prefix}_*.x.npy")))


def _file_size_map(data_dir: str, files: list[str]) -> dict[str, int]:
    """Samples per shard, from ``manifest.json`` where it lists them."""
    sizes: dict[str, int] = {}
    manifest = os.path.join(data_dir, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as fh:
            m = json.load(fh)
        for f in files:
            n = m.get(os.path.basename(f))
            if n is not None:
                sizes[f] = int(n)
    for f in files:
        if f not in sizes:
            sizes[f] = len(_load_shard(f)[1])
    return sizes


# -- pure epoch-order derivation ---------------------------------------------


def epoch_file_order(files: Sequence[str], seed: int, epoch: int | None,
                     rank: int = 0, size: int = 1) -> list[str]:
    """The epoch's file list: a seeded permutation (``epoch=None`` keeps
    sorted order, the val path), then this rank's ``[rank::size]``."""
    files = list(files)
    if epoch is not None:
        order = np.random.default_rng(seed + 1000 + epoch)
        files = [files[i] for i in order.permutation(len(files))]
    if size > 1:
        files = files[rank::size]
    return files


def shuffle_rng(seed: int, epoch: int, rank: int) -> np.random.Generator:
    """The in-file shuffle stream: one permutation per shard file."""
    return np.random.default_rng(seed + 9000 + 7919 * epoch + rank)


def augment_rng(seed: int, epoch: int, rank: int) -> np.random.Generator:
    """The host-augmentation stream (constructed either way)."""
    return np.random.default_rng(seed + 5000 + 7919 * epoch + rank)


def _synthetic_pool(n_images: int, n_classes: int, hw: int, seed: int):
    """Pool of distinct patterned uint8 images + labels; classes get
    distinct low-frequency signatures so a model can fit them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    labels = (np.arange(n_images) * max(n_classes // max(n_images, 1), 1)
              ) % n_classes
    imgs = np.empty((n_images, hw, hw, 3), np.uint8)
    for i, c in enumerate(labels):
        fx, fy = 1 + c % 5, 1 + (c // 5) % 5
        phase = 2 * np.pi * (c % 97) / 97.0
        base = (np.sin(2 * np.pi * fx * xx + phase)
                * np.cos(2 * np.pi * fy * yy))
        img = np.stack(
            [base * (0.5 + 0.5 * np.sin(phase + k)) for k in range(3)], -1)
        img = img + 0.3 * rng.standard_normal((hw, hw, 3), dtype=np.float32)
        imgs[i] = ((img - img.min()) / (img.max() - img.min() + 1e-8) * 255
                   ).astype(np.uint8)
    return imgs, labels.astype(np.int32)


class ImageNet_data(Dataset):
    """ImageNet batches from shard files, or synthetic (module
    docstring).  ``crop`` and ``n_classes`` alone give the served data
    spec; the other arguments are the JAX ``ImageNet_data``'s (its
    ``label_noise`` and ``readahead_depth`` are not taken over: depth 2)."""

    def __init__(self, data_dir: str | None = None, crop: int = 224,
                 seed: int = 0, synthetic_n: int = 8192,
                 synthetic_pool: int = 256, synthetic_store: int = 256,
                 augment_on_device: bool = True, n_classes: int = 1000):
        self.crop = int(crop)
        self.seed = seed
        self.n_classes = int(n_classes)
        self.sample_shape = (self.crop, self.crop, 3)
        #: the dtype requests arrive in (raw store images)
        self.sample_dtype = "uint8"
        self.augment_on_device = augment_on_device
        if augment_on_device:
            self.device_transform = make_device_augment(
                self.crop, mean=IMAGENET_MEAN, std=IMAGENET_STD)
        self.synthetic = False
        self.train_files: list[str] = []
        self.val_files: list[str] = []
        self._pool: tuple[np.ndarray, np.ndarray] | None = None
        self._pool_args = (synthetic_pool, synthetic_store)
        if data_dir and os.path.isdir(data_dir):
            self.train_files = _shard_glob(data_dir, "train")
            self.val_files = _shard_glob(data_dir, "val")
        if self.train_files:
            self._file_sizes = _file_size_map(
                data_dir, self.train_files + self.val_files)
            self.n_train = sum(self._file_sizes[f] for f in self.train_files)
            self.n_val = sum(self._file_sizes[f] for f in self.val_files)
            cj = os.path.join(data_dir, "classes.json")
            if os.path.exists(cj):
                with open(cj) as fh:
                    self.n_classes = len(json.load(fh))
        else:
            self.synthetic = True
            self.n_train = synthetic_n
            self.n_val = max(synthetic_n // 16, 256)

    def _synthetic(self) -> tuple[np.ndarray, np.ndarray]:
        """The pool, made at first use (a served model never draws it)."""
        if self._pool is None:
            pool, store = self._pool_args
            self._pool = _synthetic_pool(pool, self.n_classes, store,
                                         self.seed)
        return self._pool

    def _prep_train(self, x: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        if self.augment_on_device:
            return x
        return augment_normalize(x, self.crop, self.crop, rng,
                                 mean=IMAGENET_MEAN, std=IMAGENET_STD)

    def _prep_val(self, x: np.ndarray) -> np.ndarray:
        if self.augment_on_device:
            return x
        return center_normalize(x, self.crop, self.crop,
                                mean=IMAGENET_MEAN, std=IMAGENET_STD)

    def _synthetic_batches(self, n_batches: int, global_batch: int,
                           rng: np.random.Generator, train: bool
                           ) -> Iterator[Batch]:
        pool_x, pool_y = self._synthetic()
        for _ in range(n_batches):
            idx = rng.integers(0, len(pool_x), size=global_batch)
            x, y = pool_x[idx], pool_y[idx]
            x = self._prep_train(x, rng) if train else self._prep_val(x)
            yield x, y

    def _file_batches(self, files: list[str], global_batch: int,
                      aug_rng: np.random.Generator | None,
                      shuffle: np.random.Generator | None
                      ) -> Iterator[Batch]:
        """Stream batches across shard files; leftover tail samples of a
        file carry into the next batch.  Each batch is one gather per
        contributing shard, straight from the mmap."""
        pending: list[list] = []   # [x, y, perm, pos] per open shard
        buffered = 0

        def assemble() -> Batch:
            x0 = pending[0][0]
            xb = np.empty((global_batch,) + x0.shape[1:], x0.dtype)
            parts_y: list[np.ndarray] = []
            need, at = global_batch, 0
            while need:
                x, y, perm, pos = pending[0]
                take = min(need, len(perm) - pos)
                sel = perm[pos:pos + take]
                np.take(x, sel, axis=0, out=xb[at:at + take])
                parts_y.append(y[sel])
                at += take
                need -= take
                if pos + take == len(perm):
                    pending.pop(0)
                else:
                    pending[0][3] = pos + take
            yb = parts_y[0] if len(parts_y) == 1 else np.concatenate(parts_y)
            return xb, yb

        for x, y in readahead(files, _load_shard):
            perm = (shuffle.permutation(len(y)) if shuffle is not None
                    else np.arange(len(y)))
            pending.append([x, y, perm, 0])
            buffered += len(y)
            while buffered >= global_batch:
                xb, yb = assemble()
                buffered -= global_batch
                if aug_rng is not None:
                    xb = self._prep_train(xb, aug_rng)
                else:
                    xb = self._prep_val(xb)
                yield xb, yb

    def train_batches(self, epoch: int, global_batch: int,
                      rank: int = 0, size: int = 1) -> Iterator[Batch]:
        if self.synthetic:
            rng = np.random.default_rng(
                self.seed + 5000 + 7919 * epoch + 104729 * rank)
            n = (self.n_train // size) // global_batch
            yield from self._synthetic_batches(n, global_batch, rng, True)
            return
        files = epoch_file_order(self.train_files, self.seed, epoch, rank,
                                 size)
        yield from self._file_batches(
            files, global_batch, augment_rng(self.seed, epoch, rank),
            shuffle_rng(self.seed, epoch, rank))

    def val_batches(self, global_batch: int, rank: int = 0,
                    size: int = 1) -> Iterator[Batch]:
        if self.synthetic:
            rng = np.random.default_rng(self.seed + 31337 + rank)
            n = (self.n_val // size) // global_batch
            yield from self._synthetic_batches(n, global_batch, rng, False)
            return
        files = epoch_file_order(self.val_files, self.seed, None, rank, size)
        yield from self._file_batches(files, global_batch, None, None)

    def n_train_batches_for(self, epoch: int, global_batch: int,
                            rank: int = 0, size: int = 1) -> int:
        if self.synthetic:
            return (self.n_train // size) // global_batch
        files = epoch_file_order(self.train_files, self.seed, epoch, rank,
                                 size)
        return sum(self._file_sizes[f] for f in files) // global_batch
