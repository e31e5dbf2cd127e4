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

Shard trees are written by :func:`prepare_imagenet_shards` (uint8 arrays
in) and :func:`prepare_imagenet_from_images` (an ImageFolder tree of
images, decoded with Pillow), the JAX package's byte for byte: shards
``<prefix>_NNNN`` as ``.x.npy``/``.y.npy`` pairs (default) or ``.npz``,
``manifest.json`` (samples per shard) and, from images, ``classes.json``.
A rerun replaces the prefix's shards in either format, removing the
leftovers only once the new set is complete; a failed run removes the
new files it wrote, so a run in the other format leaves the earlier set
whole (one in the same format has overwritten the shards it reached, as
in JAX).  :func:`shard_tree_signature` is a tree's identity (seed, sizes
and names of its training shards).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
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


def shard_tree_signature(train_files: Sequence[str],
                         sizes: dict[str, int], seed: int) -> dict:
    """Identity of a (shard set, seed) pair: the seed, the training
    samples and files, and the sha256 of ``name:samples;`` per file in
    order (what a trainer and a remote reader must agree on for their
    streams to be byte-identical)."""
    sig = hashlib.sha256()
    for f in train_files:
        sig.update(f"{os.path.basename(f)}:{sizes[f]};".encode())
    return {"seed": int(seed),
            "n_train": int(sum(sizes[f] for f in train_files)),
            "n_files": len(train_files),
            "files_sha256": sig.hexdigest()}


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


# -- shard preparation -------------------------------------------------------


def _update_manifest(out_dir: str, entries: dict[str, int]) -> None:
    """Merge ``{shard basename: samples}`` into ``manifest.json``."""
    manifest_path = os.path.join(out_dir, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    manifest.update(entries)
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh)


def _write_shard(out_dir: str, prefix: str, index: int,
                 x: np.ndarray, y: np.ndarray, shard_format: str) -> str:
    """One shard in ``shard_format`` ('npy' pair or 'npz'); returns the
    path training discovers (an npy pair's ``.x.npy``)."""
    base = os.path.join(out_dir, f"{prefix}_{index:04d}")
    if shard_format == "npy":
        np.save(base + ".x.npy", x)
        np.save(base + ".y.npy", y)
        return base + ".x.npy"
    if shard_format == "npz":
        np.savez(base + ".npz", x=x, y=y)
        return base + ".npz"
    raise ValueError(f"unknown shard_format {shard_format!r} "
                     "(expected 'npy' or 'npz')")


def _unlink_shard(path: str) -> None:
    os.unlink(path)
    if path.endswith(".x.npy"):
        sibling = path[: -len(".x.npy")] + ".y.npy"
        if os.path.exists(sibling):
            os.unlink(sibling)


def _remove_shards(out_dir: str, paths, manifest: bool = True) -> None:
    """Delete shard files (an npy pair's sibling too) and, with
    ``manifest``, their manifest entries."""
    paths = sorted(paths)
    if not paths:
        return
    if manifest:
        manifest_path = os.path.join(out_dir, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as fh:
                m = json.load(fh)
            for p in paths:
                m.pop(os.path.basename(p), None)
            with open(manifest_path, "w") as fh:
                json.dump(m, fh)
    for p in paths:
        if os.path.exists(p):
            _unlink_shard(p)


def prepare_imagenet_shards(src_images: np.ndarray, src_labels: np.ndarray,
                            out_dir: str, prefix: str = "train",
                            shard_size: int = 1024,
                            shard_format: str = "npy") -> list[str]:
    """Pack (N, H, W, 3) uint8 images and their labels into shards of
    ``shard_size`` under ``out_dir`` (module docstring); returns the
    shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    preexisting = set(_shard_glob(out_dir, prefix))
    paths: list[str] = []
    try:
        for i in range(0, len(src_labels), shard_size):
            paths.append(_write_shard(out_dir, prefix, i // shard_size,
                                      src_images[i:i + shard_size],
                                      src_labels[i:i + shard_size],
                                      shard_format))
    except BaseException:
        _remove_shards(out_dir, set(paths) - preexisting, manifest=False)
        raise
    _remove_shards(out_dir, preexisting - set(paths))
    _update_manifest(out_dir, {
        os.path.basename(p): int(min(shard_size,
                                     len(src_labels) - k * shard_size))
        for k, p in enumerate(paths)})
    return paths


IMAGE_EXTENSIONS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


def list_image_dir(src_dir: str,
                   class_to_idx: dict[str, int] | None = None,
                   extensions: Sequence[str] = IMAGE_EXTENSIONS,
                   ) -> tuple[list[tuple[str, int]], dict[str, int]]:
    """(path, label) pairs of an ImageFolder tree (one subdirectory per
    class), labels from ``class_to_idx`` or the sorted subdirectory
    names, and that mapping."""
    classes = sorted(d for d in os.listdir(src_dir)
                     if os.path.isdir(os.path.join(src_dir, d)))
    if not classes:
        raise FileNotFoundError(
            f"{src_dir!r} has no class subdirectories (expected "
            "<src_dir>/<class>/<image>.jpeg, the ImageFolder layout)")
    if class_to_idx is None:
        class_to_idx = {c: i for i, c in enumerate(classes)}
    pairs = []
    for c in classes:
        if c not in class_to_idx:
            raise KeyError(f"directory {c!r} missing from class_to_idx")
        cdir = os.path.join(src_dir, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(tuple(extensions)):
                pairs.append((os.path.join(cdir, f), class_to_idx[c]))
    return pairs, class_to_idx


def decode_image(path: str, store: int) -> np.ndarray:
    """An image file -> uint8 (store, store, 3): RGB, the shorter side
    resized to ``store`` (bilinear), center crop.  Needs Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = store / min(w, h)
        im = im.resize((max(store, round(w * scale)),
                        max(store, round(h * scale))), Image.BILINEAR)
        left = (im.width - store) // 2
        top = (im.height - store) // 2
        im = im.crop((left, top, left + store, top + store))
        return np.asarray(im, np.uint8)


def _bounded_thread_map(fn: Callable, items: Sequence, workers: int,
                        window: int) -> Iterator:
    """``fn`` over ``items`` in a thread pool, in order, with at most
    ``window`` results in flight (a slow consumer bounds the memory)."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: deque = deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def prepare_imagenet_from_images(src_dir: str, out_dir: str,
                                 prefix: str = "train", store: int = 256,
                                 shard_size: int = 1024,
                                 class_to_idx: dict[str, int] | None = None,
                                 workers: int = 8,
                                 shuffle_seed: int | None = 0,
                                 shard_format: str = "npy") -> list[str]:
    """An ImageFolder tree -> ``store``-sized uint8 shards, the manifest
    and ``classes.json`` (module docstring), decoded in ``workers``
    threads and streamed shard by shard.  ``shuffle_seed`` shuffles the
    file order once (None keeps directory order, whose classes are
    contiguous).  Needs Pillow; :func:`prepare_imagenet_shards` takes
    decoded arrays instead."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "raw-image preparation needs Pillow; pre-decode with "
            "prepare_imagenet_shards(images, labels, ...) instead") from e

    pairs, class_to_idx = list_image_dir(src_dir, class_to_idx)
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(len(pairs))
        pairs = [pairs[i] for i in order]
    os.makedirs(out_dir, exist_ok=True)
    # the earlier run's shards go only once the new set is complete
    preexisting = set(_shard_glob(out_dir, prefix))
    with open(os.path.join(out_dir, "classes.json"), "w") as fh:
        json.dump(class_to_idx, fh)

    paths: list[str] = []
    counts: dict[str, int] = {}
    buf_x = np.empty((shard_size, store, store, 3), np.uint8)
    buf_y = np.empty(shard_size, np.int32)
    fill = 0

    def flush():
        nonlocal fill
        p = _write_shard(out_dir, prefix, len(paths), buf_x[:fill],
                         buf_y[:fill], shard_format)
        paths.append(p)
        counts[os.path.basename(p)] = fill
        fill = 0

    decoded = _bounded_thread_map(
        lambda pl: (decode_image(pl[0], store), pl[1]), pairs,
        workers=workers, window=workers * 4)
    try:
        for img, label in decoded:
            buf_x[fill] = img
            buf_y[fill] = label
            fill += 1
            if fill == shard_size:
                flush()
        if fill:
            flush()
    except BaseException:
        # a failed run leaves the earlier set: remove this run's new files
        _remove_shards(out_dir, set(paths) - preexisting, manifest=False)
        raise
    _remove_shards(out_dir, preexisting - set(paths))
    _update_manifest(out_dir, counts)
    return paths
