"""CIFAR-10 data: the pickled batches, an ``.npz``, or a synthetic pool.

Counterpart of ``theanompi_tpu/data/cifar10.py``, copied with numpy so
that both packages yield byte-identical batch streams for the same
``(seed, epoch)``: the python-pickled ``cifar-10-batches-py`` batches
from ``data_dir`` (or ``$THEANOMPI_TPU_DATA``), an ``cifar10.npz`` with
``x_train/y_train/x_test/y_test``, or, when neither is found, a seeded
synthetic stand-in (class-conditional low-frequency patterns plus
noise, learnable) with optional label noise, which gives the val error
a known floor.  With ``augment_on_device`` the host yields raw uint8
images and ``device_transform`` pads, crops, mirrors and normalizes them
on the device (ops/augment.py); otherwise the host does (data/utils.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator

import numpy as np

from theanompi_tpu_torch.data.base import Batch, Dataset
from theanompi_tpu_torch.data.utils import augment_normalize, center_normalize
from theanompi_tpu_torch.ops.augment import make_device_augment

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)


def _load_pickled_batches(d: str):
    """``data_batch_1..5`` and ``test_batch`` of ``d`` as uint8 NHWC
    arrays and int32 labels."""
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xs.append(b[b"data"])
        ys.append(b[b"labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        b = pickle.load(f, encoding="bytes")
    x_train = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x_test = np.asarray(b[b"data"]).reshape(-1, 3, 32, 32).transpose(
        0, 2, 3, 1)
    return (x_train, np.concatenate(ys).astype(np.int32),
            x_test, np.asarray(b[b"labels"], np.int32))


def _synthetic_cifar(n_train: int, n_val: int, n_classes: int = 10,
                     seed: int = 0, hw: int = 32,
                     label_noise: float = 0.0):
    """Seeded learnable stand-in: each class a distinct low-frequency
    pattern plus noise.  With ``label_noise`` each label is replaced by a
    uniform class draw with probability rho (train and val drawn apart),
    so a Bayes-optimal model's val error is the realized fraction of
    wrong labels; returns those masks too."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    protos = []
    for c in range(n_classes):
        fx, fy = 1 + c % 3, 1 + (c // 3) % 3
        phase = 2 * np.pi * c / n_classes
        base = (np.sin(2 * np.pi * fx * xx + phase)
                * np.cos(2 * np.pi * fy * yy))
        chan = np.stack([base * (0.5 + 0.5 * np.sin(phase + k))
                         for k in range(3)], -1)
        protos.append(chan.astype(np.float32))
    protos = np.stack(protos)  # (C, H, W, 3)

    def make(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y_true = r.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y_true] + 0.35 * r.standard_normal((n, hw, hw, 3),
                                                      dtype=np.float32)
        x = ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)
        y = y_true.copy()
        if label_noise > 0.0:
            flip = r.random(n) < label_noise
            y[flip] = r.integers(0, n_classes, size=int(flip.sum()),
                                 dtype=np.int32)
        return x, y, (y != y_true)

    x_tr, y_tr, wrong_tr = make(n_train, 1)
    x_va, y_va, wrong_va = make(n_val, 2)
    return x_tr, y_tr, x_va, y_va, wrong_tr, wrong_va


class Cifar10_data(Dataset):
    """CIFAR-10 batches (module docstring); the arguments are the JAX
    ``Cifar10_data``'s."""

    sample_shape = (32, 32, 3)
    n_classes = 10
    #: normalization constants in [0, 1] units
    mean = CIFAR_MEAN
    std = CIFAR_STD

    def __init__(self, data_dir: str | None = None, synthetic_n: int = 4096,
                 crop: int = 32, pad: int = 4, seed: int = 0,
                 augment_on_device: bool = False,
                 label_noise: float = 0.0):
        self.crop = crop
        self.pad = pad
        self.seed = seed
        self.synthetic = False
        #: the dtype requests arrive in (raw images when augmenting on
        #: the device, else normalized f32 crops)
        self.sample_dtype = "uint8" if augment_on_device else "float32"
        self.augment_on_device = augment_on_device
        if augment_on_device:
            self.device_transform = make_device_augment(
                crop, mean=self.mean, std=self.std, pad=pad)

        candidates = []
        if data_dir:
            candidates += [data_dir,
                           os.path.join(data_dir, "cifar-10-batches-py")]
        env = os.environ.get("THEANOMPI_TPU_DATA")
        if env:
            candidates += [os.path.join(env, "cifar-10-batches-py"),
                           os.path.join(env, "cifar10.npz")]
        loaded = None
        for cand in candidates:
            if cand.endswith(".npz") and os.path.exists(cand):
                with np.load(cand) as z:
                    loaded = (z["x_train"], z["y_train"].astype(np.int32),
                              z["x_test"], z["y_test"].astype(np.int32))
                break
            if os.path.isdir(cand) and os.path.exists(
                    os.path.join(cand, "data_batch_1")):
                loaded = _load_pickled_batches(cand)
                break

        #: realized fraction of labels differing from the true class (0.0
        #: for real data)
        self.train_noise_frac = 0.0
        self.val_noise_frac = 0.0
        if loaded is None:
            self.synthetic = True
            (*loaded, wrong_tr, wrong_va) = _synthetic_cifar(
                synthetic_n, max(synthetic_n // 8, 256), seed=seed,
                label_noise=label_noise)
            self.train_noise_frac = float(wrong_tr.mean())
            self.val_noise_frac = float(wrong_va.mean())
        elif label_noise > 0.0:
            raise ValueError("label_noise is a synthetic-oracle knob; "
                             "real CIFAR data was found and loaded")
        self.x_train, self.y_train, self.x_val, self.y_val = loaded
        self.n_train = len(self.x_train)
        self.n_val = len(self.x_val)
        if crop != 32:
            self.sample_shape = (crop, crop, 3)

    def train_batches(self, epoch: int, global_batch: int,
                      rank: int = 0, size: int = 1) -> Iterator[Batch]:
        order = np.random.default_rng(self.seed + 1000 + epoch).permutation(
            self.n_train)
        if size > 1:
            order = order[rank::size]
        aug_rng = np.random.default_rng(self.seed + 5000 + 7919 * epoch
                                        + rank)
        for i in range(len(order) // global_batch):
            idx = order[i * global_batch:(i + 1) * global_batch]
            if self.augment_on_device:
                yield self.x_train[idx], self.y_train[idx]
                continue
            x = augment_normalize(self.x_train[idx], self.crop, self.crop,
                                  aug_rng, pad=self.pad, mean=self.mean,
                                  std=self.std)
            yield x, self.y_train[idx]

    def val_batches(self, global_batch: int, rank: int = 0,
                    size: int = 1) -> Iterator[Batch]:
        for i in range(self.n_val // global_batch):
            sl = slice(i * global_batch, (i + 1) * global_batch)
            if self.augment_on_device:
                yield self.x_val[sl], self.y_val[sl]
                continue
            yield (center_normalize(self.x_val[sl], self.crop, self.crop,
                                    mean=self.mean, std=self.std),
                   self.y_val[sl])
