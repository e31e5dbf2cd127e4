"""Host-side augmentation: random crop + horizontal mirror + normalize.

Counterpart of ``theanompi_tpu/data/utils.py``: reflect ``pad``
(CIFAR's 4 pixels), a random crop, a mirror of half the images, then
``(x/255 - mean)/std``.  Used when a dataset augments on the host
(``augment_on_device=False``).  Two implementations with the same
randomness and bitwise the same results:

* the native C++ pass (``theanompi_tpu_torch/native``), one pass per
  image, taken for uint8 input whenever ``g++`` exists;
* vectorised numpy (pad copy + gather + astype + arithmetic), the
  path where no ``g++`` is found and the oracle the native pass is
  tested against.
"""

from __future__ import annotations

import numpy as np

from theanompi_tpu_torch import native


def _gather_crops(images, ys, xs, flips, crop_h, crop_w, pad):
    """Reflect-pad, gather each crop window, mirror the flipped ones."""
    n = images.shape[0]
    if pad:
        images = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="reflect")
    rows = ys[:, None, None] + np.arange(crop_h)[None, :, None]
    cols = xs[:, None, None] + np.arange(crop_w)[None, None, :]
    out = images[np.arange(n)[:, None, None], rows, cols]
    out[flips] = out[flips, :, ::-1]
    return out


def _normalize(images: np.ndarray, mean, std) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, 1, -1)
    return (images.astype(np.float32) / 255.0 - mean) / std


def _use_native(images: np.ndarray) -> bool:
    return images.dtype == np.uint8 and native.native_available()


def _native(images, ys, xs, flips, crop_h, crop_w, mean, std, pad):
    c = images.shape[-1]
    return native.crop_flip_normalize(
        images, ys, xs, flips, crop_h, crop_w,
        np.broadcast_to(np.asarray(mean, np.float32), (c,)),
        np.broadcast_to(np.asarray(std, np.float32), (c,)), pad=pad)


def augment_normalize(images: np.ndarray, crop_h: int, crop_w: int,
                      rng: np.random.Generator, *, mean, std,
                      pad: int = 0) -> np.ndarray:
    """Reflect-pad + random crop + mirror-half + ``(x/255 - mean)/std``;
    the random draws come up front in the JAX package's order (ys, xs,
    flips), so the native and numpy paths give the same batch."""
    n, h, w, _ = images.shape
    ph, pw = h + 2 * pad, w + 2 * pad
    if ph < crop_h or pw < crop_w:
        raise ValueError(
            f"images {ph}x{pw} smaller than crop {crop_h}x{crop_w}")
    ys = rng.integers(0, ph - crop_h + 1, size=n)
    xs = rng.integers(0, pw - crop_w + 1, size=n)
    flips = rng.random(n) < 0.5
    if _use_native(images):
        return _native(images, ys, xs, flips, crop_h, crop_w, mean, std,
                       pad)
    out = _gather_crops(images, ys, xs, flips, crop_h, crop_w, pad)
    return np.ascontiguousarray(_normalize(out, mean, std))


def center_normalize(images: np.ndarray, crop_h: int, crop_w: int, *,
                     mean, std) -> np.ndarray:
    """Deterministic center crop + normalize (validation path)."""
    n, h, w, _ = images.shape
    if h < crop_h or w < crop_w:
        raise ValueError(f"images {h}x{w} smaller than crop {crop_h}x{crop_w}")
    y0, x0 = (h - crop_h) // 2, (w - crop_w) // 2
    if _use_native(images):
        return _native(images, np.full(n, y0, np.int64),
                       np.full(n, x0, np.int64), np.zeros(n, np.uint8),
                       crop_h, crop_w, mean, std, 0)
    return _normalize(images[:, y0:y0 + crop_h, x0:x0 + crop_w], mean, std)
