"""Host-side augmentation: random crop + horizontal mirror + normalize.

Counterpart of the numpy path of ``theanompi_tpu/data/utils.py`` for the
ImageNet stream (no padding, mirror on): the JAX package also has a
native C++ path with identical randomness and results.  Used when a
dataset augments on the host (``augment_on_device=False``).
"""

from __future__ import annotations

import numpy as np


def _normalize(images: np.ndarray, mean, std) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, 1, -1)
    return (images.astype(np.float32) / 255.0 - mean) / std


def augment_normalize(images: np.ndarray, crop_h: int, crop_w: int,
                      rng: np.random.Generator, *, mean,
                      std) -> np.ndarray:
    """Random crop + mirror-half + ``(x/255 - mean)/std``; the random
    draws come in the JAX package's order (ys, xs, flips)."""
    n, h, w, _ = images.shape
    if h < crop_h or w < crop_w:
        raise ValueError(f"images {h}x{w} smaller than crop {crop_h}x{crop_w}")
    ys = rng.integers(0, h - crop_h + 1, size=n)
    xs = rng.integers(0, w - crop_w + 1, size=n)
    flips = rng.random(n) < 0.5
    rows = ys[:, None, None] + np.arange(crop_h)[None, :, None]
    cols = xs[:, None, None] + np.arange(crop_w)[None, None, :]
    out = images[np.arange(n)[:, None, None], rows, cols]
    out[flips] = out[flips, :, ::-1]
    return np.ascontiguousarray(_normalize(out, mean, std))


def center_normalize(images: np.ndarray, crop_h: int, crop_w: int, *,
                     mean, std) -> np.ndarray:
    """Deterministic center crop + normalize (validation path)."""
    _, h, w, _ = images.shape
    if h < crop_h or w < crop_w:
        raise ValueError(f"images {h}x{w} smaller than crop {crop_h}x{crop_w}")
    y0, x0 = (h - crop_h) // 2, (w - crop_w) // 2
    return _normalize(images[:, y0:y0 + crop_h, x0:x0 + crop_w], mean, std)
