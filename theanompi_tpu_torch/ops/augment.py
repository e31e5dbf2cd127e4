"""Device-side augmentation, eval branch.

Counterpart of ``theanompi_tpu/ops/augment.py``: requests ship raw uint8
store images and the device crops and normalizes them.  This slice ports
the eval branch (deterministic center crop, no mirror); the random train
branch comes with training.
"""

from __future__ import annotations

import torch


def make_device_augment(crop: int, mean, std):
    """Build ``transform(x, rng, train) -> float32 (N, crop, crop, C)``
    over a uint8 NHWC tensor: center crop at ``((h-crop)//2,
    (w-crop)//2)``, then ``(x/255 - mean)/std`` in f32, op by op as the
    JAX transform does."""
    consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def normalize(win: torch.Tensor) -> torch.Tensor:
        dev = win.device
        if dev not in consts:
            consts[dev] = tuple(torch.tensor(v, dtype=torch.float32,
                                             device=dev) for v in (mean, std))
        mean_t, std_t = consts[dev]
        return (win.float() / 255.0 - mean_t) / std_t

    def transform(x: torch.Tensor, rng=None, train: bool = False):
        if train:
            raise NotImplementedError(
                "the random-crop/mirror train branch is not ported yet")
        _, h, w, _ = x.shape
        if h < crop or w < crop:
            raise ValueError(f"images {h}x{w} smaller than crop {crop}")
        y0, x0 = (h - crop) // 2, (w - crop) // 2
        return normalize(x[:, y0:y0 + crop, x0:x0 + crop, :])

    return transform
