"""Device-side augmentation: crop + mirror + normalize inside the step.

Counterpart of ``theanompi_tpu/ops/augment.py``: the host ships raw
uint8 store images and the device crops, mirrors and normalizes them.
Train: a random crop window per image and a mirror of half the images,
drawn from an explicit ``torch.Generator`` on the images' device (the
numbers differ from ``jax.random``'s; :func:`crop_flip_normalize` takes
the offsets and flips explicitly, so a test can feed both packages the
same ones).  Eval: the deterministic center crop, no mirror.  ``pad``
reflect-pads the images first (CIFAR's 4 pixels), folded into the one
gather: a padded pixel reads its mirror image inside the frame.
"""

from __future__ import annotations

import torch


def reflect_index(i: torch.Tensor, size: int) -> torch.Tensor:
    """Indices into a dim of ``size`` for positions ``i`` of its reflect
    padding (numpy's and XLA's ``"reflect"``: the edge is not repeated),
    for pads shorter than ``size``."""
    i = i.abs()
    return torch.where(i >= size, 2 * (size - 1) - i, i)


def crop_flip_normalize(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                        flips: torch.Tensor, crop: int, mean_t: torch.Tensor,
                        std_t: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Crop ``x`` (uint8 NHWC, reflect-padded by ``pad`` first) at
    per-image offsets ``ys``/``xs`` into the padded frame, mirror the
    images where ``flips`` is true, then ``(x/255 - mean)/std`` in f32.
    One gather: a mirrored image reads its window's columns in
    reverse."""
    n, h, w, _ = x.shape
    ar = torch.arange(crop, device=x.device)
    rows = ys.long()[:, None] + ar                        # (n, crop)
    cols = xs.long()[:, None] + torch.where(
        flips.bool()[:, None], crop - 1 - ar, ar)         # (n, crop)
    if pad:
        rows = reflect_index(rows - pad, h)
        cols = reflect_index(cols - pad, w)
    win = x[torch.arange(n, device=x.device)[:, None, None],
            rows[:, :, None], cols[:, None, :]]
    return (win.float() / 255.0 - mean_t) / std_t


def make_device_augment(crop: int, mean, std, pad: int = 0):
    """Build ``transform(x, rng, train) -> float32 (N, crop, crop, C)``
    over a uint8 NHWC tensor, reflect-padded by ``pad``.  Train: offsets
    uniform in ``[0, h+2pad-crop]`` and ``[0, w+2pad-crop]`` and a fair
    coin per image for the mirror, drawn from ``rng`` (a
    ``torch.Generator`` on x's device).  Eval: center crop at
    ``((h+2pad-crop)//2, (w+2pad-crop)//2)``.  Both normalize
    ``(x/255 - mean)/std`` in f32, op by op as the JAX transform does."""
    consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def constants(dev: torch.device):
        if dev not in consts:
            consts[dev] = tuple(torch.tensor(v, dtype=torch.float32,
                                             device=dev) for v in (mean, std))
        return consts[dev]

    def transform(x: torch.Tensor, rng=None, train: bool = False):
        n, h, w, _ = x.shape
        ph, pw = h + 2 * pad, w + 2 * pad
        if ph < crop or pw < crop:
            raise ValueError(f"images {ph}x{pw} smaller than crop {crop}")
        mean_t, std_t = constants(x.device)
        if not train:
            if not pad:
                y0, x0 = (h - crop) // 2, (w - crop) // 2
                win = x[:, y0:y0 + crop, x0:x0 + crop, :]
                return (win.float() / 255.0 - mean_t) / std_t
            ys = torch.full((n,), (ph - crop) // 2, device=x.device)
            xs = torch.full((n,), (pw - crop) // 2, device=x.device)
            flips = torch.zeros(n, dtype=torch.bool, device=x.device)
        else:
            if rng is None:
                raise ValueError("the train branch needs a torch.Generator")
            ys = torch.randint(0, ph - crop + 1, (n,), generator=rng,
                               device=x.device)
            xs = torch.randint(0, pw - crop + 1, (n,), generator=rng,
                               device=x.device)
            flips = torch.rand(n, generator=rng, device=x.device) < 0.5
        return crop_flip_normalize(x, ys, xs, flips, crop, mean_t, std_t,
                                   pad)

    return transform
