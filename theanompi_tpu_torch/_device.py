"""Device resolution for the port's entry points.

Every entry point (``InferenceServer``, ``InferenceSession``, the model
constructors) takes ``device=`` and defaults to ``"cuda"``.  Asking for
the card on a machine without one raises: nothing falls back to the CPU
unless the caller passes ``device="cpu"`` (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda|cpu)")
    return dev
