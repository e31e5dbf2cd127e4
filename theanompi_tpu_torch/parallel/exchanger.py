"""BSP gradient exchange over ``torch.distributed``.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``.  In JAX the
exchange is a ``psum`` traced into the step; here each rank is its own
process and :meth:`BSP_Exchanger.exchange` all-reduces the gradients of
one step as ONE flat f32 buffer (one collective per step, not one per
parameter), then averages (``avg=True``, the reference's 'avg' sync
type) or keeps the sum ('cdd').  With no process group (one process)
the gradients are returned unchanged.  The bf16 wire, error feedback,
bucketed exchange and parameter averaging are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# Reference strategy names -> numeric strategy.
_STRATEGY_ALIASES = {
    "ar": "psum",
    "asa32": "psum",
    "copper": "psum",
    "nccl32": "psum",
    "psum": "psum",
    "asa16": "psum_bf16",
    "nccl16": "psum_bf16",
    "psum_bf16": "psum_bf16",
}

_NOT_PORTED = "is not ported yet (ROADMAP.md section A, item 8)"


def resolve_strategy(name: str) -> str:
    """Map a reference-era strategy name to its numeric strategy
    ('psum' | 'psum_bf16'); raises on unknown names."""
    try:
        return _STRATEGY_ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown exchange strategy {name!r}; "
            f"expected one of {sorted(_STRATEGY_ALIASES)}") from None


def all_reduce_mean(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    collective over a flat f32 buffer.  No-op without a process group."""
    all_reduce_(tensors, avg=True)


def all_reduce_(tensors: list[torch.Tensor], avg: bool) -> None:
    """Sum (``avg=False``) or average each tensor over the ranks, in
    place, through one flat f32 buffer.  A group of one rank runs the
    collective too: the path is the same at every world size."""
    if not dist.is_initialized() or not tensors:
        return
    n = dist.get_world_size()
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    if avg:
        flat.div_(n)
    at = 0
    for t in tensors:
        k = t.numel()
        t.detach().copy_(flat[at:at + k].view_as(t))
        at += k


@dataclasses.dataclass(frozen=True)
class BSP_Exchanger:
    """BSP exchange semantics (name kept for parity with the reference).

    ``strategy`` takes the reference names; only the f32 ones ('psum',
    'ar', 'nccl32', ...) are ported.  ``avg`` averages over the ranks,
    otherwise the sum is kept (the caller scales its learning rate)."""

    strategy: str = "psum"
    avg: bool = True
    exchange_what: str = "grads"
    exchange_dtype: str | None = None
    error_feedback: bool = False
    exchange_buckets: int = 1

    def __post_init__(self):
        resolved = resolve_strategy(self.strategy)
        if self.exchange_what not in ("grads", "params"):
            raise ValueError("exchange_what must be 'grads' or 'params'")
        if self.exchange_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"exchange_dtype must be 'f32' or 'bf16', "
                             f"got {self.exchange_dtype!r}")
        wire = self.exchange_dtype or (
            "bf16" if resolved == "psum_bf16" else "f32")
        if wire == "bf16":
            raise NotImplementedError(f"the bf16 exchange wire {_NOT_PORTED}")
        if self.error_feedback:
            raise NotImplementedError(f"error feedback {_NOT_PORTED}")
        if self.exchange_buckets != 1:
            raise NotImplementedError(f"the bucketed exchange {_NOT_PORTED}")
        if self.exchange_what != "grads":
            raise NotImplementedError(f"exchange_what='params' {_NOT_PORTED}")

    def exchange(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """All-reduce ``grads`` in place over the default process group
        and return them."""
        all_reduce_(grads, self.avg)
        return grads
