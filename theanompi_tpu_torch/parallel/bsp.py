"""BSP training steps: one process per card over ``torch.distributed``.

Counterpart of ``theanompi_tpu/parallel/bsp.py``.  In JAX one jitted
SPMD program holds the whole step; here each rank runs the same eager
step on its slice of the global batch:

1. forward and backward (``grad_and_metrics``); the BNs move their
   running statistics in place;
2. the BN running statistics are all-reduced to their MEAN over the
   ranks (the JAX step's ``pmean`` of ``model_state``; DDP's
   ``broadcast_buffers`` copies rank 0's instead, a different semantic);
3. the gradients are exchanged (``BSP_Exchanger``: avg or sum);
4. the optimizer updates (``apply_update``);
5. the metrics are all-reduced to their mean.

Metrics come back as device tensors; the caller turns them into host
numbers once per flush window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger,
    all_reduce_mean,
)

# loss_fn(module, batch, rng) -> (loss, metrics)
LossFn = Callable[[nn.Module, Any, Any], tuple[torch.Tensor, dict]]


@dataclasses.dataclass
class TrainState:
    """What a BSP step updates: the module (f32 master parameters and
    the BN running statistics), its optimizer, and the step count."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def grad_and_metrics(loss_fn: LossFn, module: nn.Module, batch,
                     rng) -> dict:
    """Forward + backward; the gradients land in ``.grad``.  Returns the
    metrics (detached), with the loss under ``'loss'``."""
    loss, metrics = loss_fn(module, batch, rng)
    loss.backward()
    metrics = dict(metrics)
    metrics.setdefault("loss", loss.detach())
    return metrics


def apply_update(state: TrainState) -> None:
    """The optimizer update on the exchanged gradients."""
    state.optimizer.step()
    state.step += 1


def running_stats(module: nn.Module) -> list[torch.Tensor]:
    """The module's floating-point buffers (the BN running statistics)."""
    return [b for b in module.buffers() if b.is_floating_point()]


def mean_metrics(metrics: dict) -> dict:
    """Each metric averaged over the ranks, with one collective."""
    names = sorted(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(())
                           for k in names])
    all_reduce_mean([stacked])
    return dict(zip(names, stacked.unbind()))


def make_bsp_train_step(loss_fn: LossFn,
                        exchanger: BSP_Exchanger | None = None):
    """``step(state, batch, rng) -> metrics``: one BSP iteration on this
    rank's batch (module docstring)."""
    exchanger = exchanger or BSP_Exchanger()

    def step(state: TrainState, batch, rng) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        metrics = grad_and_metrics(loss_fn, state.module, batch, rng)
        with torch.no_grad():
            all_reduce_mean(running_stats(state.module))
            exchanger.exchange([p.grad for p in state.module.parameters()
                                if p.grad is not None])
        apply_update(state)
        return mean_metrics(metrics)

    return step


def make_bsp_eval_step(eval_fn: Callable[[nn.Module, Any], dict]):
    """``step(state, batch) -> metrics``: the module in eval mode (the
    running statistics) without autograd, metrics averaged over the
    ranks; the module's mode is restored after."""

    def step(state: TrainState, batch) -> dict:
        module = state.module
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                metrics = eval_fn(module, batch)
        finally:
            module.train(was_training)
        return mean_metrics(metrics)

    return step
