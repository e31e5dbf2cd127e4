"""BSP training steps: one process per card over ``torch.distributed``.

Counterpart of ``theanompi_tpu/parallel/bsp.py``.  In JAX one jitted
SPMD program holds the whole step; here each rank runs the same eager
step on its slice of the global batch:

1. forward and backward (``grad_and_metrics``); the BNs move their
   running statistics in place.  A parameter the loss did not reach gets
   a zero gradient, exchanged and applied like any other (JAX's rule).
   With ``exchange_buckets > 1`` on the 'grads' path the gradient
   buckets are exchanged while the backward runs (``BucketedBackward``);
2. the BN running statistics are all-reduced to their MEAN over the
   ranks (the JAX step's ``pmean`` of ``model_state``; DDP's
   ``broadcast_buffers`` copies rank 0's instead, a different semantic);
3. 'grads': the gradients are exchanged (``BSP_Exchanger``: avg or sum,
   f32 or bf16 wire, with error feedback the residual in
   ``TrainState.exchange_residual``), then the optimizer updates
   (``apply_update``); 'params': the optimizer updates on the local
   gradients, then the parameters are averaged through the exchanger and
   every floating tensor of the optimizer state is averaged too;
4. the metrics are all-reduced to their mean.

The stacked cadences: ``make_bsp_multi_step`` runs k such steps on k
batches (the trajectory of k calls), ``make_bsp_accum_step`` sums the
gradients of ``a`` microbatches, divides by ``a`` and makes one
exchange and one update.  Metrics come back as device tensors; the
caller turns them into host numbers once per flush window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger,
    BucketedBackward,
    all_reduce_mean,
    zero_missing_grads,
)

# loss_fn(module, batch, rng) -> (loss, metrics)
LossFn = Callable[[nn.Module, Any, Any], tuple[torch.Tensor, dict]]


@dataclasses.dataclass
class TrainState:
    """What a BSP step updates: the module (f32 master parameters and
    the BN running statistics), its optimizer, and the step count.

    ``exchange_residual`` is this rank's error-feedback residual (JAX:
    ``TrainState.exchange_residual``, the row of this data shard): one
    f32 tensor per parameter, in ``module.parameters()`` order, on the
    module's device; ``None`` without error feedback.  Under ZeRO it is
    this rank's flat ``(total_flat,)`` vector, and ``sharding`` is the
    parameter shard the optimizer steps on (parallel/zero.py
    ``FlatShard``; FSDP's holds the parameters at rest)."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    exchange_residual: list[torch.Tensor] | torch.Tensor | None = None
    sharding: Any = None


def init_exchange_residual(module: nn.Module) -> list[torch.Tensor]:
    """A zero residual: one f32 tensor per parameter, on its device."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in module.parameters()]


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


def mean_metrics(metrics: dict, group=None) -> dict:
    """Each metric averaged over the ranks of ``group`` (default: every
    rank), with one collective."""
    names = sorted(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(())
                           for k in names])
    all_reduce_mean([stacked], group)
    return dict(zip(names, stacked.unbind()))


def exchange_grads(exchanger: BSP_Exchanger, state: TrainState) -> None:
    """The post-backward gradient exchange of the 'grads' mode (JAX's
    ``_exchange_grads_and_update`` before its update), in place on
    ``.grad`` of every parameter (``zero_missing_grads`` first); with
    error feedback through ``state.exchange_residual``."""
    params = list(state.module.parameters())
    zero_missing_grads(params)
    grads = [p.grad for p in params]
    if not exchanger.error_feedback:
        exchanger.exchange(grads)
        return
    if state.exchange_residual is None:
        raise ValueError(
            "error_feedback needs state.exchange_residual "
            "(init_exchange_residual; models/base.py builds it from "
            "ModelConfig.exchange_error_feedback)")
    exchanger.exchange_with_residual(grads, state.exchange_residual)


def average_params(exchanger: BSP_Exchanger, state: TrainState) -> None:
    """The 'params' mode after the local update: the parameters averaged
    through the exchanger (its wire and buckets, ``avg`` forced on) and
    every floating tensor of the optimizer state averaged in f32, so the
    state stays the same on every rank (JAX ``bsp.py`` 'params'
    branch)."""
    avg = (exchanger if exchanger.avg
           else dataclasses.replace(exchanger, avg=True))
    avg.exchange([p.detach() for p in state.module.parameters()])
    # (step counters that an optimizer keeps on the host are equal on
    # every rank and stay out)
    all_reduce_mean([v for p, per in state.optimizer.state.items()
                     for v in per.values()
                     if torch.is_tensor(v) and v.is_floating_point()
                     and v.device == p.device], exchanger.group)


def make_bsp_train_step(loss_fn: LossFn,
                        exchanger: BSP_Exchanger | None = None):
    """``step(state, batch, rng) -> metrics``: one BSP iteration on this
    rank's batch (module docstring).  The first call sets the exchange's
    gauges and, for the overlapped bucketed exchange, puts its hooks on
    the module's parameters (the module must stay the same after)."""
    exchanger = exchanger or BSP_Exchanger()
    overlap = (exchanger.exchange_what == "grads"
               and exchanger.exchange_buckets > 1)
    built: dict = {}

    def step(state: TrainState, batch, rng) -> dict:
        module = state.module
        if not built:
            params = list(module.parameters())
            exchanger.emit_gauges(params)
            built["module"] = module
            if overlap:
                built["buckets"] = BucketedBackward(exchanger, params)
        elif built["module"] is not module:
            raise ValueError("this step was built for another module")
        buckets = built.get("buckets")
        state.optimizer.zero_grad(set_to_none=True)
        if buckets is not None:
            buckets.arm(state.exchange_residual)
        metrics = grad_and_metrics(loss_fn, module, batch, rng)
        with torch.no_grad():
            zero_missing_grads(module.parameters())
            if buckets is not None:
                buckets.finish()
            all_reduce_mean(running_stats(module), exchanger.group)
            if exchanger.exchange_what == "grads" and buckets is None:
                exchange_grads(exchanger, state)
        apply_update(state)
        if exchanger.exchange_what == "params":
            with torch.no_grad():
                average_params(exchanger, state)
        return mean_metrics(metrics, exchanger.group)

    return step


def make_bsp_multi_step(loss_fn: LossFn,
                        exchanger: BSP_Exchanger | None = None):
    """``multi_step(state, batches, rng) -> metrics``: one single BSP
    step per batch of the list, in turn, on the same generator, so the
    trajectory is that of ``len(batches)`` calls of
    ``make_bsp_train_step``'s step (JAX scans them into one program);
    the metrics come back stacked ``(k,)``."""
    single = make_bsp_train_step(loss_fn, exchanger)

    def multi_step(state: TrainState, batches, rng) -> dict:
        per = [single(state, b, rng) for b in batches]
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}

    return multi_step


def accumulate_microbatch_grads(loss_fn: LossFn, module: nn.Module,
                                batches, rng) -> tuple[dict, int]:
    """Forward + backward of each microbatch in turn, the gradients
    summed in ``.grad`` (``g0 + g1 + ...``, as JAX's scan adds them) and
    the BN running statistics threaded through; returns the metrics
    averaged over the microbatches and their count ``a``."""
    per = [grad_and_metrics(loss_fn, module, mb, rng) for mb in batches]
    return ({k: torch.stack([m[k].detach().float().reshape(())
                             for m in per]).mean(0) for k in per[0]},
            len(per))


def make_bsp_accum_step(loss_fn: LossFn,
                        exchanger: BSP_Exchanger | None = None):
    """``accum_step(state, batches, rng) -> metrics``: gradient
    accumulation, ``a = len(batches)`` microbatches to ONE update.  The
    gradients are averaged over the microbatches locally, then exchanged
    once (the post-backward exchange, bucketed when asked; the
    overlapped hooks stay off) and applied once, so the effective global
    batch is ``a`` global batches at the memory of one microbatch.
    ``exchange_what='params'`` is refused, as in JAX."""
    exchanger = exchanger or BSP_Exchanger()
    if exchanger.exchange_what != "grads":
        raise ValueError("gradient accumulation requires "
                         "exchange_what='grads' (param-averaging per "
                         "microbatch has no accumulation semantics)")
    built: dict = {}

    def accum_step(state: TrainState, batches, rng) -> dict:
        module = state.module
        if not built:
            exchanger.emit_gauges(list(module.parameters()))
            built["gauges"] = True
        state.optimizer.zero_grad(set_to_none=True)
        metrics, a = accumulate_microbatch_grads(loss_fn, module, batches,
                                                 rng)
        with torch.no_grad():
            zero_missing_grads(module.parameters())
            for p in module.parameters():
                p.grad.div_(a)
            all_reduce_mean(running_stats(module), exchanger.group)
            exchange_grads(exchanger, state)
        apply_update(state)
        return mean_metrics(metrics, exchanger.group)

    return accum_step


def make_bsp_eval_step(eval_fn: Callable[[nn.Module, Any], dict],
                       group=None):
    """``step(state, batch) -> metrics``: the module in eval mode (the
    running statistics) without autograd, metrics averaged over the
    ranks of ``group`` (default: every rank); the module's mode is
    restored after."""

    def step(state: TrainState, batch) -> dict:
        module = state.module
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                metrics = eval_fn(module, batch)
        finally:
            module.train(was_training)
        return mean_metrics(metrics, group)

    return step
