"""Batch division, learning-rate scaling and the optimizer.

Counterpart of ``theanompi_tpu/utils/helper_funcs.py``.  The optimizer is
``torch.optim.SGD``: with ``weight_decay`` it adds ``wd * p`` to each
gradient before the momentum trace, exactly the optax chain
``add_decayed_weights -> sgd(momentum, nesterov)`` the JAX package
builds (coupled decay on every parameter).  The learning rate lives in
the optimizer's param groups, where :func:`set_learning_rate` rewrites
it, as ``optax.inject_hyperparams`` makes it mutable in JAX.
"""

from __future__ import annotations

import torch

#: optimizer families the JAX package builds; the port builds 'sgd'
OPTIMIZERS = ("sgd", "adam", "adamw", "rmsprop", "lars")


def divide_batches(n_samples: int, batch_size: int,
                   drop_remainder: bool = True) -> int:
    """Number of batches per epoch (the reference dropped ragged tails)."""
    if drop_remainder:
        return n_samples // batch_size
    return -(-n_samples // batch_size)


def scale_lr(lr: float, size: int, mode: str = "linear") -> float:
    """LR scaling with the worker count (the reference's ``scale_lr``)."""
    if mode == "linear":
        return lr * size
    if mode == "sqrt":
        return lr * (size ** 0.5)
    raise ValueError(f"unknown lr scaling mode {mode!r}")


def build_optimizer(params, learning_rate: float, optimizer: str = "sgd",
                    momentum: float = 0.0, nesterov: bool = False,
                    weight_decay: float = 0.0, **_unported
                    ) -> torch.optim.Optimizer:
    """The optimizer over ``params`` from plain hyperparameters (the
    keys of the JAX ``build_optimizer``; the adam/rmsprop/lars ones are
    accepted and unused, since only 'sgd' is ported)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"choose from {OPTIMIZERS}")
    if optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (ROADMAP.md "
            "section A, item 7); the port builds 'sgd'")
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Rewrite the learning rate of every param group in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float | None:
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None
