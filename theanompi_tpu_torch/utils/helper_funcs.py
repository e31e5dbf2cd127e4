"""Batch division, learning-rate scaling, the optimizers and the npz
parameter snapshots.

Counterpart of ``theanompi_tpu/utils/helper_funcs.py``: the five optax
chains the JAX ``build_optimizer`` makes, step for step, and its
``save_params_npz``/``load_params_npz`` format (one npz member per leaf
of a nested dict of arrays, named by its key path joined with ``/``, in
the order ``jax.tree_util`` flattens a dict: sorted keys, depth first).

* 'sgd' is ``torch.optim.SGD``: with ``weight_decay`` it adds ``wd * p``
  to each gradient before the momentum trace, exactly the optax chain
  ``add_decayed_weights -> sgd(momentum, nesterov)`` (coupled decay on
  every parameter);
* 'adam' is ``torch.optim.Adam``, whose ``weight_decay`` is the same
  coupled ``add_decayed_weights -> adam`` (bias-corrected moments, eps
  outside the square root);
* 'adamw' is ``torch.optim.AdamW``, ``optax.adamw``'s update: Adam's
  moments plus the decoupled decay ``lr * wd * p`` on every parameter;
* 'rmsprop' is :class:`RMSprop`, ``add_decayed_weights -> optax.rmsprop``
  as the JAX package builds it: eps INSIDE the square root
  (``g * rsqrt(nu + eps)``, nu starting at 0), then the learning rate,
  then, with momentum, the trace of the LR-scaled updates.
  ``torch.optim.RMSprop`` puts eps outside the root and keeps its buffer
  before the LR, which drifts from optax once the LR changes;
* 'lars' is :class:`LARS`, ``optax.lars``: decay on every parameter,
  the per-parameter trust ratio ``tc * |p| / |g + wd p|`` (1 where
  either norm is 0), the learning rate, then the trace (momentum,
  nesterov) of the LR-scaled updates.  PyTorch has none.

The learning rate lives in the optimizer's param groups, where
:func:`set_learning_rate` rewrites it, as ``optax.inject_hyperparams``
makes it mutable in JAX.  The state of the two written out here is
named per parameter (``square_avg``, ``momentum_buffer``), so
``state_dict()`` round-trips through the checkpoints.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

#: optimizer families the JAX package builds (all ported)
OPTIMIZERS = ("sgd", "adam", "adamw", "rmsprop", "lars")


class RMSprop(torch.optim.Optimizer):
    """``add_decayed_weights(wd) -> optax.rmsprop(lr, decay, eps,
    momentum)`` (module docstring), per parameter:
    ``u = g + wd p``; ``nu = (1 - decay) u^2 + decay nu``;
    ``u = -lr u rsqrt(nu + eps)``; with momentum ``m = u + momentum m``,
    ``u = m``; ``p += u``."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            momentum, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    if momentum:
                        state["momentum_buffer"] = torch.zeros_like(p)
                u = p.grad + wd * p if wd else p.grad
                nu = state["square_avg"]
                nu.mul_(decay).add_((1 - decay) * (u * u))
                u = u * torch.rsqrt(nu + eps) * (-lr)
                if momentum:
                    buf = state["momentum_buffer"]
                    buf.mul_(momentum).add_(u)
                    u = buf
                p.add_(u)
        return loss


class LARS(torch.optim.Optimizer):
    """``optax.lars(lr, weight_decay, trust_coefficient, eps=0,
    momentum, nesterov)`` (module docstring), per parameter:
    ``u = g + wd p``; ``u = u * r`` with ``r = tc |p| / |u|``, or 1 where
    ``|p|`` or ``|u|`` is 0; ``u = -lr u``; ``m = u + momentum m``;
    ``u = m`` (nesterov: ``u + momentum m``); ``p += u``.  The norms are
    per parameter tensor, as optax's are per leaf.

    Under FSDP (parallel/fsdp.py) the one tensor is this rank's flat
    shard, and ``shard_segments`` (``(lo, hi, leaf, whole)`` per piece of
    a parameter in the shard) with ``n_leaves`` keep the norms per
    parameter: a piece that is a whole parameter gives its norm as a
    plain parameter would, a piece of one that other ranks share gives
    its sum of squares; one all-reduce sums the vector of both over the
    ranks, the shared ones take their square root, and each element is
    scaled by its parameter's ratio (pads by 1)."""

    #: the FSDP shard's parameter pieces, and the parameter count
    shard_segments: list | None = None
    n_leaves: int = 0

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001):
        super().__init__(params, dict(
            lr=lr, momentum=momentum, nesterov=nesterov,
            weight_decay=weight_decay, trust_coefficient=trust_coefficient))

    def _shard_norms(self, p: torch.Tensor, u: torch.Tensor):
        """Per-parameter norms of the flat shard ``p`` and its update
        ``u``, over every rank (class docstring); also each element's
        parameter index (``n_leaves`` for a pad)."""
        segs, n = self.shard_segments, self.n_leaves
        vec = p.new_zeros(2 * n)
        whole = [(lo, hi, i) for lo, hi, i, w in segs if w]
        shared = [(lo, hi, i) for lo, hi, i, w in segs if not w]
        if whole:
            # each piece copied into storage of its own, so the norm
            # sums in a plain parameter's order
            idx = torch.tensor([i for _, _, i in whole], device=p.device)
            vec[idx] = torch.stack(torch._foreach_norm(
                [p[lo:hi].clone() for lo, hi, _ in whole]))
            vec[idx + n] = torch.stack(torch._foreach_norm(
                [u[lo:hi].clone() for lo, hi, _ in whole]))
        for lo, hi, i in shared:
            vec[i] = p[lo:hi].square().sum()
            vec[i + n] = u[lo:hi].square().sum()
        if dist.is_initialized():
            dist.all_reduce(vec)
        if shared:
            idx = torch.tensor([i for _, _, i in shared], device=p.device)
            idx = torch.cat([idx, idx + n])
            vec[idx] = vec[idx].sqrt()
        leaf = torch.full(p.shape, n, dtype=torch.long, device=p.device)
        for lo, hi, i, _ in segs:
            leaf[lo:hi] = i
        return vec[:n], vec[n:], leaf

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, momentum = group["lr"], group["momentum"]
            wd, tc = group["weight_decay"], group["trust_coefficient"]
            us = [p.grad + wd * p for p in params]
            if self.shard_segments is not None:
                p_norm, u_norm, leaf = self._shard_norms(params[0], us[0])
            else:
                p_norm = torch.stack(torch._foreach_norm(params))
                u_norm = torch.stack(torch._foreach_norm(us))
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm),
                                tc * p_norm / u_norm)
            if self.shard_segments is not None:
                ratio = torch.cat([ratio, ratio.new_ones(1)])[leaf][None]
            for p, u, r in zip(params, us, ratio.unbind()):
                state = self.state[p]
                if not state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                u = u * r * (-lr)
                buf = state["momentum_buffer"]
                buf.mul_(momentum).add_(u)
                p.add_(u + momentum * buf if group["nesterov"] else buf)
        return loss


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
                    weight_decay: float = 0.0, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    rmsprop_decay: float = 0.9,
                    lars_trust_coefficient: float = 0.001
                    ) -> torch.optim.Optimizer:
    """The optimizer over ``params`` from plain hyperparameters (the
    keys of the JAX ``build_optimizer``; module docstring).  Weight decay
    is coupled (added to the gradients) for sgd, adam and rmsprop, and
    applied by adamw and lars themselves."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"choose from {OPTIMIZERS}")
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(beta1, beta2), eps=eps,
                                weight_decay=weight_decay)
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(beta1, beta2), eps=eps,
                                 weight_decay=weight_decay)
    if optimizer == "rmsprop":
        return RMSprop(params, lr=learning_rate, decay=rmsprop_decay,
                       eps=eps, momentum=momentum,
                       weight_decay=weight_decay)
    if optimizer == "lars":
        return LARS(params, lr=learning_rate, momentum=momentum,
                    nesterov=nesterov, weight_decay=weight_decay,
                    trust_coefficient=lars_trust_coefficient)
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Rewrite the learning rate of every param group in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float | None:
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None


# -- npz parameter snapshots (the JAX package's format) --


def _flat_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(key path, leaf)`` of a nested dict, keys sorted at each level
    (``jax.tree_util``'s dict order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flat_leaves(v, path + "/"))
        else:
            out.append((path, v))
    return out


def nest_paths(leaves) -> dict:
    """``(key path, leaf)`` pairs, the path's keys joined with ``/``, as a
    nested dict."""
    tree: dict = {}
    for path, leaf in leaves:
        *scopes, last = path.split("/")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[last] = leaf
    return tree


def save_params_npz(path: str, params: dict) -> None:
    """Write a nested dict of arrays as the JAX ``save_params_npz`` does:
    one member per leaf, named by its ``/``-joined key path."""
    flat = {k: np.asarray(v) for k, v in _flat_leaves(params)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str, like: dict) -> dict:
    """The nested dict of numpy arrays shaped as ``like``, read from an
    npz of :func:`save_params_npz`'s form; each leaf is cast to ``like``'s
    dtype.  A member ``like`` lacks is ignored, a missing one raises
    ``KeyError`` and a shape that differs ``ValueError`` (JAX's
    ``load_params_npz``)."""
    out = []
    with np.load(path) as data:
        for key, leaf in _flat_leaves(like):
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} "
                                 f"vs {leaf.shape}")
            out.append((key, arr.astype(leaf.dtype)))
    return nest_paths(out)
