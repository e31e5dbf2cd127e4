"""Weights across the two packages: flax trees -> the port's state_dict.

A JAX ResNet's ``params`` and ``batch_stats`` (nested dicts of numpy
arrays) map leaf by leaf onto :class:`~theanompi_tpu_torch.models.
resnet50.ResNet`:

* conv kernels ``<scope>/Conv_0/kernel`` go HWIO -> OIHW (the layer
  wrappers nest flax's own module one level deeper);
* the dense kernel ``Dense_0/Dense_0/kernel`` goes (in, out) -> (out, in);
* each BN takes ``scale``/``bias`` from ``params`` and ``mean``/``var``
  from ``batch_stats``.  Inside a block the BN names follow creation
  order, so with a projection ``BatchNorm_0`` is the projection's BN
  and the main BNs are ``BatchNorm_1..3``.

Every leaf must be used exactly once: a missing or a leftover leaf
raises ``KeyError``.  :func:`params_from_flax` maps a ``params``-shaped
tree alone (weights, or their gradients, or weights after an update)
onto the port's parameter names, and :func:`batch_stats_from_flax` the
``batch_stats`` alone onto its buffer names.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from theanompi_tpu_torch.models.resnet50 import ResNet


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def resnet_layers(module: ResNet) -> Iterator[tuple[str, str, str]]:
    """(port prefix, flax scope, kind) for every weighted layer."""
    yield "stem_conv", "stem_conv", "conv"
    yield "stem_bn", "stem_bn", "bn"
    for i, blk in enumerate(module.blocks):
        scope = f"BottleneckBlock_{i}"
        first_bn = 0
        if blk.proj_conv is not None:
            yield f"blocks.{i}.proj_conv", f"{scope}/proj_conv", "conv"
            yield f"blocks.{i}.proj_bn", f"{scope}/BatchNorm_0", "bn"
            first_bn = 1
        for j in range(3):
            yield f"blocks.{i}.conv{j}", f"{scope}/Conv_{j}", "conv"
            yield (f"blocks.{i}.bn{j}", f"{scope}/BatchNorm_{first_bn + j}",
                   "bn")
    yield "head", "Dense_0", "dense"


def state_dict_from_flax(module: ResNet, params,
                         batch_stats) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (f32 tensors) for ``module`` from a
    flax ResNet's ``params`` and ``batch_stats``."""
    out = _from_flax(module, params, batch_stats)
    expected = set(module.state_dict())
    if set(out) != expected:
        raise KeyError("bridge keys differ from the module's state_dict: "
                       f"{sorted(set(out) ^ expected)[:8]}")
    return out


def params_from_flax(module: ResNet, params) -> dict[str, torch.Tensor]:
    """``{parameter name: f32 tensor}`` for every parameter of
    ``module`` from a flax ``params``-shaped tree (weights or their
    gradients)."""
    out = _from_flax(module, params, None)
    expected = {name for name, _ in module.named_parameters()}
    if set(out) != expected:
        raise KeyError("bridge keys differ from the module's parameters: "
                       f"{sorted(set(out) ^ expected)[:8]}")
    return out


def batch_stats_from_flax(module: ResNet,
                          batch_stats) -> dict[str, torch.Tensor]:
    """``{buffer name: f32 tensor}`` (every BN's ``mean``/``var``) from
    a flax ``batch_stats`` tree."""
    return _from_flax(module, None, batch_stats)


def _from_flax(module: ResNet, params, batch_stats) -> dict:
    pool = {}
    if params is not None:
        pool.update({("params", k): v for k, v in _flatten(params).items()})
    if batch_stats is not None:
        pool.update({("batch_stats", k): v
                     for k, v in _flatten(batch_stats).items()})

    def take(coll: str, path: str) -> np.ndarray:
        try:
            return pool.pop((coll, path))
        except KeyError:
            raise KeyError(f"flax leaf {coll}/{path} is missing") from None

    out: dict[str, np.ndarray] = {}
    for prefix, scope, kind in resnet_layers(module):
        if params is None:
            if kind == "bn":
                for name in ("mean", "var"):
                    out[f"{prefix}.{name}"] = take("batch_stats",
                                                   f"{scope}/{name}")
        elif kind == "conv":
            out[f"{prefix}.weight"] = take(
                "params", f"{scope}/Conv_0/kernel").transpose(3, 2, 0, 1)
        elif kind == "bn":
            for name in ("scale", "bias"):
                out[f"{prefix}.{name}"] = take("params", f"{scope}/{name}")
            if batch_stats is not None:
                for name in ("mean", "var"):
                    out[f"{prefix}.{name}"] = take("batch_stats",
                                                   f"{scope}/{name}")
        else:
            out[f"{prefix}.weight"] = take(
                "params", f"{scope}/Dense_0/kernel").T
            out[f"{prefix}.bias"] = take("params", f"{scope}/Dense_0/bias")
    if pool:
        left = sorted(f"{c}/{p}" for c, p in pool)
        raise KeyError(f"{len(left)} flax leaves left unmapped: {left[:8]}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in out.items()}
