"""Weights across the two packages: flax trees -> the port's state_dict.

A JAX AlexNet's ``params`` map onto :class:`~theanompi_tpu_torch.models.
alex_net.AlexNetCNN` (:func:`alexnet_state_dict_from_flax`): the conv
kernels ``Conv_{i}/Conv_0/kernel`` go HWIO ``(kh, kw, in/groups, out)``
-> OIHW ``(out, in/groups, kh, kw)``, the dense kernels
``Dense_{i}/Dense_0/kernel`` go (in, out) -> (out, in), and the biases
map as they are.

A JAX TransformerLM's ``params`` map onto :class:`~theanompi_tpu_torch.
models.transformer.TransformerLMNet` (:func:`transformer_state_dict_from_
flax`): ``Embed_0/embedding`` and ``pos_emb`` as they are, each
``Block_i`` onto ``blocks.i`` (``LayerNorm_0``/``_1`` scale and bias, the
bias-free ``q/k/v/o_proj`` and the ``mlp_up``/``mlp_down`` kernels (in,
out) -> weights (out, in), with their biases), then the final
``LayerNorm_0`` and ``Dense_0``.

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


def _pop_leaf(pool: dict, coll: str, path: str) -> np.ndarray:
    try:
        return pool.pop((coll, path))
    except KeyError:
        raise KeyError(f"flax leaf {coll}/{path} is missing") from None


def _to_torch(pool: dict, out: dict) -> dict[str, torch.Tensor]:
    """``out`` as f32 tensors, once every leaf of ``pool`` was used."""
    if pool:
        left = sorted(f"{c}/{p}" for c, p in pool)
        raise KeyError(f"{len(left)} flax leaves left unmapped: {left[:8]}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in out.items()}


def alexnet_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """The port's AlexNet ``state_dict`` (f32 tensors) from a flax
    AlexNet's ``params``-shaped tree (weights, their gradients, or
    weights after an update)."""
    from theanompi_tpu_torch.models.alex_net import CONVS

    pool = {("params", k): v for k, v in _flatten(params).items()}
    out: dict[str, np.ndarray] = {}
    scopes = ([(c[0], "Conv_0", (3, 2, 0, 1)) for c in CONVS]
              + [(f"Dense_{i}", "Dense_0", (1, 0)) for i in range(3)])
    for scope, inner, perm in scopes:
        out[f"{scope}.weight"] = _pop_leaf(
            pool, "params", f"{scope}/{inner}/kernel").transpose(perm)
        out[f"{scope}.bias"] = _pop_leaf(pool, "params",
                                         f"{scope}/{inner}/bias")
    return _to_torch(pool, out)


def transformer_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """The port's TransformerLMNet ``state_dict`` (f32 tensors) from a
    flax TransformerLMNet's ``params``-shaped tree (weights, their
    gradients, or weights after an update)."""
    pool = {("params", k): v for k, v in _flatten(params).items()}
    n_layers = len({k.split("/")[0] for _, k in pool
                    if k.startswith("Block_")})
    out: dict[str, np.ndarray] = {
        "Embed_0.embedding": _pop_leaf(pool, "params", "Embed_0/embedding"),
        "pos_emb": _pop_leaf(pool, "params", "pos_emb")}

    def dense(port: str, scope: str, bias: bool) -> None:
        out[f"{port}.weight"] = _pop_leaf(pool, "params",
                                          f"{scope}/kernel").T
        if bias:
            out[f"{port}.bias"] = _pop_leaf(pool, "params", f"{scope}/bias")

    def norm(port: str, scope: str) -> None:
        for name in ("scale", "bias"):
            out[f"{port}.{name}"] = _pop_leaf(pool, "params",
                                              f"{scope}/{name}")

    for i in range(n_layers):
        scope, port = f"Block_{i}", f"blocks.{i}"
        norm(f"{port}.LayerNorm_0", f"{scope}/LayerNorm_0")
        norm(f"{port}.LayerNorm_1", f"{scope}/LayerNorm_1")
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{port}.{name}", f"{scope}/{name}", bias=False)
        for name in ("mlp_up", "mlp_down"):
            dense(f"{port}.{name}", f"{scope}/{name}", bias=True)
    norm("LayerNorm_0", "LayerNorm_0")
    dense("Dense_0", "Dense_0", bias=True)
    return _to_torch(pool, out)


def _from_flax(module: ResNet, params, batch_stats) -> dict:
    pool = {}
    if params is not None:
        pool.update({("params", k): v for k, v in _flatten(params).items()})
    if batch_stats is not None:
        pool.update({("batch_stats", k): v
                     for k, v in _flatten(batch_stats).items()})

    def take(coll: str, path: str) -> np.ndarray:
        return _pop_leaf(pool, coll, path)

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
    return _to_torch(pool, out)
