"""Weights across the two packages: flax trees -> the port's state_dict.

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

The networks whose port modules carry the flax scope names (AlexNet,
Cifar10, VGG16/19, GoogLeNet with its aux towers, and the BN variants
of AlexNet, VGG and GoogLeNet) map mechanically
(:func:`zoo_state_dict_from_flax`): a port module at ``a.b`` is the
flax scope ``a/b``; a :class:`~theanompi_tpu_torch.models.layers.Conv`
or ``Dense`` nests flax's own layer as ``Conv_0``/``Dense_0`` (kernel
HWIO ``(kh, kw, in/groups, out)`` -> OIHW ``(out, in/groups, kh, kw)``,
(in, out) -> (out, in)); a ``BatchNormAct`` named
``BatchNorm_k`` is the JAX ``layers.BatchNorm`` wrapper, whose
variables sit one scope deeper in ``BatchNorm_0`` (``scale``/``bias`` in
``params``, ``mean``/``var`` in ``batch_stats``).  A ``BiasAct_k``
takes its bias from ``BiasAct_k/bias`` in a tree built with
``bn_act_impl='pallas'``, or from the conv before it,
``Conv_k/Conv_0/bias``, in one built with ``'xla'`` (the tree holds no
``BiasAct`` scope then).

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

from torch import nn

from theanompi_tpu_torch.models import layers as L
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


def zoo_arrays_from_flax(module: nn.Module, params=None,
                         batch_stats=None) -> dict[str, np.ndarray]:
    """``{port state_dict name: numpy array}`` for ``module`` (a zoo
    network named by the flax scopes, module docstring) from a flax
    ``params``-shaped tree (weights or their gradients) and/or its
    ``batch_stats``: every parameter when ``params`` is given, every BN
    running statistic when ``batch_stats`` is.  The arrays are views
    (transposed kernels), not copies."""
    pool = {}
    if params is not None:
        pool.update({("params", k): v for k, v in _flatten(params).items()})
    if batch_stats is not None:
        pool.update({("batch_stats", k): v
                     for k, v in _flatten(batch_stats).items()})
    fused = any("BiasAct_" in path for _, path in pool)
    out: dict[str, np.ndarray] = {}
    for name, m in module.named_modules():
        scope = name.replace(".", "/")
        if isinstance(m, (L.Conv, L.Dense)) and params is not None:
            inner, perm = (("Conv_0", (3, 2, 0, 1)) if isinstance(m, L.Conv)
                           else ("Dense_0", (1, 0)))
            out[f"{name}.weight"] = _pop_leaf(
                pool, "params", f"{scope}/{inner}/kernel").transpose(perm)
            if m.bias is not None:
                out[f"{name}.bias"] = _pop_leaf(pool, "params",
                                                f"{scope}/{inner}/bias")
        elif isinstance(m, L.BiasAct) and params is not None:
            parent, _, leaf = scope.rpartition("/")
            conv = f"{parent}/Conv_{leaf.split('_')[-1]}".lstrip("/")
            out[f"{name}.bias"] = _pop_leaf(
                pool, "params",
                f"{scope}/bias" if fused else f"{conv}/Conv_0/bias")
        elif isinstance(m, L.BatchNormAct):
            for coll, names in (("params", ("scale", "bias")),
                                ("batch_stats", ("mean", "var"))):
                if (params if coll == "params" else batch_stats) is None:
                    continue
                for leaf in names:
                    out[f"{name}.{leaf}"] = _pop_leaf(
                        pool, coll, f"{scope}/BatchNorm_0/{leaf}")
    if pool:
        left = sorted(f"{c}/{p}" for c, p in pool)
        raise KeyError(f"{len(left)} flax leaves left unmapped: {left[:8]}")
    params_names = {n for n, _ in module.named_parameters()}
    expected = {n for n in module.state_dict()
                if (n in params_names and params is not None)
                or (n not in params_names and batch_stats is not None)}
    if set(out) != expected:
        raise KeyError("bridge keys differ from the module's state: "
                       f"{sorted(set(out) ^ expected)[:8]}")
    return out


def zoo_state_dict_from_flax(module: nn.Module, params=None,
                             batch_stats=None) -> dict[str, torch.Tensor]:
    """:func:`zoo_arrays_from_flax` as f32 tensors: with both trees, the
    module's whole ``state_dict``."""
    return _to_torch({}, zoo_arrays_from_flax(module, params, batch_stats))
