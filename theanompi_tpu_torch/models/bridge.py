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

A :class:`~theanompi_tpu_torch.models.layers.ConvTranspose` at ``a.b``
is flax's ``nn.ConvTranspose`` at ``a/b`` itself (no inner scope): its
``(kh, kw, in, out)`` kernel is flipped on (kh, kw) and permuted to the
port's ``(in, out, kh, kw)`` weight, and its bias is taken as it is.  So
the WGAN's ``nn.ModuleDict`` of ``generator`` and ``critic`` maps onto
JAX's ``{"generator": ..., "critic": ...}`` parameter tree.

Every leaf must be used exactly once: a missing or a leftover leaf
raises ``KeyError``.  :func:`params_from_flax` maps a ``params``-shaped
tree alone (weights, or their gradients, or weights after an update)
onto the port's parameter names, and :func:`batch_stats_from_flax` the
``batch_stats`` alone onto its buffer names.

The other way, :func:`flax_params` turns any port network's parameters
into the flax-named ``params`` tree of numpy f32 arrays that the JAX
model of the same configuration holds (kernels back in HWIO, ``(in,
out)`` and flax's transposed-conv layouts), and :func:`module_params_
from_flax` takes such a tree back to ``{parameter name: tensor}``; both
pick the ResNet, TransformerLM or scope-named mapping by the module's
class.  Parameters only, as the JAX contract's npz snapshots hold them
(never ``batch_stats``), and each refuses a missing or leftover name.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from torch import nn

from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.resnet50 import ResNet
from theanompi_tpu_torch.utils.helper_funcs import nest_paths


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


#: flax layout -> port layout of each kind of leaf (numpy views)
_FROM_FLAX = {
    "conv": lambda a: a.transpose(3, 2, 0, 1),          # HWIO -> OIHW
    "dense": lambda a: a.transpose(1, 0),               # (in, out) -> OI
    "conv_t": lambda a: np.flip(a, (0, 1)).transpose(2, 3, 0, 1),
    "same": lambda a: a,
}
#: port layout -> flax layout, the inverse of each
_TO_FLAX = {
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "dense": lambda a: a.transpose(1, 0),
    "conv_t": lambda a: np.flip(a.transpose(2, 3, 0, 1), (0, 1)),
    "same": lambda a: a,
}


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


def _transformer_param_leaves(n_layers: int):
    """``(port parameter name, flax params path, layout)`` of every
    parameter of an ``n_layers`` TransformerLMNet (module docstring)."""
    yield "Embed_0.embedding", "Embed_0/embedding", "same"
    yield "pos_emb", "pos_emb", "same"

    def dense(port: str, scope: str, bias: bool):
        yield f"{port}.weight", f"{scope}/kernel", "dense"
        if bias:
            yield f"{port}.bias", f"{scope}/bias", "same"

    def norm(port: str, scope: str):
        for name in ("scale", "bias"):
            yield f"{port}.{name}", f"{scope}/{name}", "same"

    for i in range(n_layers):
        scope, port = f"Block_{i}", f"blocks.{i}"
        yield from norm(f"{port}.LayerNorm_0", f"{scope}/LayerNorm_0")
        yield from norm(f"{port}.LayerNorm_1", f"{scope}/LayerNorm_1")
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield from dense(f"{port}.{name}", f"{scope}/{name}", False)
        for name in ("mlp_up", "mlp_down"):
            yield from dense(f"{port}.{name}", f"{scope}/{name}", True)
    yield from norm("LayerNorm_0", "LayerNorm_0")
    yield from dense("Dense_0", "Dense_0", True)


def transformer_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """The port's TransformerLMNet ``state_dict`` (f32 tensors) from a
    flax TransformerLMNet's ``params``-shaped tree (weights, their
    gradients, or weights after an update)."""
    pool = {("params", k): v for k, v in _flatten(params).items()}
    n_layers = len({k.split("/")[0] for _, k in pool
                    if k.startswith("Block_")})
    return _to_torch(pool, {
        port: _FROM_FLAX[layout](_pop_leaf(pool, "params", path))
        for port, path, layout in _transformer_param_leaves(n_layers)})


def _resnet_param_leaves(module: ResNet):
    """``(port parameter name, flax params path, layout)`` of every
    parameter of a ResNet (module docstring)."""
    for prefix, scope, kind in resnet_layers(module):
        if kind == "conv":
            yield f"{prefix}.weight", f"{scope}/Conv_0/kernel", "conv"
        elif kind == "bn":
            for name in ("scale", "bias"):
                yield f"{prefix}.{name}", f"{scope}/{name}", "same"
        else:
            yield f"{prefix}.weight", f"{scope}/Dense_0/kernel", "dense"
            yield f"{prefix}.bias", f"{scope}/Dense_0/bias", "same"


def _from_flax(module: ResNet, params, batch_stats) -> dict:
    pool = {}
    if params is not None:
        pool.update({("params", k): v for k, v in _flatten(params).items()})
    if batch_stats is not None:
        pool.update({("batch_stats", k): v
                     for k, v in _flatten(batch_stats).items()})
    out: dict[str, np.ndarray] = {}
    if params is not None:
        for port, path, layout in _resnet_param_leaves(module):
            out[port] = _FROM_FLAX[layout](_pop_leaf(pool, "params", path))
    if batch_stats is not None:
        for prefix, scope, kind in resnet_layers(module):
            if kind == "bn":
                for name in ("mean", "var"):
                    out[f"{prefix}.{name}"] = _pop_leaf(
                        pool, "batch_stats", f"{scope}/{name}")
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
        if params is not None:
            for port, path, layout in _zoo_param_leaves(name, m, fused):
                out[port] = _FROM_FLAX[layout](
                    _pop_leaf(pool, "params", path))
        if isinstance(m, L.BatchNormAct) and batch_stats is not None:
            for leaf in ("mean", "var"):
                out[f"{name}.{leaf}"] = _pop_leaf(
                    pool, "batch_stats", f"{scope}/BatchNorm_0/{leaf}")
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


def _zoo_param_leaves(name: str, m: nn.Module, fused: bool):
    """``(port parameter name, flax params path, layout)`` of the
    parameters that module ``m`` at ``name`` owns itself (module
    docstring's scope rules); ``fused``: the flax tree was built with
    ``bn_act_impl='pallas'`` (``BiasAct`` scopes of its own)."""
    scope = name.replace(".", "/")
    if isinstance(m, (L.Conv, L.Dense)):
        inner, layout = (("Conv_0", "conv") if isinstance(m, L.Conv)
                         else ("Dense_0", "dense"))
        yield f"{name}.weight", f"{scope}/{inner}/kernel", layout
        if m.bias is not None:
            yield f"{name}.bias", f"{scope}/{inner}/bias", "same"
    elif isinstance(m, L.ConvTranspose):
        yield f"{name}.weight", f"{scope}/kernel", "conv_t"
        if m.bias is not None:
            yield f"{name}.bias", f"{scope}/bias", "same"
    elif isinstance(m, L.BiasAct):
        parent, _, leaf = scope.rpartition("/")
        conv = f"{parent}/Conv_{leaf.split('_')[-1]}".lstrip("/")
        yield (f"{name}.bias",
               f"{scope}/bias" if fused else f"{conv}/Conv_0/bias", "same")
    elif isinstance(m, L.BatchNormAct):
        for leaf in ("scale", "bias"):
            yield f"{name}.{leaf}", f"{scope}/BatchNorm_0/{leaf}", "same"


def _is_transformer(module: nn.Module) -> bool:
    from theanompi_tpu_torch.models.transformer import TransformerLMNet

    return isinstance(module, TransformerLMNet)


def _param_leaves(module: nn.Module, fused: bool):
    """``(port parameter name, flax params path, layout)`` of every
    parameter of ``module``, by its family (module docstring)."""
    if isinstance(module, ResNet):
        return _resnet_param_leaves(module)
    if _is_transformer(module):
        return _transformer_param_leaves(len(module.blocks))
    return (leaf for name, m in module.named_modules()
            for leaf in _zoo_param_leaves(name, m, fused))


def flax_params(module: nn.Module, fused: bool = False) -> dict:
    """``module``'s parameters as the JAX model's flax ``params`` tree:
    nested dicts of f32 numpy arrays in flax's layouts; ``fused`` places
    a BN-free zoo member's conv biases as a tree built with
    ``bn_act_impl='pallas'`` holds them (``BiasAct_k/bias``), else in the
    conv before each.  Every parameter is used once."""
    pool = {n: p.detach().float().cpu().numpy()
            for n, p in module.named_parameters()}
    leaves = []
    for port, path, layout in _param_leaves(module, fused):
        try:
            leaf = pool.pop(port)
        except KeyError:
            raise KeyError(f"port parameter {port} is missing") from None
        leaves.append((path, np.ascontiguousarray(_TO_FLAX[layout](leaf))))
    if pool:
        raise KeyError(f"{len(pool)} port parameters left unmapped: "
                       f"{sorted(pool)[:8]}")
    return nest_paths(leaves)


def module_params_from_flax(module: nn.Module,
                            params) -> dict[str, torch.Tensor]:
    """``{parameter name: f32 tensor}`` of ``module`` from a flax
    ``params`` tree (:func:`flax_params` inverted; a zoo tree of either
    ``bn_act_impl``).  Every leaf must be used once and every parameter
    covered."""
    pool = {("params", k): v for k, v in _flatten(params).items()}
    fused = any("BiasAct_" in path for _, path in pool)
    out = {port: _FROM_FLAX[layout](_pop_leaf(pool, "params", path))
           for port, path, layout in _param_leaves(module, fused)}
    names = {n for n, _ in module.named_parameters()}
    if set(out) != names:
        raise KeyError("bridge keys differ from the module's parameters: "
                       f"{sorted(set(out) ^ names)[:8]}")
    return _to_torch(pool, out)
