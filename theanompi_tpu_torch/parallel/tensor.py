"""Tensor parallelism over the mesh's ``model`` axis (Megatron's pair).

Counterpart of ``theanompi_tpu/parallel/tensor.py``.  JAX annotates the
parameter shardings and lets GSPMD insert the collectives; the port
writes them by hand, as Megatron's two conjugate autograd functions over
the ``model`` group (an ``AxisGroup`` of parallel/mesh.py):

* :func:`copy_to_model`: identity forward, all-reduce backward, before
  the column-parallel products (``q/k/v_proj``, ``mlp_up``): each rank
  feeds the whole activation to its column block, and the activation's
  gradient is the sum of every block's;
* :func:`reduce_from_model`: all-reduce forward, identity backward,
  after the row-parallel products (``o_proj``, ``mlp_down``): each rank
  holds a partial sum over its row block.

:func:`transformer_tp_specs` is JAX's rule over the port's parameter
names: the dimension of each block parameter cut over ``model`` (the
port's weights are ``(out, in)``, flax's kernels ``(in, out)``), None
for the replicated ones.  The ``mlp_down`` bias stays whole and is added
once, after the all-reduce.

The data-axis side needs nothing new: the replicated parameters'
gradients come out equal on every ``model`` rank (the backward all-reduce
of :func:`copy_to_model` gives each rank the whole activation gradient),
so the BSP exchange over the ``data`` group (parallel/bsp.py) is the
step; its 'avg' is JAX's global-batch mean gradient and its 'cdd' sum is
JAX's ``grad_scale = data_axis_size`` (``_gspmd_step``), the stacked
cadence (``steps_per_call``) is the BSP multi step, and the optimizer is
built from the sharded parameters (JAX's ``shard_train_state``): no rank
ever holds a whole momentum buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: column-parallel projections (output dim over ``model``)
COLUMN = ("q_proj", "k_proj", "v_proj", "mlp_up")
#: row-parallel projections (input dim over ``model``)
ROW = ("o_proj", "mlp_down")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=tp.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``tp`` (none issued
    over one rank)."""
    return x if tp is None or tp.trivial else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """All-reduce forward over ``tp``, identity backward (none issued
    over one rank)."""
    return x if tp is None or tp.trivial else _ReduceFromModel.apply(x, tp)


def transformer_tp_specs(names) -> dict[str, int | None]:
    """``{parameter name: dim cut over 'model' or None}`` for the port's
    TransformerLMNet names (JAX's Megatron rules): inside a block the
    column-parallel weights ``(out, in)`` and biases are cut on dim 0,
    the row-parallel weights on dim 1 (their biases whole); embeddings,
    norms, the positional table and the head stay whole."""
    out = {}
    for name in names:
        parts = name.split(".")
        dim = None
        if parts[0] == "blocks" and len(parts) == 4:
            layer, leaf = parts[2], parts[3]
            if layer in COLUMN:
                dim = 0
            elif layer in ROW and leaf == "weight":
                dim = 1
        out[name] = dim
    return out
