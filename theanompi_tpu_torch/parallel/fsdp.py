"""Fully sharded data parallelism: parameters and optimizer state 1/N a rank.

Counterpart of ``theanompi_tpu/parallel/fsdp.py``.  JAX commits every
parameter to a shard of the data axis and lets GSPMD insert the
gathers and reduce-scatters into a step written as plain global-batch
math.  The port writes them out, in PyTorch's flat-parameter idiom over
ZeRO's bucketed layout (parallel/zero.py ``FlatShard``): at rest each
rank holds its 1/N flat shard of the parameters (f32) and the optimizer
state of that shard, and nothing else of either (the module's
parameters are empty tensors).  The step all-gathers the parameters,
each into storage of its own, runs the forward and backward on the
rank's batch, reduce-scatters the gradients per bucket (from the
backward's hooks when ``exchange_buckets > 1``), updates the shard and
frees the gathered parameters and their gradients.  Gathering and
freeing layer by layer inside the forward, which lowers the peak, is
not done (ROADMAP.md).

The step's numbers are JAX's global-batch math:

* the gradient is the average over the ranks (the global batch mean's;
  'cdd' keeps the sum, JAX's ``grads * n``);
* the BN statistics are the global batch's: JAX's GSPMD step reduces
  ``xf.mean`` over the whole sharded batch (checked against its
  2-device step), so at more than one rank every ``BatchNormAct``
  averages its ``[mean, E[x^2]]`` over the ranks, forward and backward
  (``layers._MeanOverRanks``, what ``sync_bn`` does), and the running
  statistics, equal on every rank, are not averaged again.  The
  ``sync_bn`` knob itself is refused with FSDP, as in JAX;
* LARS takes each parameter's norms over the whole parameter: its one
  tensor is the flat shard, and :meth:`FlatShard.leaf_segments` tells it
  where each parameter's pieces lie (utils/helper_funcs.py ``LARS``).

There is no seam for the bf16 wire or error feedback here, as in JAX:
both are refused.  The random stream is each rank's own (the model's
epoch generator); JAX's step draws from one global key.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from theanompi_tpu_torch.parallel.bsp import (
    LossFn,
    TrainState,
    make_bsp_eval_step,
)
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger, world_size
from theanompi_tpu_torch.parallel.zero import (
    FlatShard,
    _ravel_bucketed,
    _shard_slice,
    _sharded_step,
    _unravel_bucketed,
)


def init_fsdp_state(module: nn.Module, make_optimizer,
                    exchange_buckets: int = 1) -> TrainState:
    """Shard the module's parameters (:class:`FlatShard` with ``fsdp``:
    the module keeps empty parameters) and build the optimizer over the
    shard, ``make_optimizer([shard])``, so the whole optimizer state
    never exists on any rank.  A LARS optimizer learns the shard's
    parameter segments."""
    from theanompi_tpu_torch.utils.helper_funcs import LARS

    shard = FlatShard(module, exchange_buckets, fsdp=True)
    optimizer = make_optimizer([shard.shard])
    if isinstance(optimizer, LARS):
        optimizer.shard_segments = shard.leaf_segments()
        optimizer.n_leaves = len(shard.params)
    return TrainState(module, optimizer, sharding=shard)


def global_batch_norm(module: nn.Module) -> None:
    """The BNs take the global batch's statistics (module docstring); at
    one rank the batch is the global batch and they stay as they are."""
    from theanompi_tpu_torch.models.layers import BatchNormAct

    if world_size() > 1:
        for m in module.modules():
            if isinstance(m, BatchNormAct):
                m.sync = True


def make_bsp_fsdp_step(loss_fn: LossFn,
                       exchanger: BSP_Exchanger | None = None,
                       accum: bool = False, multi: bool = False):
    """``step(state, batch, rng) -> metrics``: the FSDP step (module
    docstring) for a state :func:`init_fsdp_state` built at the same
    ``exchange_buckets``; ``accum`` and ``multi`` as
    ``zero.make_bsp_zero_step``.  The exchanger gives ``avg`` and the
    bucket count; the bf16 wire and error feedback are refused."""
    exchanger = exchanger or BSP_Exchanger()
    if exchanger.wire_dtype != "f32" or exchanger.error_feedback:
        raise ValueError(
            "fsdp_sharding's gradient collectives run at full precision; "
            "exchange_dtype='bf16'/error_feedback have no seam here — use "
            "zero_sharding or plain BSP for the compressed exchange")
    return _sharded_step(loss_fn, exchanger, accum, multi, fsdp=True,
                         prepare=global_batch_norm)


@contextlib.contextmanager
def full_params(state: TrainState | None, write_back: bool = False):
    """Inside, an FSDP state's module holds its whole parameters
    (gathered from every rank: every rank enters together); on the way
    out, with ``write_back``, the shard takes the parameters as they are
    then (a load), and they are freed again.  Any other state: nothing
    to do."""
    shard = getattr(state, "sharding", None)
    if not isinstance(shard, FlatShard) or not shard.fsdp:
        yield
        return
    shard.materialize()
    try:
        yield
        if write_back:
            shard.refresh()
    finally:
        shard.release()


def make_bsp_fsdp_eval_step(eval_fn):
    """``step(state, batch) -> metrics``: ``make_bsp_eval_step`` with the
    parameters gathered for the batch (JAX's eval step gathers them
    once per batch too)."""
    inner = make_bsp_eval_step(eval_fn)

    def step(state: TrainState, batch) -> dict:
        with full_params(state):
            return inner(state, batch)

    return step


def per_param_opt_state(state: TrainState) -> dict:
    """The shard optimizer's state as a plain BSP optimizer's state dict
    over the module's parameters (``parameters()`` order): each state
    tensor of the shard's length gathered from every rank and cut into
    whole parameters, any other entry (Adam's step) repeated per
    parameter.  Every rank calls it together."""
    shard = state.sharding
    sd = state.optimizer.state_dict()
    per = sd["state"].get(0, {})
    n_params = len(shard.params)
    leaves: dict = {}
    for key, v in per.items():
        if torch.is_tensor(v) and v.shape == shard.shard.shape:
            flat = shard.gather_flat(v)
            leaves[key] = [t.reshape(s) for t, s in zip(
                _unravel_bucketed(flat, shard.layout), shard.shapes)][::-1]
        else:
            leaves[key] = [v] * n_params
    groups = [{**g, "params": list(range(n_params))}
              for g in sd["param_groups"]]
    return {"state": {i: {k: leaves[k][i] for k in per}
                      for i in range(n_params)} if per else {},
            "param_groups": groups}


def load_per_param_opt_state(state: TrainState, saved: dict) -> None:
    """Load a plain-BSP-form optimizer state dict (:func:`per_param_opt_
    state`'s) into the shard optimizer: each per-parameter tensor
    raveled into the layout and this rank's shard taken."""
    shard = state.sharding
    n_params = len(shard.params)
    per = saved.get("state", {})
    if per and set(per) != set(range(n_params)):
        raise ValueError(f"opt_state holds state for parameters "
                         f"{sorted(per)}; this model has {n_params}")
    mine: dict = {}
    if per:
        for key in per[0]:
            vals = [per[i][key] for i in range(n_params)][::-1]
            if torch.is_tensor(vals[0]) and vals[0].dim() > 0:
                for v, s in zip(vals, shard.shapes):
                    if tuple(v.shape) != tuple(s):
                        raise ValueError(
                            f"opt_state[{key!r}] has a tensor of shape "
                            f"{tuple(v.shape)} for a parameter of {tuple(s)}")
                flat = _ravel_bucketed(
                    [v.to(shard.shard.device) for v in vals], shard.layout)
                mine[key] = _shard_slice(flat, shard.layout, shard.rank)
            else:
                mine[key] = vals[0]
    groups = [{**g, "params": [0]} for g in saved["param_groups"]]
    state.optimizer.load_state_dict(
        {"state": {0: mine} if mine else {}, "param_groups": groups})

