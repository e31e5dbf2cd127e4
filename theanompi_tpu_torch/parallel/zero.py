"""ZeRO-1 data parallelism: the optimizer state sharded over the ranks.

Counterpart of ``theanompi_tpu/parallel/zero.py``.  Plain BSP keeps the
whole optimizer state (momentum, Adam's moments) on every rank; ZeRO-1
keeps 1/N of it on each of N ranks:

    grads  --reduce_scatter-->  this rank's 1/N gradient shard
    update of this rank's 1/N parameter shard (the optimizer's tensor)
    params <--all_gather----    every rank's updated shard

One process per card, each collective written out over
``torch.distributed`` (NCCL on the card, gloo on the CPU).  The
collective volume is one all-reduce's, and the update is the plain
BSP step's for the elementwise optimizers (sgd, adam, adamw, rmsprop);
LARS is layerwise and is refused (models/base.py; a flat shard has no
layer boundaries to take its norms over).

**The flat layout** (:class:`_ZeroLayout`, JAX's).  The parameters, in
the order the backward completes them (:func:`layout_params`: the
reverse of ``module.parameters()``, the order :class:`BucketedBackward`
plans in; JAX flattens flax's tree instead, so the tests compare per
parameter, each side unravelled by its own layout), are cut into
``exchange_buckets`` contiguous buckets balanced by size
(``bucket_ranges``).  Each bucket's f32 segment is padded to a multiple
of N and rank r owns piece r of every segment; its shard is the
concatenation of those pieces.  The last bucket of a bucketed layout
carries ``N * B^2`` more zeros (JAX's B-encoding pad), so the shard's
length rises strictly with the bucket count and a checkpoint resumed
under another ``exchange_buckets`` (or world size) fails on shape
instead of applying momentum to the wrong parameters.  Pad elements
stay zero: zero parameters, gradients and optimizer state.

**The step** (:func:`make_bsp_zero_step`).  Forward and backward on the
rank's batch; then each bucket's gradient segment is reduce-scattered
in f32.  On the bf16 wire each rank quantizes its segment, sends piece
r to rank r with ``all_to_all_single`` and sums the N pieces it receives
in f32: a bf16 reduce-scatter would round every partial sum to bf16 and
swallow the corrections error feedback puts back (JAX's ``zero.py``
says the same).  With error feedback the residual is this rank's flat
``(total_flat,)`` f32 vector (:func:`init_zero_exchange_residual`):
``bf16(g + r)`` goes on the wire and ``r`` becomes ``(g + r) -
bf16(g + r)``.  The shard is averaged (``avg``) or summed ('cdd'), the
BN running statistics are averaged over the ranks as in BSP, the
optimizer steps on the shard, and ``all_gather_into_tensor`` writes
every rank's shard back into the parameters.  With ``exchange_buckets >
1`` each bucket's collective starts from the backward's gradient hooks
as soon as its gradients are complete (:class:`BucketedBackward` with
this layout's plan, in plan order on every rank).  Accumulation
(``accum``) scatters once after the last microbatch, as JAX does;
``multi`` runs one full step per batch (``steps_per_call``).

At one rank and at two, on the f32 wire, the step is bit-identical to
the plain BSP step (a sum of one or two terms has one order), which the
tests and ``chip_smoke.py`` phase 20 pin.  The parallel/fsdp.py step is
this one with the parameters sharded too (:class:`FlatShard`'s
``fsdp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from theanompi_tpu_torch.parallel.bsp import (
    LossFn,
    TrainState,
    accumulate_microbatch_grads,
    apply_update,
    grad_and_metrics,
    mean_metrics,
    running_stats,
)
from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger,
    BucketedBackward,
    _Pending,
    all_reduce_mean,
    bucket_ranges,
    emit_bucket_gauges,
    issues,
    validate_bucket_count,
    world_size,
    zero_missing_grads,
)


def _elems(tensors) -> tuple[int, ...]:
    """Element counts of tensors (or the counts themselves)."""
    return tuple(int(t.numel()) if isinstance(t, torch.Tensor) else int(t)
                 for t in tensors)


def _flat_info(tensors, n_shards: int) -> tuple[int, int, int]:
    """(total, pad, per_shard) of the one-bucket flat vector."""
    total = sum(_elems(tensors))
    pad = (-total) % n_shards
    return total, pad, (total + pad) // n_shards


@dataclasses.dataclass(frozen=True)
class _ZeroLayout:
    """The bucketed flat layout: a pure function of (leaf sizes,
    n_shards, exchange_buckets), the same on every rank.  Bucket b owns
    leaves ``ranges[b]``: ``m[b]`` elements padded by ``pad[b]`` to
    segment ``seg[b]`` (a multiple of n_shards); its per-shard piece is
    ``pb[b] = seg[b] // n`` at offset ``shard_off[b]`` in the shard and
    ``flat_off[b]`` in the bucketed flat vector.  One bucket is the
    plain flat layout padded to a multiple of n."""

    ranges: tuple          # ((lo, hi) leaf index ranges)
    leaf_elems: tuple      # element count per leaf, layout order
    m: tuple               # real elements per bucket
    pad: tuple             # pad elements per bucket
    seg: tuple             # m + pad (multiple of n)
    pb: tuple              # per-shard piece per bucket
    flat_off: tuple        # bucket offset in the bucketed flat vector
    shard_off: tuple       # bucket offset in the per-shard vector
    per_shard: int         # sum(pb)
    total_flat: int        # sum(seg)


def _zero_layout(tensors, n_shards: int,
                 exchange_buckets: int = 1) -> _ZeroLayout:
    """The layout of ``tensors`` (or their element counts), in order."""
    validate_bucket_count(exchange_buckets)
    elems = _elems(tensors)
    ranges = tuple(bucket_ranges(elems, exchange_buckets))
    m = tuple(sum(elems[lo:hi]) for lo, hi in ranges)
    pad = tuple((-mb) % n_shards for mb in m)
    if len(ranges) > 1:
        # the B-encoding pad (module docstring): natural pads sum to less
        # than n*B, and n*(B'^2 - B^2) exceeds that for every B' > B
        pad = pad[:-1] + (pad[-1] + n_shards * len(ranges) ** 2,)
    seg = tuple(mb + pb for mb, pb in zip(m, pad))
    pb = tuple(s // n_shards for s in seg)
    flat_off = tuple(int(x) for x in np.cumsum((0,) + seg[:-1]))
    shard_off = tuple(int(x) for x in np.cumsum((0,) + pb[:-1]))
    return _ZeroLayout(ranges=ranges, leaf_elems=elems, m=m, pad=pad,
                       seg=seg, pb=pb, flat_off=flat_off,
                       shard_off=shard_off, per_shard=sum(pb),
                       total_flat=sum(seg))


def layout_params(module: nn.Module) -> list[nn.Parameter]:
    """The module's parameters in the flat layout's order: the reverse
    of ``parameters()``, the order the backward completes them."""
    return list(module.parameters())[::-1]


def _ravel_bucket(tensors, pad: int) -> torch.Tensor:
    """One bucket's tensors as a padded f32 segment."""
    parts = [t.detach().reshape(-1).float() for t in tensors]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _ravel_bucketed(tensors, layout: _ZeroLayout) -> torch.Tensor:
    """The bucketed flat vector of ``tensors`` (layout order)."""
    return torch.cat([_ravel_bucket(tensors[lo:hi], pad)
                      for (lo, hi), pad in zip(layout.ranges, layout.pad)])


def _unravel_bucketed(flat: torch.Tensor,
                      layout: _ZeroLayout) -> list[torch.Tensor]:
    """Each leaf's 1-D slice of the bucketed flat vector (views; pads
    dropped): the inverse of :func:`_ravel_bucketed` up to shapes."""
    out = []
    for (lo, hi), off in zip(layout.ranges, layout.flat_off):
        pos = off
        for i in range(lo, hi):
            n = layout.leaf_elems[i]
            out.append(flat[pos:pos + n])
            pos += n
    return out


def _shard_slice(flat: torch.Tensor, layout: _ZeroLayout,
                 idx: int) -> torch.Tensor:
    """Shard ``idx`` of the bucketed flat vector: its piece of every
    bucket, concatenated."""
    return torch.cat([flat[off + idx * pb:off + (idx + 1) * pb]
                      for off, pb in zip(layout.flat_off, layout.pb)])


def _bucketed_from_rows(rows: torch.Tensor,
                        layout: _ZeroLayout) -> torch.Tensor:
    """The bucketed flat vector from every shard, stacked ``(n,
    per_shard)`` (what an all-gather of the shards returns)."""
    return torch.cat([rows[:, so:so + pb].reshape(-1)
                      for so, pb in zip(layout.shard_off, layout.pb)])


class FlatShard:
    """This rank's shard of the bucketed flat parameter vector (f32: the
    sharded optimizer's one tensor), its layout, and the parameters it
    covers, in layout order.

    ZeRO (``fsdp=False``) keeps the module's parameters whole: the step
    re-slices the shard from them (:meth:`refresh`) and writes the
    gathered update back into them (:meth:`materialize`).  FSDP
    (``fsdp=True``) keeps only the shard at rest: the parameters are
    empty tensors between steps, :meth:`materialize` gathers each into
    storage of its own and :meth:`release` frees them."""

    def __init__(self, module: nn.Module, exchange_buckets: int = 1,
                 fsdp: bool = False, data=None, extra=None):
        self.params = layout_params(module)
        self.shapes = [p.shape for p in self.params]
        self.fsdp = fsdp
        # the shard axis (parallel/mesh.py AxisGroup; None: every rank)
        # and the other reduce axes, whose sum the shard takes after its
        # reduce-scatter (JAX's ``extra_axes``; None: there are none)
        self.group = None if data is None else data.group
        self.extra = extra
        if data is None:
            self.rank = dist.get_rank() if dist.is_initialized() else 0
        else:
            self.rank = data.index
        self.n = world_size(self.group)
        self.layout = _zero_layout(self.params, self.n, exchange_buckets)
        with torch.no_grad():
            self.shard = _shard_slice(
                _ravel_bucketed(self.params, self.layout), self.layout,
                self.rank)
        if fsdp:
            self.release()

    # -- the parameters ----------------------------------------------------

    def refresh(self) -> None:
        """Re-slice the shard from the live (whole) parameters."""
        with torch.no_grad():
            self.shard.copy_(_shard_slice(
                _ravel_bucketed(self.params, self.layout), self.layout,
                self.rank))

    def gather_flat(self, shard: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """The bucketed flat vector of every rank's ``shard`` (default:
        the parameter shard), by one all-gather; every rank calls it."""
        shard = self.shard if shard is None else shard
        if issues(self.group):
            out = shard.new_empty(self.n * shard.numel())
            dist.all_gather_into_tensor(out, shard.contiguous(),
                                        group=self.group)
            rows = out.view(self.n, -1)
        else:
            rows = shard[None]
        return _bucketed_from_rows(rows, self.layout)

    def materialize(self) -> None:
        """The whole parameters from every rank's shard: ZeRO copies them
        into the live parameters; FSDP gives each parameter storage of
        its own (a fresh allocation, aligned as a plain parameter is)."""
        with torch.no_grad():
            views = _unravel_bucketed(self.gather_flat(), self.layout)
            for p, v, shape in zip(self.params, views, self.shapes):
                if self.fsdp:
                    p.data = v.view(shape).clone()
                else:
                    p.copy_(v.view(shape))

    def release(self) -> None:
        """FSDP at rest: each parameter an empty tensor, no gradient."""
        for p in self.params:
            p.data = p.data.new_empty(0)
            p.grad = None

    def clear_grads(self) -> None:
        for p in self.params:
            p.grad = None

    # -- the gradients ---------------------------------------------------------

    def launch_scatter(self, b: int, out: torch.Tensor,
                       exchanger: BSP_Exchanger,
                       residual: torch.Tensor | None,
                       async_op: bool = False) -> _Pending:
        """Start bucket ``b``'s collective from its parameters'
        gradients; ``complete()`` writes this rank's summed piece into
        its place in ``out`` (per_shard).  The f32 wire reduce-scatters;
        the bf16 wire quantizes (with error feedback ``g + r``, updating
        this bucket's segment of ``residual`` in place), exchanges the
        pieces with an all-to-all and sums the received rows in f32."""
        lay = self.layout
        lo, hi = lay.ranges[b]
        seg = _ravel_bucket([p.grad for p in self.params[lo:hi]], lay.pad[b])
        so, pb = lay.shard_off[b], lay.pb[b]
        dst = out[so:so + pb]
        if exchanger.wire_dtype != "bf16":
            if issues(self.group):
                piece = seg.new_empty(pb)
                work = dist.reduce_scatter_tensor(piece, seg,
                                                  group=self.group,
                                                  async_op=async_op)
            else:
                piece, work = seg, None
            return _Pending(work, piece, lambda x: x, [dst])
        if exchanger.error_feedback:
            if residual is None:
                raise ValueError(
                    "error_feedback needs state.exchange_residual "
                    "(init_zero_exchange_residual; models/base.py builds "
                    "it from ModelConfig.exchange_error_feedback)")
            res = residual[lay.flat_off[b]:lay.flat_off[b] + lay.seg[b]]
            comp = seg + res
            q = comp.to(torch.bfloat16)
            res.copy_(comp - q.float())
        else:
            q = seg.to(torch.bfloat16)
        if issues(self.group):
            recv = torch.empty_like(q)
            work = dist.all_to_all_single(recv, q, group=self.group,
                                          async_op=async_op)
        else:
            recv, work = q, None
        return _Pending(work, recv,
                        lambda r: r.view(self.n, pb).float().sum(0), [dst])

    def scatter(self, exchanger: BSP_Exchanger,
                residual: torch.Tensor | None) -> torch.Tensor:
        """Every bucket's collective after the backward, in plan order;
        returns this rank's summed gradient shard."""
        out = self.shard.new_empty(self.layout.per_shard)
        for b in range(len(self.layout.ranges)):
            self.launch_scatter(b, out, exchanger, residual).complete()
        return out

    def leaf_segments(self) -> list[tuple[int, int, int, bool]]:
        """``(lo, hi, leaf, whole)`` for each piece of a leaf in this
        rank's shard: the shard range, the leaf's layout index, and
        whether the piece is the whole leaf (else other ranks hold the
        rest of it).  LARS's per-leaf norms under FSDP read these."""
        lay, out = self.layout, []
        for b, ((lo, hi), fo) in enumerate(zip(lay.ranges, lay.flat_off)):
            start = fo + self.rank * lay.pb[b]
            end = start + lay.pb[b]
            pos = fo
            for i in range(lo, hi):
                n = lay.leaf_elems[i]
                a, z = max(pos, start), min(pos + n, end)
                if a < z:
                    out.append((lay.shard_off[b] + a - start,
                                lay.shard_off[b] + z - start, i,
                                z - a == n))
                pos += n
        return out


class _ScatterBackward(BucketedBackward):
    """:class:`BucketedBackward` with the flat layout's buckets and a
    bucket's collective the reduce-scatter (or the bf16 all-to-all) of
    :meth:`FlatShard.launch_scatter` into ``self.out``, the step's
    gradient shard."""

    def __init__(self, exchanger: BSP_Exchanger, shard: FlatShard):
        super().__init__(exchanger, shard.params,
                         buckets=[list(range(lo, hi))
                                  for lo, hi in shard.layout.ranges])
        self.shard = shard
        self.out: torch.Tensor | None = None

    def arm(self, residual: torch.Tensor | None = None) -> None:
        super().arm(residual)
        self.out = self.shard.shard.new_empty(self.shard.layout.per_shard)

    def _launch(self, b: int) -> list[_Pending]:
        return [self.shard.launch_scatter(b, self.out, self.exchanger,
                                          self._residual, async_op=True)]


def init_zero_opt_state(module: nn.Module, make_optimizer,
                        exchange_buckets: int = 1, data=None, extra=None
                        ) -> tuple[torch.optim.Optimizer, FlatShard]:
    """This rank's parameter shard (:class:`FlatShard`) and the optimizer
    over it, ``make_optimizer([shard])``: the optimizer state is 1/N of
    plain BSP's on every rank, and no rank builds the whole of it.
    ``exchange_buckets`` must be the step's: it fixes the layout.  On a
    mesh, ``data`` is the shard axis and ``extra`` the other reduce axes
    (``AxisGroup``s of parallel/mesh.py): the state is sharded over
    ``data`` only."""
    from theanompi_tpu_torch.utils.helper_funcs import LARS

    shard = FlatShard(module, exchange_buckets, data=data, extra=extra)
    optimizer = make_optimizer([shard.shard])
    if isinstance(optimizer, LARS):
        raise ValueError("zero_sharding needs an ELEMENTWISE optimizer; "
                         "lars computes layerwise trust ratios which a "
                         "flat shard cannot see")
    return optimizer, shard


def init_zero_exchange_residual(module: nn.Module,
                                exchange_buckets: int = 1) -> torch.Tensor:
    """A zero error-feedback residual for the ZeRO step: this rank's
    bucketed flat gradient vector, ``(total_flat,)`` f32 on the module's
    device (JAX keeps all ranks' as ``(n, total_flat)``; the checkpoint
    gathers them so).  ``exchange_buckets`` fixes the layout."""
    params = layout_params(module)
    layout = _zero_layout(params, world_size(), exchange_buckets)
    return torch.zeros(layout.total_flat, dtype=torch.float32,
                       device=params[0].device)


def _sharded_step(loss_fn: LossFn, exchanger: BSP_Exchanger, accum: bool,
                  multi: bool, fsdp: bool, prepare=None):
    """The ZeRO step (``fsdp=False``) or the FSDP step: single, ``multi``
    or ``accum`` (module docstring).  ``prepare(module)`` runs once, at
    the first call."""
    if accum and multi:
        raise ValueError("accum and multi are mutually exclusive "
                         "stacked cadences")
    if exchanger.exchange_what != "grads":
        raise ValueError(f"{'fsdp' if fsdp else 'zero'}_sharding IS the "
                         "gradient exchange; exchange_what='params' does "
                         "not apply")
    bucketed = exchanger.exchange_buckets > 1
    built: dict = {}

    def start(state: TrainState):
        shard = state.sharding
        if not isinstance(shard, FlatShard) or shard.fsdp != fsdp:
            raise ValueError(
                "this step needs the state "
                + ("init_fsdp_state builds" if fsdp
                   else "of init_zero_opt_state (TrainState.sharding)"))
        if not built:
            built["module"] = state.module
            if bucketed:
                emit_bucket_gauges("fsdp" if fsdp else "zero",
                                   shard.layout.ranges, shard.params,
                                   exchanger.wire_dtype)
                if not accum:
                    built["hooks"] = _ScatterBackward(exchanger, shard)
            if prepare is not None:
                prepare(state.module)
        elif built["module"] is not state.module:
            raise ValueError("this step was built for another module")
        if fsdp:
            shard.materialize()
        else:
            shard.refresh()
        shard.clear_grads()
        return shard

    def finish(state: TrainState, shard: FlatShard, gshard: torch.Tensor,
               metrics: dict) -> dict:
        with torch.no_grad():
            if not fsdp:  # FSDP's BN statistics are the global batch's
                all_reduce_mean(running_stats(state.module),
                                exchanger.group)
            n_total = shard.n
            if shard.extra is not None and not shard.extra.trivial:
                # the other reduce axes sum the 1/N shard plainly (JAX's
                # psum over ``extra_axes`` after the data reduce-scatter)
                dist.all_reduce(gshard, group=shard.extra.group)
                n_total *= shard.extra.size
            if exchanger.avg:
                gshard.div_(n_total)
        shard.shard.grad = gshard
        apply_update(state)
        shard.shard.grad = None
        shard.clear_grads()
        if fsdp:
            shard.release()
        else:
            shard.materialize()
        return mean_metrics(metrics, exchanger.group)

    def step(state: TrainState, batch, rng) -> dict:
        shard = start(state)
        hooks = built.get("hooks")
        if hooks is not None:
            hooks.arm(state.exchange_residual)
        metrics = grad_and_metrics(loss_fn, state.module, batch, rng)
        with torch.no_grad():
            zero_missing_grads(shard.params)
            if hooks is not None:
                hooks.finish()
                gshard, hooks.out = hooks.out, None
            else:
                gshard = shard.scatter(exchanger, state.exchange_residual)
        return finish(state, shard, gshard, metrics)

    def accum_step(state: TrainState, batches, rng) -> dict:
        shard = start(state)
        metrics, a = accumulate_microbatch_grads(loss_fn, state.module,
                                                 batches, rng)
        with torch.no_grad():
            zero_missing_grads(shard.params)
            for p in shard.params:
                p.grad.div_(a)
            gshard = shard.scatter(exchanger, state.exchange_residual)
        return finish(state, shard, gshard, metrics)

    def multi_step(state: TrainState, batches, rng) -> dict:
        per = [step(state, b, rng) for b in batches]
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}

    return accum_step if accum else (multi_step if multi else step)


def make_bsp_zero_step(loss_fn: LossFn,
                       exchanger: BSP_Exchanger | None = None,
                       accum: bool = False, multi: bool = False):
    """``step(state, batch, rng) -> metrics``: the ZeRO-1 BSP step on this
    rank's batch (module docstring) for a ``TrainState`` whose
    ``sharding`` and optimizer :func:`init_zero_opt_state` built (and
    whose ``exchange_residual`` :func:`init_zero_exchange_residual` built,
    with error feedback), at the same ``exchange_buckets``.  The
    exchanger gives ``avg``, the wire (``exchange_dtype``), error
    feedback and the bucket count; ``exchange_what`` must be 'grads'.
    ``accum=True``: ``step(state, microbatches, rng)``, one update;
    ``multi=True``: ``step(state, batches, rng)``, one step per batch,
    the metrics stacked ``(k,)``."""
    return _sharded_step(loss_fn, exchanger or BSP_Exchanger(), accum,
                         multi, fsdp=False)
