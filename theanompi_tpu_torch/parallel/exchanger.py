"""BSP gradient and parameter exchange over ``torch.distributed``.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``.  In JAX the
exchange is a ``psum`` traced into the step; here each rank is its own
process and :meth:`BSP_Exchanger.exchange` reduces a list of tensors in
place, one collective per bucket (``exchange_buckets``, default one
bucket holding every tensor), then averages (``avg=True``, the
reference's 'avg' sync type) or keeps the sum ('cdd').  The numeric
strategies are the JAX package's:

* the f32 wire ('psum', 'ar', 'nccl32', ...): one ``all_reduce`` of the
  bucket's flat buffer;
* the bf16 wire ('psum_bf16', 'nccl16', 'asa16', or
  ``exchange_dtype='bf16'``): each rank quantizes its values to bf16, the
  ranks ``all_gather`` the bf16 values and each sums them locally in f32
  (JAX's ``_bf16_sum``).  It is not a bf16 all-reduce, whose partial sums round
  in bf16 and swallow the increments error feedback puts back;
* error feedback (``exchange_with_residual``): ``g + r`` is quantized and
  sent, and the new per-rank residual is ``(g + r) - bf16(g + r)`` in
  f32.

Bucketing regroups elementwise collectives and never reorders the sum of
one element over the ranks on the bf16 wire (the local f32 sum runs in
rank order); on the f32 wire that holds at one and two ranks, where a
sum of one element has one order.  :class:`BucketedBackward` launches
the buckets from gradient hooks while the backward runs (JAX's
``backward_exchange``).  With no process group (one process) the f32
exchange leaves the tensors as they are and the bf16 wire quantizes
them, as a JAX mesh of one device does.

The module ends with the async rules' merge arithmetic (EASGD, ASGD,
GOSGD; JAX ``exchanger.py:555-675``), plain functions of lists or dicts
of tensors that return new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.parallel.mesh import LOCAL
from theanompi_tpu_torch.parallel.partition import balanced_ranges

# Reference strategy names -> numeric strategy.
_STRATEGY_ALIASES = {
    "ar": "psum",
    "asa32": "psum",
    "copper": "psum",
    "nccl32": "psum",
    "psum": "psum",
    "asa16": "psum_bf16",
    "nccl16": "psum_bf16",
    "psum_bf16": "psum_bf16",
}


def bucket_ranges(sizes, n_buckets: int) -> list[tuple[int, int]]:
    """Byte-balanced bucket plan over ordered tensors: contiguous
    ``(lo, hi)`` ranges, a pure function of (byte sizes, bucket count),
    so every rank derives the same plan.  A bucket count beyond the
    tensor count clamps to one bucket per tensor."""
    sizes = list(sizes)
    return balanced_ranges(sizes, min(int(n_buckets), len(sizes)))


def validate_bucket_count(exchange_buckets) -> int:
    """The one check of the ``exchange_buckets`` knob (JAX's text)."""
    b = exchange_buckets
    if isinstance(b, bool) or not isinstance(b, int) or b < 1:
        raise ValueError(
            f"exchange_buckets must be an int >= 1, got {b!r}")
    return b


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def emit_bucket_gauges(plane: str, ranges, tensors, wire_dtype: str) -> None:
    """Bucket telemetry, set once per built step (JAX: once per trace):
    the bucket count and each bucket's wire bytes."""
    if not monitor.enabled():
        return
    monitor.set_gauge("bsp/exchange_buckets", len(ranges), plane=plane,
                      dtype=wire_dtype)
    for i, (lo, hi) in enumerate(ranges):
        if wire_dtype == "bf16":
            nbytes = 2 * sum(t.numel() for t in tensors[lo:hi])
        else:
            nbytes = sum(_nbytes(t) for t in tensors[lo:hi])
        monitor.set_gauge("bsp/exchange_bucket_bytes", nbytes,
                          plane=plane, bucket=str(i), dtype=wire_dtype)


def resolve_strategy(name: str) -> str:
    """Map a reference-era strategy name to its numeric strategy
    ('psum' | 'psum_bf16'); raises on unknown names."""
    try:
        return _STRATEGY_ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown exchange strategy {name!r}; "
            f"expected one of {sorted(_STRATEGY_ALIASES)}") from None


def issues(group=None) -> bool:
    """Whether a collective over ``group`` is issued: a process group
    exists and ``group`` is not the one-rank :data:`~theanompi_tpu_torch.
    parallel.mesh.LOCAL`."""
    return dist.is_initialized() and group is not LOCAL


def world_size(group=None) -> int:
    """Ranks in ``group`` (default: the default process group; 1 without
    one)."""
    return dist.get_world_size(group) if issues(group) else 1


def all_reduce_mean(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (the
    model's reduce group, parallel/mesh.py; default: every rank), in
    place, with one collective over a flat f32 buffer (the BN
    statistics, the metrics, the optimizer state of 'params').  The
    default group of one rank runs the collective too; no-op without a
    process group."""
    if not issues(group) or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    _split_into(flat, tensors)


def _flat(tensors) -> torch.Tensor | None:
    """The tensors as ONE flat vector when their dtypes agree; ``None``
    for a mixed-dtype bucket (reduced tensor by tensor instead, which
    keeps each one's numerics)."""
    if len({t.dtype for t in tensors}) != 1:
        return None
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _split_into(flat: torch.Tensor, tensors) -> None:
    at = 0
    for t in tensors:
        k = t.numel()
        t.detach().copy_(flat[at:at + k].view_as(t))
        at += k


class _Pending:
    """One launched bucket collective: its work handle (``None`` when it
    ran synchronously or without a process group), the buffer it fills,
    what turns that buffer into the bucket's result, and the tensors the
    result is written back into."""

    def __init__(self, work, out: torch.Tensor, finish, tensors):
        self.work, self.out, self.finish = work, out, finish
        self.tensors = tensors

    def complete(self) -> None:
        """Wait, and write the exchanged values into the tensors."""
        if self.work is not None:
            self.work.wait()
        _split_into(self.finish(self.out), self.tensors)


def zero_missing_grads(params) -> None:
    """JAX's rule for a parameter the loss does not reach: its gradient
    is zero, exchanged and applied like any other.  Every rank then puts
    every parameter on the wire, whichever ones its batch used."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


@dataclasses.dataclass(frozen=True)
class BSP_Exchanger:
    """BSP exchange semantics (the JAX ``BSP_Exchanger``'s fields and
    validation; see the module docstring).

    ``strategy`` takes the reference names, ``exchange_dtype`` (``None``:
    from the strategy, 'f32' or 'bf16') overrides the wire,
    ``error_feedback`` needs the bf16 wire and ``exchange_what='grads'``,
    ``exchange_what='params'`` averages the parameters after a local
    update (parallel/bsp.py), and ``exchange_buckets`` cuts the tensors
    into that many byte-balanced buckets, one collective each.  ``avg``
    averages over the ranks, otherwise the sum is kept (the caller scales
    its learning rate).  ``group`` is the process group of the reduce
    axes (JAX's ``axis``; parallel/mesh.py ``AxisGroup.group``), ``None``
    every rank.  JAX's ``fp16_scale`` is not ported: bf16 has f32's
    exponent range and needs no scaling."""

    strategy: str = "psum"
    avg: bool = True
    exchange_what: str = "grads"
    exchange_dtype: str | None = None
    error_feedback: bool = False
    exchange_buckets: int = 1
    group: Any = None

    def __post_init__(self):
        validate_bucket_count(self.exchange_buckets)
        resolve_strategy(self.strategy)
        if self.exchange_what not in ("grads", "params"):
            raise ValueError("exchange_what must be 'grads' or 'params'")
        if self.exchange_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"exchange_dtype must be 'f32' or 'bf16', "
                             f"got {self.exchange_dtype!r}")
        if self.error_feedback:
            if self.wire_dtype != "bf16":
                raise ValueError(
                    "error_feedback compensates bf16 quantization; it "
                    "needs exchange_dtype='bf16' (or a bf16 strategy)")
            if self.exchange_what != "grads":
                raise ValueError(
                    "error_feedback is a gradient-compression technique; "
                    "exchange_what='params' has no residual semantics")

    @property
    def resolved(self) -> str:
        if self.exchange_dtype == "bf16":
            return "psum_bf16"
        if self.exchange_dtype == "f32":
            return "psum"
        return _STRATEGY_ALIASES[self.strategy]

    @property
    def wire_dtype(self) -> str:
        """'bf16' | 'f32': what moves between the ranks."""
        return "bf16" if self.resolved == "psum_bf16" else "f32"

    def emit_gauges(self, tensors: list[torch.Tensor]) -> None:
        """The exchange's telemetry for one built step (JAX sets it once
        per trace): bytes per call and wire dtype, the build count, and
        the bucket plan's gauges when bucketed."""
        if not monitor.enabled():
            return
        if self.wire_dtype == "bf16":
            wire = "bfloat16"
            nbytes = 2 * sum(t.numel() for t in tensors)
        else:
            wire = ",".join(sorted({str(t.dtype).removeprefix("torch.")
                                    for t in tensors})) or "none"
            nbytes = sum(_nbytes(t) for t in tensors)
        monitor.set_gauge("exchange/bytes_per_call", nbytes,
                          strategy=self.resolved, dtype=wire,
                          what=self.exchange_what)
        monitor.inc("exchange/traces_total", strategy=self.resolved)
        if self.exchange_buckets > 1 and tensors:
            emit_bucket_gauges(
                "bsp", bucket_ranges([_nbytes(t) for t in tensors],
                                     self.exchange_buckets),
                tensors, self.wire_dtype)

    # -- one bucket ------------------------------------------------------

    def _average(self, red: torch.Tensor) -> torch.Tensor:
        return red / world_size(self.group) if self.avg else red

    def _gather_bf16(self, q: torch.Tensor, async_op: bool):
        """All-gather bf16 ``q`` over the ranks: (work, (n, *q.shape))."""
        if not issues(self.group):
            return None, q[None]
        n = dist.get_world_size(self.group)
        out = torch.empty(n * q.numel(), dtype=q.dtype, device=q.device)
        work = dist.all_gather_into_tensor(out, q.contiguous(),
                                           group=self.group,
                                           async_op=async_op)
        return work, out.view((n,) + tuple(q.shape))

    def _launch_bucket(self, tensors, residual=None,
                       async_op: bool = False) -> list[_Pending]:
        """Start the collectives of one bucket: one flat collective when
        the dtypes agree, else one per tensor (which keeps each one's
        numerics).  With error feedback (``residual``: one f32 tensor per
        tensor) ``bf16(t + r)`` goes on the wire and the residual becomes
        ``(t + r) - bf16(t + r)`` here.  Each returned ``_Pending`` writes
        the exchanged (and averaged) values back into its tensors on
        ``complete()``."""
        flat = _flat(tensors)
        if flat is None:
            return [q for k, t in enumerate(tensors)
                    for q in self._launch_bucket(
                        [t], None if residual is None else [residual[k]],
                        async_op)]
        dtype = flat.dtype
        if residual is not None:
            comp = flat.float() + _flat(residual)
            q = comp.to(torch.bfloat16)
            _split_into(comp - q.float(), residual)
        elif self.wire_dtype == "bf16":
            q = flat.to(torch.bfloat16)
        else:
            work = (dist.all_reduce(flat, group=self.group,
                                    async_op=async_op)
                    if issues(self.group) else None)
            return [_Pending(work, flat, self._average, tensors)]
        work, out = self._gather_bf16(q, async_op)
        return [_Pending(work, out, lambda g: self._average(
            g.float().sum(0).to(dtype)), tensors)]

    # -- the exchange ----------------------------------------------------

    def _ranges(self, tensors) -> list[tuple[int, int]]:
        return bucket_ranges([_nbytes(t) for t in tensors],
                             self.exchange_buckets)

    def exchange(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Reduce ``tensors`` in place over ``group`` (every rank by default),
        one collective per bucket, and return them."""
        if tensors:
            for lo, hi in self._ranges(tensors):
                for pending in self._launch_bucket(tensors[lo:hi]):
                    pending.complete()
        return tensors

    def exchange_with_residual(self, tensors: list[torch.Tensor],
                               residual: list[torch.Tensor]
                               ) -> list[torch.Tensor]:
        """The bf16 exchange with error feedback, in place: each tensor
        becomes the average (or sum) over the ranks of ``bf16(t + r)``,
        accumulated in f32, and each residual ``r`` (f32, this rank's)
        becomes ``(t + r) - bf16(t + r)``.  Over a run the residual puts
        back every bit the wire dropped."""
        if not self.error_feedback:
            raise ValueError("exchange_with_residual needs "
                             "error_feedback=True")
        if len(residual) != len(tensors):
            raise ValueError(f"{len(residual)} residuals for "
                             f"{len(tensors)} tensors")
        if tensors:
            for lo, hi in self._ranges(tensors):
                for pending in self._launch_bucket(tensors[lo:hi],
                                                   residual[lo:hi]):
                    pending.complete()
        return tensors


class BucketedBackward:
    """The bucketed gradient exchange overlapped with the backward (JAX's
    ``backward_exchange``; ``exchange_buckets > 1``, ``'grads'``).

    The parameters are cut into ``bucket_ranges`` over their byte sizes
    in the order the backward produces their gradients (the reverse of
    registration order), unless ``buckets`` gives the plan (parameter
    indices per bucket, in plan order: ZeRO's flat layout).  A post-accumulate-grad hook on each parameter
    marks it ready; a complete bucket is packed into one flat buffer
    (with error feedback, ``g + r`` is quantized there and the residual
    updated) and its collective starts with ``async_op=True``.  Buckets
    start in plan order on every rank, a complete bucket waiting for the
    ones before it: ranks that issued collectives in different orders
    would deadlock or mismatch.  :meth:`finish`, after the backward,
    starts whatever has not started (a parameter that got no gradient
    goes on the wire with a zero one, as in JAX), waits for every bucket
    and writes the exchanged gradients into ``.grad``.

    The hooks act only between :meth:`arm` and :meth:`finish`, so a
    backward outside a step (an accumulation microbatch) exchanges
    nothing.  One module on one device: the hooks run on its autograd
    thread, one at a time."""

    def __init__(self, exchanger: BSP_Exchanger,
                 params: list[torch.nn.Parameter],
                 buckets: list[list[int]] | None = None):
        if exchanger.exchange_what != "grads":
            raise ValueError("the overlapped exchange is the GRADIENT "
                             "exchange; exchange_what='params' has no "
                             "backward to overlap with")
        self.exchanger = exchanger
        self.params = list(params)
        if buckets is None:
            order = list(range(len(self.params)))[::-1]
            ranges = bucket_ranges([_nbytes(self.params[i]) for i in order],
                                   exchanger.exchange_buckets)
            buckets = [order[lo:hi] for lo, hi in ranges]
        #: parameter indices of each bucket, in plan order
        self.buckets = [list(idx) for idx in buckets]
        self._bucket_of = {i: b for b, idx in enumerate(self.buckets)
                           for i in idx}
        self._armed = False
        self._residual: list[torch.Tensor] | None = None
        self._missing: list[int] = []
        self._next = 0
        self._pending: list[_Pending] = []
        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(self._hook_for(i))

    def _hook_for(self, i: int):
        def hook(_param):
            if not self._armed:
                return
            b = self._bucket_of[i]
            self._missing[b] -= 1
            while (self._next < len(self.buckets)
                   and self._missing[self._next] == 0):
                self._launch_next()
        return hook

    def arm(self, residual: list[torch.Tensor] | None = None) -> None:
        """Start a step: the next backward's hooks launch the buckets
        (``residual``: this rank's error-feedback residual, one f32
        tensor per parameter, updated in place)."""
        if self.exchanger.error_feedback and residual is None:
            raise ValueError("error_feedback needs the residual "
                             "(TrainState.exchange_residual)")
        self._residual = residual if self.exchanger.error_feedback else None
        self._missing = [len(idx) for idx in self.buckets]
        self._next = 0
        self._pending = []
        self._armed = True

    def _launch(self, b: int) -> list[_Pending]:
        """Start bucket ``b``'s collectives: the exchange of its
        gradients (ZeRO's reduce-scatter overrides this)."""
        idx = self.buckets[b]
        return self.exchanger._launch_bucket(
            [self.params[i].grad for i in idx],
            None if self._residual is None
            else [self._residual[i] for i in idx], async_op=True)

    def _launch_next(self) -> None:
        self._next += 1
        self._pending += self._launch(self._next - 1)

    def finish(self) -> None:
        """Start the buckets left, in plan order (a parameter that got no
        gradient has a zero one, ``zero_missing_grads``), wait for all
        and write the exchanged gradients into ``.grad``."""
        if not self._armed:
            raise RuntimeError("BucketedBackward.finish() without arm()")
        try:
            zero_missing_grads(self.params)
            while self._next < len(self.buckets):
                self._launch_next()
            for pending in self._pending:
                pending.complete()
        finally:
            self._armed = False
            self._pending = []


# -- the async rules' merge arithmetic (EASGD, ASGD, GOSGD) ------------------
#
# JAX's ``exchanger.py:555-675``: pure functions of lists (or dicts with
# the same keys) of tensors.  Each returns new tensors and leaves its
# arguments as they were, so nothing a caller hands on aliases a tensor
# that a later in-place step updates (JAX donates instead).  Scalar
# coefficients are applied in f32, as JAX's traced Python floats are.


def _leafwise(fn, *trees):
    """``fn`` over matching leaves of lists or of dicts (``trees[0]``'s
    keys)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: fn(*(t[k] for t in trees)) for k in first}
    return [fn(*xs) for xs in zip(*trees, strict=True)]


def easgd_worker_update(worker, center, alpha):
    """worker - alpha * (worker - center)."""
    return _leafwise(lambda w, c: w - alpha * (w - c), worker, center)


def easgd_center_update(center, worker, alpha):
    """center + alpha * (worker - center)."""
    return _leafwise(lambda c, w: c + alpha * (w - c), center, worker)


def easgd_both_updates(worker, center, alpha):
    """One elastic exchange: ``(new_worker, new_center)``."""
    return (easgd_worker_update(worker, center, alpha),
            easgd_center_update(center, worker, alpha))


def easgd_center_update_n(center, worker_mean, alpha_eff):
    """``center + alpha_eff * (mean - center)``: the closed form of n
    elastic exchanges against one center version (``alpha_eff = n *
    alpha``)."""
    return _leafwise(lambda c, m: c + alpha_eff * (m - c), center,
                     worker_mean)


def easgd_apply_delta(current, snapshot, returned):
    """The overlapped exchange's correction: the elastic force the store
    computed for ``snapshot`` (``snapshot - returned``), applied to the
    parameters the worker holds now: ``current - (snapshot - returned)``."""
    return _leafwise(lambda c, s, r: c - (s - r), current, snapshot, returned)


def asgd_apply_grads(center, grads, lr):
    """Parameter-server SGD step: center - lr * grads."""
    return _leafwise(lambda c, g: c - lr * g, center, grads)


def gosgd_merge(own, own_w: float, recv, recv_w: float):
    """Gossip merge: the weighted average ``(own_w * own + recv_w *
    recv) / (own_w + recv_w)`` and the summed weight, every scalar in
    f32 as JAX's jitted merge computes it (the weight is returned as a
    Python float)."""
    own_w, recv_w = np.float32(own_w), np.float32(recv_w)
    total = np.float32(own_w + recv_w)
    merged = _leafwise(
        lambda a, b: (float(own_w) * a + float(recv_w) * b.to(a.device))
        / float(total), own, recv)
    return merged, float(total)


#: per-parameter optimizer slots that hold first-moment information, the
#: port's names for optax's ``trace``/``mu``/``mean``/``momentum``
#: (SGD, LARS and RMSprop ``momentum_buffer``; Adam and AdamW
#: ``exp_avg``).  Second moments and step counts are never scaled.
FIRST_MOMENT_SLOTS = frozenset({"momentum_buffer", "exp_avg"})


def gosgd_scale_momentum(optimizer: torch.optim.Optimizer, frac: float):
    """Scale the optimizer's first-moment slots by the receiver's share
    of a gossip merge (JAX's ``gosgd_scale_momentum``: the sender's
    unshipped momentum taken as zero), in place; returns ``optimizer``."""
    with torch.no_grad():
        for per in optimizer.state.values():
            for slot, value in per.items():
                if slot in FIRST_MOMENT_SLOTS and torch.is_tensor(value):
                    value.mul_(frac)
    return optimizer
