"""Intra-host aggregation for the async rules — N local workers cost
ONE wire exchange per shard per period (
docs/DESIGN.md "Hierarchical exchange").

The async center's wire cost used to scale with worker count: every
EASGD/ASGD worker shipped its full (or per-shard) tree to the service
each period, so an n-worker host paid n times the bytes for math that
is a single sum.  The reference design (arXiv:1605.08325) concentrates
communication in one exchange process per host; the weight-update
sharding of arXiv:2004.13336 applies the same idea to a partitioned
center.  This module rebuilds both as an in-process aggregation plane
in front of the (possibly sharded) parameter service:

* :class:`LocalAggregator` — one per host.  Co-located workers submit
  their exchange payloads; when every registered worker's payload for
  the current period is in, the LAST arriver (on its own exchange
  thread under ``overlap=True``, so aggregation rides the existing
  comm/compute overlap) combines them and performs ONE wire exchange:

  - **ASGD** delta-sums exactly: the aggregate payload is the SUM of
    the workers' gradients, applied as one optimizer step
    (``push_pull_n``) — algebraically equal to n same-version pushes
    for any gradient-linear update; the fresh center fans back to all
    n workers, each its own copy on its device.
  - **EASGD** elastic displacements compose in closed form when
    applied against ONE center version: the aggregate payload is the
    MEAN of the workers' params and the center applies
    ``center += n*alpha*(mean - center)`` (``exchange_n``), returning
    the PRE-update center so each worker's own elastic pull
    ``w_i - alpha*(w_i - center)`` is computed on its own stream
    against that same version.  Exact in real arithmetic; f32
    reordering bounds the deviation (docs/DESIGN.md documents the
    tolerance and the ``n*alpha <= 1`` stability note).

  The wire op carries the worker-count multiplier, so the center math
  and the shard plane's version-fence accounting stay identical to n
  independent exchanges at the same version — one tagged
  ``shard_exchange`` per shard per period.

* :class:`AggregatedExchange` — the per-worker port.  Duck-types the
  store clients (``exchange``/``push_pull``/``set_lr``/...), so the
  rules' worker loops and their ``_ExchangePipe`` overlap plane are
  unchanged.  Fallback matrix (never wedge): an aggregator that is
  down — killed, or its wire op failed — fails every waiter with the
  typed :class:`AggregatorDown`, and the port falls back to a DIRECT
  per-worker exchange for that period (lazily connecting its own
  client), rejoining the aggregator as soon as it is alive again.  A
  worker that leaves (finished, crashed, supervised restart) drops out
  of the period quorum via ``leave``, so the survivors' periods keep
  completing; a wedged period times out
  (``THEANOMPI_TPU_AGG_TIMEOUT_S``) into the same direct fallback.

Trust model: the aggregator runs in the training process and holds no
key material beyond what any worker already holds (the same
``THEANOMPI_TPU_SERVICE_KEY`` session) — it narrows the service's
attack surface if anything, since one authenticated connection per
host replaces N.

Copy of ``theanompi_tpu/parallel/aggregate.py`` over the port's lists of
tensors.  Where JAX sums on the host, the port keeps the period on the
workers' device: each port submits a copy of its worker's tensors made
on the worker's stream (with the event that marks it written), the
flyer sums and averages them on its own worker's device, and each
worker's elastic pull runs on its own stream.  Only the one mean or
gradient sum crosses to the host, inside the service client, for the
wire.  The operations are JAX's elementwise f32 ones in JAX's order,
so the bits are those of JAX's host aggregator.  Every direct fallback
counts in ``aggregate/fallbacks_total`` and in :attr:`LocalAggregator.
fallbacks` (read by the rules' results).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.parallel.server import publish, receive

#: one worker's payload: a list of tensors in the stores' order
Tensors = list


def _agg_timeout_s() -> float:
    """How long a submitted worker waits for its period's quorum
    before withdrawing and falling back to a direct exchange — the
    backstop against a peer that died without leaving."""
    return float(os.environ.get("THEANOMPI_TPU_AGG_TIMEOUT_S", "120"))


class AggregatorDown(RuntimeError):
    """The aggregation plane cannot serve this period — killed, not
    yet restarted, or the period wedged past the timeout.  Typed so
    the port's fallback (and the fault-matrix tests) classify on the
    class, not prose."""


def _tree_sum(payloads: list) -> Tensors:
    out = payloads[0]
    for p in payloads[1:]:
        out = [a + b for a, b in zip(out, p, strict=True)]
    return out


class LocalAggregator:
    """One per host: combines the registered local workers' exchange
    payloads into ONE wire exchange per period (module docstring).

    ``client`` is the host's single service handle — an in-process
    store (``EASGDServer``/``ASGDServer``), a ``RemoteEASGD``/
    ``RemoteASGD``, or the sharded routers — anything exposing
    ``exchange_n`` (easgd) / ``push_pull_n`` (asgd).  The aggregator
    never owns the handle's lifecycle; the rule session does.

    Threading: workers call :meth:`exchange` concurrently.  The last
    arriver of a period becomes the FLYER — it performs the wire op
    outside the lock while the others wait on the condition — so no
    dedicated aggregator thread exists to supervise; "restart" is the
    :meth:`kill`/:meth:`restart` transition, with the ports' direct
    fallback covering the down window."""

    def __init__(self, kind: str, client, alpha: float | None = None,
                 wait_timeout_s: float | None = None):
        if kind not in ("easgd", "asgd"):
            raise ValueError(
                f"hierarchical aggregation applies to easgd/asgd only, "
                f"got {kind!r} — GOSGD pushes whole trees to random "
                "peers (nothing to sum) and BSP exchanges in-step")
        if kind == "easgd" and alpha is None:
            raise ValueError("easgd aggregation needs alpha (the "
                             "per-worker elastic pull is computed "
                             "on its own stream against the pre-update "
                             "center)")
        self.kind = kind
        self._client = client
        self._alpha = None if alpha is None else float(alpha)
        self._timeout = (wait_timeout_s if wait_timeout_s is not None
                         else _agg_timeout_s())
        self._lock = make_lock("LocalAggregator._lock")
        self._cv = make_condition(self._lock, "LocalAggregator._cv")
        self._members: set[int] = set()     # guarded_by: self._lock
        self._pending: dict[int, tuple] = {}   # guarded_by: self._lock
        self._gen = 0                       # guarded_by: self._lock
        self._flying = False                # guarded_by: self._lock
        #: gen -> {rank: (result, error)}   # guarded_by: self._lock
        self._results: dict[int, dict] = {}
        self._down: str | None = None       # guarded_by: self._lock
        #: direct exchanges the ports made instead (every cause)
        self.fallbacks = 0                  # guarded_by: self._lock
        #: aggregate wire exchanges flown
        self.flights = 0                    # guarded_by: self._lock
        #: flights below this gen were killed mid-air: their waiters
        #: already failed over, so they must never publish (a restart
        #: clearing _down would otherwise let a stale flight leak one
        #: full result tree per bailed waiter)  # guarded_by: self._lock
        self._kill_watermark = 0

    # -- membership ----------------------------------------------------

    def register(self, rank: int) -> None:
        """Add ``rank`` to the period quorum (idempotent).  The rule
        registers every local worker BEFORE the threads start, so the
        first period already aggregates at full fan-in."""
        with self._cv:
            self._members.add(int(rank))
            self._cv.notify_all()

    def leave(self, rank: int) -> None:
        """Drop ``rank`` from the quorum (finished / crashed /
        restarting worker) and wake waiters — the survivors' period
        may now be complete."""
        with self._cv:
            self._members.discard(int(rank))
            self._pending.pop(int(rank), None)
            self._cv.notify_all()

    def members(self) -> set[int]:
        with self._lock:
            return set(self._members)

    def counts(self) -> dict:
        """Aggregate wire exchanges flown and direct fallbacks taken."""
        with self._lock:
            return {"flights": self.flights, "fallbacks": self.fallbacks}

    # -- liveness (the supervised-restart surface) ---------------------

    def alive(self) -> bool:
        with self._lock:
            return self._down is None

    def kill(self, reason: str = "aggregator killed") -> None:
        """Take the plane down: every waiter (and every later submit)
        gets a typed :class:`AggregatorDown`, which the ports turn
        into a direct exchange within the same period — the
        fault-matrix's no-idle-gap guarantee."""
        with self._cv:
            self._down = str(reason)
            self._pending.clear()
            self._results.clear()  # every waiter raises; don't leak
            self._kill_watermark = self._gen
            self._cv.notify_all()

    def restart(self) -> None:
        """Bring the plane back; ports rejoin on their next period
        (they probe :meth:`alive` before every submit)."""
        with self._cv:
            self._down = None
            self._cv.notify_all()

    # -- the period exchange -------------------------------------------

    def exchange(self, rank: int, payload: Tensors,
                 ready: torch.cuda.Event | None = None) -> Tensors:
        """Submit ``rank``'s payload for the current period (tensors on
        its device, which no one writes until this returns; ``ready``
        the event recorded after they were written, ``publish``);
        blocks until the period's aggregate wire exchange completes
        and returns this worker's share as new tensors on the payload's
        device (EASGD: its new params; ASGD: the fresh center).  Raises
        :class:`AggregatorDown` when the plane is down, the wire op
        failed, or the period wedged past the timeout — the caller
        falls back to a direct exchange."""
        rank = int(rank)
        deadline = time.monotonic() + self._timeout
        with self._cv:
            if self._down is not None:
                raise AggregatorDown(self._down)
            if rank not in self._members:
                raise AggregatorDown(
                    f"rank {rank} is not registered with the "
                    "aggregator")
            if rank in self._pending:
                raise RuntimeError(
                    f"rank {rank} already has a payload in the current "
                    "period — one exchange per worker per period")
            my_gen = self._gen
            self._pending[rank] = (payload, ready)
            self._cv.notify_all()
            flyer = False
            while True:
                res = self._results.get(my_gen)
                if res is not None and rank in res:
                    out, err = res.pop(rank)
                    if not res:
                        self._results.pop(my_gen, None)
                    if err is not None:
                        raise err
                    break
                if self._down is not None:
                    self._pending.pop(rank, None)
                    raise AggregatorDown(self._down)
                # a kill that a fast restart() made invisible to this
                # waiter (it slept through the down window) must still
                # fail it over — otherwise it waits forever on a
                # result nobody will publish:
                if my_gen < self._kill_watermark:
                    # our generation's flight was in the air when the
                    # kill landed: the flyer discards its result (see
                    # the watermark note below).  At-least-once — the
                    # aggregate may still have applied, exactly a
                    # re-sent exchange after a lost reply
                    raise AggregatorDown(
                        "aggregation plane was killed while this "
                        "period's exchange was in flight")
                if self._gen == my_gen and rank not in self._pending:
                    # our payload was discarded by a kill before any
                    # flyer took it (a flyer bumps _gen atomically
                    # with taking the work): never applied, so the
                    # direct fallback cannot double-apply
                    raise AggregatorDown(
                        "payload discarded by an aggregation-plane "
                        "kill")
                if (self._gen == my_gen and not self._flying
                        and self._pending
                        and set(self._pending) >= self._members):
                    # last arriver: this thread flies the period
                    work = dict(self._pending)
                    self._pending.clear()
                    self._flying = True
                    self._gen += 1
                    flyer = True
                    break
                if not self._cv.wait(0.05) \
                        and time.monotonic() > deadline:
                    if rank in self._pending:
                        # a peer died without leaving: withdraw and
                        # fall back rather than wedge the worker —
                        # the payload was NOT applied, so the direct
                        # fallback cannot double-apply it
                        have = sorted(self._pending)  # incl. this rank
                        self._pending.pop(rank)
                        self._cv.notify_all()
                        raise AggregatorDown(
                            f"period quorum not met within "
                            f"{self._timeout:.0f}s (have {have}, "
                            f"need {sorted(self._members)})")
                    # the payload is already inside an in-flight wire
                    # op, whose own retry deadline bounds it: falling
                    # back now would apply this period twice — wait
                    # for the flight's result/error instead
                    deadline = time.monotonic() + self._timeout
        if flyer:
            # flyer path — wire op OUTSIDE the lock
            err = None
            center = None
            try:
                center = self._fly(work, payload)
            except BaseException as e:
                err = e
            with self._cv:
                self._flying = False
                gen_res = {r: (center,
                               None if err is None else
                               AggregatorDown(f"aggregate wire "
                                              f"exchange failed: "
                                              f"{err}"))
                           for r in work}
                out, my_err = gen_res.pop(rank)
                if gen_res and self._down is None \
                        and my_gen >= self._kill_watermark:
                    # a kill mid-flight already failed this gen's
                    # waiters into their direct fallback
                    # (at-least-once, exactly like a re-sent exchange
                    # after a lost reply) — publishing would only leak
                    # entries nobody collects; the watermark covers a
                    # kill+restart both landing while this flight was
                    # in the air
                    self._results[my_gen] = gen_res
                self._cv.notify_all()
            if my_err is not None:
                raise my_err
        # every worker — flyer and waiters alike — computes its own
        # share OUTSIDE the lock on its own thread and stream, instead
        # of serialized on the flyer while n-1 threads sit parked
        return self._share(payload, out)

    def _share(self, payload: Tensors, reply) -> Tensors:
        """One worker's period result from the wire reply, on the
        current stream of the payload's device: EASGD pulls its own
        params elastically against the PRE-update center; ASGD's reply
        is the fresh center, of which each worker gets its own copy."""
        center, ready = reply
        receive(center, ready)
        if self.kind == "easgd":
            a = float(np.float32(self._alpha))
            return [w - a * (w - c.to(w.device))
                    for w, c in zip(payload, center, strict=True)]
        return [c.to(w.device, copy=True)
                for w, c in zip(payload, center, strict=True)]

    def _fly(self, work: dict, own: Tensors):
        """Combine one period's payloads on the device of the flyer's
        own payload ``own`` and do the single wire exchange; returns the
        center reply every worker's :meth:`_share` is computed against,
        with the event that marks it written."""
        n = len(work)
        device = own[0].device
        payloads = []
        for r in sorted(work):
            p, ready = work[r]
            receive(p, ready)
            payloads.append([t.to(device) for t in p])
        with monitor.span("local_aggregate", rule=self.kind):
            if self.kind == "easgd":
                total = _tree_sum(payloads)
                mean = (payloads[0] if n == 1 else
                        [s / float(n) for s in total])
                reply = self._client.exchange_n(mean, n)
            else:  # asgd
                gsum = payloads[0] if n == 1 else _tree_sum(payloads)
                reply = self._client.push_pull_n(gsum, n)
        with self._lock:
            self.flights += 1
        if monitor.enabled():
            monitor.set_gauge("aggregate/fan_in", float(n),
                              rule=self.kind)
            monitor.inc("aggregate/exchanges_total", 1.0,
                        rule=self.kind)
            # bytes a direct fan-out would have put on the NIC and did
            # not: (n-1) extra requests + (n-1) extra replies
            saved = (n - 1) * (monitor.tree_bytes(payloads[0])
                               + monitor.tree_bytes(reply))
            if saved:
                monitor.inc("aggregate/bytes_saved_total",
                            float(saved), rule=self.kind)
        return reply, publish(reply)


class AggregatedExchange:
    """Per-worker port onto the host's :class:`LocalAggregator` —
    duck-types the store clients the async rules already program
    against, with the direct-exchange fallback (module docstring).

    ``direct_connect`` is the rule's existing per-worker client
    factory; it is only invoked on the first fallback, so the happy
    path opens zero extra connections."""

    def __init__(self, agg: LocalAggregator, rank: int,
                 direct_connect: Callable[[], Any]):
        self._agg = agg
        self._rank = int(rank)
        self._connect = direct_connect
        self._direct = None
        agg.register(rank)

    # -- fallback plumbing --------------------------------------------

    def _direct_client(self):
        if self._direct is None:
            self._direct = self._connect()
        return self._direct

    def _via(self, agg_call, direct_call, device):
        if self._agg.alive():
            try:
                return agg_call()
            except AggregatorDown:
                pass
        # BOTH fallback routes count: a worker that raced the kill
        # inside exchange() AND one that found the plane already down
        # — the monitor must see every direct period of a down window
        with self._agg._lock:
            self._agg.fallbacks += 1
        monitor.inc("aggregate/fallbacks_total", rule=self._agg.kind)
        return [t.to(device) for t in direct_call()]

    @staticmethod
    def _copy(tensors: Sequence[torch.Tensor]):
        """Copies of the worker's tensors on its device, made on its
        current stream after its step, and the event marking them
        written: the period reads them while the worker goes on."""
        out = [t.detach().clone() for t in tensors]
        return out, publish(out)

    # -- store-client surface -----------------------------------------

    def exchange(self, worker_params: Sequence[torch.Tensor]) -> Tensors:
        mine, ready = self._copy(worker_params)
        return self._via(
            lambda: self._agg.exchange(self._rank, mine, ready),
            lambda: self._direct_client().exchange(mine),
            worker_params[0].device)

    def push_pull(self, grads: Sequence[torch.Tensor]) -> Tensors:
        mine, ready = self._copy(grads)
        return self._via(
            lambda: self._agg.exchange(self._rank, mine, ready),
            lambda: self._direct_client().push_pull(mine),
            grads[0].device)

    # control ops ride the aggregator's (thread-safe) service handle —
    # they are rare and tiny, so aggregating them would buy nothing
    def set_lr(self, lr: float) -> None:
        self._agg._client.set_lr(lr)

    def get_center(self) -> Tensors:
        return self._agg._client.get_center()

    def get_opt_state(self) -> Tensors:
        return self._agg._client.get_opt_state()

    @property
    def supports_opt_state(self) -> bool:
        return getattr(self._agg._client, "supports_opt_state", True)

    def close(self) -> None:
        """Leave the period quorum and drop the fallback client (if
        one was ever opened).  Never touches the aggregator's shared
        service handle — the rule session owns that."""
        self._agg.leave(self._rank)
        direct, self._direct = self._direct, None
        if direct is not None and hasattr(direct, "close"):
            direct.close()
