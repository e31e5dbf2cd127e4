"""Dynamic request batching for the inference path.

A copy of ``theanompi_tpu/serving/batcher.py``.  A :class:`DynamicBatcher`
coalesces concurrent requests until ``max_batch`` rows are pending or the
OLDEST request has waited ``max_delay_ms``, pads the batch with zero rows
up to one of a small fixed set of bucket sizes (``BatchPolicy.buckets``,
default powers of two up to ``max_batch``), runs it, and slices each
request's rows back out.  Eval-mode inference is row-independent (BN
uses running statistics), so pad rows cannot perturb real rows.

Admission control: the pending-request queue is bounded at
``max_queue``; beyond it ``submit`` raises :class:`Overloaded` at once
instead of queueing.

Unlike the JAX batcher, warmup runs on the collector thread itself, at
``start()``: PyTorch's cuBLAS/cuDNN handles are per thread.

Telemetry (no-op while the monitor is off): ``serving/request_ms``,
``serving/batch_rows``, ``serving/batch_occupancy``,
``serving/queue_depth``, ``serving/overloaded_total``,
``serving/padding_rows_total``, ``serving/batches_total``,
``serving/batch_errors_total``, ``serving/replica_heartbeat``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock


class Overloaded(RuntimeError):
    """Admission-control rejection: the queue is at capacity (or the
    replica is dead).  Deliberately NOT retried by the transport —
    the server answered, fast, and the correct reactions (client-side
    backoff, load shedding, more replicas) live above the wire."""


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always included) — a handful
    of batch shapes covering every occupancy."""
    out = set()
    b = 1
    while b < max_batch:
        out.add(b)
        b *= 2
    out.add(max_batch)
    return tuple(sorted(out))


def pick_bucket(rows: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= rows (buckets sorted ascending)."""
    for b in buckets:
        if b >= rows:
            return b
    raise ValueError(f"{rows} rows exceed the largest bucket "
                     f"{buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Batching/admission knobs for one replica (docs/SERVING.md)."""

    #: max rows per coalesced batch (= the largest bucket)
    max_batch: int = 8
    #: max time the OLDEST pending request waits for company before
    #: the batch dispatches regardless of occupancy
    max_delay_ms: float = 5.0
    #: padded batch shapes (sorted ascending); None = powers of two up
    #: to max_batch.  The largest bucket must equal max_batch.
    buckets: tuple[int, ...] | None = None
    #: admission bound: pending REQUESTS beyond this are rejected with
    #: Overloaded instead of queued
    max_queue: int = 32
    #: a submitted request gives up after this long (a dead/wedged
    #: replica must not hang its clients forever)
    submit_timeout_s: float = 60.0

    def resolved_buckets(self) -> tuple[int, ...]:
        if self.buckets is None:
            return default_buckets(self.max_batch)
        bs = tuple(sorted(set(int(b) for b in self.buckets)))
        if not bs or bs[0] < 1:
            raise ValueError(f"invalid buckets {self.buckets!r}")
        if bs[-1] != self.max_batch:
            raise ValueError(
                f"largest bucket {bs[-1]} != max_batch {self.max_batch} "
                "— a full batch must have a shape to land in")
        return bs


class _Request:
    __slots__ = ("x", "rows", "done", "result", "error", "t0")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.rows = int(x.shape[0])
        self.done = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.t0 = time.monotonic()


class DynamicBatcher:
    """One replica's coalescing queue + collector thread.

    ``run_batch(x_padded) -> y`` executes one padded batch (leading
    dim is a bucket size); it is called from the collector thread
    only, so it needs no locking of its own.  A batch-execution
    exception fails THAT batch's requests (each ``submit`` re-raises
    it) and is handed to ``on_batch_error``; if the hook returns
    falsy the batcher marks itself dead — pending and future submits
    are rejected with :class:`Overloaded` so the server routes around
    the corpse (serving/server.py owns the restart-from-export
    policy)."""

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 policy: BatchPolicy | None = None, replica: int = 0,
                 on_batch_error: Callable[[BaseException], bool]
                 | None = None):
        self.policy = policy or BatchPolicy()
        self.buckets = self.policy.resolved_buckets()
        self.replica = int(replica)
        self._run_batch = run_batch
        self._on_batch_error = on_batch_error
        self._q: deque[_Request] = deque()      # guarded_by: self._lock
        self._qrows = 0                         # guarded_by: self._lock
        self._lock = make_lock("DynamicBatcher._lock")
        self._cond = make_condition(self._lock)
        self._stop = threading.Event()
        self._dead = False                      # guarded_by: self._lock
        self._thread: threading.Thread | None = None
        self._warmup: Callable[[], None] | None = None
        # plain-int stats (read without the lock — torn reads of a
        # monotonically-increasing int are harmless for stats())
        self.n_batches = 0
        self.n_rows = 0
        self.n_overloaded = 0
        self.n_batch_errors = 0
        self.max_occupancy = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "DynamicBatcher":
        """Start the collector thread.  A queued :meth:`warmup` runs
        first, on that thread; start() returns once it has run and
        re-raises its error (with the batcher stopped)."""
        ready = threading.Event()
        failed: list[Exception] = []

        def run():
            try:
                if self._warmup is not None:
                    self._warmup()
            except Exception as e:  # re-raised by start() below
                failed.append(e)
                return
            finally:
                ready.set()
            self._loop()

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"serving-batcher-{self.replica}")
        self._thread.start()
        ready.wait()
        if failed:
            self.stop()
            raise failed[0]
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._fail_pending(Overloaded(
            f"replica {self.replica} is shutting down"))

    @property
    def alive(self) -> bool:
        # _dead is declared guarded_by this lock, so the probe honors
        # the discipline.  alive is inherently check-then-act either
        # way — the server re-checks under the lock in submit() and
        # converts a lost race into Overloaded failover; the cost here
        # is one uncontended acquire per routing probe (the collector
        # releases the lock while it waits in _collect).
        with self._lock:
            return not self._dead and not self._stop.is_set()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def stats(self) -> dict:
        return {
            "replica": self.replica,
            "alive": self.alive,
            "batches": self.n_batches,
            "rows": self.n_rows,
            "overloaded": self.n_overloaded,
            "batch_errors": self.n_batch_errors,
            "max_occupancy": self.max_occupancy,
            "queue_depth": self.queue_depth(),
        }

    # -- client side ---------------------------------------------------

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Enqueue one request (``x``: (rows, *sample)) and block for
        its rows of the batched result.  Raises :class:`Overloaded`
        on admission rejection, or re-raises the batch-execution
        error that consumed this request."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request needs a leading rows dim >= 1, "
                             f"got shape {x.shape}")
        if x.shape[0] > self.policy.max_batch:
            raise ValueError(
                f"request rows {x.shape[0]} exceed max_batch "
                f"{self.policy.max_batch}; split the request")
        req = _Request(x)
        with self._cond:
            if self._dead or self._stop.is_set():
                self.n_overloaded += 1
                monitor.inc("serving/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"replica {self.replica} is not serving")
            if len(self._q) >= self.policy.max_queue:
                self.n_overloaded += 1
                monitor.inc("serving/overloaded_total",
                            replica=self.replica)
                raise Overloaded(
                    f"replica {self.replica} queue is full "
                    f"({self.policy.max_queue} pending); rejecting "
                    "instead of queueing unboundedly")
            self._q.append(req)
            self._qrows += req.rows
            monitor.set_gauge("serving/queue_depth", len(self._q),
                              replica=self.replica)
            self._cond.notify_all()
        if not req.done.wait(self.policy.submit_timeout_s):
            # reclaim the admission slot: an abandoned request must not
            # keep counting against max_queue (starving live requests
            # with Overloaded) nor burn a device batch nobody awaits.
            # If the collector already popped it into an in-flight
            # batch (ValueError below) it executes once regardless —
            # there is no cancelling a dispatched batch.
            with self._cond:
                try:
                    self._q.remove(req)
                    self._qrows -= req.rows
                    monitor.set_gauge("serving/queue_depth",
                                      len(self._q),
                                      replica=self.replica)
                except ValueError:
                    pass
            raise TimeoutError(
                f"request timed out after "
                f"{self.policy.submit_timeout_s}s on replica "
                f"{self.replica} (wedged batch?)")
        if req.error is not None:
            raise req.error
        monitor.observe("serving/request_ms",
                        (time.monotonic() - req.t0) * 1e3)
        return req.result

    # -- collector thread ---------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            group = self._collect()
            if group:
                self._execute(group)

    def _collect(self) -> list[_Request]:
        """Block for the first request, then hold the batch open until
        ``max_batch`` rows are pending or the oldest request has
        waited ``max_delay_ms``; pop whole requests up to the row
        cap."""
        max_rows = self.policy.max_batch
        with self._cond:
            while not self._q and not self._stop.is_set():
                # bounded wait so the heartbeat stays fresh while idle
                self._cond.wait(0.25)
                monitor.set_gauge("serving/replica_heartbeat",
                                  time.time(), replica=self.replica)
            if self._stop.is_set():
                return []
            deadline = self._q[0].t0 + self.policy.max_delay_ms / 1e3
            while self._qrows < max_rows and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            group: list[_Request] = []
            rows = 0
            while self._q and rows + self._q[0].rows <= max_rows:
                req = self._q.popleft()
                self._qrows -= req.rows
                group.append(req)
                rows += req.rows
            monitor.set_gauge("serving/queue_depth", len(self._q),
                              replica=self.replica)
            return group

    def _execute(self, group: list[_Request]) -> None:
        rows = sum(r.rows for r in group)
        bucket = pick_bucket(rows, self.buckets)
        x = (group[0].x if len(group) == 1
             else np.concatenate([r.x for r in group], axis=0))
        if bucket > rows:
            pad = np.zeros((bucket - rows, *x.shape[1:]), x.dtype)
            x = np.concatenate([x, pad], axis=0)
            monitor.inc("serving/padding_rows_total", bucket - rows,
                        replica=self.replica)
        try:
            out = np.asarray(self._run_batch(x))
        except Exception as e:
            self.n_batch_errors += 1
            monitor.inc("serving/batch_errors_total",
                        replica=self.replica)
            for r in group:
                r.error = e
                r.done.set()
            if self._on_batch_error is not None:
                if not self._on_batch_error(e):
                    self._mark_dead()
            return
        self.n_batches += 1
        self.n_rows += rows
        self.max_occupancy = max(self.max_occupancy, len(group))
        monitor.observe("serving/batch_rows", rows,
                        replica=self.replica)
        monitor.observe("serving/batch_occupancy", rows / bucket,
                        replica=self.replica)
        monitor.inc("serving/batches_total", replica=self.replica)
        monitor.set_gauge("serving/replica_heartbeat", time.time(),
                          replica=self.replica)
        off = 0
        for r in group:
            r.result = out[off:off + r.rows]
            off += r.rows
            r.done.set()

    def _mark_dead(self) -> None:
        with self._cond:
            self._dead = True
            self._cond.notify_all()
        self._fail_pending(Overloaded(
            f"replica {self.replica} died (restart budget exhausted)"))

    def _fail_pending(self, err: BaseException) -> None:
        with self._cond:
            pending, self._q = list(self._q), deque()
            self._qrows = 0
        for r in pending:
            if not r.done.is_set():
                r.error = err
                r.done.set()

    # -- warmup ---------------------------------------------------------

    def warmup(self, sample_shape: tuple[int, ...],
               dtype: np.dtype, fn: Callable | None = None) -> None:
        """Queue a run of every bucket shape (zeros through
        ``run_batch``) on the collector thread, before it takes its
        first request: PyTorch creates its cuBLAS/cuDNN handles per
        thread at first use, so warming any other thread would leave the
        first served batches to pay for them.  Call before start().
        ``fn`` overrides the batch fn: the server passes the raw session
        so warmup bypasses the ``serve_step`` fault site and the served-
        batch counter — an injected fault must hit serving, not
        start-up."""
        fn = fn or self._run_batch

        def run():
            for b in self.buckets:
                fn(np.zeros((b, *sample_shape), dtype))

        self._warmup = run
