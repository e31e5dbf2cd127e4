"""RemoteBatchSource — the trainer's view of the reader fleet (copy of
``theanompi_tpu/ingest/client.py``).

An iterator of host ``(x, y)`` batches that plugs into
``DevicePrefetcher`` exactly where ``Dataset.train_batches`` does
(models/base.py ``begin_epoch``), so the rules switch between local
and distributed ingest on nothing but the launcher's ``--ingest``
flag.  One instance covers one (epoch, rank, size) stream and yields
its batches IN EPOCH ORDER — byte-identical to the in-process loader
for the same seed (pinned by tests/test_torch_ingest.py, also against
the JAX package's readers), because reader and trainer derive the same
permutation from (seed, epoch).  Addresses are ``host:port`` or
``unix:/path``, as in JAX; each pipe's handshake and wire hello wait
under ``rpc``'s deadline.

Mechanics:

* **plan** — from the coordinator (``--ingest coord:port``) or derived
  client-side over a static reader list (``--ingest r1:p,r2:p``);
  either way a contiguous batch-range assignment
  (``protocol.partition_batches``, rotated by trainer rank so a
  same-phase trainer fleet loads every reader concurrently).
* **meta check** — every reader's ``ingest_meta`` must equal the local
  dataset's ``ingest_signature()`` (same seed, same shard set); a
  mismatched fleet is a hard construction error, not a silently
  different permutation.
* **pipelined pulls, ONE fetch thread** — up to ``depth`` request
  frames are in flight at once, pipelined on a single connection per
  reader (the serve loop handles one connection's requests in order,
  so replies come back FIFO) and collected with a select-style
  ``multiprocessing.connection.wait`` over all pending connections.
  One thread by design: the JAX package measured N recv threads in
  one client process collapse from ~1000 to ~40 pulls/s at N=12 — the
  classic GIL convoy (every IO wake-up pays the 5 ms switch interval
  against whichever thread holds the GIL); a single select loop
  streams at full socket rate.  The in-flight window doubles as the
  trainer-side backpressure: a slow consumer freezes the window,
  which idles the fleet — no queue anywhere grows past ``depth``.
* **one socket per reader peer** — unless the wire is pinned to v1,
  the pipes ride the RPC substrate's stream multiplexing
  (``parallel/rpc.py``): the meta/probe control clients and the pull
  pipeline to one reader share one authenticated socket; against a
  non-mux server every stream silently falls back to its own socket.
* **overload** — a reader's typed ``Overloaded`` rejection reschedules
  the pull after a short jittered backoff (kept small: a backed-off
  index can be the stream's head-of-line, and everything behind the
  reorder window waits on it).
* **failover** — a connect/transport failure marks the reader dead
  (reported to the coordinator, which verifies before reassigning;
  static mode re-partitions over the survivors), re-queues every
  index that was in flight on that connection, and retries on the new
  owners.  Correct because any reader serves any index identically.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque

import numpy as np

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.ingest import protocol
from theanompi_tpu_torch.ingest.protocol import ingest_addresses  # re-export
from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.parallel import rpc, shm, wire
from theanompi_tpu_torch.parallel.rpc import wait_readable as _wait_readable
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.resilience.retry import CONNECTION_ERRORS, RetryPolicy

__all__ = ["RemoteBatchSource", "ingest_addresses"]

#: how many times one batch index may be re-queued (owner failovers +
#: overload retries) before the stream gives up
MAX_RESENDS_PER_BATCH = 64

#: overload backoff: base * 2^k, jittered, capped.  The cap stays
#: small because a backed-off pull can be the stream's HEAD-OF-LINE
#: index — everything behind the reorder window waits on it, so a
#: long sleep here converts one rejection into a whole-stream stall
_BACKOFF_BASE_S = 0.005
_BACKOFF_CAP_S = 0.05


#: pulls in flight at once when the caller passes no ``depth``
DEPTH = 8


def _control_retry() -> RetryPolicy:
    """Fail-fast policy for control-plane calls (probe, meta, plan,
    report-dead): a dead fleet must answer in seconds, not wait out a
    30 s reconnect ladder."""
    return RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.2,
                       multiplier=2.0, jitter=0.5, deadline_s=3.0,
                       name="ingest_control")


class _ReaderPipe:
    """One pipelined stream to one reader, owned by the fetch thread
    (single-threaded by design — no locking): HMAC connect + the same
    silent wire-v2 negotiation ``ServiceClient`` does, plus a FIFO of
    in-flight (index, t_sent) — the serve loop answers one stream's
    requests in order, so reply k is the FIFO's head.

    ``transport`` (a ``rpc.MuxConnection``) makes the pipe one logical
    stream on a shared socket instead of its own connection — the
    control-plane clients and the pull pipeline to one reader then
    cost one fd between them."""

    def __init__(self, addr: str, transport=None,
                 offer_shm: bool = True):
        from theanompi_tpu_torch.parallel.service import _authkey

        self.addr = addr
        self.wire: wire.WireOptions | None = None
        self.trace = False  # hello grant — batch pulls then carry ctx
        #: the shm lane channel THIS pipe negotiated (None when riding
        #: a mux transport, whose shared channel the transport owns)
        self._own_shm = None
        self.fifo: deque = deque()  # (index, t_sent)
        if transport is not None:
            self.conn, pre = transport.connect_stream()
            if pre is not None:
                self.wire = pre
                self.trace = transport.trace
                return  # negotiation inherited from the transport
        else:
            self.conn = rpc.connect_client(rpc.client_address(addr),
                                           _authkey())
            rpc.set_nodelay(self.conn)
        if os.environ.get("THEANOMPI_TPU_WIRE_PROTOCOL", "v2") == "v2":
            want = wire.WireOptions.from_env()
            offer = shm.client_offer() if offer_shm else None
            self.conn.send((wire.HELLO_OP,
                            wire.hello_payload(want, shm_offer=offer)))
            status, payload = rpc.recv_deadline(self.conn)
            if (status == "ok" and isinstance(payload, dict)
                    and payload.get("version") == wire.WIRE_VERSION):
                self._own_shm = shm.client_channel(offer, payload)
                self.wire = wire.WireOptions(
                    compression=payload.get("compression", "none"),
                    dtype=payload.get("dtype", "f32"),
                    allow_pickle=want.allow_pickle,
                    shm=self._own_shm)
                self.trace = bool(payload.get("trace"))

    def send(self, msg) -> None:
        if self.trace:
            ctx = trace.inject()
            if ctx is not None:
                msg = (wire.TRACE_OP, ctx, *msg)
        if self.wire is not None:
            wire.send_msg(self.conn, msg, self.wire)
        else:
            self.conn.send(msg)

    def recv(self):
        if self.wire is not None:
            return wire.recv_msg(self.conn, self.wire)
        return self.conn.recv()

    def close(self) -> None:
        ch, self._own_shm = self._own_shm, None
        if ch is not None:
            ch.close()  # release leases the reader never acked
        try:
            self.conn.close()
        except OSError:
            pass


class RemoteBatchSource:
    """Iterator of host batches for ONE epoch stream (class docstring).

    ``data`` is the trainer's local dataset object — used for the
    byte-identity meta check (``ingest_signature()``), the batch count,
    and to refuse configurations the remote stream cannot reproduce
    (host-side augmentation)."""

    def __init__(self, addresses: list[str], data, epoch: int,
                 global_batch: int, rank: int = 0, size: int = 1,
                 depth: int | None = None):
        if getattr(data, "device_transform", None) is None:
            raise ValueError(
                "distributed ingest ships raw uint8 store batches; the "
                "dataset must augment on device (augment_on_device="
                "True) for the remote stream to be byte-identical to "
                "the local one")
        sig = data.ingest_signature()  # raises for synthetic datasets
        self.epoch = int(epoch)
        self.rank = int(rank)
        self.size = int(size)
        self.global_batch = int(global_batch)
        self.n_batches = int(data.n_train_batches_for(
            epoch, global_batch, rank, size))
        self.depth = depth if depth is not None else DEPTH
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        #: one multiplexed socket per reader peer (parallel/rpc.py):
        #: the meta/probe control clients and the pull pipeline share
        #: it, and against a non-mux server every stream silently gets
        #: its own socket.  A v1-pinned run keeps dedicated sockets —
        #: mux streams are wire-v2 framed by construction, so honoring
        #: the operator's v1 escape hatch means never negotiating a mux
        #: hello
        self._mux = (os.environ.get("THEANOMPI_TPU_WIRE_PROTOCOL", "v2")
                     != "v1")
        #: addr -> rpc.MuxConnection; fetch thread + constructor only
        self._transports: dict = {}
        #: offer the shared-memory batch lane to readers; a typed
        #: ShmRefusal flips this off and every later pull goes in-band
        #: (silent, never a stream failure)
        self._shm_on = True

        # consumer-facing state (fetch thread produces, __next__
        # consumes)
        self._lock = make_lock("RemoteBatchSource._lock")
        self._cond = make_condition(self._lock,
                                    "RemoteBatchSource._cond")
        self._next_yield = 0            # guarded_by: self._lock
        self._results: dict = {}        # guarded_by: self._lock
        self._err: BaseException | None = None  # guarded_by: self._lock
        self._closed = False            # guarded_by: self._lock
        # plan state (fetch thread mutates on failover; the
        # constructor writes it once before the thread starts)
        self._coord = None
        self._readers: list[str] = []   # guarded_by: self._lock
        self._owners: list = []         # guarded_by: self._lock

        self._resolve_fleet(list(addresses), sig)
        self._thread = threading.Thread(
            target=self._fetch_loop, daemon=True,
            name=f"ingest-fetch-r{self.rank}")
        self._thread.start()

    # -- fleet resolution (control plane: plain ServiceClient) ---------

    def _transport(self, addr: str):
        """The shared per-peer mux transport (None when mux is off)."""
        if not self._mux:
            return None
        t = self._transports.get(addr)
        if t is None:
            t = self._transports[addr] = rpc.MuxConnection(addr)
        return t

    def _drop_transport(self, addr: str) -> None:
        t = self._transports.pop(addr, None)
        if t is not None:
            t.close()

    def _control_client(self, addr: str):
        from theanompi_tpu_torch.parallel.service import ServiceClient

        return ServiceClient(addr, retry=_control_retry(),
                             transport=self._transport(addr))

    def _resolve_fleet(self, addresses: list[str], sig: dict) -> None:
        probe = self._control_client(addresses[0])
        try:
            kind = probe.call(protocol.OP_INFO).get("kind")
        except Exception:
            probe.close()
            raise
        if kind == "coordinator":
            if len(addresses) > 1:
                probe.close()
                raise ValueError(
                    f"{addresses[0]} is a coordinator; pass EITHER one "
                    "coordinator address OR a comma-separated reader "
                    "list, not a mix")
            self._coord = probe
            self._refresh_plan()
        elif kind == "reader":
            probe.close()
            with self._lock:
                self._readers = list(addresses)
                self._owners = protocol.partition_batches(
                    self.n_batches, self._readers, rotation=self.rank)
        else:
            probe.close()
            raise ValueError(
                f"{addresses[0]} answered ingest_info with kind="
                f"{kind!r}; expected a reader or coordinator")
        # byte-identity fence: every reader in the plan must serve the
        # exact (seed, shard set) this trainer's dataset was built on
        with self._lock:
            fleet = sorted({addr for _, _, addr in self._owners})
        for addr in fleet:
            c = self._control_client(addr)
            try:
                meta = c.call(protocol.OP_META)
            finally:
                c.close()
            if meta != sig:
                raise ValueError(
                    f"ingest reader {addr} serves a different dataset "
                    f"than this trainer: reader {meta} vs local {sig} "
                    "— same --data-dir and --seed are required for a "
                    "byte-identical stream")

    def _refresh_plan(self) -> None:
        """(Re)fetch the assignment from the coordinator."""
        plan = self._coord.call(
            protocol.OP_PLAN, self.epoch, self.rank, self.size,
            self.global_batch, self.n_batches)
        with self._lock:
            self._owners = [tuple(o) for o in plan["owners"]]
            self._readers = sorted({a for _, _, a in self._owners})
        monitor.inc("ingest/plan_refreshes_total")

    def _fail_over(self, addr: str) -> None:
        """A pull could not reach ``addr``: drop it from the plan
        (verified via the coordinator when there is one) and
        re-partition over the survivors."""
        monitor.inc("ingest/reader_failovers_total", reader=addr)
        if self._coord is not None:
            self._coord.call(protocol.OP_REPORT_DEAD, addr)
            self._refresh_plan()
            with self._lock:
                survivors = [a for _, _, a in self._owners]
            if addr not in survivors:
                return
            # the coordinator still believes in it (its ping worked);
            # treat the failure as transient and keep the plan
            return
        with self._lock:
            survivors = [a for a in self._readers if a != addr]
            if not survivors:
                raise ConnectionError(
                    f"last ingest reader {addr} is unreachable; no "
                    "survivors to reassign its batch ranges to")
            self._readers = survivors
            self._owners = protocol.partition_batches(
                self.n_batches, survivors, rotation=self.rank)

    # -- the fetch loop (single thread, pipelined, select-driven) ------

    def _fetch_loop(self) -> None:
        pipes: dict[str, _ReaderPipe] = {}
        by_conn: dict = {}
        #: requeued indices awaiting their retry time: (not_before, i).
        #: A retried index was already claimed, so it is ALWAYS inside
        #: the window below — retries can never be starved by fresh
        #: sends (an earlier time-ordered design let later indices
        #: fill the window while a backed-off head-of-line index
        #: waited: permanent deadlock)
        retries: list = []
        resends: dict[int, int] = {}
        backoffs: dict[int, int] = {}
        next_seq = 0  # first never-sent index
        try:
            while True:
                with self._lock:
                    if self._closed or self._err is not None:
                        return
                    if self._next_yield >= self.n_batches:
                        return
                    # the bounded reorder window, by INDEX: everything
                    # outstanding (buffered results, in-flight pulls,
                    # pending retries) lives in [next_yield, window_hi)
                    window_hi = self._next_yield + self.depth
                now = time.monotonic()
                sent_any = False
                while retries and retries[0][0] <= now:
                    _, idx = heapq.heappop(retries)
                    if self._send(idx, pipes, by_conn, retries,
                                  resends):
                        sent_any = True
                while next_seq < min(window_hi, self.n_batches):
                    idx = next_seq
                    next_seq += 1
                    if self._send(idx, pipes, by_conn, retries,
                                  resends):
                        sent_any = True
                busy = [p.conn for p in pipes.values() if p.fifo]
                if not busy:
                    if not retries:
                        # window full of buffered results (or stream
                        # fully sent): wait for the consumer to drain
                        with self._cond:
                            if (self._next_yield < self.n_batches
                                    and not self._closed
                                    and next_seq >= min(
                                        self._next_yield + self.depth,
                                        self.n_batches)):
                                self._cond.wait(0.05)
                        continue
                    # retries pending their backoff window
                    if not sent_any:
                        time.sleep(0.005)
                    continue
                # rpc.wait_readable == multiprocessing.connection.wait
                # for plain sockets, and also understands mux streams
                for conn in _wait_readable(busy, timeout=0.05):
                    pipe = by_conn[conn]
                    self._collect(pipe, pipes, by_conn, retries,
                                  resends, backoffs)
        except BaseException as e:
            with self._cond:
                if self._err is None:
                    self._err = e
                self._cond.notify_all()
        finally:
            for p in pipes.values():
                p.close()

    def _send(self, idx: int, pipes, by_conn, pending,
              resends) -> bool:
        """Issue one pipelined request; False re-queued the index."""
        faults.fire("ingest_pull", index=idx, rank=self.rank)
        with self._lock:
            addr = protocol.owner_of(self._owners, idx)
        try:
            pipe = pipes.get(addr)
            if pipe is None:
                pipe = pipes[addr] = _ReaderPipe(
                    addr, transport=self._transport(addr),
                    offer_shm=self._shm_on)
                by_conn[pipe.conn] = pipe
            if trace.enabled():
                # each pipelined pull roots its own trace at the send
                # (nothing else is open on the fetch thread); the
                # injected context makes the reader's serve span its
                # child.  Gated so the untraced fetch loop is
                # unchanged to the byte.
                with monitor.span("ingest_request", reader=pipe.addr,
                                  index=str(idx)):
                    pipe.send((protocol.OP_BATCH, self.epoch,
                               self.rank, self.size,
                               self.global_batch, idx))
            else:
                pipe.send((protocol.OP_BATCH, self.epoch, self.rank,
                           self.size, self.global_batch, idx))
            pipe.fifo.append((idx, time.monotonic()))
            return True
        except CONNECTION_ERRORS:
            self._drop_pipe(addr, pipes, by_conn, pending, resends,
                            extra=[idx])
            return False

    def _collect(self, pipe: _ReaderPipe, pipes, by_conn, pending,
                 resends, backoffs) -> None:
        """Receive the reply at the head of one pipe's FIFO."""
        idx, t_sent = pipe.fifo[0]
        try:
            with monitor.span("ingest_pull", reader=pipe.addr):
                status, payload = pipe.recv()
        except CONNECTION_ERRORS as e:
            if isinstance(e, wire.ShmRefusal):
                # a reply carried shm content this side must refuse:
                # a LANE failure, not a reader failure — reconnect
                # in-band without failing the reader over
                self._drop_lane(pipe, pipes, by_conn, pending, resends)
                return
            self._drop_pipe(pipe.addr, pipes, by_conn, pending,
                            resends)
            return
        pipe.fifo.popleft()
        if status == "ok":
            x, y = payload
            monitor.observe("ingest/pull_ms",
                            (time.monotonic() - t_sent) * 1e3,
                            reader=pipe.addr)
            backoffs.pop(idx, None)
            with self._cond:
                self._results[idx] = (np.asarray(x), np.asarray(y))
                self._cond.notify_all()
            return
        err = str(payload)
        if wire.ShmRefusal.__name__ in err:
            # the reader refused our frame's shm content (its lane
            # state is gone — restart, swept lease): requeue the pull
            # and retry in-band.  Typed classification, same idiom as
            # Overloaded below.
            pipe.fifo.appendleft((idx, t_sent))
            self._drop_lane(pipe, pipes, by_conn, pending, resends)
            return
        from theanompi_tpu_torch.serving.batcher import Overloaded

        if Overloaded.__name__ in err:
            # typed admission rejection: reschedule after a short
            # jittered backoff — load shedding, not failure
            monitor.inc("ingest/pull_overloaded_total",
                        reader=pipe.addr)
            k = backoffs.get(idx, 0)
            backoffs[idx] = k + 1
            self._requeue(idx, pending, resends, delay=min(
                _BACKOFF_CAP_S, _BACKOFF_BASE_S * (1 << min(k, 5))
            ) * (0.5 + (hash((idx, k)) % 100) / 100))
            return
        from theanompi_tpu_torch.parallel.service import ServiceError

        raise ServiceError(
            f"ingest reader {pipe.addr} rejected batch {idx}: {err}")

    def _drop_lane(self, pipe: _ReaderPipe, pipes, by_conn, pending,
                   resends) -> None:
        """A typed shm refusal: disable the lane for the whole stream,
        drop only this PIPE (the reader itself is healthy — no
        failover) and requeue everything that was in flight on it."""
        self._shm_on = False
        if self._mux:
            t = self._transports.get(pipe.addr)
            if t is not None:
                t.disable_shm()
        pipes.pop(pipe.addr, None)
        by_conn.pop(pipe.conn, None)
        lost = [i for i, _ in pipe.fifo]
        pipe.close()
        for i in lost:
            self._requeue(i, pending, resends, delay=0.0)

    def _drop_pipe(self, addr: str, pipes, by_conn, pending, resends,
                   extra=()) -> None:
        """A connection failed: re-queue everything in flight on it
        and move the plan off the reader."""
        pipe = pipes.pop(addr, None)
        lost = list(extra)
        if pipe is not None:
            by_conn.pop(pipe.conn, None)
            lost += [idx for idx, _ in pipe.fifo]
            pipe.close()
        # a fresh retry must not inherit the dead peer's mux socket
        self._drop_transport(addr)
        self._fail_over(addr)
        for idx in lost:
            self._requeue(idx, pending, resends, delay=0.0)

    def _requeue(self, idx: int, pending, resends,
                 delay: float) -> None:
        n = resends.get(idx, 0) + 1
        resends[idx] = n
        if n > MAX_RESENDS_PER_BATCH:
            raise ConnectionError(
                f"batch {idx} failed after {n} attempts across the "
                "reader fleet")
        heapq.heappush(pending, (time.monotonic() + delay, idx))

    # -- consumer side --------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while True:
                if self._err is not None:
                    err, self._err = self._err, None
                    self._closed = True
                    self._cond.notify_all()
                    raise err
                if self._closed:
                    # JAX's consumer would wait here forever
                    raise RuntimeError("RemoteBatchSource is closed")
                if self._next_yield >= self.n_batches:
                    raise StopIteration
                batch = self._results.pop(self._next_yield, None)
                if batch is not None:
                    self._next_yield += 1
                    self._cond.notify_all()  # window opens
                    return batch
                self._cond.wait(0.1)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        if self._coord is not None:
            self._coord.close()
        for t in list(self._transports.values()):
            t.close()
        self._transports.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
