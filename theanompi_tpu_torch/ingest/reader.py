"""Ingest reader — one process of the standalone reader fleet (copy of
``theanompi_tpu/ingest/reader.py``).

A reader owns the mmap shard tree read path for a slice of every
epoch: it derives the epoch permutation purely from (seed, epoch)
(``ingest/order.py``), pre-pages its ASSIGNED batch range in a
background thread (maps each shard file and touches one byte of every
page), and serves ``ingest_batch`` pulls by gathering rows
straight from the mmaps into a uint8 batch that ships as a raw wire-v2
frame (``wire.RawArrays``: zero-copy buffers, no zlib attempt, no
re-dtype).  Because the permutation is pure, any reader can serve any
batch index byte-identically — assignment is read-ahead locality, not
correctness — which is what makes the coordinator's mid-epoch
reassignment after a reader death safe.

Backpressure (the serving discipline): concurrent
assemblies are admission-bounded at ``max_inflight``; a pull beyond
that is rejected in O(1) with the typed :class:`Overloaded` the
serving stack already defines — the class name rides the wire's err
prefix, the client backs off and retries.  A reader therefore never
holds more than ``max_inflight`` assembled batches (plus one in-flight
reply per connection), no matter how many trainers lean on it.

Runs behind the param-service wire loop (``parallel/service.py
serve``, the port's selector loop): HMAC auth via
``THEANOMPI_TPU_SERVICE_KEY``, negotiated v2 framing, typed err
replies, faithful shutdown.  The reader imports no card library beyond
``torch`` itself and never touches a card.

Launch:  ``python -m theanompi_tpu_torch.ingest.reader --port 45951 \\
             --data-dir /data/imagenet --seed 0 --reader-id 0``
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.data.imagenet import (
    _file_size_map,
    _shard_glob,
    shard_tree_signature,
)
from theanompi_tpu_torch.ingest import protocol
from theanompi_tpu_torch.ingest.order import EpochOrder
from theanompi_tpu_torch.parallel import wire
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving.batcher import Overloaded

#: (epoch, rank, size) orders a reader keeps live.  One entry per
#: TRAINER STREAM per epoch — T trainers need T entries for the
#: current epoch alone, plus the next epoch being pre-paged and slack
#: for a straggler finishing the previous one.  Sized generously (an
#: order is perms + mmap handles, ~KBs/shard): an undersized cache is
#: catastrophic, not merely slow — T+1 streams over a cache of T
#: churns every pull into a full permutation rebuild + mmap reopen
#: (measured: 0.4 ms assemblies become 15 ms).
ORDER_CACHE = 32

#: admission default — the bounded QUEUE: total batch pulls a reader
#: holds (executing + waiting) before it rejects in O(1).  A memory
#: bound (each admitted pull holds at most one assembled batch), sized
#: comfortably above normal concurrent demand (trainers x client depth
#: against one reader) because every rejection risks stalling a
#: trainer's head-of-line index behind a backoff sleep
MAX_INFLIGHT = 32

#: dedicated assembly threads per reader.  The gather holds the GIL
#: (numpy fancy indexing), so letting every connection's handler thread
#: gather its own batch degenerates into the GIL convoy (the JAX
#: package measured a reader serving 4 pipelined connections that way
#: collapse from ~940 to ~220 MB/s on its host).  Funneling ALL gathers
#: through one worker keeps exactly one GIL-holding thread while the
#: handler threads do only GIL-released socket sends
ASSEMBLY_THREADS = 1


#: how long an admitted pull waits for its assembly before the reader
#: calls itself wedged and sheds it (assemblies are ~ms; this only
#: trips if something is stuck)
_GATE_TIMEOUT_S = 30.0


def _touch_pages(x) -> None:
    """Read one byte of every 4 KiB page of a memory-mapped shard, so
    the page cache holds it before a pull gathers from it (the port's
    ``_load_shard`` maps without advising the kernel)."""
    flat = np.asarray(x).reshape(-1).view(np.uint8)
    int(flat[::4096].sum())


class IngestReader:
    """The reader's service object (``serve(service=...)`` dispatch).

    Thread model: the wire loop runs one handler thread per
    connection; ``handle`` is therefore concurrent.  The order cache
    and stats counters live under one lock; batch assembly itself runs
    outside it (the mmap gathers are read-only and the admission
    semaphore bounds their concurrency)."""

    def __init__(self, data_dir: str, seed: int = 0, reader_id: int = 0,
                 max_inflight: int | None = None):
        self.reader_id = int(reader_id)
        self.data_dir = data_dir
        self.seed = int(seed)
        self.files = _shard_glob(data_dir, "train")
        if not self.files:
            raise FileNotFoundError(
                f"no train_* shard files under {data_dir!r} — ingest "
                "readers serve a prepared shard tree "
                "(python -m theanompi_tpu_torch.tools.prepare_imagenet)")
        self.sizes = _file_size_map(data_dir, self.files)
        self.meta = shard_tree_signature(self.files, self.sizes,
                                         self.seed)
        self._max_inflight = (max_inflight if max_inflight is not None
                              else MAX_INFLIGHT)
        #: RPC-substrate executor width (parallel/rpc.py): a handler
        #: blocks on its assembly future, so the pool must admit
        #: max_inflight concurrent pulls plus slack — the O(1)
        #: Overloaded rejection needs a worker free to run it
        self.RPC_MAX_WORKERS = self._max_inflight + 4
        #: O(1) admission bound = the bounded queue (class docstring);
        #: a Semaphore is internally synchronized
        self._admission = threading.Semaphore(self._max_inflight)
        #: ALL gathers run on this worker so exactly one thread holds
        #: the GIL for assembly (ASSEMBLY_THREADS) — handler
        #: threads wait on the future (parked, no GIL churn) and then
        #: do only the GIL-released reply send
        from concurrent.futures import ThreadPoolExecutor

        self._assembler = ThreadPoolExecutor(
            max_workers=ASSEMBLY_THREADS,
            thread_name_prefix=f"ingest-assemble-r{self.reader_id}")
        self._lock = make_lock("IngestReader._lock")
        self._orders: OrderedDict = OrderedDict()  # guarded_by: self._lock
        self._served = 0                           # guarded_by: self._lock
        self._assigned: dict = {}                  # guarded_by: self._lock
        #: serializes assignment replacement end to end (swap, stop
        #: previous, START new) — without it a concurrent ingest_assign
        #: could observe a stored-but-not-yet-started thread and join
        #: it (RuntimeError).  Ordered strictly before self._lock.
        self._assign_serial = make_lock("IngestReader._assign_serial")
        self._prefetch_stop: threading.Event | None = None  # guarded_by: self._lock
        self._prefetch_thread: threading.Thread | None = None  # guarded_by: self._lock

    # -- epoch orders ---------------------------------------------------

    def _order(self, epoch: int, rank: int, size: int) -> EpochOrder:
        key = (int(epoch), int(rank), int(size))
        with self._lock:
            order = self._orders.get(key)
            if order is not None:
                self._orders.move_to_end(key)
                return order
        # construct outside the lock (permutation draws for the whole
        # file list); a racing handler's copy loses via setdefault
        order = EpochOrder(self.files, self.sizes, self.seed, *key)
        with self._lock:
            order = self._orders.setdefault(key, order)
            self._orders.move_to_end(key)
            evicted = []
            while len(self._orders) > ORDER_CACHE:
                _, old = self._orders.popitem(last=False)
                evicted.append(old)
        for old in evicted:
            old.drop_shards()  # release the retired epoch's mmaps
        return order

    # -- ops ------------------------------------------------------------

    def _batch(self, epoch, rank, size, global_batch, index):
        faults.fire("ingest_batch", reader=self.reader_id, epoch=epoch,
                    index=index)
        if not self._admission.acquire(blocking=False):
            monitor.inc("ingest/reader_overloaded_total",
                        reader=self.reader_id)
            raise Overloaded(
                f"reader {self.reader_id}: {self._max_inflight} "
                "assemblies already in flight; rejecting instead of "
                "queueing unboundedly")
        t0 = time.monotonic()
        try:
            order = self._order(epoch, rank, size)
            fut = self._assembler.submit(order.assemble, int(index),
                                         int(global_batch))
            import concurrent.futures

            try:
                x, y = fut.result(timeout=_GATE_TIMEOUT_S)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                monitor.inc("ingest/reader_overloaded_total",
                            reader=self.reader_id)
                raise Overloaded(
                    f"reader {self.reader_id}: assembly not scheduled "
                    f"within {_GATE_TIMEOUT_S}s (wedged gather?)"
                ) from None
        finally:
            self._admission.release()
        with self._lock:
            self._served += 1
        monitor.inc("ingest/reader_batches_total", reader=self.reader_id)
        monitor.observe("ingest/reader_assemble_ms",
                        (time.monotonic() - t0) * 1e3,
                        reader=self.reader_id)
        monitor.progress(phase="ingest")
        return wire.RawArrays(x, y)

    def _assign(self, epoch, rank, size, global_batch, lo, hi):
        """Record the assigned batch range and (re)start the read-ahead
        thread pre-paging its shard files.  A new assignment replaces
        the previous one (epoch rotation / mid-epoch reassignment)."""
        key = (int(epoch), int(rank), int(size))
        order = self._order(*key)
        file_idx = order.files_for_batches(int(lo), int(hi),
                                           int(global_batch))
        stop = threading.Event()
        thread = threading.Thread(
            target=self._prefetch, args=(order, file_idx, stop),
            daemon=True, name=f"ingest-prefetch-r{self.reader_id}")
        with self._assign_serial:
            with self._lock:
                self._assigned[key] = (int(lo), int(hi))
                prev_stop, prev_thread = (self._prefetch_stop,
                                          self._prefetch_thread)
                self._prefetch_stop = stop
                self._prefetch_thread = thread
            if prev_stop is not None:
                prev_stop.set()
            if prev_thread is not None:
                prev_thread.join(timeout=5)
            # started INSIDE the serial section: whoever replaces this
            # assignment next is guaranteed to see a started thread
            thread.start()
        return "ok"

    def _prefetch(self, order: EpochOrder, file_idx: list[int],
                  stop: threading.Event) -> None:
        for i in file_idx:
            if stop.is_set():
                return
            _touch_pages(order._shard(i)[0])
            monitor.inc("ingest/reader_prefetch_files_total",
                        reader=self.reader_id)

    def stop_prefetch(self) -> None:
        """Stop the read-ahead thread (shutdown path; also keeps the
        test suite's thread-leak fence honest)."""
        with self._assign_serial:  # a mid-flight _assign finishes first
            with self._lock:
                stop, thread = self._prefetch_stop, self._prefetch_thread
                self._prefetch_stop = self._prefetch_thread = None
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def shutdown(self) -> None:
        """Full teardown: read-ahead thread + the assembly worker."""
        self.stop_prefetch()
        self._assembler.shutdown(wait=True)

    def stats(self) -> dict:
        with self._lock:
            return {"reader": self.reader_id,
                    "served": self._served,
                    "assigned": {f"{k[0]}/{k[1]}/{k[2]}": list(v)
                                 for k, v in self._assigned.items()},
                    "max_inflight": self._max_inflight,
                    "n_files": len(self.files)}

    #: control-plane ops (parallel/rpc.py): meta checks, assignment
    #: pushes, and stats must not queue behind a pool of batch pulls
    #: parked on assembly futures
    RPC_CONTROL_OPS = frozenset({protocol.OP_INFO, protocol.OP_META,
                                 protocol.OP_ASSIGN, "stats"})

    def handle(self, op: str, *args):
        if op == protocol.OP_BATCH:
            return self._batch(*args)
        if op == protocol.OP_INFO:
            return {"kind": "reader", "reader": self.reader_id,
                    "pid": os.getpid()}
        if op == protocol.OP_META:
            return dict(self.meta)
        if op == protocol.OP_ASSIGN:
            return self._assign(*args)
        if op == "stats":
            return self.stats()
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


def serve_reader(host: str, port: int, reader: IngestReader,
                 ready_event: threading.Event | None = None,
                 stop_event: threading.Event | None = None,
                 authkey: bytes | None = None) -> None:
    """The param-service wire loop over an :class:`IngestReader`."""
    from theanompi_tpu_torch.parallel.service import serve

    try:
        serve(host, port, ready_event=ready_event, stop_event=stop_event,
              authkey=authkey, service=reader)
    finally:
        reader.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.ingest.reader",
        description="theanompi-tpu ingest reader (PyTorch port) — one "
                    "process of the distributed ingest fleet")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data-dir", required=True,
                    help="prepared shard tree (train_*.x.npy pairs "
                         "and/or .npz)")
    ap.add_argument("--seed", type=int, default=0,
                    help="MUST equal the trainers' dataset seed — the "
                         "epoch permutation derives from it (the "
                         "client's meta check refuses a mismatch)")
    ap.add_argument("--reader-id", type=int, default=0)
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="admission bound on concurrent batch pulls "
                         f"(the bounded queue; default {MAX_INFLIGHT})")
    args = ap.parse_args(argv)
    reader = IngestReader(args.data_dir, seed=args.seed,
                          reader_id=args.reader_id,
                          max_inflight=args.max_inflight)
    print(f"[ingest] reader {args.reader_id} serving {len(reader.files)} "
          f"shard files from {args.data_dir} on "
          f"{args.host}:{args.port}", flush=True)
    # request-driven progress, no stall watchdog; per-process file
    # suffix so N readers sharing a monitor dir never clobber each other
    with monitor.session(stall_after=float("inf"),
                         name=f"ingest_reader{args.reader_id}_"
                              f"{os.getpid()}"):
        monitor.progress(phase="ingest")
        serve_reader(args.host, args.port, reader)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
