"""Prefill fleet: the compute-bound half of disaggregated serving.

Counterpart of ``theanompi_tpu/frontdoor/prefill.py``.  A
:class:`PrefillServer` owns one
:class:`~theanompi_tpu_torch.decode.session.DecodeSession` and runs only
the prompt-phase programs: ``prefill`` (and ``extend`` on a prefix-cache
hit).  One ``prefill`` RPC admits the prompt, reads the first generated
token off the prefill logits, exports the sequence's KV pages to the
host (ring layout verbatim, ``decode/migrate.py``), releases the pages
to the pool and ships ``(manifest, pages)``: for an f32 pool a
``wire.RawArrays`` pair of raw frames (``serving/server.py``
``wire_pages``), so the KV bytes reach the decode fleet exactly as they
were prefilled.

The replica holds no stream state across requests: pages live on it for
one RPC (the prefix cache keeps page-aligned prefixes across prompts, as
a decode replica's does).  So the autoscaler (``frontdoor/autoscale.py``)
can kill any prefill replica between RPCs without dropping a stream.

Admission is a counter, not a queue: past ``max_pending`` concurrent
prefills the RPC is refused with the typed
:class:`~theanompi_tpu_torch.serving.batcher.Overloaded` in O(1); the
router treats it as shedding and tries the next replica.

Concurrent prefills coalesce: handler threads queue their prompt and
elect a leader (whoever takes the session lock first); the leader
drains up to ``prefill_batch`` queued prompts, after waiting out a
deadline measured from the oldest queued one, into ONE ``admit_batch``
call and one batched page export (``export_pages_batch``).  Followers
wait on their job's event.

The fleet-wide prefix cache (``decode/fleetcache.py``) lives here too:
one prefill replica serves ``cache_lookup``, ``cache_register`` and
``cache_decref`` as the fleet's cache AUTHORITY, with a lease table
whose page references make an eviction on the authority safe; every
other replica attaches a ``FleetCacheClient`` (``--fleet-cache``).

Launch: ``python -m theanompi_tpu_torch.frontdoor.prefill --export-dir D
--port P [--device cpu]`` (default ``--device cuda``, which raises
without a card); ``frontdoor/fleet.py`` spawns one per replica.
"""

from __future__ import annotations

import argparse
import collections
import os
import threading
import time

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.decode import fleetcache, migrate
from theanompi_tpu_torch.decode.session import DecodeSession
from theanompi_tpu_torch.parallel import rpc
from theanompi_tpu_torch.parallel.service import ServiceClient, ServiceError
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving.batcher import Overloaded
from theanompi_tpu_torch.serving.export import (
    build_model_from_meta,
    load_export,
)
from theanompi_tpu_torch.serving.server import wire_pages

#: one above the serving block's 45900
DEFAULT_PORT = 45950


class _PrefillJob:
    """One queued prompt awaiting the coalescing leader."""

    __slots__ = ("prompt", "t0", "done", "result", "error")

    def __init__(self, prompt: np.ndarray):
        self.prompt = prompt
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class PrefillServer:
    """One prefill replica: prompt in, (manifest, KV pages) out.

    ``device`` defaults to ``"cuda"`` and raises without a card; the
    model is rebuilt from the export's meta unless ``model`` is given."""

    def __init__(self, export_dir: str, page_size: int = 16,
                 pages_per_seq: int = 8, max_seqs: int = 8,
                 prefill_buckets: tuple[int, ...] | None = None,
                 max_pending: int = 8, warmup: bool = True,
                 model=None, prefix_cache: bool = True,
                 prefill_batch: int = 8,
                 prefill_delay_ms: float = 2.0,
                 fleet_cache: str | None = None,
                 device: str | torch.device = "cuda"):
        self.export_dir = os.path.abspath(export_dir)
        self.device = resolve_device(device)
        loaded = load_export(self.export_dir)
        if not loaded.meta.get("decode"):
            raise ValueError(
                "the prefill role needs a decode-capable export "
                "(TransformerLM family; export_meta 'decode' is "
                f"false/absent in {self.export_dir})")
        self.model = (model if model is not None
                      else build_model_from_meta(loaded.meta, self.device))
        self.session = DecodeSession(
            self.model, params=loaded.state, version=loaded.version,
            page_size=page_size, pages_per_seq=pages_per_seq,
            max_seqs=max_seqs, prefill_buckets=prefill_buckets,
            prefix_cache=prefix_cache)
        self.max_pending = int(max_pending)
        #: coalescing cap (1 = the serial program path)
        self.prefill_batch = max(1, int(prefill_batch))
        #: how long the OLDEST queued prompt waits for company before
        #: the leader runs a partial batch
        self.prefill_delay_ms = float(prefill_delay_ms)
        # the session's host state (pool, prefix cache) is built for one
        # scheduler thread; RPC handlers are a pool, so one lock
        # serializes the admit -> export -> release window (the
        # coalescing leader of each batch holds it)
        self._lock = make_lock("PrefillServer._lock")
        self.n_prefills = 0        # guarded_by: self._lock
        self.n_batches = 0         # guarded_by: self._lock
        #: live fleet-cache leases: lease id -> increfed page ids
        self._leases: dict[str, list[int]] = {}  # guarded_by: self._lock
        self._lease_seq = 0        # guarded_by: self._lock
        self._gate = make_lock("PrefillServer._gate")
        self._inflight = 0         # guarded_by: self._gate
        self.n_shed = 0            # guarded_by: self._gate
        #: prompts awaiting a coalescing leader (lock order: _lock
        #: before _bq_cond; the leader gathers under the session lock)
        self._bq: collections.deque[_PrefillJob] = collections.deque()
        self._bq_cond = make_condition(name="PrefillServer._bq_cond")
        if fleet_cache:
            # this replica is a fleet-cache CLIENT: local misses fetch
            # from (and cold prefills register with) the authority
            self.session.fleet = fleetcache.FleetCacheClient(fleet_cache)
        if warmup:
            self.session.warmup()
            if self.prefill_batch > 1:
                self.session.warmup_prefill_batch()

    # -- request path --------------------------------------------------

    def prefill(self, prompt):
        """One prompt pass: the page manifest and the filled pages.  O(1)
        typed ``Overloaded`` past the admission bound; a bad prompt (too
        long, empty) raises ``ValueError``: a per-request refusal either
        way, the replica keeps serving.  Concurrent calls coalesce (see
        the module docstring); each caller gets its own result."""
        with self._gate:
            if self._inflight >= self.max_pending:
                self.n_shed += 1
                monitor.inc("frontdoor/prefill_shed_total")
                raise Overloaded(
                    f"prefill admission: {self._inflight} in flight "
                    f">= max_pending {self.max_pending}")
            self._inflight += 1
        try:
            faults.fire("page_migrate", side="export")
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            t = prompt.shape[0]
            if not 1 <= t <= self.session.max_prompt:
                # refused before it is queued, so one bad prompt never
                # fails the batch it would have ridden in
                raise ValueError(
                    f"prompt length {t} outside "
                    f"[1, {self.session.max_prompt}] (largest prefill "
                    "bucket)")
            job = _PrefillJob(prompt)
            with self._bq_cond:
                self._bq.append(job)
                self._bq_cond.notify_all()
            # leader election: whoever takes the session lock first runs
            # a batch (which may or may not carry this job; loop until
            # one did)
            while not job.done.is_set():
                with self._lock:
                    if not job.done.is_set():
                        self._run_batch_locked()
            if job.error is not None:
                raise job.error
            return job.result
        finally:
            with self._gate:
                self._inflight -= 1

    def _run_batch_locked(self) -> None:  # requires_lock: self._lock
        """Leader leg (session lock held): wait out the oldest queued
        prompt's deadline, take up to ``prefill_batch`` jobs, run one
        admit and one export for all of them, and resolve each job.  The
        pages are always released: a batch leaves no stream state
        behind, whether it succeeded or failed."""
        cap = min(self.prefill_batch, self.session.cfg.max_seqs)
        with self._bq_cond:
            if not self._bq:
                return
            if cap > 1 and self.prefill_delay_ms > 0:
                deadline = self._bq[0].t0 + self.prefill_delay_ms / 1e3
                while len(self._bq) < cap:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._bq_cond.wait(remaining)
            jobs = [self._bq.popleft()
                    for _ in range(min(cap, len(self._bq)))]
        if not jobs:
            return
        t0 = time.perf_counter()
        try:
            if cap == 1:
                # the serial program path
                admitted = [self.session.admit(jobs[0].prompt)]
            else:
                admitted = self.session.admit_batch(
                    [j.prompt for j in jobs])
        except Exception as e:
            for job in jobs:
                job.error = e
                job.done.set()
            return
        try:
            exported = self.session.export_pages_batch(
                [s for s, _ in admitted])
            for job, (seq, logits), (k, v) in zip(jobs, admitted,
                                                  exported):
                first = int(np.argmax(logits))
                manifest = migrate.page_manifest(
                    self.session.cfg, job.prompt, seq.length, first,
                    version=self.session.version)
                job.result = (manifest, wire_pages(k, v))
            self.n_prefills += len(jobs)
            self.n_batches += 1
        except Exception as e:
            for job in jobs:
                job.error = e
        finally:
            # exported (or failed): this replica is done with the
            # streams; only the prefix cache may keep their pages
            for seq, _ in admitted:
                self.session.release(seq)
            for job in jobs:
                job.done.set()
        monitor.inc("frontdoor/prefills_total", float(len(jobs)))
        monitor.observe("frontdoor/prefill_batch_occupancy",
                        float(len(jobs)))
        monitor.observe("frontdoor/prefill_ms",
                        (time.perf_counter() - t0) * 1000.0)

    # -- fleet prefix-cache authority (decode/fleetcache.py) -----------

    def cache_lookup(self, prompt):
        """Authority op: the longest page-aligned cached prefix of
        ``prompt``.  A hit increfs the entry's pages under a fresh lease
        and ships their bytes; evicting the entry drops only its own
        references, so a page cannot be freed until
        :meth:`cache_decref` drops the lease too."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            pc = self.session.prefix_cache
            entry = pc.lookup(prompt) if pc is not None else None
            if entry is None:
                monitor.inc("frontdoor/fleet_cache_lookups_total",
                            result="miss")
                return None
            self.session.pool.incref(entry.pages)
            self._lease_seq += 1
            lease = f"lease-{os.getpid()}-{self._lease_seq}"
            self._leases[lease] = list(entry.pages)
            k, v = self.session.export_page_ids(entry.pages)
            manifest = fleetcache.prefix_manifest(
                self.session.cfg, prompt[:entry.n_tokens],
                version=self.session.version)
            monitor.inc("frontdoor/fleet_cache_lookups_total",
                        result="hit")
            monitor.set_gauge("frontdoor/fleet_cache_leases",
                              float(len(self._leases)))
        return manifest, wire_pages(k, v), lease

    def cache_decref(self, lease_id) -> str:
        """Authority op: release a lease's page reference.  An unknown
        lease (foreign, double decref) raises the typed
        :class:`~theanompi_tpu_torch.decode.fleetcache.LeaseError`, a
        per-call refusal that never unbalances the refcounts."""
        with self._lock:
            pages = self._leases.pop(str(lease_id), None)
            if pages is None:
                raise fleetcache.LeaseError(
                    f"unknown lease {lease_id!r} (foreign, or already "
                    "released)")
            self.session.pool.decref(pages)
            monitor.set_gauge("frontdoor/fleet_cache_leases",
                              float(len(self._leases)))
        return "ok"

    def cache_register(self, manifest, pages) -> dict:
        """Authority op: adopt a peer's just-prefilled prefix pages as
        cache content.  A geometry or shape mismatch raises the typed
        ``IncompatiblePages`` before the pool is touched."""
        k, v = pages
        with self._lock:
            if self.session.prefix_cache is None:
                return {"added": False,
                        "reason": "prefix cache disabled"}
            reason = fleetcache.prefix_incompatibility(
                manifest, k, v, self.session.cfg)
            if reason is not None:
                raise migrate.IncompatiblePages(reason)
            added = self.session.adopt_prefix(
                np.asarray(manifest["prefix"], np.int32), k, v)
        monitor.inc("frontdoor/fleet_cache_registers_total")
        return {"added": bool(added)}

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._gate:
            inflight, shed = self._inflight, self.n_shed
        with self._lock:
            prefills, batches = self.n_prefills, self.n_batches
            leases = len(self._leases)
            pc = self.session.prefix_cache
            hits = (None if pc is None
                    else {"hits": pc.hits, "misses": pc.misses,
                          "entries": len(pc)})
        return {
            "role": "prefill",
            "version": self.session.version,
            "prefills": prefills,
            "prefill_batches": batches,
            "prefill_batch": self.prefill_batch,
            "fleet_cache_leases": leases,
            "inflight": inflight,
            "max_pending": self.max_pending,
            "overloaded": shed,
            "prefix_cache": hits,
            "compiles": dict(self.session.compiles),
        }

    # -- wire dispatch -------------------------------------------------

    def rpc_max_workers(self) -> int:
        # every admissible prefill may block in a handler, plus slack so
        # O(1) Overloaded refusals never wait behind them
        return self.max_pending + 8

    def handle(self, op: str, *args):
        if op == "prefill":
            (prompt,) = args
            return self.prefill(prompt)
        if op == "cache_lookup":
            (prompt,) = args
            return self.cache_lookup(prompt)
        if op == "cache_register":
            manifest, pages = args
            return self.cache_register(manifest, pages)
        if op == "cache_decref":
            (lease_id,) = args
            return self.cache_decref(lease_id)
        if op == "stats":
            return self.stats()
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


def serve(server: PrefillServer, host: str = "0.0.0.0",
          port: int = DEFAULT_PORT,
          ready_event: threading.Event | None = None,
          stop_event: threading.Event | None = None,
          authkey: bytes | None = None) -> None:
    """The RPC substrate over a :class:`PrefillServer` (the same HMAC,
    wire-v2 and typed-err stack as every other plane)."""
    from theanompi_tpu_torch.parallel.service import _authkey

    if authkey is None:
        authkey = _authkey(generate=True)
    rpc.serve(server, host, port, ready_event=ready_event,
              stop_event=stop_event, authkey=authkey,
              hooks=rpc.RpcHooks(),
              max_workers=server.rpc_max_workers())


class PrefillClient(ServiceClient):
    """Wire client of the prefill role.  ``prefill`` is pure (the
    replica keeps no stream state), so at-least-once transport retries
    are safe; a typed ``Overloaded`` re-raises as itself and is never
    retried by the transport: the router decides what happens next."""

    def prefill(self, prompt):
        """``(manifest, k, v)``: numpy pages for an f32 pool, CPU
        bfloat16 tensors for a bf16 one."""
        try:
            manifest, pages = self.call(
                "prefill", np.asarray(prompt, np.int32))
        except ServiceError as e:
            if Overloaded.__name__ in str(e):
                raise Overloaded(str(e)) from None
            raise
        k, v = pages
        return manifest, k, v

    def stats(self) -> dict:
        return self.call("stats")

    def ping(self) -> str:
        return self.call("ping")

    def shutdown(self) -> None:
        self.call("shutdown")


# ---------------------------------------------------------------------------
# Entry point (frontdoor/fleet.py spawns this module per prefill replica)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.frontdoor.prefill",
        description="prefill replica of disaggregated serving (PyTorch "
                    "port)")
    ap.add_argument("--export-dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--prefill-buckets", default=None, metavar="N,N,...")
    ap.add_argument("--max-pending", type=int, default=8)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefill-batch", type=int, default=8,
                    help="max prompts coalesced into one batched "
                         "prefill (1 = serial programs)")
    ap.add_argument("--prefill-delay-ms", type=float, default=2.0,
                    help="how long the oldest queued prompt waits "
                         "for company before a partial batch runs")
    ap.add_argument("--fleet-cache", default=None, metavar="HOST:PORT",
                    help="fleet prefix-cache authority address (this "
                         "replica becomes a fleet-cache client)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    buckets = (tuple(int(b) for b in args.prefill_buckets.split(","))
               if args.prefill_buckets else None)
    with monitor.session(stall_after=float("inf"),
                         name=f"prefill{os.getpid()}"):
        monitor.progress(phase="frontdoor")
        server = PrefillServer(
            args.export_dir, page_size=args.page_size,
            pages_per_seq=args.pages_per_seq, max_seqs=args.max_seqs,
            prefill_buckets=buckets, max_pending=args.max_pending,
            prefix_cache=not args.no_prefix_cache,
            prefill_batch=args.prefill_batch,
            prefill_delay_ms=args.prefill_delay_ms,
            fleet_cache=args.fleet_cache, device=args.device)
        s = server.session
        print(f"[frontdoor] PREFILL v{s.version} on "
              f"{args.host}:{args.port} (window={s.window}, "
              f"page_size={s.cfg.page_size}, "
              f"prefill_buckets={s.prefill_buckets}, "
              f"max_pending={server.max_pending}, "
              f"device={server.device})", flush=True)
        serve(server, args.host, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
