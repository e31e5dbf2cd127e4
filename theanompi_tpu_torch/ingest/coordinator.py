"""Ingest coordinator — range assignment, epoch boundaries, reader
liveness (copy of ``theanompi_tpu/ingest/coordinator.py``).

The coordinator is deliberately dataset-agnostic: the epoch
permutation is a pure function of (seed, epoch) that readers and
trainers both derive locally (``ingest/order.py``), so the only global
state worth coordinating is *membership* — which readers are alive —
and the contiguous batch-range assignment derived from it
(``protocol.partition_batches``).  Per epoch it

* answers ``ingest_plan`` with the current assignment (computing it
  once per (epoch, rank, size, batch, n) and pinning it until
  membership changes), and
* **drives the shuffle-epoch boundary**: on a plan's first
  computation it pushes ``ingest_assign`` to every owner so the fleet
  starts pre-paging the new epoch's shard ranges before trainers pull.

Reader death is handled two ways, both converging on a version bump +
recomputed plans over the survivors:

* a **probe thread** pings every reader each ``probe_interval_s`` —
  covers silent deaths and notices a supervised relaunch
  (``ingest/fleet.py``) coming back, returning the reader to the pool
  for subsequent plans;
* ``ingest_report_dead`` — a trainer that hit a connect failure
  reports the address; the coordinator re-verifies (one ping) before
  believing it, so a flaky client cannot evict a healthy reader.

Mid-epoch reassignment is safe because assignment is locality, not
correctness: any reader serves any batch index byte-identically.

Launch:  ``python -m theanompi_tpu_torch.ingest.coordinator --port 45950 \\
             --readers host:45951,host:45952``
"""

from __future__ import annotations

import argparse
import os
import threading

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.ingest import protocol

PROBE_INTERVAL_S = 2.0


def _probe_retry():
    """One-shot connect policy for liveness probes and assignment
    pushes: a probe must answer 'dead' in ~a second, not inherit the
    service client's 30 s restart patience."""
    from theanompi_tpu_torch.resilience.retry import RetryPolicy

    return RetryPolicy(max_attempts=1, base_delay=0.05, max_delay=0.1,
                       deadline_s=2.0, name="ingest_probe")


class IngestCoordinator:
    """The coordinator's service object (``serve(service=...)``)."""

    def __init__(self, readers: list[str],
                 probe_interval_s: float = PROBE_INTERVAL_S):
        if not readers:
            raise ValueError("coordinator needs at least one reader "
                             "address (--readers)")
        self._lock = make_lock("IngestCoordinator._lock")
        #: addr -> alive?  (registration order is the assignment order)
        self._readers: dict[str, bool] = {a: True for a in readers}  # guarded_by: self._lock
        self._version = 1              # guarded_by: self._lock
        #: (epoch, rank, size, batch, n) -> (version, owners)
        self._plans: dict = {}         # guarded_by: self._lock
        self._reassignments = 0        # guarded_by: self._lock
        self._probe_interval_s = float(probe_interval_s)
        self._stop = threading.Event()
        self._probe_thread: threading.Thread | None = None

    # -- membership -----------------------------------------------------

    def start_probing(self) -> "IngestCoordinator":
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="ingest-coordinator-probe")
        self._probe_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None

    def _ping(self, addr: str) -> bool:
        from theanompi_tpu_torch.parallel.service import ServiceClient

        c = None
        try:
            c = ServiceClient(addr, retry=_probe_retry())
            return c.call(protocol.OP_INFO).get("kind") == "reader"
        except Exception:
            return False
        finally:
            if c is not None:
                c.close()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._probe_interval_s):
            with self._lock:
                addrs = list(self._readers)
            flips: dict[str, bool] = {}
            for addr in addrs:
                if self._stop.is_set():
                    return
                flips[addr] = self._ping(addr)
            with self._lock:
                changed = [a for a, ok in flips.items()
                           if self._readers.get(a) not in (None, ok)]
                for a in changed:
                    self._readers[a] = flips[a]
                if changed:
                    self._bump_locked()
            for a in changed:
                print(f"[ingest] coordinator: reader {a} is now "
                      f"{'alive' if flips[a] else 'DEAD'}", flush=True)
                monitor.inc("ingest/reader_liveness_flips_total",
                            alive=flips[a])

    def _bump_locked(self) -> None:  # requires_lock: self._lock
        """Membership changed: invalidate pinned plans."""
        self._version += 1
        self._plans.clear()

    def _alive_locked(self) -> list[str]:  # requires_lock: self._lock
        return [a for a, ok in self._readers.items() if ok]

    # -- ops ------------------------------------------------------------

    def _plan(self, epoch, rank, size, global_batch, n_batches):
        key = (int(epoch), int(rank), int(size), int(global_batch),
               int(n_batches))
        with self._lock:
            cached = self._plans.get(key)
            if cached is not None:
                version, owners = cached
                return {"version": version,
                        "owners": [list(o) for o in owners]}
            alive = self._alive_locked()
            if not alive:
                raise RuntimeError(
                    "no ingest readers alive; cannot assign batch "
                    "ranges (are the reader processes up?)")
            # rotation = the trainer's rank (see partition_batches):
            # concurrent same-phase trainers start on DIFFERENT
            # readers, so the fleet serves in parallel instead of one
            # reader at a time
            owners = protocol.partition_batches(key[4], alive,
                                                rotation=key[1])
            version = self._version
            self._plans[key] = (version, owners)
        # first computation of this plan = the epoch boundary for this
        # (rank, size) stream: push assignments so every owner starts
        # pre-paging its range before the trainer pulls into it
        self._push_assignments(key, owners)
        monitor.inc("ingest/plans_total")
        return {"version": version, "owners": [list(o) for o in owners]}

    def _push_assignments(self, key, owners) -> None:
        from theanompi_tpu_torch.parallel.service import ServiceClient

        epoch, rank, size, global_batch, _ = key
        for lo, hi, addr in owners:
            if lo >= hi:
                continue
            c = None
            try:
                c = ServiceClient(addr, retry=_probe_retry())
                c.call(protocol.OP_ASSIGN, epoch, rank, size,
                       global_batch, lo, hi)
            except Exception:
                # best-effort: a reader that missed its assignment
                # still serves pulls (assignment is read-ahead only);
                # the probe loop will notice if it is actually dead
                pass
            finally:
                if c is not None:
                    c.close()

    def _report_dead(self, addr):
        addr = str(addr)
        with self._lock:
            known = addr in self._readers
        # verify OUTSIDE the lock (a ping takes ~ms); a flaky trainer
        # must not evict a healthy reader
        alive = self._ping(addr) if known else False
        with self._lock:
            if known and not alive and self._readers.get(addr):
                self._readers[addr] = False
                self._bump_locked()
                self._reassignments += 1
                monitor.inc("ingest/reassignments_total")
                print(f"[ingest] coordinator: reader {addr} reported "
                      "dead and confirmed unreachable; reassigning "
                      "its ranges", flush=True)
            return {"dead": not alive, "version": self._version}

    def stats(self) -> dict:
        with self._lock:
            return {"version": self._version,
                    "readers": dict(self._readers),
                    "alive": len(self._alive_locked()),
                    "plans": len(self._plans),
                    "reassignments": self._reassignments}

    def handle(self, op: str, *args):
        if op == protocol.OP_INFO:
            with self._lock:
                return {"kind": "coordinator",
                        "readers": len(self._readers),
                        "pid": os.getpid()}
        if op == protocol.OP_PLAN:
            return self._plan(*args)
        if op == protocol.OP_REPORT_DEAD:
            return self._report_dead(*args)
        if op == "stats":
            return self.stats()
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


def serve_coordinator(host: str, port: int,
                      coordinator: IngestCoordinator,
                      ready_event: threading.Event | None = None,
                      stop_event: threading.Event | None = None,
                      authkey: bytes | None = None) -> None:
    from theanompi_tpu_torch.parallel.service import serve

    coordinator.start_probing()
    try:
        serve(host, port, ready_event=ready_event,
              stop_event=stop_event, authkey=authkey,
              service=coordinator)
    finally:
        coordinator.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.ingest.coordinator",
        description="theanompi-tpu ingest coordinator (PyTorch port) — "
                    "batch-range assignment + reader liveness")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int,
                    default=protocol.DEFAULT_COORDINATOR_PORT)
    ap.add_argument("--readers", required=True,
                    help="comma-separated reader addresses host:port")
    ap.add_argument("--probe-interval-s", type=float,
                    default=PROBE_INTERVAL_S)
    args = ap.parse_args(argv)
    readers = protocol.ingest_addresses(args.readers)
    coord = IngestCoordinator(readers,
                              probe_interval_s=args.probe_interval_s)
    print(f"[ingest] coordinator on {args.host}:{args.port} over "
          f"{len(readers)} reader(s)", flush=True)
    with monitor.session(stall_after=float("inf"),
                         name=f"ingest_coord_{os.getpid()}"):
        monitor.progress(phase="ingest")
        serve_coordinator(args.host, args.port, coord)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
