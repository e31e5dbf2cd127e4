"""Event export — the bounded, drop-counting bridge from one process's
monitor to the fleet collector (copy of
``theanompi_tpu/monitor/export.py``).

Two pieces:

* :class:`RotatingJsonlWriter` — an append-only JSONL writer with
  size-based rotation (``MAX_BYTES``, keep ``KEEP``
  files) so week-long runs cannot fill the disk; the rotation itself
  is counted (``monitor/rotations_total``).  The registry snapshot
  files are overwrite-in-place and never grow — rotation exists for
  the two APPENDING streams: the local span-event
  JSONL and the collector's merged fleet JSONL.
* :class:`Exporter` — a background thread (name family
  ``monitor-export-*``) fed by :func:`emit` from span exit.  The hot
  path only appends to a bounded deque under a lock: a full buffer
  **drops and counts** (``monitor/export_dropped_total``), it never
  blocks.  The thread drains batches to the local events file and —
  when ``THEANOMPI_TPU_COLLECTOR`` names a collector — ships them over
  the ordinary ``ServiceClient``/HMAC/wire-v2 stack.  A dead collector
  degrades to local-only (``monitor/export_errors_total``, with
  reconnect backoff); it never fails a caller.

Clock-offset model: at the export handshake the exporter calls
``collector_hello`` and assumes the collector stamped its wall clock
at the midpoint of the RPC round trip; ``offset_s = server_t_wall -
(client_t_wall_now - rtt/2)`` maps this process's wall timestamps onto
the collector's clock.  The offset (and the rtt that bounds its error)
ride every export batch, so ``tools/traces.py`` can align spans from
processes whose wall clocks disagree.

The exporter is started/stopped by the monitor session
(``monitor._activate``/``_finalize``) only when tracing or a collector
address is configured — otherwise :func:`emit` is one global read and
a ``None`` check, preserving the disabled no-op contract.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.monitor import trace as _trace

#: defaults of the constructors' arguments: a rotated file's size and
#: how many rotated files are kept; the exporter's buffer (events), how
#: often it drains, and how often it ships a registry snapshot
MAX_BYTES, KEEP = 64 << 20, 3
BUFFER, FLUSH_S, METRICS_S = 4096, 0.5, 2.0

#: the process-wide exporter, None unless a monitor session started
#: one.  Read unlocked on the emit fast path (attribute read of a
#: module global is atomic); swapped only under the monitor session
#: lock.
_exporter: "Exporter | None" = None


def set_exporter(ex: "Exporter | None") -> None:
    global _exporter
    _exporter = ex


def emit(event: dict) -> None:
    """Hand one event to the running exporter; silently dropped when
    none is running (tracing without a session, or export disabled)."""
    ex = _exporter
    if ex is not None:
        ex.emit(event)


class RotatingJsonlWriter:
    """Append JSON lines to ``path``; when the file would exceed
    ``max_bytes``, shift ``path -> path.1 -> ... -> path.keep`` (the
    oldest falls off) and start fresh.  Thread-safe; write failures
    are swallowed (telemetry must never take down the workload) after
    counting via the monitor facade."""

    def __init__(self, path: str, max_bytes: int | None = None,
                 keep: int | None = None):
        self.path = path
        self.max_bytes = max_bytes if max_bytes is not None else MAX_BYTES
        self.keep = keep if keep is not None else KEEP
        self._lock = make_lock("RotatingJsonlWriter._lock")
        self._size = -1          # guarded_by: self._lock
        self.rotations = 0       # guarded_by: self._lock

    def write_lines(self, lines: list[str]) -> None:
        if not lines:
            return
        blob = "".join(line + "\n" for line in lines)
        data = blob.encode("utf-8")
        with self._lock:
            try:
                if self._size < 0:  # first write: pick up existing size
                    try:
                        self._size = os.path.getsize(self.path)
                    except OSError:
                        self._size = 0
                if self.max_bytes > 0 \
                        and self._size + len(data) > self.max_bytes \
                        and self._size > 0:
                    self._rotate_locked()
                with open(self.path, "ab") as f:
                    f.write(data)
                self._size += len(data)
            except OSError:
                return

    def write_events(self, events: list[dict]) -> None:
        self.write_lines([json.dumps(ev, default=str, sort_keys=True)
                          for ev in events])

    def _rotate_locked(self) -> None:  # requires_lock: self._lock
        from theanompi_tpu_torch import monitor

        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self.keep > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._size = 0
        self.rotations += 1
        monitor.inc("monitor/rotations_total",
                    file=os.path.basename(self.path))


class Exporter:
    """Bounded background shipper for span/metric events.  See module
    docstring for the contract; the one invariant everything else
    hangs off: :meth:`emit` is O(1), lock-append-or-drop, and can
    never raise into a hot path."""

    def __init__(self, run_dir: str, suffix: str, rank: int, registry,
                 collector: str | None = None,
                 capacity: int | None = None,
                 flush_s: float | None = None,
                 metrics_every_s: float | None = None):
        self.run_dir = run_dir
        self.suffix = suffix
        self.collector = collector
        self._registry = registry
        self._cap = capacity if capacity is not None else BUFFER
        self._flush_s = flush_s if flush_s is not None else FLUSH_S
        self._metrics_s = metrics_every_s if metrics_every_s is not None \
            else METRICS_S
        self._meta = {"pid": os.getpid(), "role": suffix,
                      "rank": int(rank)}
        self._writer = RotatingJsonlWriter(
            os.path.join(run_dir, f"events_{suffix}.jsonl"))
        self._lock = make_lock("Exporter._lock")
        self._buf: deque = deque()   # guarded_by: self._lock
        self.dropped = 0             # guarded_by: self._lock
        self._wake = threading.Event()
        self._stop = threading.Event()
        # exporter-thread-private shipping state (single-threaded, no
        # lock): the client, its clock offset, and reconnect backoff
        self._client = None
        self._offset_s: float | None = None
        self._rtt_s: float | None = None
        self._next_connect = 0.0
        self._next_metrics = 0.0
        self._thread: threading.Thread | None = None

    # -- hot path ----------------------------------------------------

    def emit(self, event: dict) -> None:
        with self._lock:
            if len(self._buf) >= self._cap:
                self.dropped += 1
                self._registry.inc("monitor/export_dropped_total")
                return
            self._buf.append(event)
        self._wake.set()

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "Exporter":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"monitor-export-{self.suffix}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    # -- exporter thread ---------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._flush_s)
            self._wake.clear()
            self._flush_once()
        self._flush_once()  # final drain so short sessions lose nothing

    def _flush_once(self) -> None:
        with self._lock:
            batch = list(self._buf)
            self._buf.clear()
        self._registry.set_gauge("monitor/export_buffer",
                                 float(len(batch)))
        now = time.monotonic()
        ship = list(batch)
        if self.collector and now >= self._next_metrics:
            self._next_metrics = now + self._metrics_s
            ship.append({"event": "metrics", "t_wall": time.time(),
                         "t_mono": now,
                         "snapshot": self._registry.snapshot()})
        if batch:
            # local file gets identity merged per line; the collector
            # path ships identity once per batch instead
            self._writer.write_events(
                [{**ev, **self._meta} for ev in batch])
        if ship and self.collector:
            self._ship(ship)

    def _ship(self, events: list[dict]) -> None:
        client = self._ensure_client()
        if client is None:
            return
        meta = dict(self._meta)
        if self._offset_s is not None:
            meta["offset_s"] = self._offset_s
            meta["rtt_s"] = self._rtt_s
        try:
            client.call("collector_export", meta, events)
            self._registry.inc("monitor/export_batches_total")
        except Exception:
            self._registry.inc("monitor/export_errors_total")
            self._drop_client()

    def _ensure_client(self):
        if self._client is not None:
            return self._client
        if time.monotonic() < self._next_connect:
            return None
        # lazy import: monitor must not pull the service/rpc stack in
        # at import time (service imports monitor, not vice versa)
        try:
            from theanompi_tpu_torch.parallel.service import ServiceClient
            from theanompi_tpu_torch.resilience.retry import RetryPolicy

            client = ServiceClient(
                str(self.collector),
                retry=RetryPolicy(max_attempts=1, deadline_s=5.0,
                                  name="export"))
            t0 = time.monotonic()
            reply = client.call("collector_hello", dict(self._meta))
            rtt = time.monotonic() - t0
            # midpoint model: the collector stamped its wall clock
            # roughly rtt/2 ago
            self._offset_s = float(reply["t_wall"]) \
                - (time.time() - rtt / 2.0)
            self._rtt_s = rtt
            self._client = client
            return client
        except Exception:
            self._registry.inc("monitor/export_errors_total")
            self._next_connect = time.monotonic() + 2.0
            return None

    def _drop_client(self) -> None:
        client, self._client = self._client, None
        self._next_connect = time.monotonic() + 2.0
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {"buffered": len(self._buf), "dropped": self.dropped,
                    "offset_s": self._offset_s, "rtt_s": self._rtt_s,
                    "collector": self.collector}


def maybe_start(run_dir: str, suffix: str, rank: int,
                registry) -> "Exporter | None":
    """Session hook: start an exporter iff tracing is on or a
    collector is configured (either alone is useful — local-only trace
    files, or metrics-only fleet shipping)."""
    collector = os.environ.get(_trace.COLLECTOR_ENV_VAR) or None
    if not (_trace.enabled() or collector):
        return None
    ex = Exporter(run_dir, suffix, rank, registry,
                  collector=collector).start()
    set_exporter(ex)
    return ex
