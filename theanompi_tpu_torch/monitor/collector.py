"""Telemetry collector — the fleet's single merged timeline (copy of
``theanompi_tpu/monitor/collector.py``; ``fleet.jsonl`` keeps its record
format, so ``tools/traces.py`` and ``tools/tmtop.py`` read either
package's file).

One collector process per run sits behind the SAME substrate as every
other service (``rpc.serve``, HMAC handshake, wire-v2 framing — a
telemetry channel is still an authenticated channel; see
"collector trust model" in docs/OBSERVABILITY.md): every fleet
process's :class:`monitor.export.Exporter` ships span/metric event
batches to it, and the collector appends them — stamped with the
sender's identity (pid, role, rank) and estimated clock offset — to
ONE rotating ``fleet.jsonl`` under the run dir.  ``tools/traces.py``
and ``tools/tmtop.py`` consume that file.

Clock-offset protocol: ``collector_hello`` answers with the
collector's wall/mono clocks; the exporter measures the RPC round
trip and derives ``offset_s`` (midpoint model, see export.py).  The
offset rides every subsequent export batch and is merged into each
event record here, so consumers can map every process's wall stamps
onto the collector's clock without trusting fleet-wide NTP.

Supervision: :class:`CollectorProcess` spawns and watches the real
subprocess exactly like ``ShardProcessGroup`` watches shards —
restart-on-death with a budget (``monitor/collector_restarts_total``).
A dead collector never hurts the fleet: exporters degrade to their
local event files and count ``monitor/export_errors_total``.

Ops: ``ping`` | ``collector_hello`` (clock sample + identity log) |
``collector_export(meta, events)`` | ``collector_stats``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.monitor import trace as _trace
from theanompi_tpu_torch.monitor.export import RotatingJsonlWriter

FLEET_FILE = "fleet.jsonl"

#: identity keys an export batch's meta may carry into merged records
_META_KEYS = ("pid", "role", "rank", "offset_s", "rtt_s")


class TelemetryCollector:
    """``handle(op, *args)`` duck type for ``rpc.serve``."""

    #: hello/stats answer from the control pool so a flood of export
    #: batches can never starve the clock handshake
    RPC_CONTROL_OPS = frozenset({"collector_hello", "collector_stats"})

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, FLEET_FILE)
        self._writer = RotatingJsonlWriter(self.path)
        self._lock = make_lock("TelemetryCollector._lock")
        self.n_events = 0        # guarded_by: self._lock
        self.n_batches = 0       # guarded_by: self._lock
        self.senders: dict = {}  # guarded_by: self._lock

    def handle(self, op: str, *args):
        if op == "ping":
            return "pong"
        if op == "collector_hello":
            meta = args[0] if args and isinstance(args[0], dict) else {}
            with self._lock:
                self.senders[(meta.get("pid"), meta.get("role"))] = \
                    time.time()
            return {"t_wall": time.time(), "t_mono": time.monotonic()}
        if op == "collector_export":
            if len(args) != 2:
                raise ValueError("collector_export wants (meta, events)")
            return self._ingest(args[0], args[1])
        if op == "collector_stats":
            return self.stats()
        raise ValueError(f"unknown op {op!r}")

    def _ingest(self, meta, events) -> int:
        if not isinstance(meta, dict) or not isinstance(events, list):
            raise ValueError("malformed export batch")
        ident = {k: meta[k] for k in _META_KEYS if k in meta}
        recs = [{**ev, **ident} for ev in events
                if isinstance(ev, dict)]
        self._writer.write_events(recs)
        with self._lock:
            self.n_events += len(recs)
            self.n_batches += 1
            self.senders[(meta.get("pid"), meta.get("role"))] = \
                time.time()
        monitor.inc("monitor/collector_events_total", len(recs),
                    role=str(meta.get("role")))
        monitor.inc("monitor/collector_batches_total")
        return len(recs)

    def stats(self) -> dict:
        with self._lock:
            return {"events": self.n_events, "batches": self.n_batches,
                    "senders": len(self.senders), "path": self.path,
                    "rotations": self._writer.rotations}


def serve_collector(host: str, port: int, run_dir: str,
                    ready_event: threading.Event | None = None,
                    stop_event: threading.Event | None = None,
                    authkey: bytes | None = None) -> None:
    from theanompi_tpu_torch.parallel import rpc
    from theanompi_tpu_torch.parallel.service import _authkey

    class _CollectorRpcHooks(rpc.RpcHooks):
        plane = "collector"

    rpc.serve(TelemetryCollector(run_dir), host, port,
              ready_event=ready_event, stop_event=stop_event,
              authkey=authkey if authkey is not None else _authkey(),
              hooks=_CollectorRpcHooks())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="theanompi-tpu telemetry collector — merged fleet "
                    "JSONL behind the authenticated RPC substrate "
                    "(docs/OBSERVABILITY.md 'Distributed tracing')")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True,
                    help="run dir; fleet.jsonl is written here")
    args = ap.parse_args(argv)
    # the collector must never export to ITSELF: its own rpc_handle
    # spans shipping through its own exporter would amplify every
    # batch into more batches, forever.  It keeps a local monitor
    # session (its service/* and collector_* series) with tracing and
    # collector shipping stripped.
    os.environ.pop(_trace.COLLECTOR_ENV_VAR, None)
    os.environ.pop(_trace.ENV_VAR, None)
    print(f"[collector] listening on {args.host}:{args.port}, "
          f"fleet file under {args.dir}", flush=True)
    with monitor.session(stall_after=float("inf"),
                         name=f"collector{os.getpid()}"):
        monitor.progress(phase="serving")
        serve_collector(args.host, args.port, args.dir)
    return 0


class CollectorProcess:
    """Spawn + supervise the collector subprocess (launcher seam,
    mirroring ``ShardProcessGroup``): restart-on-death with a budget,
    TCP-probe readiness, terminate-then-kill stop.  Exports
    ``THEANOMPI_TPU_COLLECTOR`` so every child the launcher forks
    afterwards ships its telemetry here."""

    def __init__(self, run_dir: str, host: str = "127.0.0.1",
                 max_restarts: int = 3, ready_timeout_s: float = 60.0):
        from theanompi_tpu_torch.parallel.service import _authkey
        from theanompi_tpu_torch.parallel.shards import _free_port

        _authkey(generate=True)  # ensure + export the shared key
        self.run_dir = run_dir
        self.host = host
        self.port = _free_port()
        self.max_restarts = int(max_restarts)
        self._lock = make_lock("CollectorProcess._lock")
        self._stopping = threading.Event()
        self._proc = self._spawn()      # guarded_by: self._lock
        self.restarts = 0               # guarded_by: self._lock
        self._wait_ready(ready_timeout_s)
        os.environ[_trace.COLLECTOR_ENV_VAR] = self.addr
        self._watcher = threading.Thread(
            target=self._watch, daemon=True, name="collector-watcher")
        self._watcher.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _spawn(self) -> subprocess.Popen:
        from theanompi_tpu_torch.parallel.shards import child_env

        env = child_env()
        # never let the collector ship to itself (main() strips this
        # too); it does no tensor work and touches no card
        env.pop(_trace.COLLECTOR_ENV_VAR, None)
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.monitor.collector",
               "--host", self.host, "--port", str(self.port),
               "--dir", self.run_dir]
        return subprocess.Popen(cmd, env=env)

    def _wait_ready(self, timeout_s: float) -> None:
        from theanompi_tpu_torch.parallel.service import ServiceClient

        deadline = time.monotonic() + timeout_s
        while True:
            c = None
            try:
                c = ServiceClient(self.addr)
                c.call("ping")
                return
            except Exception:
                with self._lock:
                    rc = self._proc.poll()
                if rc is not None:
                    raise RuntimeError(
                        f"collector died during startup (rc={rc})")
                if time.monotonic() > deadline:
                    self.stop()
                    raise RuntimeError(
                        f"collector at {self.addr} never came up "
                        f"within {timeout_s}s")
                time.sleep(0.2)
            finally:
                if c is not None:
                    c.close()

    def _watch(self) -> None:
        while not self._stopping.wait(0.5):
            with self._lock:
                proc = self._proc
            if proc.poll() is None or self._stopping.is_set():
                continue
            with self._lock:
                if self.restarts >= self.max_restarts:
                    continue  # budget spent: exporters degrade local
                self.restarts += 1
                n = self.restarts
                self._proc = self._spawn()
            print(f"[collector] died (rc={proc.returncode}); "
                  f"relaunched on port {self.port} "
                  f"({n}/{self.max_restarts})",
                  file=sys.stderr, flush=True)
            monitor.inc("monitor/collector_restarts_total")

    def stats(self) -> dict | None:
        """Live collector stats (None while it is down)."""
        from theanompi_tpu_torch.parallel.service import ServiceClient

        c = None
        try:
            c = ServiceClient(self.addr)
            return c.call("collector_stats")
        except Exception:
            return None
        finally:
            if c is not None:
                c.close()

    def stop(self) -> None:
        self._stopping.set()
        if getattr(self, "_watcher", None) is not None \
                and self._watcher.is_alive():
            self._watcher.join(timeout=5)
        if os.environ.get(_trace.COLLECTOR_ENV_VAR) == self.addr:
            del os.environ[_trace.COLLECTOR_ENV_VAR]
        with self._lock:
            proc = self._proc
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)

    def __enter__(self) -> "CollectorProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def read_fleet(path: str) -> list[dict]:
    """All records of a fleet JSONL (rotated files first, oldest to
    newest) — the consumers' loader."""
    out: list[dict] = []
    rotated = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        rotated.append(f"{path}.{i}")
        i += 1
    for p in [*reversed(rotated), path]:
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail line mid-write
        except OSError:
            continue
    return out


if __name__ == "__main__":
    sys.exit(main())
