"""Health reporting: heartbeat files, a stall watchdog, straggler
detection (copy of ``theanompi_tpu/monitor/health.py``).

A reporter thread rewrites a small JSON file every few seconds with
(phase, step, seconds since the last progress), so an outside observer
can tell "slow" from "stuck" without a debugger.  The same thread runs
the watchdog: when no progress has been reported for ``stall_after``
seconds it names the stuck phase on stderr, once per stall, and counts
it.  ``StragglerDetector`` flags an async-rule worker whose recent
median step exceeds ``factor`` x its peers' median; flags are
edge-triggered.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
from collections import deque

from theanompi_tpu_torch.monitor.registry import (
    MetricsRegistry,
    atomic_write_text,
)


class HeartbeatReporter:
    """Background thread: heartbeat file + stall watchdog + periodic
    metrics-snapshot flush.

    ``heartbeat_{suffix}.json`` (suffix ``rank{rank}`` by default) is
    rewritten atomically every ``interval`` seconds::

        {"rank": 0, "pid": 1234, "phase": "train", "step": 812,
         "progress_age_s": 0.4, "stalled": false, "uptime_s": 93.1,
         "written": 1754200000.0, "workers": {"1": {...}}}

    A ``written`` older than a few intervals means the process is gone
    or its interpreter is held; ``progress_age_s``/``stalled`` separate
    alive-but-stuck from making progress.  ``progress()`` is the hot
    path: a few attribute writes under a lock."""

    def __init__(self, run_dir: str, rank: int = 0,
                 registry: MetricsRegistry | None = None,
                 interval: float = 5.0, stall_after: float = 60.0,
                 snapshot_path: str | None = None,
                 suffix: str | None = None):
        self.run_dir = run_dir
        self.rank = rank
        self.registry = registry
        self.interval = interval
        self.stall_after = stall_after
        self.snapshot_path = snapshot_path
        # co-located processes that are not ranks of one session (a
        # service beside a trainer) each take a suffix of their own
        self.path = os.path.join(
            run_dir, f"heartbeat_{suffix or f'rank{rank}'}.json")
        self._lock = threading.Lock()
        self._t_start = time.monotonic()
        self._phase = "startup"                # guarded_by: self._lock
        self._step: int | None = None          # guarded_by: self._lock
        self._last_progress = time.monotonic()  # guarded_by: self._lock
        self._workers: dict[str, dict] = {}    # guarded_by: self._lock
        self._stalled = False                  # guarded_by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def progress(self, phase: str | None = None, step: int | None = None,
                 worker: int | None = None) -> None:
        """Work advanced.  ``worker`` scopes the update to one async
        worker thread; the rank-level phase follows it too (the
        workers are then the only progress source)."""
        now = time.monotonic()
        with self._lock:
            self._last_progress = now
            if phase is not None:
                self._phase = phase
            if worker is None:
                if step is not None:
                    self._step = step
            else:
                w = self._workers.setdefault(str(worker), {})
                if phase is not None:
                    w["phase"] = phase
                if step is not None:
                    w["step"] = step
                w["progress_age_s"] = 0.0
                w["_last"] = now
            if self._stalled:
                self._stalled = False
                if self.registry is not None:
                    self.registry.inc("health/stall_recoveries_total")

    def start(self) -> "HeartbeatReporter":
        os.makedirs(self.run_dir, exist_ok=True)
        self.write_once()  # a file exists from t=0
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"monitor-heartbeat-r{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None
        self.write_once()  # final state on disk

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._check_stall()
            self.write_once()
            if self.registry is not None and self.snapshot_path:
                try:
                    self.registry.write_jsonl(self.snapshot_path)
                except OSError:
                    pass  # a full disk must not kill the training loop

    def _check_stall(self) -> None:
        with self._lock:
            age = time.monotonic() - self._last_progress
            phase, step, was = self._phase, self._step, self._stalled
            if age > self.stall_after:
                self._stalled = True
        if age > self.stall_after and not was:
            # edge-triggered: name the stuck phase once per episode
            print(f"[monitor] WATCHDOG rank {self.rank}: no progress for "
                  f"{age:.0f}s (phase={phase!r}, step={step}) — "
                  f"stall threshold {self.stall_after:.0f}s",
                  file=sys.stderr, flush=True)
            if self.registry is not None:
                self.registry.inc("health/stalls_total", phase=phase)

    def state(self) -> dict:
        now = time.monotonic()
        with self._lock:
            workers = {
                k: {kk: vv for kk, vv in w.items() if kk != "_last"}
                | {"progress_age_s": round(now - w.get("_last", now), 3)}
                for k, w in self._workers.items()}
            return {"rank": self.rank, "pid": os.getpid(),
                    "phase": self._phase, "step": self._step,
                    "progress_age_s": round(now - self._last_progress, 3),
                    "stalled": self._stalled,
                    "uptime_s": round(now - self._t_start, 3),
                    "written": time.time(), "workers": workers}

    def write_once(self) -> str:
        try:
            atomic_write_text(self.path, json.dumps(self.state()))
        except OSError:
            pass
        return self.path


class StragglerDetector:
    """Rolling-median straggler detection over per-worker step times.

    ``observe(rank, seconds)`` returns True while ``rank`` is flagged:
    its own recent median exceeds ``factor`` x the median of the OTHER
    workers' recent steps (a pooled median would be dragged up by the
    straggler itself).  Needs ``min_samples`` observations from the
    flagged worker and at least 2 active workers before flagging."""

    def __init__(self, factor: float = 2.0, window: int = 32,
                 min_samples: int = 8,
                 registry: MetricsRegistry | None = None):
        self.factor = factor
        self.min_samples = min_samples
        self.registry = registry
        self._lock = threading.Lock()
        self._window = window
        self._times: dict[int, deque[float]] = {}  # guarded_by: self._lock
        self._flagged: set[int] = set()            # guarded_by: self._lock

    def observe(self, rank: int, seconds: float) -> bool:
        with self._lock:
            dq = self._times.setdefault(rank, deque(maxlen=self._window))
            dq.append(float(seconds))
            if len(self._times) < 2 or len(dq) < self.min_samples:
                return rank in self._flagged
            own = statistics.median(dq)
            others = [t for r, d in self._times.items()
                      if r != rank for t in d]
            peer_med = statistics.median(others)
            is_straggler = peer_med > 0 and own > self.factor * peer_med
            was = rank in self._flagged
            if is_straggler and not was:
                self._flagged.add(rank)
                if self.registry is not None:
                    self.registry.inc("health/straggler_flags_total",
                                      worker=rank)
                print(f"[monitor] STRAGGLER worker {rank}: median step "
                      f"{own * 1e3:.1f}ms vs peer median "
                      f"{peer_med * 1e3:.1f}ms "
                      f"(threshold {self.factor:g}x)",
                      file=sys.stderr, flush=True)
            elif not is_straggler and was:
                self._flagged.discard(rank)
            return is_straggler

    def stragglers(self) -> list[int]:
        with self._lock:
            return sorted(self._flagged)
