"""Straggler detection for the async rules' workers (copy of
``StragglerDetector`` in ``theanompi_tpu/monitor/health.py``; the rest
of that module, the heartbeat and the stall watchdog, is not ported
yet)."""

from __future__ import annotations

import statistics
import sys
import threading
from collections import deque

from theanompi_tpu_torch.monitor.registry import MetricsRegistry


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
