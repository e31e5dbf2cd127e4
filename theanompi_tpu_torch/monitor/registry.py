"""Metrics registry: counters, gauges, streaming histograms.

A copy of the series store of ``theanompi_tpu/monitor/registry.py``
(without its pytree helpers): a thread-safe map of labeled series, one
lock held only for O(1) work, histograms keeping exact count/sum/min/max
plus a ring of recent observations for percentiles, and a JSONL
snapshot.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any

HISTOGRAM_RING = 1024

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def state(self) -> dict:
        return {"value": self.value}


class Gauge:
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, delta: float) -> None:
        self.value += delta

    def state(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Exact count/sum/min/max; nearest-rank p50/p95/p99 over the most
    recent ``HISTOGRAM_RING`` observations (None when empty)."""

    kind = "histogram"
    __slots__ = ("count", "sum", "min", "max", "_ring")
    PERCENTILES = (50.0, 95.0, 99.0)

    def __init__(self, ring: int = HISTOGRAM_RING):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._ring: deque[float] = deque(maxlen=ring)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._ring.append(v)

    def percentile(self, q: float) -> float | None:
        if not self._ring:
            return None
        data = sorted(self._ring)
        rank = max(1, min(len(data), math.ceil(q / 100.0 * len(data))))
        return data[rank - 1]

    def state(self) -> dict:
        out = {"count": self.count, "sum": self.sum,
               "min": None if self.count == 0 else self.min,
               "max": None if self.count == 0 else self.max}
        for q in self.PERCENTILES:
            out[f"p{q:g}"] = self.percentile(q)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe store of labeled series; ``write_count`` counts
    every mutation (the disabled facade must leave it at zero)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[tuple[str, LabelKey], Any] = {}  # guarded_by: self._lock
        self._kinds: dict[str, str] = {}                    # guarded_by: self._lock
        self.write_count = 0                                # guarded_by: self._lock

    def _get(self, kind: str, name: str, labels: dict[str, Any]):  # requires_lock: self._lock
        declared = self._kinds.setdefault(name, kind)
        if declared != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{declared}, cannot use as {kind}")
        key = (name, _label_key(labels))
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _KINDS[kind]()
        return series

    def inc(self, name: str, amount: float = 1.0, /, **labels) -> None:
        with self._lock:
            self._get("counter", name, labels).inc(amount)
            self.write_count += 1

    def set_gauge(self, name: str, value: float, /, **labels) -> None:
        with self._lock:
            self._get("gauge", name, labels).set(value)
            self.write_count += 1

    def add_gauge(self, name: str, delta: float, /, **labels) -> None:
        with self._lock:
            self._get("gauge", name, labels).add(delta)
            self.write_count += 1

    def observe(self, name: str, value: float, /, **labels) -> None:
        with self._lock:
            self._get("histogram", name, labels).observe(value)
            self.write_count += 1

    def get(self, name: str, /, **labels):
        with self._lock:
            return self._series.get((name, _label_key(labels)))

    def snapshot(self) -> list[dict]:
        now = time.time()
        with self._lock:
            items = sorted(self._series.items(),
                           key=lambda kv: (kv[0][0], kv[0][1]))
            return [{"ts": now, "name": name, "kind": s.kind,
                     "labels": dict(lk), **s.state()}
                    for (name, lk), s in items]

    def write_jsonl(self, path: str) -> str:
        """Atomically (re)write the snapshot, one series per line."""
        text = "".join(json.dumps(rec) + "\n" for rec in self.snapshot())
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return path
