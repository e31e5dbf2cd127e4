"""Metrics registry: counters, gauges, streaming histograms.

A copy of ``theanompi_tpu/monitor/registry.py``: a thread-safe map of
labeled series, one lock held only for O(1) work, histograms keeping
exact count/sum/min/max plus a ring of recent observations for
percentiles, a JSONL snapshot and a Prometheus text dump.  The pytree
helpers walk nests of lists, tuples and dicts of numpy arrays and torch
tensors instead of JAX pytrees.
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


def atomic_write_text(path: str, text: str) -> None:
    """Write-then-rename publication, shared by every monitor file
    writer (snapshot, heartbeat, postmortem).  The tmp name carries the
    pid and the thread id, so the heartbeat thread and a same-process
    caller never truncate each other's half-written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


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
        out = {"count": self.count, "sum": round(self.sum, 6),
               "min": None if self.count == 0 else self.min,
               "max": None if self.count == 0 else self.max,
               "mean": None if self.count == 0 else self.sum / self.count}
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
        """The raw series object (None if absent); mutating it bypasses
        ``write_count``."""
        with self._lock:
            return self._series.get((name, _label_key(labels)))

    def value(self, name: str, /, **labels) -> float | None:
        s = self.get(name, **labels)
        return None if s is None or not hasattr(s, "value") else s.value

    def series_names(self) -> set[str]:
        with self._lock:
            return {name for name, _ in self._series}

    def snapshot(self) -> list[dict]:
        now = time.time()
        with self._lock:
            items = sorted(self._series.items(),
                           key=lambda kv: (kv[0][0], kv[0][1]))
            return [{"ts": now, "name": name, "kind": s.kind,
                     "labels": dict(lk), **s.state()}
                    for (name, lk), s in items]

    def write_jsonl(self, path: str) -> str:
        """Atomically (re)write the snapshot, one series per line (the
        latest state, not an append log)."""
        atomic_write_text(path, "".join(json.dumps(rec) + "\n"
                                        for rec in self.snapshot()))
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters and gauges as they are;
        histograms as summary quantile lines plus _count/_sum)."""
        lines: list[str] = []
        seen_types: set[str] = set()
        for rec in self.snapshot():
            pname = _prom_name(rec["name"])
            if pname not in seen_types:
                ptype = {"counter": "counter", "gauge": "gauge",
                         "histogram": "summary"}[rec["kind"]]
                lines.append(f"# TYPE {pname} {ptype}")
                seen_types.add(pname)
            labels = rec["labels"]
            if rec["kind"] == "histogram":
                lines.append(f"{pname}_count{_prom_labels(labels)} "
                             f"{rec['count']}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} "
                             f"{rec['sum']}")
                for q in (50, 95, 99):
                    v = rec[f"p{q}"]
                    if v is not None:
                        ql = dict(labels, quantile=f"0.{q}")
                        lines.append(f"{pname}{_prom_labels(ql)} {v}")
            else:
                lines.append(f"{pname}{_prom_labels(labels)} "
                             f"{rec['value']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    """``service/rpc_ms`` -> ``theanompi_service_rpc_ms``."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"theanompi_{safe}"


def _prom_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""

    def esc(v: str) -> str:
        # exposition-format escaping: one unescaped quote in a label
        # value (an op name off the wire) would invalidate the dump
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    inner = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total byte size of the arrays in a nest of lists, tuples and
    dicts (numpy arrays, torch tensors, bytes; other leaves count 0):
    the service client's wire accounting."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, (bytes, bytearray)):
            total += len(leaf)
        elif hasattr(leaf, "element_size") and hasattr(leaf, "numel"):
            total += leaf.numel() * leaf.element_size()  # torch
        elif isinstance(getattr(leaf, "nbytes", None), int):
            total += leaf.nbytes  # numpy
    return total


def tree_dtypes(tree: Any) -> str:
    """Sorted comma-joined dtype set of a nest of arrays (one label
    value per exchange call, not one series per leaf).  A torch dtype
    is named as numpy names it (``torch.float32`` -> ``float32``)."""
    names: set[str] = set()
    for leaf in _leaves(tree):
        dt = getattr(leaf, "dtype", None)
        if dt is not None:
            names.add(str(dt).removeprefix("torch."))
    return ",".join(sorted(names)) or "none"
