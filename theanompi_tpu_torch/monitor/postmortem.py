"""Crash postmortem: everything the monitor knows at the point of death
(copy of ``theanompi_tpu/monitor/postmortem.py``).

``postmortem_{suffix}.json`` (suffix ``rank{rank}`` by default)::

    {"ts": ..., "rank": ..., "pid": ..., "exception": {type, message,
     traceback}, "open_spans": [...], "recent_step_ms": [...],
     "metrics": [<registry snapshot>]}

The dump must never make a crash worse: every section is built
best-effort and I/O failures are swallowed.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Iterable

from theanompi_tpu_torch.monitor.registry import (
    MetricsRegistry,
    atomic_write_text,
)
from theanompi_tpu_torch.monitor.spans import open_spans


def build_postmortem(rank: int, exc: BaseException | None,
                     registry: MetricsRegistry | None = None,
                     recent_steps: Iterable[float] | None = None) -> dict:
    """The postmortem payload as a dict (apart from the writer, so a
    test can read it without a file system)."""
    report: dict = {"ts": time.time(), "rank": rank, "pid": os.getpid()}
    if exc is not None:
        report["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-8000:],
        }
    try:
        report["open_spans"] = open_spans()
    except Exception:
        report["open_spans"] = []
    if recent_steps is not None:
        report["recent_step_ms"] = [round(s * 1e3, 3)
                                    for s in recent_steps]
    if registry is not None:
        try:
            report["metrics"] = registry.snapshot()
        except Exception:
            report["metrics"] = []
    return report


def dump_postmortem(run_dir: str, rank: int, exc: BaseException | None,
                    registry: MetricsRegistry | None = None,
                    recent_steps: Iterable[float] | None = None,
                    suffix: str | None = None) -> str | None:
    """Write ``postmortem_{suffix}.json``; returns its path, or None if
    the write failed (never raises: the crash in flight owns the
    stack)."""
    report = build_postmortem(rank, exc, registry, recent_steps)
    path = os.path.join(run_dir,
                        f"postmortem_{suffix or f'rank{rank}'}.json")
    try:
        atomic_write_text(path, json.dumps(report, indent=1, default=str))
    except Exception:
        return None
    return path
