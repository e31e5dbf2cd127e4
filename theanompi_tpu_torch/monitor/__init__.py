"""theanompi_tpu_torch.monitor — telemetry for the rules, the services,
the ingest fleet and the launcher (counterpart of
``theanompi_tpu/monitor``).

One process-wide monitor with four faces:

* **metrics registry** (``registry.py``): counters, gauges, streaming
  histograms with labels, snapshot to JSONL and Prometheus text;
* **spans** (``spans.py``): nested wall-clock spans that fence on CUDA
  tensors and enter ``torch.profiler.record_function``, linked across
  processes by ``trace.py`` and shipped by ``export.py`` to a
  ``collector.py`` that merges the fleet's events into one
  ``fleet.jsonl``;
* **health** (``health.py``): heartbeat file, stall watchdog, straggler
  detection;
* **postmortem** (``postmortem.py``): crash dump of the registry, the
  open spans and the recent step times.

Enablement contract: monitoring is OFF unless a run dir is configured,
through ``session(run_dir=...)`` or the ``THEANOMPI_TPU_MONITOR``
environment variable.  When off, every facade function returns after
one boolean check and the registry receives zero writes; nothing is
written to disk.

Files under the run dir (the suffix is ``rank{r}``, or the session's
``name`` for a process that is not a training rank)::

    metrics_{suffix}.jsonl    latest registry snapshot, 1 series a line
    metrics_{suffix}.prom     Prometheus text dump (final flush)
    heartbeat_{suffix}.json   liveness + phase + progress age
    postmortem_{suffix}.json  on an exception escaping the session
    events_{suffix}.jsonl     span events, when tracing or a collector
                              is on (``THEANOMPI_TPU_TRACE``,
                              ``THEANOMPI_TPU_COLLECTOR``)

The port's series keep their PR 13 labels: ``span_ms{span=...}`` (JAX:
``name``) and ``step_ms{phase, worker}`` (JAX: ``worker`` only).
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import deque
from typing import Any, Iterator

from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.monitor.health import (
    HeartbeatReporter,
    StragglerDetector,
)
from theanompi_tpu_torch.monitor.postmortem import (
    build_postmortem,
    dump_postmortem as _dump_postmortem_file,
)
from theanompi_tpu_torch.monitor.registry import (
    MetricsRegistry,
    tree_bytes,
    tree_dtypes,
)
from theanompi_tpu_torch.monitor.spans import NULL_SPAN, Span, open_spans

ENV_VAR = "THEANOMPI_TPU_MONITOR"

#: how many recent step durations the postmortem carries
RECENT_STEPS = 64
#: the heartbeat's stall watchdog fires after this many seconds with no
#: step (``session(stall_after=)`` overrides it)
STALL_AFTER_S = 60.0

__all__ = [
    "ENV_VAR", "MetricsRegistry", "Span", "StragglerDetector",
    "HeartbeatReporter", "build_postmortem", "enabled", "monitor_dir",
    "registry", "session", "inc", "set_gauge", "add_gauge", "observe",
    "span", "progress", "observe_step", "flush", "dump_postmortem",
    "open_spans", "tree_bytes", "tree_dtypes", "reset_for_tests",
    "snapshot_path", "trace",
]


class _State:
    """All mutable module state in one bag, swap-able for tests."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.enabled = False
        self.run_dir: str | None = None
        self.rank = 0
        self.suffix = "rank0"
        self.heartbeat: HeartbeatReporter | None = None
        self.straggler: StragglerDetector | None = None
        self.exporter = None  # export.Exporter when tracing/collecting
        self.recent_steps: deque[float] = deque(maxlen=RECENT_STEPS)
        self.depth = 0


_state = _State()
_lock = threading.RLock()


def enabled() -> bool:
    return _state.enabled


def monitor_dir() -> str | None:
    """The active session's run directory, or None when monitoring is
    off (where ``resilience.recovery.record_crash`` drops its marker)."""
    return _state.run_dir


def registry() -> MetricsRegistry:
    """The process registry.  Always exists (its ``write_count`` proves
    the disabled no-op path); only the facade writes to it when on."""
    return _state.registry


def snapshot_path() -> str | None:
    if _state.run_dir is None:
        return None
    return os.path.join(_state.run_dir, f"metrics_{_state.suffix}.jsonl")


@contextlib.contextmanager
def session(run_dir: str | None = None, rank: int = 0,
            interval: float | None = None,
            stall_after: float | None = None,
            name: str | None = None) -> Iterator[bool]:
    """Activate monitoring for the block; yields whether it is live.
    ``run_dir=None`` falls back to ``$THEANOMPI_TPU_MONITOR``; with
    neither the block runs with monitoring off.  Reentrant: nested
    sessions share the outer one's state and only the outermost exit
    flushes.  An exception escaping the block dumps the postmortem
    before it propagates."""
    resolved = run_dir or os.environ.get(ENV_VAR) or None
    if not resolved:
        yield False
        return
    with _lock:
        # activate before counting the depth: an activation that raises
        # (a bad interval, an unwritable dir) must not leave a depth
        # behind, or every later session would record nothing
        if _state.depth == 0:
            _activate(resolved, rank, interval, stall_after, name)
        _state.depth += 1
    try:
        yield True
    except BaseException as e:
        dump_postmortem(e)
        raise
    finally:
        with _lock:
            _state.depth -= 1
            if _state.depth == 0:
                _finalize()


def _activate(run_dir: str, rank: int, interval: float | None,
              stall_after: float | None, name: str | None) -> None:
    if interval is None:
        interval = float(os.environ.get(
            "THEANOMPI_TPU_MONITOR_INTERVAL", "5"))
    if stall_after is None:
        stall_after = STALL_AFTER_S
    os.makedirs(run_dir, exist_ok=True)
    # a fresh registry per session: consecutive sessions in one process
    # must not merge each other's series
    _state.registry = MetricsRegistry()
    _state.recent_steps.clear()
    _state.run_dir = run_dir
    _state.rank = rank
    _state.suffix = name or f"rank{rank}"
    _state.straggler = StragglerDetector(registry=_state.registry)
    _state.heartbeat = HeartbeatReporter(
        run_dir, rank=rank, registry=_state.registry, interval=interval,
        stall_after=stall_after,
        snapshot_path=os.path.join(run_dir,
                                   f"metrics_{_state.suffix}.jsonl"),
        suffix=_state.suffix).start()
    _state.registry.set_gauge("monitor/enabled", 1.0)
    # tracing and export ride the session: re-read the switches here
    # (launcher-exported vars take effect) and start the exporter only
    # when tracing or a collector is configured
    trace.activate_from_env()
    from theanompi_tpu_torch.monitor import export as _export

    _state.exporter = _export.maybe_start(
        run_dir, _state.suffix, rank, _state.registry)
    _state.enabled = True


def _finalize() -> None:
    _state.enabled = False
    # the final snapshot says the session ended, and a later session's
    # postmortem must not inherit this one's step times
    _state.registry.set_gauge("monitor/enabled", 0.0)
    _state.recent_steps.clear()
    hb, _state.heartbeat = _state.heartbeat, None
    if hb is not None:
        hb.stop()
    _stop_exporter()
    run_dir, suffix = _state.run_dir, _state.suffix
    if run_dir is not None:
        try:
            _state.registry.write_jsonl(
                os.path.join(run_dir, f"metrics_{suffix}.jsonl"))
            with open(os.path.join(run_dir,
                                   f"metrics_{suffix}.prom"), "w") as f:
                f.write(_state.registry.to_prometheus())
        except OSError:
            pass
    _state.run_dir = None
    _state.straggler = None


def _stop_exporter() -> None:
    ex, _state.exporter = _state.exporter, None
    if ex is not None:
        from theanompi_tpu_torch.monitor import export as _export

        _export.set_exporter(None)
        ex.stop()


def reset_for_tests() -> None:
    """Hard reset: stop any heartbeat and exporter thread and swap in a
    fresh state.  Test fixtures only."""
    global _state
    with _lock:
        hb = _state.heartbeat
        if hb is not None:
            hb.stop()
        _stop_exporter()
        trace.reset_for_tests()
        _state = _State()


# ---------------------------------------------------------------------------
# Hot-path instrumentation (all gated)
# ---------------------------------------------------------------------------


def inc(name: str, amount: float = 1.0, /, **labels) -> None:
    if not _state.enabled:
        return
    _state.registry.inc(name, amount, **labels)


def set_gauge(name: str, value: float, /, **labels) -> None:
    if not _state.enabled:
        return
    _state.registry.set_gauge(name, value, **labels)


def add_gauge(name: str, delta: float, /, **labels) -> None:
    if not _state.enabled:
        return
    _state.registry.add_gauge(name, delta, **labels)


def observe(name: str, value: float, /, **labels) -> None:
    if not _state.enabled:
        return
    _state.registry.observe(name, value, **labels)


def span(name: str, /, fence: Any = None, **labels):
    """A context manager timing the block into ``span_ms{span=...}``;
    the shared no-op when monitoring is off.  ``fence=`` waits at exit
    for the cards holding the given tensors (``spans.py``)."""
    if not _state.enabled:
        return NULL_SPAN
    return Span(name, registry=_state.registry, fence=fence, **labels)


def progress(phase: str | None = None, step: int | None = None,
             worker: int | None = None) -> None:
    """Feed the heartbeat and its watchdog: call whenever work
    advances."""
    if not _state.enabled:
        return
    hb = _state.heartbeat
    if hb is not None:
        hb.progress(phase, step, worker)


def observe_step(seconds: float, phase: str | None = None,
                 step: int | None = None, worker: int | None = None) -> bool:
    """One training step: the ``step_ms`` histogram (labelled by
    ``phase`` and, for an async worker, ``worker``), the heartbeat, the
    postmortem's recent steps and, with ``worker``, the straggler
    detector.  Returns True while that worker is flagged as a
    straggler."""
    if not _state.enabled:
        return False
    labels = {"phase": str(phase)}
    if worker is not None:
        labels["worker"] = str(worker)
    _state.registry.observe("step_ms", seconds * 1e3, **labels)
    _state.recent_steps.append(seconds)
    hb = _state.heartbeat
    if hb is not None:
        hb.progress(phase, step, worker)
    if worker is not None and _state.straggler is not None:
        return _state.straggler.observe(worker, seconds)
    return False


def flush() -> str | None:
    """Write the snapshot JSONL now (the heartbeat thread also does,
    every interval, and the session's exit)."""
    if not _state.enabled or _state.run_dir is None:
        return None
    path = snapshot_path()
    try:
        _state.registry.write_jsonl(path)
    except OSError:
        return None
    return path


def dump_postmortem(exc: BaseException | None = None) -> str | None:
    """Write the crash report to the run dir; a no-op when off.  Called
    when an exception escapes ``session()``."""
    if not _state.enabled or _state.run_dir is None:
        return None
    return _dump_postmortem_file(
        _state.run_dir, _state.rank, exc, registry=_state.registry,
        recent_steps=list(_state.recent_steps), suffix=_state.suffix)
