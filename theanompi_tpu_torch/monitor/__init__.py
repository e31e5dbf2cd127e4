"""Telemetry facade (subset of ``theanompi_tpu/monitor``).

Monitoring is OFF unless a run dir is configured, through
``session(run_dir=...)`` or the ``THEANOMPI_TPU_MONITOR`` environment
variable.  When off, ``inc``/``set_gauge``/``add_gauge``/``observe``/``span``/
``progress``/``observe_step`` return after one boolean check and the
registry receives zero writes.  When on, the session's registry is written as
``metrics_{name}.jsonl`` in the run dir at session exit.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

from theanompi_tpu_torch.monitor.registry import MetricsRegistry

ENV_VAR = "THEANOMPI_TPU_MONITOR"


class _State:
    def __init__(self):
        self.registry = MetricsRegistry()
        self.enabled = False
        self.run_dir: str | None = None
        self.name = "rank0"
        self.depth = 0


_state = _State()
_lock = threading.RLock()


def enabled() -> bool:
    return _state.enabled


def registry() -> MetricsRegistry:
    return _state.registry


@contextlib.contextmanager
def session(run_dir: str | None = None,
            name: str = "rank0") -> Iterator[bool]:
    """Activate monitoring for the block; yields whether it is live.
    Reentrant: only the outermost exit writes the snapshot."""
    resolved = run_dir or os.environ.get(ENV_VAR) or None
    if not resolved:
        yield False
        return
    with _lock:
        if _state.depth == 0:
            os.makedirs(resolved, exist_ok=True)
            _state.registry = MetricsRegistry()
            _state.run_dir, _state.name = resolved, name
            _state.enabled = True
        _state.depth += 1
    try:
        yield True
    finally:
        with _lock:
            _state.depth -= 1
            if _state.depth == 0:
                _state.enabled = False
                _state.registry.write_jsonl(os.path.join(
                    _state.run_dir, f"metrics_{_state.name}.jsonl"))
                _state.run_dir = None


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


class _Span:
    """Times its block into the ``span_ms{name=...}`` histogram."""

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        observe("span_ms", (time.monotonic() - self._t0) * 1e3,
                span=self.name, **self.labels)
        return False


def span(name: str, /, **labels):
    """A context manager timing the block into ``span_ms``; a shared
    no-op when monitoring is off."""
    if not _state.enabled:
        return contextlib.nullcontext()
    return _Span(name, labels)


def progress(phase: str | None = None, step: int | None = None) -> None:
    """Work advanced: counts ``progress_total{phase=...}`` and records
    the step in the ``progress_step`` gauge."""
    if not _state.enabled:
        return
    _state.registry.inc("progress_total", phase=str(phase))
    if step is not None:
        _state.registry.set_gauge("progress_step", step, phase=str(phase))


def observe_step(seconds: float, phase: str | None = None,
                 step: int | None = None) -> None:
    """One training step's host time into the ``step_ms`` histogram."""
    if not _state.enabled:
        return
    _state.registry.observe("step_ms", seconds * 1e3, phase=str(phase))
    progress(phase, step)
