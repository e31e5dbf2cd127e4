"""Span tracing — nested wall-clock spans that line up with profiler
traces.

Counterpart of ``theanompi_tpu/monitor/spans.py``.  A span is a named
wall-clock interval around a phase of work (``with span("comm"):
...``).  Three things happen per span:

1. **Honest timing.**  A CUDA launch returns before the card finishes,
   so a plain wall timer measures the enqueue.  A span can *fence* on
   tensors at exit (``fence=...``) through ``utils/recorder.
   device_fence``, which synchronizes the cards holding them (never a
   ``.cpu()`` copy): the span then lasts at least as long as the work
   queued on them.
2. **Profiler alignment.**  Each span enters a
   ``torch.profiler.record_function`` of its full name, so under a
   ``utils/profiling.StepProfiler`` capture the span shows up by name
   in the trace, host spans and kernels on one ruler (JAX's spans enter
   ``jax.profiler.TraceAnnotation``).
3. **Registry feed.**  On exit the duration lands in the histogram
   ``span_ms{span=<full name>}`` (the port's label, kept since PR 13;
   JAX's is ``name``), and an escaping exception counts
   ``span_errors_total{span=...}``.

Nesting is tracked per thread; the full name of a nested span is
``parent/child``.  Open spans are visible across threads
(:func:`open_spans`) so the postmortem can say which phase each thread
was in.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from theanompi_tpu_torch.monitor import trace as _trace

_local = threading.local()

#: every open span of the process: id(span) -> Span (the postmortem
#: reads it; entries are removed on exit)
_open: dict[int, "Span"] = {}
_open_lock = threading.Lock()


def _stack() -> list["Span"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _fence(tree: Any) -> None:
    # lazy: utils.recorder imports the monitor facade, which imports
    # this module
    from theanompi_tpu_torch.utils.recorder import device_fence

    device_fence(tree)


class Span:
    """One timed interval.  Use through ``monitor.span(...)`` (a no-op
    when monitoring is off) or directly.  ``registry=None`` times and
    nests but records nowhere."""

    __slots__ = ("name", "full_name", "labels", "fence_on", "registry",
                 "t0", "t_wall", "thread", "_annotation", "_annotate",
                 "trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, name: str, registry=None, fence: Any = None,
                 annotate: bool = True, **labels):
        self.name = name
        self.full_name = name  # finalized on __enter__ from the stack
        self.labels = labels
        self.fence_on = fence
        self.registry = registry
        self.t0 = 0.0
        self.t_wall = 0.0
        self.thread = threading.current_thread().name
        self._annotate = annotate
        self._annotation = None
        # trace linkage: ids stay None unless tracing is on at
        # __enter__, so the disabled path allocates nothing
        self.trace_id: str | None = None
        self.span_id: str | None = None
        self.parent_id: str | None = None
        self.sampled = False

    def __enter__(self) -> "Span":
        # t0 is set before the span becomes visible, so a concurrent
        # open_spans() never computes an age from 0.0
        self.t0 = time.monotonic()
        st = _stack()
        if st:
            self.full_name = f"{st[-1].full_name}/{self.name}"
        if _trace.enabled():
            (self.trace_id, self.span_id,
             self.parent_id, self.sampled) = _trace.begin(
                st[-1] if st else None)
        st.append(self)
        with _open_lock:
            _open[id(self)] = self
        if self._annotate:
            try:
                import torch

                self._annotation = torch.profiler.record_function(
                    self.full_name)
                self._annotation.__enter__()
            except Exception:
                # best-effort alignment: a failure must not abort
                # __enter__ after the span registered itself
                self._annotation = None
        # re-stamp after the annotation's setup, so its cost is not
        # charged to the block; the wall stamp pairs with this instant
        self.t0 = time.monotonic()
        self.t_wall = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if self.fence_on is not None and exc_type is None:
                _fence(self.fence_on)
        finally:
            dt = time.monotonic() - self.t0
            if self._annotation is not None:
                try:
                    self._annotation.__exit__(exc_type, exc, tb)
                except Exception:
                    # a profiler stopping under an open span must not
                    # skip the cleanup below or mask the body's error
                    pass
                self._annotation = None
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            else:  # exited out of order: scrub
                try:
                    st.remove(self)
                except ValueError:
                    pass
            with _open_lock:
                _open.pop(id(self), None)
            if self.registry is not None:
                self.registry.observe("span_ms", dt * 1e3,
                                      span=self.full_name, **self.labels)
                if exc_type is not None:
                    self.registry.inc("span_errors_total",
                                      span=self.full_name)
            if self.trace_id is not None:
                _trace.record_span(self, dt, exc_type is not None)

    @property
    def age_s(self) -> float:
        return time.monotonic() - self.t0


class _NullSpan:
    """The disabled fast path: a shared, reentrant, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


def current_span() -> Span | None:
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def open_spans() -> list[dict]:
    """Every open span of the process (all threads), oldest first."""
    with _open_lock:
        spans = list(_open.values())
    spans.sort(key=lambda s: s.t0)
    out = []
    for s in spans:
        d = {"name": s.full_name, "thread": s.thread,
             "age_s": round(s.age_s, 3), "labels": s.labels}
        if s.trace_id is not None:  # only under tracing
            d["trace"] = s.trace_id
            d["span"] = s.span_id
        out.append(d)
    return out
