"""Trace context — the cross-process identity that stitches one fleet
into one timeline.

Copy of ``theanompi_tpu/monitor/trace.py`` (the port imports nothing of
the JAX package).  A trace context is three fields: ``trace_id`` (16
hex chars, shared by every span of one logical request), the caller's
``span_id`` (the parent link), and a ``sampled`` flag.  It rides wire
v2 as an envelope op (``wire.TRACE_OP``) that is only sent after both
peers granted ``trace`` in the ``wire_hello`` — legacy peers never see
it and degrade silently, exactly like compression/dtype negotiation.

This module is deliberately standalone (stdlib imports only): it is
imported by ``monitor/spans.py`` at module load and by the wire/rpc
layers, so it sits at the bottom of the import graph.
``spans``/``export`` are resolved lazily at the few call sites that
need them.

Enablement contract (mirrors the monitor facade and ``faults.py``):
tracing is OFF unless ``THEANOMPI_TPU_TRACE`` is set truthy — when
off, ``enabled()`` is one attribute read, ``inject()``/``capture()``
return ``None``, ``attach_wire(...)`` is a no-op context manager, and
spans never allocate ids.

Sampling: ``THEANOMPI_TPU_TRACE_SAMPLE`` (default 1.0) rolls once at
the trace ROOT; children and remote continuations inherit the
decision, so a trace is always complete-or-absent — never a partial
tree.  Unsampled spans still propagate ids (cheap) but skip export.
"""

from __future__ import annotations

import contextlib
import os
import threading

ENV_VAR = "THEANOMPI_TPU_TRACE"
SAMPLE_ENV_VAR = "THEANOMPI_TPU_TRACE_SAMPLE"
#: address (host:port) of the telemetry collector; consumed by
#: monitor/export.py but defined here so launcher/export/collector
#: agree on one spelling
COLLECTOR_ENV_VAR = "THEANOMPI_TPU_COLLECTOR"

_TRUTHY = ("1", "true", "yes", "on")


class _TraceState:
    """Module state in one bag, swap-able for tests (same pattern as
    the monitor facade's ``_State``)."""

    def __init__(self):
        self.enabled = False
        self.sample = 1.0


_state = _TraceState()
_local = threading.local()


def enabled() -> bool:
    return _state.enabled


def set_enabled(on: bool, sample: float | None = None) -> None:
    """Explicit switch (tests, launcher).  ``sample`` clamps to
    [0, 1]."""
    _state.enabled = bool(on)
    if sample is not None:
        _state.sample = min(1.0, max(0.0, float(sample)))


def activate_from_env() -> None:
    """Re-read the env switches, so an exported env var takes effect at
    session start, not only at import time."""
    raw = (os.environ.get(ENV_VAR) or "").strip().lower()
    _state.enabled = raw in _TRUTHY
    try:
        _state.sample = min(1.0, max(0.0, float(
            os.environ.get(SAMPLE_ENV_VAR, "") or 1.0)))
    except ValueError:
        _state.sample = 1.0


def new_id() -> str:
    """64 random bits as 16 hex chars — fork-safe (``os.urandom``, no
    inherited PRNG state) and collision-safe at fleet scale."""
    return os.urandom(8).hex()


def _roll_sample() -> bool:
    s = _state.sample
    if s >= 1.0:
        return True
    if s <= 0.0:
        return False
    return int.from_bytes(os.urandom(2), "big") < int(s * 65536.0)


# ---------------------------------------------------------------------------
# Span linkage (called from spans.Span.__enter__/__exit__)
# ---------------------------------------------------------------------------


def begin(parent) -> tuple[str, str, str | None, bool]:
    """Ids for a span that is entering: ``(trace_id, span_id,
    parent_id, sampled)``.  Parent resolution order: the enclosing
    span on this thread's stack, else the thread's attached remote
    context (an RPC caller on another process), else a fresh root."""
    if parent is not None and getattr(parent, "trace_id", None):
        return parent.trace_id, new_id(), parent.span_id, parent.sampled
    rem = getattr(_local, "remote", None)
    if rem is not None:
        return rem[0], new_id(), rem[1], rem[2]
    return new_id(), new_id(), None, _roll_sample()


def record_span(span, dur_s: float, err: bool) -> None:
    """Ship one finished span to the exporter (no-op when no exporter
    is running or the trace was not sampled).  The record carries BOTH
    clocks — ``t_wall`` for cross-process merging (after collector
    offset correction) and ``t_mono`` for in-process interval math —
    plus thread identity; pid/role/rank are stamped once per batch by
    the exporter.  JAX's record format, field for field."""
    if not span.sampled:
        return
    from theanompi_tpu_torch.monitor import export as _export

    _export.emit({
        "event": "span",
        "trace": span.trace_id,
        "span": span.span_id,
        "parent": span.parent_id,
        "name": span.full_name,
        "labels": dict(span.labels),
        "t_wall": span.t_wall,
        "t_mono": span.t0,
        "dur_s": dur_s,
        "thread": span.thread,
        "err": bool(err),
    })


# ---------------------------------------------------------------------------
# Wire form
# ---------------------------------------------------------------------------


def inject() -> dict | None:
    """The wire-form context for an outgoing RPC: the currently-open
    span on this thread (its own id becomes the server side's parent),
    else the thread's attached remote context (pass-through for proxy
    hops that open no span of their own).  ``None`` when tracing is off
    or nothing is open — callers send a plain message then."""
    if not _state.enabled:
        return None
    from theanompi_tpu_torch.monitor import spans as _spans

    cur = _spans.current_span()
    if cur is not None and getattr(cur, "trace_id", None):
        return {"t": cur.trace_id, "s": cur.span_id,
                "x": 1 if cur.sampled else 0}
    rem = getattr(_local, "remote", None)
    if rem is not None:
        return {"t": rem[0], "s": rem[1], "x": 1 if rem[2] else 0}
    return None


#: cross-thread handoff uses the same derivation as cross-process
#: injection — capture in the submitting thread, attach in the worker
capture = inject


@contextlib.contextmanager
def attach_wire(ctx: dict | None):
    """Attach a wire-form context as this thread's remote parent for
    the duration of the block; spans opened inside become children of
    the caller's span.  Tolerant of ``None``/malformed input (a hostile
    or buggy peer must not break dispatch) and an exact no-op when
    tracing is disabled."""
    if not _state.enabled or not isinstance(ctx, dict):
        yield
        return
    t, s = ctx.get("t"), ctx.get("s")
    if not (isinstance(t, str) and isinstance(s, str)
            and 0 < len(t) <= 32 and 0 < len(s) <= 32):
        yield
        return
    prev = getattr(_local, "remote", None)
    _local.remote = (t, s, bool(ctx.get("x", 1)))
    try:
        yield
    finally:
        _local.remote = prev


def reset_for_tests() -> None:
    global _state
    _state = _TraceState()
    if hasattr(_local, "remote"):
        _local.remote = None


activate_from_env()
