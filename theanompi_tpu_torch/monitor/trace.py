"""Trace context — the cross-process identity that stitches one fleet
into one timeline.

The wire half of ``theanompi_tpu/monitor/trace.py`` (the port imports
nothing of the JAX package).  A trace context is three fields:
``trace_id`` (shared by every span of one logical request), the
caller's ``span_id`` (the parent link), and a ``sampled`` flag.  It
rides wire v2 as an envelope op (``wire.TRACE_OP``) that is only sent
after both peers granted ``trace`` in the ``wire_hello`` — legacy peers
never see it and degrade silently, exactly like compression/dtype
negotiation.  The port has no span tree, sampling or exporter yet
(ROADMAP item 16): :func:`inject` propagates the context a thread
attached with :func:`attach_wire` (a proxy hop), so a port service
passes a JAX caller's context on.

This module is deliberately standalone (stdlib imports only): the
wire/rpc layers import it, so it sits at the bottom of the import
graph.

Enablement contract (mirrors the monitor facade and ``faults.py``):
tracing is OFF unless ``THEANOMPI_TPU_TRACE`` is set truthy — when
off, ``enabled()`` is one attribute read, ``inject()``/``capture()``
return ``None`` and ``attach_wire(...)`` is a no-op context manager.
"""

from __future__ import annotations

import contextlib
import os
import threading

ENV_VAR = "THEANOMPI_TPU_TRACE"

_TRUTHY = ("1", "true", "yes", "on")


class _TraceState:
    """Module state in one bag, swap-able for tests (same pattern as
    the monitor facade's ``_State``)."""

    def __init__(self):
        self.enabled = False


_state = _TraceState()
_local = threading.local()


def enabled() -> bool:
    return _state.enabled


def set_enabled(on: bool) -> None:
    """Explicit switch (tests, launcher)."""
    _state.enabled = bool(on)


def activate_from_env() -> None:
    """Re-read the env switch, so a monkeypatched/exported env var
    takes effect at session start, not only at import time."""
    raw = (os.environ.get(ENV_VAR) or "").strip().lower()
    _state.enabled = raw in _TRUTHY


def inject() -> dict | None:
    """The wire-form context for an outgoing RPC: the thread's attached
    remote context (pass-through for proxy hops that open no span of
    their own).  ``None`` when tracing is off or nothing is attached —
    callers send a plain message then."""
    if not _state.enabled:
        return None
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
    the duration of the block.  Tolerant of ``None``/malformed input (a
    hostile or buggy peer must not break dispatch) and an exact no-op
    when tracing is disabled."""
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
