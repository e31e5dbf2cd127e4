"""One-in-flight exchange thread: the async rules' comm/compute overlap.

Copy of ``theanompi_tpu/parallel/pipe.py``.  The exchange runs under its
own span (``<name>_rpc``, or ``span=``: the shard router's
``shard_exchange``) on the pipe's thread, inside the trace context
the submitting thread captured (``monitor.trace``), so an overlapped
exchange stays a child of the worker's span; the worker's wait is the
caller's ``<name>_collect`` span.  ``close()`` joins the thread.
"""

from __future__ import annotations

import queue
import threading

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.monitor import trace

#: _ExchangePipe shutdown sentinel
_STOP = object()


class _ExchangePipe:
    """One in-flight parameter exchange per worker.

    ``submit(payload)`` hands a payload to this worker's exchange thread
    and returns at once; the worker keeps computing while ``fn(payload)``
    runs.  ``collect()`` blocks until that exchange finishes and returns
    ``(payload, result)``.  At most ONE exchange is outstanding
    (``submit`` while one is raises), so a worker never runs ahead of the
    center by more than one exchange period (bounded staleness 1).  An
    exception of ``fn`` (an injected fault among them) is carried to the
    worker and raised at ``collect()``, and again at every later
    ``submit()``.  ``close()`` drops a request the thread has not
    started, stops the thread and joins it (it waits for a running
    ``fn``); a result nobody collected stays in the pipe."""

    def __init__(self, fn, name: str, worker: int, span: str | None = None):
        self._fn = fn
        self._name = name
        self._span = span if span is not None else f"{name}_rpc"
        self._worker = str(worker)
        self._req: queue.Queue = queue.Queue(maxsize=1)
        self._res: queue.Queue = queue.Queue()
        self._lock = make_lock("_ExchangePipe._lock")
        self._err: BaseException | None = None  # guarded_by: self._lock
        self.outstanding = False                # guarded_by: self._lock
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"{name}-exchange-w{worker}")
        self._thread.start()

    def _run(self):
        while True:
            item = self._req.get()
            if item is _STOP:
                return
            payload, ctx = item
            try:
                # the submitter's trace context re-attaches here, so the
                # exchange span and the RPC it wraps stay children of
                # the submitting worker's span
                with trace.attach_wire(ctx), \
                        monitor.span(self._span, worker=self._worker):
                    out = (self._fn(payload), None)
            except BaseException as e:  # surfaced at collect()
                out = (None, e)
            self._res.put((payload, out))

    def busy(self) -> bool:
        """Locked read of the barrier flag."""
        with self._lock:
            return self.outstanding

    def submit(self, payload) -> None:
        """Hand one payload to the exchange thread (returns at once).  A
        prior failure or an exchange already outstanding raises here."""
        with self._lock:
            if self._err is not None:
                raise self._err
            if self.outstanding:
                raise RuntimeError(
                    f"{self._name}: bounded-staleness barrier — at most "
                    "one exchange may be outstanding; collect() first")
            self.outstanding = True
        try:
            # the context is captured here, on the submitting thread,
            # where the caller's span is still open
            self._req.put((payload, trace.capture()))
        except BaseException:
            with self._lock:
                self.outstanding = False
            raise

    def collect(self):
        """Block for the in-flight exchange; returns (payload, result).
        Re-raises the exchange thread's exception in the worker."""
        payload, (result, err) = self._res.get()
        with self._lock:
            self.outstanding = False
            if err is not None:
                self._err = err
        if err is not None:
            raise err
        return payload, result

    def close(self) -> None:
        """Stop and join the exchange thread (idempotent)."""
        if not self._thread.is_alive():
            return
        try:  # a request the thread has not dequeued is dropped
            while True:
                self._req.get_nowait()
        except queue.Empty:
            pass
        self._req.put(_STOP)
        self._thread.join()
