"""Worker supervision for the async rules (copy of
``theanompi_tpu/resilience/supervisor.py``).

The reference (and this rebuild's default) is fail-fast: any worker
exception aborts the whole session (SURVEY.md §5.3).  For long
multi-worker runs that is the wrong trade — one transient fault (a
dropped connection, an injected kill, an OOM-killed data thread)
should not discard hours of every other worker's progress.  The
TensorFlow paper (arXiv:1605.08695) treats component restart as a
first-class requirement; this module is that layer for the async
rules' worker *threads*.

:class:`WorkerSupervisor` wraps each worker target: when a worker
raises a recoverable error (any ``Exception``; ``BaseException``
escapees like KeyboardInterrupt stay fatal) and restart budget
remains, the rule-provided ``restart_from`` callback re-seeds the
worker's model from the center parameters and the worker function is
re-run.  A worker that exhausts its budget — or is not restartable at
all (GOSGD has no center; it passes ``restart_from=None``) — is
*lost*: the rule's ``on_lost`` hook runs (GOSGD's existing
``hub.deactivate`` path, so peers stop gossiping at the corpse), and
the session continues **unless the surviving-worker quorum drops
below ``min_workers``**, in which case the whole session aborts with
the worker's original error — the fail-fast contract, restored at the
quorum boundary.

Straggler handoff (docs/OBSERVABILITY.md): the rules feed
``monitor.observe_step``'s straggler flag into
:meth:`note_straggler`; the supervisor counts edge transitions
(``resilience/straggler_handoffs_total``) and exposes the live set —
a Python thread cannot be preempted, so a *stalled-but-alive* worker
is surfaced and counted rather than forcibly restarted (the stall
watchdog names it; the operator or the launcher-level auto-resume
acts on it).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Sequence

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.resilience.retry import RetryPolicy


class WorkerSupervisor:
    """Bounded restart-with-quorum supervision (module docstring)."""

    def __init__(self, n_workers: int, max_restarts: int = 1,
                 min_workers: int = 1,
                 restart_from: Callable[[int], None] | None = None,
                 on_lost: Callable[[int], None] | None = None,
                 backoff: RetryPolicy | None = None,
                 name: str = "rule"):
        if min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got {min_workers}")
        self.n_workers = n_workers
        self.max_restarts = max_restarts
        self.min_workers = min_workers
        self.restart_from = restart_from
        self.on_lost = on_lost
        self.name = name
        # short pause before re-running a restarted worker: the fault
        # that killed it (a service mid-restart, say) is often still
        # clearing; full retry semantics are overkill here
        self.backoff = backoff or RetryPolicy(
            max_attempts=max(2, max_restarts + 1), base_delay=0.1,
            max_delay=2.0, name=f"{name}-restart")
        self._lock = make_lock("WorkerSupervisor._lock")
        self._restarts: dict[int, int] = {}   # guarded_by: self._lock
        self._lost: set[int] = set()          # guarded_by: self._lock
        self._stragglers: set[int] = set()    # guarded_by: self._lock

    # -- introspection (rules put these in their result dict) ----------

    def restart_counts(self) -> dict[int, int]:
        with self._lock:
            return dict(self._restarts)

    def lost_workers(self) -> list[int]:
        with self._lock:
            return sorted(self._lost)

    def is_lost(self, rank: int) -> bool:
        with self._lock:
            return rank in self._lost

    def stragglers(self) -> list[int]:
        with self._lock:
            return sorted(self._stragglers)

    # -- detector handoff ---------------------------------------------

    def note_straggler(self, rank: int, flagged: bool) -> None:
        """Consume the StragglerDetector signal (the return value of
        ``monitor.observe_step``).  Edge-triggered bookkeeping only —
        see the module docstring on why a live thread is not
        restarted."""
        with self._lock:
            was = rank in self._stragglers
            if flagged == was:
                return
            if flagged:
                self._stragglers.add(rank)
            else:
                self._stragglers.discard(rank)
        if flagged:
            monitor.inc("resilience/straggler_handoffs_total",
                        worker=rank)

    # -- the run loop --------------------------------------------------

    def run(self, workers: Sequence[Callable], extra: Sequence[Callable] = ()
            ) -> None:
        """Run ``workers`` under supervision plus ``extra`` unsupervised
        targets (e.g. EASGD's orchestrator); every target receives the
        shared abort Event.  Joins everything; re-raises the first
        fatal error."""
        abort = threading.Event()
        errors: list[BaseException] = []

        def supervised(rank: int, fn: Callable):
            def loop():
                while not abort.is_set():
                    try:
                        fn(abort)
                        return
                    except BaseException as e:
                        # the restart ordinal comes from under
                        # _handle_failure's lock: a bare read of
                        # self._restarts here would race other
                        # workers' failure bookkeeping
                        attempt = self._handle_failure(
                            rank, e, errors, abort)
                        if not attempt:
                            return
                        try:
                            if self.restart_from is not None:
                                self.restart_from(rank)
                        except BaseException as e2:
                            # center unreachable etc. — restarting is
                            # hopeless; fail the session
                            with self._lock:
                                errors.append(e2)
                            abort.set()
                            return
                        time.sleep(self.backoff.delay(attempt - 1))
            return threading.Thread(target=loop, daemon=True,
                                    name=f"{self.name}-worker{rank}")

        def plain(i: int, fn: Callable):
            def run_once():
                try:
                    fn(abort)
                except BaseException as e:
                    with self._lock:
                        errors.append(e)
                    abort.set()
            return threading.Thread(target=run_once, daemon=True,
                                    name=f"{self.name}-extra{i}")

        threads = [supervised(r, fn) for r, fn in enumerate(workers)]
        threads += [plain(i, fn) for i, fn in enumerate(extra)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _handle_failure(self, rank: int, e: BaseException,
                        errors: list[BaseException],
                        abort: threading.Event) -> int:
        """Decide restart (returns the 1-based restart ordinal) vs
        stop-this-thread (returns 0); flips the session abort when the
        error is fatal or quorum is lost."""
        recoverable = isinstance(e, Exception)
        with self._lock:
            if abort.is_set():
                return 0
            n = self._restarts.get(rank, 0)
            if (recoverable and self.restart_from is not None
                    and n < self.max_restarts):
                self._restarts[rank] = n + 1
                print(f"[resilience] {self.name} worker {rank} died "
                      f"({type(e).__name__}: {e}); restarting from "
                      f"center ({n + 1}/{self.max_restarts})",
                      file=sys.stderr, flush=True)
                monitor.inc("resilience/worker_restarts_total",
                            worker=rank)
                return n + 1
            self._lost.add(rank)
            alive = self.n_workers - len(self._lost)
            monitor.inc("resilience/workers_lost_total", worker=rank)
            if not recoverable or alive < self.min_workers:
                print(f"[resilience] {self.name} worker {rank} lost "
                      f"({type(e).__name__}: {e}); "
                      f"{'fatal error' if not recoverable else 'quorum lost'}"
                      f" ({alive} alive < {self.min_workers} required) — "
                      "aborting session", file=sys.stderr, flush=True)
                errors.append(e)
                abort.set()
                return 0
        # outside the lock: the hook may do service I/O.  ``alive`` was
        # computed under the lock
        if self.on_lost is not None:
            try:
                self.on_lost(rank)
            except Exception as hook_err:
                print(f"[resilience] on_lost({rank}) hook failed: "
                      f"{hook_err}", file=sys.stderr, flush=True)
        print(f"[resilience] {self.name} worker {rank} lost "
              f"({type(e).__name__}: {e}); continuing with "
              f"{alive} worker(s)", file=sys.stderr, flush=True)
        return 0
