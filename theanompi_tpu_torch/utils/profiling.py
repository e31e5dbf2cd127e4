"""The step profiler: a ``torch.profiler`` trace of a session's first steps.

Counterpart of ``theanompi_tpu/utils/profiling.py`` (``jax.profiler``
there).  :class:`StepProfiler` traces the host and, where a card is
visible, its kernels (CUPTI) over the first ``n_steps`` training
iterations, across epoch boundaries, then stops and writes a Chrome
trace, ``rank{r}.{pid}.pt.trace.json`` in its directory (load it in
Perfetto or ``chrome://tracing``).  Each iteration is a
``train#<step>`` range in the trace (``label``), as the JAX package's
``StepTraceAnnotation`` marks it.

Enable with ``THEANOMPI_TPU_PROFILE=/dir`` (and optionally
``THEANOMPI_TPU_PROFILE_STEPS``, default 20) or ``run_bsp_session(...,
profile_dir=...)``.  Without a directory nothing is built and ``label``
hands back one shared null context: the step path carries no profiler
object and no ``record_function``.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


class StepProfiler:
    """Trace the first ``n_steps`` training iterations, then stop.

    A context manager: ``with StepProfiler(dir):`` starts the trace on
    entry and stops it on exit, so a loop that crashes mid-trace still
    writes a loadable trace (``stop`` is what writes it)."""

    def __init__(self, log_dir: str | None = None,
                 n_steps: int | None = None):
        self.log_dir = log_dir or os.environ.get("THEANOMPI_TPU_PROFILE")
        self.n_steps = (n_steps if n_steps is not None else int(
            os.environ.get("THEANOMPI_TPU_PROFILE_STEPS", "20")))
        self._prof = None
        self._done = False
        self._count = 0
        #: the trace file, once written
        self.trace_path: str | None = None

    @property
    def enabled(self) -> bool:
        return bool(self.log_dir)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def __enter__(self) -> "StepProfiler":
        self.maybe_start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def maybe_start(self) -> None:
        if self.log_dir and self._prof is None and not self._done:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def label(self, step: int):
        """The context to run training iteration ``step`` in: a
        ``train#<step>`` range while tracing, else a shared no-op."""
        if self._prof is None:
            return _OFF
        return torch.profiler.record_function(f"train#{step}")

    def step(self) -> None:
        """Call once per training iteration."""
        if self._prof is not None:
            self._count += 1
            if self._count >= self.n_steps:
                self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._done = True
        prof.stop()
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_initialized() else 0
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"rank{rank}.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)
