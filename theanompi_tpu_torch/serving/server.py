"""Multi-replica inference server (in-process; the TCP front is not
ported yet).

Counterpart of ``theanompi_tpu/serving/server.py`` for the eval
(image-classification) branch.  One :class:`InferenceServer` owns N
:class:`Replica`\\ s, each an
:class:`~theanompi_tpu_torch.serving.export.InferenceSession` behind its
own :class:`~theanompi_tpu_torch.serving.batcher.DynamicBatcher`.
Requests round-robin over live replicas with overflow failover; when
every live replica's queue is full the request is rejected with
:class:`Overloaded`.

Resilience: ``serve_step`` (one replica batch) is a fault site.  A batch
failure fails that batch's requests, then the replica is restarted from
the export (a fresh verified load of the version it serves) up to
``max_restarts`` times, after which it is lost and traffic routes around
it.

Hot reload: a watcher polls the export directory; a newer published
version is verified-loaded once and swapped into every replica, so
in-flight batches finish on the old weights and no request is dropped.
A corrupt newest version is skipped until a newer one appears; an
incompatible one is refused with :class:`IncompatibleExport`.

Autoregressive decode serving is not ported yet: ``decode=True`` raises.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving.batcher import (
    BatchPolicy,
    DynamicBatcher,
    Overloaded,
)
from theanompi_tpu_torch.serving.export import (
    IncompatibleExport,
    InferenceSession,
    build_model_from_meta,
    export_incompatibility,
    latest_export_version,
    load_export,
)


class Replica:
    """One inference session + batcher under restart supervision."""

    def __init__(self, idx: int, export_dir: str, policy: BatchPolicy,
                 loaded, model, max_restarts: int = 2):
        self.idx = int(idx)
        self.export_dir = export_dir
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._steps = 0
        self.session = InferenceSession(model, state=loaded.state,
                                        version=loaded.version)
        self.batcher = DynamicBatcher(
            self._run_batch, policy, replica=self.idx,
            on_batch_error=self._on_batch_error)

    @property
    def alive(self) -> bool:
        return self.batcher.alive

    def submit(self, x: np.ndarray) -> np.ndarray:
        return self.batcher.submit(x)

    def _run_batch(self, x: np.ndarray) -> np.ndarray:
        self._steps += 1
        faults.fire("serve_step", replica=self.idx, step=self._steps)
        return self.session.infer(x)

    def _on_batch_error(self, exc: BaseException) -> bool:
        """Reload this replica's weights from the export, pinned to the
        version being served (an upgrade goes through ``check_reload``'s
        compatibility gate, never through a crash).  False (replica
        lost) once the restart budget is spent."""
        self.restarts += 1
        monitor.inc("serving/replica_restarts_total", replica=self.idx)
        if self.restarts > self.max_restarts:
            print(f"[serving] replica {self.idx} exhausted "
                  f"{self.max_restarts} restarts ({type(exc).__name__}: "
                  f"{exc}); marking it lost", flush=True)
            return False
        try:
            loaded = load_export(self.export_dir,
                                 version=self.session.version)
        except Exception as e:
            print(f"[serving] replica {self.idx} restart-from-export failed "
                  f"({type(e).__name__}: {e}); marking it lost", flush=True)
            return False
        self.session.swap(loaded.version, loaded.state)
        print(f"[serving] replica {self.idx} restarted on "
              f"v{self.session.version} after {type(exc).__name__} "
              f"(restart {self.restarts}/{self.max_restarts})", flush=True)
        return True

    def swap(self, version: int, state: dict) -> None:
        self.session.swap(version, state)


class InferenceServer:
    """Replica pool + admission + hot reload (module docstring).

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to serve through the kernels' plain versions.  The
    model is rebuilt from the export's meta, and every replica warms up
    each bucket at :meth:`start`."""

    def __init__(self, export_dir: str, replicas: int = 1,
                 policy: BatchPolicy | None = None, max_restarts: int = 2,
                 reload_poll_s: float = 1.0, decode: bool = False,
                 device: str | torch.device = "cuda"):
        if decode:
            raise NotImplementedError(
                "decode serving (TransformerLM exports) is not ported yet")
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.device = resolve_device(device)
        self.export_dir = os.path.abspath(export_dir)
        self.policy = policy or BatchPolicy()
        self.reload_poll_s = float(reload_poll_s)
        loaded = load_export(self.export_dir)
        self.model = build_model_from_meta(loaded.meta, self.device)
        self.version = loaded.version        # guarded_by: self._reload_lock
        self._meta = loaded.meta             # guarded_by: self._reload_lock
        self.replicas = [
            Replica(i, self.export_dir, self.policy, loaded, self.model,
                    max_restarts=max_restarts)
            for i in range(int(replicas))
        ]
        shape = tuple(loaded.meta.get("sample_shape")
                      or self.model.data.sample_shape)
        dtype = np.dtype(loaded.meta.get("sample_dtype") or np.float32)
        for r in self.replicas:
            # runs at start(), on the replica's collector thread; the
            # raw session, not run_batch: warmup skips the serve_step
            # fault site and the served-batch counter
            r.batcher.warmup(shape, dtype, fn=r.session.infer)
        self._rr_lock = make_lock("InferenceServer._rr_lock")
        self._rr = 0                          # guarded_by: self._rr_lock
        self._stop = threading.Event()
        self._watcher: threading.Thread | None = None
        self._reload_lock = make_lock("InferenceServer._reload_lock")
        #: newest published version that failed verification or was
        #: refused; not re-loaded until a strictly newer one appears
        self._bad_newest: int | None = None  # guarded_by: self._reload_lock
        #: refusal reason when _bad_newest was incompatible, re-raised
        #: from memory on every further reload of that version
        self._bad_reason: str | None = None  # guarded_by: self._reload_lock
        monitor.set_gauge("serving/model_version", self.version)
        monitor.set_gauge("serving/replicas", len(self.replicas))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "InferenceServer":
        """Start every replica (each warms up on its own thread first)
        and the reload watcher; a failed warmup stops what started."""
        try:
            for r in self.replicas:
                r.batcher.start()
        except Exception:
            self.stop()
            raise
        if self.reload_poll_s > 0:
            self._watcher = threading.Thread(
                target=self._watch_reload, daemon=True,
                name="serving-reload-watcher")
            self._watcher.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self.replicas:
            r.batcher.stop()
        if self._watcher is not None:
            self._watcher.join(timeout=5)

    # -- request path --------------------------------------------------

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Route one eval request (``(rows, *sample)``) to a live replica
        with overflow failover; :class:`Overloaded` only when every live
        replica rejects."""
        n = len(self.replicas)
        with self._rr_lock:
            start = self._rr
            self._rr = (self._rr + 1) % n
        last: Overloaded | None = None
        any_alive = False
        for k in range(n):
            r = self.replicas[(start + k) % n]
            if not r.alive:
                continue
            any_alive = True
            try:
                return r.submit(x)
            except Overloaded as e:
                last = e
        if not any_alive:
            raise Overloaded("no live replicas (all lost); the server "
                             "needs a restart or a good export")
        raise last if last is not None else Overloaded("rejected")

    # -- hot reload ----------------------------------------------------

    def check_reload(self) -> int:
        """One poll: load + swap a newer published version; returns the
        serving version either way."""
        with self._reload_lock:
            newest = latest_export_version(self.export_dir)
            if newest is None or newest <= self.version:
                return self.version
            if newest == self._bad_newest:
                if self._bad_reason is not None:
                    raise IncompatibleExport(self._bad_reason)
                return self.version
            loaded = load_export(self.export_dir)
            if loaded.version <= self.version:
                # the newest version did not verify and the load fell
                # back; versions are immutable, so skip it until a
                # strictly newer one is published
                self._bad_newest = newest
                self._bad_reason = None
                return self.version
            reason = export_incompatibility(self._meta, loaded.meta)
            if reason is not None:
                self._bad_newest = newest
                self._bad_reason = (f"refusing hot reload v{self.version} "
                                    f"-> v{loaded.version}: {reason}")
                monitor.inc("serving/reload_refused_total")
                print(f"[serving] {self._bad_reason}", flush=True)
                raise IncompatibleExport(self._bad_reason)
            self._bad_newest = None
            self._bad_reason = None
            for r in self.replicas:
                r.swap(loaded.version, loaded.state)
            self._meta = loaded.meta
            old, self.version = self.version, loaded.version
            monitor.set_gauge("serving/model_version", self.version)
            monitor.inc("serving/reloads_total")
            print(f"[serving] hot reload v{old} -> v{self.version} "
                  f"({len(self.replicas)} replicas, in-flight requests "
                  "kept)", flush=True)
            return self.version

    def _watch_reload(self) -> None:
        while not self._stop.wait(self.reload_poll_s):
            try:
                self.check_reload()
            except IncompatibleExport:
                pass  # printed once at refusal time
            except Exception as e:
                # a broken half-published export must not kill the
                # watcher; the next poll retries
                print(f"[serving] reload check failed: "
                      f"{type(e).__name__}: {e}", flush=True)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._reload_lock:
            reps = [dict(r.batcher.stats(), restarts=r.restarts,
                         version=r.session.version)
                    for r in self.replicas]
            version = self.version
        return {
            "version": version,
            "decode": False,
            "replicas": reps,
            "overloaded": sum(r["overloaded"] for r in reps),
            "live_replicas": sum(1 for r in self.replicas if r.alive),
            "batches": sum(r["batches"] for r in reps),
            "rows": sum(r["rows"] for r in reps),
            "max_occupancy": max((r["max_occupancy"] for r in reps),
                                 default=0),
        }
