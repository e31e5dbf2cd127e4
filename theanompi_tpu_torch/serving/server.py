"""Multi-replica inference server, its TCP front and its wire client.

Counterpart of ``theanompi_tpu/serving/server.py``.  One
:class:`InferenceServer` owns N replicas.  In eval mode (image
classifiers) each is a :class:`Replica`: an
:class:`~theanompi_tpu_torch.serving.export.InferenceSession` behind its
own :class:`~theanompi_tpu_torch.serving.batcher.DynamicBatcher`.  In
decode mode (``decode=True``, the TransformerLM family) each is a
:class:`~theanompi_tpu_torch.decode.scheduler.DecodeReplica`: a paged KV
cache behind a continuous batcher, serving ``generate``.  Requests
round-robin over live replicas with overflow failover; when every live
replica rejects, the request gets :class:`Overloaded`.

Transport: :func:`serve` puts the server behind the shared RPC substrate
(parallel/rpc.py: the selector loop, HMAC auth, wire-v2 framing, typed
``err`` replies), TCP only, as every host plane of this package.  Ops:
``infer``, ``generate``, ``adopt``, ``drain``, ``stats``, ``reload``,
``ping`` and the substrate's ``shutdown``; :class:`InferenceClient`
calls them and re-raises ``Overloaded``, ``IncompatibleExport`` and
``IncompatiblePages`` as their own types.  ``serve_rpc`` (each request,
in the connection handler) is a fault site.

Resilience: ``serve_step`` (one replica batch) is a fault site, and
``decode_step`` / ``page_migrate`` on the decode path.  A batch
failure fails that batch's requests, then the replica is restarted from
the export (a fresh verified load of the version it serves) up to
``max_restarts`` times, after which it is lost and traffic routes around
it.

Hot reload: a watcher polls the export directory; a newer published
version is verified-loaded once and swapped into every replica, so
in-flight batches finish on the old weights and no request is dropped.
A corrupt newest version is skipped until a newer one appears; an
incompatible one is refused with :class:`IncompatibleExport`.  A decode
server with a draft export (speculative decoding) polls the draft's
directory the same way (``check_draft_reload``).

Launch: ``python -m theanompi_tpu_torch.serving.server --export-dir D
[--decode ...]`` or ``python -m theanompi_tpu_torch.launcher SERVE
--export-dir D [...]``; both default to the card (``--device cpu`` for
the CPU).
"""

from __future__ import annotations

import argparse
import os
import threading

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.decode.migrate import IncompatiblePages
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.parallel import rpc, wire
from theanompi_tpu_torch.parallel.service import ServiceClient, ServiceError
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
    draft_incompatibility,
    export_incompatibility,
    latest_export_version,
    load_export,
)

#: default port one above the param service's 45800 block
DEFAULT_PORT = 45900
#: the DecodePolicy fields of a ``decode_opts`` dict (the rest go to
#: the DecodeReplica)
_POLICY_KEYS = ("max_pending", "max_new_cap", "submit_timeout_s",
                "eos_token", "speculate_k", "prefill_batch",
                "prefill_delay_ms")


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
    model is rebuilt from the export's meta.  Eval replicas warm up each
    batch bucket at :meth:`start`; decode replicas run the smallest
    program of each family they can reach at construction
    (``warmup``).  ``decode_opts``: the ``DecodePolicy`` fields and the
    ``DecodeReplica`` cache options (:func:`decode_opts_from_args`)."""

    def __init__(self, export_dir: str, replicas: int = 1,
                 policy: BatchPolicy | None = None, max_restarts: int = 2,
                 reload_poll_s: float = 1.0, decode: bool = False,
                 decode_opts: dict | None = None,
                 device: str | torch.device = "cuda"):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.device = resolve_device(device)
        self.export_dir = os.path.abspath(export_dir)
        self.policy = policy or BatchPolicy()
        self.reload_poll_s = float(reload_poll_s)
        self.decode = bool(decode)
        loaded = load_export(self.export_dir)
        self.model = build_model_from_meta(loaded.meta, self.device)
        self.version = loaded.version        # guarded_by: self._reload_lock
        self._meta = loaded.meta             # guarded_by: self._reload_lock
        self.draft_export_dir = None
        self.draft_version = None            # guarded_by: self._reload_lock
        self._draft_meta = None              # guarded_by: self._reload_lock
        if self.decode:
            if not loaded.meta.get("decode"):
                raise ValueError(
                    "decode mode needs a decode-capable export "
                    "(TransformerLM family; export_meta 'decode' is "
                    f"false/absent in {self.export_dir})")
            from theanompi_tpu_torch.decode import (
                DecodePolicy,
                DecodeReplica,
            )

            opts = dict(decode_opts or {})
            pol_kw = {k: opts.pop(k) for k in _POLICY_KEYS if k in opts}
            self.replicas = [
                DecodeReplica(i, self.export_dir, self.model, loaded,
                              policy=DecodePolicy(**pol_kw),
                              max_restarts=max_restarts, **opts)
                for i in range(int(replicas))
            ]
            self.draft_export_dir = (
                os.path.abspath(opts["draft_export_dir"])
                if opts.get("draft_export_dir") else None)
            r0 = self.replicas[0]
            self.draft_version = (r0.draft_session.version
                                  if r0.draft_session is not None else None)
            self._draft_meta = r0.draft_meta
            for r in self.replicas:
                r.warmup()
        else:
            self.replicas = [
                Replica(i, self.export_dir, self.policy, loaded,
                        self.model, max_restarts=max_restarts)
                for i in range(int(replicas))
            ]
            shape = tuple(loaded.meta.get("sample_shape")
                          or self.model.data.sample_shape)
            dtype = np.dtype(loaded.meta.get("sample_dtype") or np.float32)
            for r in self.replicas:
                # runs at start(), on the replica's collector thread;
                # the raw session, not run_batch: warmup skips the
                # serve_step fault site and the served-batch counter
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
        #: the same memory for the draft export's poll
        self._bad_draft_newest: int | None = None  # guarded_by: self._reload_lock
        self._bad_draft_reason: str | None = None  # guarded_by: self._reload_lock
        monitor.set_gauge("serving/model_version", self.version)
        monitor.set_gauge("serving/replicas", len(self.replicas))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "InferenceServer":
        """Start every replica (an eval replica warms up on its own
        thread first) and the reload watcher; a failed warmup stops what
        started."""
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

    def _route(self, fn_name: str, *args):
        """Round-robin one request over live replicas with overflow
        failover; :class:`Overloaded` only when every live replica
        rejects."""
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
                return getattr(r, fn_name)(*args)
            except Overloaded as e:
                last = e
        if not any_alive:
            raise Overloaded("no live replicas (all lost); the server "
                             "needs a restart or a good export")
        raise last if last is not None else Overloaded("rejected")

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Route one eval request (``(rows, *sample)``) to a live
        replica."""
        if self.decode:
            raise ValueError("this server runs decode mode; use the "
                             "'generate' op (InferenceClient.generate)")
        return self._route("submit", x)

    def generate(self, prompt: np.ndarray, max_new: int | None = None):
        """Route one token-generation request to a live decode replica;
        the generated token ids (int32), or a ``MigratedStream`` when
        the replica drained mid-stream."""
        if not self.decode:
            raise ValueError("this server runs eval mode; start it with "
                             "decode=True (launcher SERVE --decode) for "
                             "the generate op")
        out = self._route("generate", prompt, max_new)
        if not isinstance(out, (list, np.ndarray)):
            return out  # MigratedStream
        return np.asarray(out, np.int32)

    def generate_adopted(self, manifest: dict, k, v,
                         max_new: int | None = None):
        """Route one MIGRATED stream (pages + manifest) to a live decode
        replica, which adopts the pages and decodes from there; a
        geometry mismatch raises ``IncompatiblePages``."""
        if not self.decode:
            raise ValueError("this server runs eval mode; start it with "
                             "decode=True (launcher SERVE --decode) for "
                             "the adopt op")
        out = self._route("generate_adopted", manifest, k, v, max_new)
        if not isinstance(out, (list, np.ndarray)):
            return out  # MigratedStream
        return np.asarray(out, np.int32)

    def drain_migrate(self) -> int:
        """Scale-down hand-off: every decode replica stops admitting and
        exports its live streams as ``MigratedStream`` payloads at the
        next step boundary.  Returns the replicas told to drain."""
        if not self.decode:
            raise ValueError("drain_migrate is a decode-mode op")
        for r in self.replicas:
            r.drain_migrate()
        return len(self.replicas)

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

    def check_draft_reload(self) -> int | None:
        """One poll of the DRAFT export (speculative decoding): load and
        swap a newer compatible draft into every replica; returns the
        serving draft version (None when speculation is off).  A draft
        that no longer fits the live target or the live draft raises
        ``IncompatibleExport``, remembered like a refused target
        publish."""
        if not self.decode or self.draft_export_dir is None:
            return None
        with self._reload_lock:
            newest = latest_export_version(self.draft_export_dir)
            if newest is None or newest <= self.draft_version:
                return self.draft_version
            if newest == self._bad_draft_newest:
                if self._bad_draft_reason is not None:
                    raise IncompatibleExport(self._bad_draft_reason)
                return self.draft_version
            loaded = load_export(self.draft_export_dir)
            if loaded.version <= self.draft_version:
                self._bad_draft_newest = newest
                self._bad_draft_reason = None
                return self.draft_version
            reason = (draft_incompatibility(self._meta, loaded.meta)
                      or export_incompatibility(self._draft_meta,
                                                loaded.meta))
            if reason is not None:
                self._bad_draft_newest = newest
                self._bad_draft_reason = (
                    f"refusing draft hot reload v{self.draft_version} "
                    f"-> v{loaded.version}: {reason}")
                monitor.inc("serving/reload_refused_total")
                print(f"[serving] {self._bad_draft_reason}", flush=True)
                raise IncompatibleExport(self._bad_draft_reason)
            self._bad_draft_newest = None
            self._bad_draft_reason = None
            swapped = sum(1 for r in self.replicas
                          if r.swap_draft(loaded.version, loaded.state))
            if swapped == 0:
                print(f"[serving] draft v{loaded.version} published but "
                      "speculation is disabled on every replica (failed "
                      "draft restarts); not swapped — restart the server "
                      "to re-enable speculation", flush=True)
                return self.draft_version
            self._draft_meta = loaded.meta
            old, self.draft_version = self.draft_version, loaded.version
            monitor.inc("serving/reloads_total")
            print(f"[serving] draft hot reload v{old} -> "
                  f"v{self.draft_version} ({swapped}/{len(self.replicas)} "
                  "replicas speculating, in-flight streams kept)",
                  flush=True)
            return self.draft_version

    def _watch_reload(self) -> None:
        while not self._stop.wait(self.reload_poll_s):
            for check in (self.check_reload, self.check_draft_reload):
                try:
                    check()
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
            draft_version = self.draft_version
        out = {
            "version": version,
            "decode": self.decode,
            "replicas": reps,
            "overloaded": sum(r.get("overloaded", 0) for r in reps),
            "live_replicas": sum(1 for r in self.replicas if r.alive),
        }
        if self.decode:
            drafted = sum((r.get("speculation") or {})
                          .get("draft_tokens", 0) for r in reps)
            accepted = sum((r.get("speculation") or {})
                           .get("accepted_draft_tokens", 0) for r in reps)
            out.update(
                tokens=sum(r.get("tokens", 0) for r in reps),
                steps=sum(r.get("steps", 0) for r in reps),
                shared_steps=sum(r.get("shared_steps", 0) for r in reps),
                max_concurrent=max((r.get("max_concurrent", 0)
                                    for r in reps), default=0),
                draft_version=draft_version,
                draft_tokens=drafted,
                accepted_draft_tokens=accepted,
                accept_rate=accepted / drafted if drafted else None,
                prefix_cache_hits=sum(
                    (r.get("prefix_cache") or {}).get("hits", 0)
                    for r in reps),
            )
        else:
            out.update(
                batches=sum(r.get("batches", 0) for r in reps),
                rows=sum(r.get("rows", 0) for r in reps),
                max_occupancy=max((r.get("max_occupancy", 0)
                                   for r in reps), default=0),
            )
        return out

    # -- wire dispatch -------------------------------------------------

    def rpc_max_workers(self) -> int:
        """Executor width for the RPC substrate: every admissible
        request (bounded queues + one executing batch per replica) can
        block in a handler at once, plus slack for O(1) rejections."""
        n = len(self.replicas)
        if self.decode:
            per = max(r.batcher.policy.max_pending
                      + r.session.cfg.max_seqs for r in self.replicas)
        else:
            per = self.policy.max_queue + self.policy.max_batch
        return n * per + 8

    @staticmethod
    def _wire_tokens(out):
        """Wire encoding of a generate/adopt result: a token array, or a
        drained stream as ``("migrated", tokens, manifest, pages)``."""
        if isinstance(out, np.ndarray):
            return out
        return ("migrated", [int(t) for t in out.tokens], out.manifest,
                wire_pages(out.k, out.v))

    def handle(self, op: str, *args):
        if op == "infer":
            (x,) = args
            x = np.asarray(x)
            # a wire buffer is read-only; the batcher may hand it on
            return self.submit(x if x.flags.writeable else x.copy())
        if op == "generate":
            prompt, max_new = args
            return self._wire_tokens(
                self.generate(np.asarray(prompt, np.int32),
                              None if max_new is None else int(max_new)))
        if op == "adopt":
            manifest, pages, max_new = args
            k, v = pages
            return self._wire_tokens(
                self.generate_adopted(manifest, k, v,
                                      None if max_new is None
                                      else int(max_new)))
        if op == "drain":
            return self.drain_migrate()
        if op == "stats":
            return self.stats()
        if op == "reload":
            # target first, then the draft poll; either refusal raises
            # the typed IncompatibleExport
            version = self.check_reload()
            self.check_draft_reload()
            return version
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


def wire_pages(k, v):
    """KV pages for the wire: one ``RawArrays`` frame pair (no
    compression, no wire-dtype re-encode) for f32 pages; bf16 pages as
    CPU bf16 tensors (numpy has no bfloat16)."""
    if isinstance(k, torch.Tensor) and k.dtype == torch.bfloat16:
        return (k.cpu(), v.cpu())
    return wire.RawArrays(*(np.ascontiguousarray(
        a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
        for a in (k, v)))


class _ServingRpcHooks(rpc.RpcHooks):
    """The inference plane's seams into the RPC substrate: the
    ``serving/*`` series and the ``serve_rpc`` fault site ('raise'
    rejects this RPC with a typed err the client sees, 'delay' adds
    latency; the server stays live)."""

    plane = "serving"

    def on_connect(self) -> None:
        monitor.add_gauge("serving/clients", 1.0)

    def on_disconnect(self) -> None:
        monitor.add_gauge("serving/clients", -1.0)

    def on_request(self, op: str, ms: float) -> None:
        monitor.inc("serving/requests_total", op=op)
        monitor.observe("serving/rpc_ms", ms, op=op)
        monitor.progress(phase="serving")

    def on_error(self, op: str) -> None:
        monitor.inc("serving/errors_total", op=op)

    def on_negotiate(self, opts) -> None:
        monitor.inc("serving/wire_negotiations_total",
                    compression=opts.compression, dtype=opts.dtype)

    def fire(self, op: str) -> None:
        faults.fire("serve_rpc", op=op)


def serve(server: InferenceServer, host: str = "0.0.0.0",
          port: int = DEFAULT_PORT,
          ready_event: threading.Event | None = None,
          stop_event: threading.Event | None = None,
          authkey: bytes | None = None) -> None:
    """The RPC substrate over ``server`` until a ``shutdown`` op or
    ``stop_event``.  The executor pool is sized by the plane's own
    admission bound (:meth:`InferenceServer.rpc_max_workers`).
    ``authkey=None`` reads ``THEANOMPI_TPU_SERVICE_KEY`` (generating and
    printing one when unset)."""
    from theanompi_tpu_torch.parallel.service import _authkey

    if authkey is None:
        authkey = _authkey(generate=True)
    rpc.serve(server, host, port, ready_event=ready_event,
              stop_event=stop_event, authkey=authkey,
              hooks=_ServingRpcHooks(),
              max_workers=server.rpc_max_workers())


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class InferenceClient(ServiceClient):
    """Wire client: transport failures reconnect with backoff (``infer``
    and greedy ``generate`` are pure, so at-least-once is safe);
    server-side errors fail fast, ``Overloaded``,
    ``IncompatibleExport`` and ``IncompatiblePages`` re-raised as their
    own types."""

    _TYPED = (Overloaded, IncompatibleExport, IncompatiblePages)

    def _typed_call(self, op: str, *args):
        try:
            return self.call(op, *args)
        except ServiceError as e:
            for cls in self._TYPED:
                if cls.__name__ in str(e):
                    raise cls(str(e)) from None
            raise

    def infer(self, x) -> np.ndarray:
        return self._typed_call("infer", np.asarray(x))

    @staticmethod
    def _unwire_tokens(out):
        """Token ids, or a drained stream's ``MigratedStream``."""
        if (isinstance(out, tuple) and len(out) == 4
                and out[0] == "migrated"):
            from theanompi_tpu_torch.decode.scheduler import MigratedStream

            _, tokens, manifest, pages = out
            k, v = pages
            return MigratedStream([int(t) for t in tokens], manifest, k, v)
        return np.asarray(out, np.int32)

    def generate(self, prompt, max_new: int | None = None):
        """Greedy-decode up to ``max_new`` tokens after ``prompt`` on a
        decode-mode server: the token ids (int32), or a
        ``MigratedStream`` when the replica drained mid-stream."""
        return self._unwire_tokens(self._typed_call(
            "generate", np.asarray(prompt, np.int32),
            None if max_new is None else int(max_new)))

    def adopt(self, manifest: dict, k, v, max_new: int | None = None):
        """Ship one migrated stream (manifest + KV pages, byte-exact) to
        a decode-mode server; its token ids, first token included."""
        return self._unwire_tokens(self._typed_call(
            "adopt", manifest, wire_pages(k, v),
            None if max_new is None else int(max_new)))

    def drain_migrate(self) -> int:
        """Tell a decode server to drain (scale-down hand-off)."""
        return int(self.call("drain"))

    def stats(self) -> dict:
        return self.call("stats")

    def reload(self) -> int:
        """Force an export-dir poll; the serving version after it.  A
        refused publish re-raises ``IncompatibleExport``."""
        return int(self._typed_call("reload"))

    def shutdown(self) -> None:
        self.call("shutdown")


# ---------------------------------------------------------------------------
# Entry point (the launcher's SERVE rule lands here)
# ---------------------------------------------------------------------------


def add_decode_args(ap: argparse.ArgumentParser) -> None:
    """The ``--decode`` options, shared by this module's CLI and the
    launcher's SERVE rule."""
    ap.add_argument("--decode", action="store_true",
                    help="autoregressive mode: paged KV cache + "
                         "continuous batching over a TransformerLM "
                         "export; serves the 'generate' op")
    ap.add_argument("--decode-page-size", type=int, default=16,
                    help="tokens per KV-cache page")
    ap.add_argument("--decode-pages-per-seq", type=int, default=8,
                    help="pages per live sequence (page_size x "
                         "pages_per_seq is the attention window)")
    ap.add_argument("--decode-max-seqs", type=int, default=8,
                    help="max concurrently-decoding sequences per replica")
    ap.add_argument("--decode-max-pending", type=int, default=32,
                    help="admission bound: pending prompts beyond it are "
                         "rejected with Overloaded")
    ap.add_argument("--decode-prefill-buckets", default=None,
                    metavar="N,N,...",
                    help="padded prompt-length buckets (default powers "
                         "of two up to min(512, max_len))")
    ap.add_argument("--decode-draft-export-dir", default=None,
                    metavar="DIR",
                    help="speculative decoding: a small decode-capable "
                         "export proposing tokens the target verifies k "
                         "at a time (dims may differ, vocab must match)")
    ap.add_argument("--decode-speculate-k", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--decode-no-prefix-cache", action="store_true",
                    help="disable the cross-request prefix cache")
    ap.add_argument("--decode-prefill-batch", type=int, default=8,
                    help="max prompts in ONE batched prefill per "
                         "admission round (1 = serial prefill)")
    ap.add_argument("--decode-prefill-delay-ms", type=float, default=2.0,
                    help="how long the oldest pending prompt may wait for "
                         "batch company")
    ap.add_argument("--decode-fleet-cache", default=None,
                    metavar="HOST:PORT",
                    help="fleet-wide prefix cache authority (a "
                         "prefill server's port): local prefix-cache "
                         "misses consult it, cold prefills register "
                         "their page-aligned prefixes — docs/"
                         "SERVING.md 'Fleet prefix cache'")


def decode_opts_from_args(args) -> dict | None:
    """The ``--decode*`` options -> ``InferenceServer(decode_opts=...)``;
    one translation for the launcher and this module's CLI."""
    if not args.decode:
        return None
    opts = {
        "page_size": args.decode_page_size,
        "pages_per_seq": args.decode_pages_per_seq,
        "max_seqs": args.decode_max_seqs,
        "max_pending": args.decode_max_pending,
        "prefix_cache": not args.decode_no_prefix_cache,
        "prefill_batch": args.decode_prefill_batch,
        "prefill_delay_ms": args.decode_prefill_delay_ms,
    }
    if args.decode_fleet_cache:
        opts["fleet_cache"] = args.decode_fleet_cache
    if args.decode_prefill_buckets:
        opts["prefill_buckets"] = tuple(
            int(b) for b in args.decode_prefill_buckets.split(","))
    if args.decode_draft_export_dir:
        opts["draft_export_dir"] = args.decode_draft_export_dir
        opts["speculate_k"] = args.decode_speculate_k
    return opts


def serve_main(export_dir: str, host: str = "0.0.0.0",
               port: int = DEFAULT_PORT, replicas: int = 1,
               max_batch: int = 8, max_delay_ms: float = 5.0,
               buckets: tuple[int, ...] | None = None,
               max_queue: int = 32, max_restarts: int = 2,
               reload_poll_s: float = 1.0, decode: bool = False,
               decode_opts: dict | None = None,
               device: str = "cuda") -> int:
    """Build, start and serve an :class:`InferenceServer` until a
    ``shutdown`` op; telemetry under ``THEANOMPI_TPU_MONITOR`` in files
    named ``serve<pid>``."""
    policy = BatchPolicy(max_batch=max_batch, max_delay_ms=max_delay_ms,
                         buckets=buckets, max_queue=max_queue)
    with monitor.session(stall_after=float("inf"),
                         name=f"serve{os.getpid()}"):
        monitor.progress(phase="serving")
        server = InferenceServer(
            export_dir, replicas=replicas, policy=policy,
            max_restarts=max_restarts, reload_poll_s=reload_poll_s,
            decode=decode, decode_opts=decode_opts, device=device)
        server.start()
        if decode:
            r0 = server.replicas[0]
            s0 = r0.session
            spec = ("off" if r0.draft_session is None else
                    f"k={r0.batcher.policy.speculate_k} "
                    f"draft=v{r0.draft_session.version}")
            print(f"[serving] DECODE v{server.version} x{replicas} "
                  f"replicas on {host}:{port} (window={s0.window}, "
                  f"page_size={s0.cfg.page_size}, "
                  f"max_seqs={s0.cfg.max_seqs}, "
                  f"prefill_buckets={s0.prefill_buckets}, "
                  f"speculation={spec}, prefix_cache="
                  f"{'on' if s0.prefix_cache is not None else 'off'}, "
                  f"device={server.device})", flush=True)
        else:
            print(f"[serving] v{server.version} x{replicas} replicas on "
                  f"{host}:{port} (max_batch={max_batch}, "
                  f"max_delay={max_delay_ms}ms, "
                  f"buckets={server.policy.resolved_buckets()}, "
                  f"max_queue={max_queue}, device={server.device})",
                  flush=True)
        try:
            serve(server, host, port)
        finally:
            server.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.serving.server",
        description="dynamic-batching inference server (PyTorch port)")
    ap.add_argument("--export-dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated padded batch sizes "
                         "(default: powers of two up to max-batch)")
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--reload-poll-s", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    add_decode_args(ap)
    _kernels.add_cache_dir_option(ap)
    args = ap.parse_args(argv)
    _kernels.apply_cache_dir_option(args)
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    return serve_main(args.export_dir, args.host, args.port,
                      replicas=args.replicas, max_batch=args.max_batch,
                      max_delay_ms=args.max_delay_ms, buckets=buckets,
                      max_queue=args.max_queue,
                      max_restarts=args.max_restarts,
                      reload_poll_s=args.reload_poll_s,
                      decode=args.decode,
                      decode_opts=decode_opts_from_args(args),
                      device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
