"""Asynchronous training rules: EASGD, ASGD, GOSGD, in one process.

Counterpart of ``theanompi_tpu/rules/async_rules.py``:

* EASGD (Zhang et al.): a store holds the *center* parameters; each
  worker trains ``tau`` iterations, then makes an elastic exchange
  (worker -= a (worker - center); center += a (worker - center)), and a
  final one after its last epoch.  An orchestrator thread validates and
  checkpoints the center on worker 0's epochs, on a model of its own
  (worker 0's is being trained meanwhile).
* ASGD: a parameter server: workers push gradients, the server's
  optimizer applies them and returns the fresh center.  Rank 0 forwards
  the LR schedule to the server at the end of its epochs and
  checkpoints the server's center and optimizer state.
* GOSGD (Blot et al.): no store of parameters; each worker keeps
  (params, weight) and, with probability ``p_push`` an iteration, halves
  its weight and pushes (a copy of its params, weight/2) to a peer drawn
  from ``np.random.default_rng(seed + 31 * rank)``; the peer merges by
  weighted average (and, with ``merge_momentum='scale'``, scales its
  first moments by its share).  Per-worker npz/json sidecars beside the
  checkpoint let a resume restore every worker; the weights are
  renormalized to sum to 1.  At the end the hub is drained and the
  weighted consensus validated.

One worker thread per entry of the device list (``init(devices=...,
device=...)``, ``rules.base.resolve_devices``), each with a model of its
own on its device, training on its shard of every epoch
(``shard_rank``/``shard_size``), on a CUDA stream of its own; several
workers may share a card.  The stores are in-process
(``parallel/server.py``) unless ``server_addr`` names a parameter service
(``parallel/service.py``; each worker then holds a connection of its own)
or, comma-separated, a shard fleet (``parallel/shards.py``);
``session_id`` scopes the service's store (default: a fresh id per
session; hosts of one session pass the same).  GOSGD's
``n_total_workers``/``rank_offset`` place this process's workers in the
global rank space of a hub several processes share.
``local_aggregation=True`` (EASGD, ASGD) sends one aggregate exchange a
period for all of this process's workers (``parallel/aggregate.py``).
``overlap=True`` runs each EASGD/ASGD worker's exchange on a pipe thread
(``parallel/pipe.py``) while it computes on.  A BSP checkpoint seeds any
async rule, and an EASGD center checkpoint resumes under BSP (the
payloads are the canonical ones).

Failure is fail-fast by default: a worker's exception aborts the
session and ``wait()`` raises it.  ``max_restarts > 0`` supervises the
workers (``resilience/supervisor.py``): a failed EASGD/ASGD worker
restarts from the center, at the epoch it died in; a failed GOSGD
worker is deactivated in the hub; the session aborts when fewer than
``min_workers`` are left.

A session can also be built without threads: ``prepare(...)`` makes the
models, the store and the workers, and a caller drives each worker's
``open``/``step``/``end_epoch``/``finish``/``close`` in an order of its
choosing (a deterministic schedule), then ``close()``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import threading
import time
import uuid

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.models.base import TorchModel
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.parallel.aggregate import (
    AggregatedExchange,
    LocalAggregator,
)
from theanompi_tpu_torch.parallel.exchanger import (
    easgd_apply_delta,
    gosgd_merge,
    gosgd_scale_momentum,
)
from theanompi_tpu_torch.parallel.pipe import _ExchangePipe
from theanompi_tpu_torch.parallel.server import (
    ASGDServer,
    EASGDServer,
    GossipHub,
    publish,
    receive,
)
from theanompi_tpu_torch.parallel.service import (
    RemoteASGD,
    RemoteEASGD,
    RemoteGossipHub,
    ServiceClient,
    ShardedServiceClient,
)
from theanompi_tpu_torch.parallel.shards import (
    ShardedASGD,
    ShardedEASGD,
    shard_addresses,
)
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.resilience.supervisor import WorkerSupervisor
from theanompi_tpu_torch.rules.base import (
    Rule,
    resolve_devices,
    resolve_model_class,
)
from theanompi_tpu_torch.utils.checkpoint import Checkpointer
from theanompi_tpu_torch.utils.recorder import Recorder


def _is_client(obj) -> bool:
    """A connection to a parameter service (owned, closed by its owner)."""
    return isinstance(obj, (ServiceClient, ShardedServiceClient,
                            AggregatedExchange))


def _prune_gosgd_sidecars(sidecar_dir: str, kept: set[int]) -> None:
    """Drop the per-worker npz and the meta json of epochs the
    checkpointer pruned (``max_to_keep``): otherwise a long GOSGD run
    keeps a full parameter set per worker per epoch."""
    for path in (glob.glob(os.path.join(sidecar_dir, "gosgd_w*_*.npz"))
                 + glob.glob(os.path.join(sidecar_dir, "gosgd_meta_*.json"))):
        m = re.search(r"_(\d+)\.(?:npz|json)$", path)
        if m and int(m.group(1)) not in kept:
            try:
                os.unlink(path)
            except OSError:
                pass


def _on_stream(device: torch.device, stream):
    """Context: ``device`` current and ``stream`` its current stream
    (nothing on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def _params(model: TorchModel) -> list[torch.Tensor]:
    return list(model.module.parameters())


def _assign(dst, src) -> None:
    """Copy ``src`` into ``dst`` in place (lists, or dicts by key)."""
    with torch.no_grad():
        if isinstance(src, dict):
            for name, t in src.items():
                dst[name].copy_(t)
        else:
            for d, s in zip(dst, src, strict=True):
                d.copy_(s)


def _load_params(model: TorchModel, params: dict) -> None:
    """A checkpoint payload's ``params`` (name -> tensor) into ``model``."""
    _assign(dict(model.module.named_parameters()), params)


class _Worker:
    """One worker: its model, recorder and stream, and the loop a session
    thread runs (:meth:`run`), one iteration at a time (:meth:`step`)."""

    rule = ""

    def __init__(self, session: "_AsyncRule", rank: int):
        self.s = session
        self.rank = rank
        self.model = session.models[rank]
        self.recorder = session.recorders[rank]
        dev = self.model.device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.pipe: _ExchangePipe | None = None
        self.pipe_stream = None
        #: this worker's store handle while it runs (:meth:`open`): the
        #: session's in-process store, a connection of its own to the
        #: service, or its port on the local aggregator
        self.srv = None
        # outlives one run(): a supervised restart resumes at the epoch
        # the worker died in (re-running finished epochs would retrain
        # them, and ASGD's rank 0 would push an early LR to the server)
        self.progress = {"epoch": session.start_epoch}
        self.it_total = 0
        #: iterations over every life of this worker
        self.iterations = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return _params(self.model)

    def on_stream(self):
        return _on_stream(self.model.device, self.stream)

    def sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def adopt(self, params) -> None:
        """Copy ``params`` into this worker's parameters (a supervised
        restart from the center), on its stream."""
        with self.on_stream():
            _assign(self.params, params)
            self.sync()

    def run(self, abort: threading.Event) -> None:
        """The worker thread's body: every epoch from where it stands,
        then the rule's final exchange."""
        with self.on_stream():
            try:
                self.open()
                for epoch in range(self.progress["epoch"], self.s.n_epochs):
                    self.progress["epoch"] = epoch
                    n_iters = self.model.begin_epoch(epoch)
                    for it in range(n_iters):
                        if abort.is_set():
                            return
                        self.step(it)
                    self.end_epoch(epoch)
                self.finish()
            finally:
                try:
                    self.close()
                finally:
                    self.sync()

    def step(self, it: int) -> None:
        """One iteration: the fault site, the rule's work, the step-time
        observation (whose straggler flag the supervisor consumes)."""
        faults.fire("worker_step", rule=self.rule, worker=self.rank,
                    step=self.it_total)
        t0 = time.monotonic()
        self.iteration(it)
        self.it_total += 1
        self.iterations += 1
        flagged = monitor.observe_step(time.monotonic() - t0, phase="train",
                                       step=self.it_total, worker=self.rank)
        if self.s.sup is not None:
            self.s.sup.note_straggler(self.rank, flagged)

    def open(self) -> None:
        self.model.compile_iter_fns("avg")
        self.it_total = 0
        self._open_store()

    def _open_store(self) -> None:
        s = self.s
        if s.aggregator is not None:
            self.srv = AggregatedExchange(s.aggregator, self.rank,
                                          s.connect)
        else:
            self.srv = s.connect()

    def _close_store(self) -> None:
        srv, self.srv = self.srv, None
        if _is_client(srv) and srv is not self.s.server:
            srv.close()

    def _open_pipe(self, fn, name: str) -> None:
        """The overlap pipe and the side stream its thread launches on."""
        if self.stream is not None and self.pipe_stream is None:
            self.pipe_stream = torch.cuda.Stream(self.model.device)
        self.pipe = _ExchangePipe(fn, name, self.rank)

    def iteration(self, it: int) -> None:
        raise NotImplementedError

    def end_epoch(self, epoch: int) -> None:
        self.model._flush_metrics(self.recorder)
        self.model.adjust_hyperp(epoch + 1)

    def finish(self) -> None:
        pass

    def close(self) -> None:
        try:
            if self.pipe is not None:
                self.pipe.close()
            self.model.cleanup()
        finally:
            self._close_store()


class _AsyncRule(Rule):
    """Shared scaffolding: N worker threads, one model per device entry."""

    name = "async"

    def init(self, devices=None,
             modelfile: str = "theanompi_tpu_torch.models.cifar10",
             modelclass: str = "Cifar10_model", config=None,
             resume: bool = False, sync_type: str = "avg",
             device: str | torch.device = "cuda", **kwargs) -> "_AsyncRule":
        """Start the session on a background thread over the workers'
        ``devices`` (``resolve_devices(devices, device)``); ``kwargs`` are
        the rule's options, then the model constructor's."""
        devs = resolve_devices(devices, device, self.uses_global_mesh)
        self._start(devs, modelfile, modelclass, config, resume, sync_type,
                    **kwargs)
        return self

    def prepare(self, devices=None,
                modelfile: str = "theanompi_tpu_torch.models.cifar10",
                modelclass: str = "Cifar10_model", config=None,
                resume: bool = False, device: str | torch.device = "cuda",
                **kwargs) -> "_AsyncRule":
        """Build the session (models, store, workers) on this thread and
        start nothing: the caller drives ``self.workers`` (module
        docstring) and calls :meth:`close`."""
        self._prepare(resolve_devices(devices, device, self.uses_global_mesh),
                      modelfile, modelclass, config, resume, **kwargs)
        return self

    def _session(self, devs, modelfile, modelclass, config, resume,
                 sync_type, **kwargs):
        self._prepare(devs, modelfile, modelclass, config, resume, **kwargs)
        try:
            counts = _kernels.launch_counts()
            self._run()
            after = _kernels.launch_counts()
            self.result.update(
                iterations=sum(w.iterations for w in self.workers),
                train_s=self.train_s, val_batches=self.val_batches,
                launches={k: after[k] - counts.get(k, 0) for k in after})
            if self.sup is not None:
                self.result["restarts"] = self.sup.restart_counts()
                self.result["lost_workers"] = self.sup.lost_workers()
        finally:
            self.close()

    def close(self) -> None:
        """Stop every worker's threads, close the checkpointer and the
        session's own connection to a parameter service."""
        try:
            for w in getattr(self, "workers", ()):
                w.close()
        finally:
            try:
                if getattr(self, "ckpt", None) is not None:
                    self.ckpt.close()
            finally:
                store = getattr(self, "server", None)
                if _is_client(store):
                    store.close()

    # -- building ------------------------------------------------------------

    def _remote(self, server_addr, session_id) -> bool:
        """Parse ``server_addr`` (one address, or a comma-separated shard
        fleet) and the session id; True when the store is remote."""
        self.addrs = shard_addresses(server_addr)
        self.sharded = self.addrs is not None and len(self.addrs) > 1
        self.session_id = session_id or uuid.uuid4().hex
        self.aggregator = None
        return self.addrs is not None

    def _aggregate(self, kind: str, alpha: float | None = None) -> None:
        """The local aggregator over the session's store, every worker
        registered before any thread starts (JAX's wiring)."""
        self.aggregator = LocalAggregator(kind, self.server, alpha=alpha)
        for i in range(len(self.models)):
            self.aggregator.register(i)

    def _aggregate_result(self) -> dict:
        if self.aggregator is None:
            return {}
        return {"aggregate": self.aggregator.counts()}

    def _build_workers(self, devs, modelfile, modelclass, config,
                       **kwargs) -> list[TorchModel]:
        cls = resolve_model_class(modelfile, modelclass)
        cfg = config if config is not None else cls.default_config()
        if cfg.steps_per_call > 1:
            raise ValueError(
                "steps_per_call>1 (the scanned multi-step program) is a "
                "BSP feature; the async rules exchange/gossip BETWEEN "
                "iterations, which a fused k-step program would skip")
        if cfg.grad_accum_steps > 1:
            raise ValueError(
                "grad_accum_steps>1 is a BSP feature; the async rules' "
                "exchange cadence is per-iteration")
        if cfg.zero_sharding:
            raise ValueError(
                "zero_sharding is a BSP feature; async workers own "
                "1-device meshes where a data-axis shard is the whole "
                "state (no memory win, silently misleading)")
        if cfg.fsdp_sharding:
            raise ValueError(
                "fsdp_sharding is a BSP feature; an async worker is one "
                "device, whose shard is the whole state, and the stores "
                "read the worker's parameters between steps")
        models = []
        for i, dev in enumerate(devs):
            models.append(cls(config=config, device=dev, shard_rank=i,
                              shard_size=len(devs), **kwargs))
            # the workers share worker 0's dataset: iterators are made
            # per epoch and the source arrays/files are read-only
            kwargs.setdefault("data", models[0].data)
        self._model_args = (cls, config, kwargs)
        if any(d.type == "cuda" for d in devs):
            _kernels.bind_all()
        return models

    def _setup(self, devs, modelfile, modelclass, config, resume,
               checkpoint: bool, max_epochs, **kwargs) -> dict | None:
        """Models, recorders, checkpointer and the epochs to run; returns
        the restored payload (None: nothing to resume), the start epoch
        set from it.  The rule loads the payload and fast-forwards the
        LR schedule (:meth:`_fast_forward`)."""
        self.devices = list(devs)
        self.models = self._build_workers(devs, modelfile, modelclass,
                                          config, **kwargs)
        self.model = self.models[0]
        cfg = self.model.config
        self.recorders = [Recorder(rank=i, size=len(devs),
                                   print_freq=cfg.print_freq,
                                   flops_per_sample=m.train_flops_per_sample)
                          for i, m in enumerate(self.models)]
        self.ckpt_dir = os.path.join(cfg.snapshot_dir, self.model.name)
        self.ckpt = Checkpointer(self.ckpt_dir) if checkpoint else None
        self.start_epoch = 0
        self.val_batches = 0
        self.sup: WorkerSupervisor | None = None
        payload = None
        if resume:
            if self.ckpt is None:
                raise ValueError("resume=True requires checkpoint=True")
            self.restored_epoch, payload = self.ckpt.restore_latest_verified()
            if payload is not None:
                self.start_epoch = int(payload["epoch"]) + 1
        self.n_epochs = (cfg.n_epochs if max_epochs is None
                         else min(cfg.n_epochs, self.start_epoch + max_epochs))
        return payload

    def _fast_forward(self) -> float | None:
        """Every worker's LR schedule at the start epoch; returns its LR."""
        lr = None
        for m in self.models:
            lr = m.adjust_hyperp(self.start_epoch)
        return lr

    def _restart_from_center(self, rank: int) -> None:
        self.workers[rank].adopt(self.server.get_center())

    def connect(self):
        """A store handle for one worker: the in-process store itself, or
        a connection of its own that JOINS the session (no parameters
        re-shipped; reading a worker's parameters from another thread
        would race its step)."""
        return self.server

    def _supervise(self, max_restarts: int, min_workers: int) -> None:
        """Supervised restarts from the center (``max_restarts > 0``)."""
        if max_restarts > 0:
            self.sup = WorkerSupervisor(
                n_workers=len(self.models), max_restarts=max_restarts,
                min_workers=min_workers,
                restart_from=self._restart_from_center, name=self.name)

    # -- running -------------------------------------------------------------

    def _run_worker_threads(self, targets, extra=()) -> None:
        """Run the worker targets (and ``extra`` ones, EASGD's
        orchestrator), each given the shared abort event.  Without a
        supervisor the first failure aborts the others and is raised once
        every thread has ended.  ``train_s``: the seconds until the last
        thread ended."""
        t0 = time.monotonic()
        try:
            self._join_threads(targets, extra)
        finally:
            self.train_s = time.monotonic() - t0

    def _join_threads(self, targets, extra) -> None:
        if self.sup is not None:
            self.sup.run(targets, extra=extra)
            return
        errors: list[BaseException] = []
        abort = threading.Event()

        def wrap(fn, i):
            def run():
                try:
                    fn(abort)
                except BaseException as e:
                    errors.append(e)
                    abort.set()
            return threading.Thread(target=run, daemon=True,
                                    name=f"{self.name}-worker{i}")

        threads = [wrap(fn, i)
                   for i, fn in enumerate(list(targets) + list(extra))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _validate(self, params) -> dict:
        """Validate ``params`` on worker 0's model (its thread has ended)."""
        probe = self.models[0]
        probe.compile_iter_fns("avg")
        _assign(_params(probe), params)
        val = probe.val_epoch(self.recorders[0])
        self.val_batches += probe.val_batches_run
        return val

    def _prepare(self, devs, modelfile, modelclass, config, resume,
                 **kwargs):
        raise NotImplementedError

    def _run(self) -> None:
        raise NotImplementedError


# -- EASGD ------------------------------------------------------------------


class _EASGDWorker(_Worker):
    rule = "easgd"

    def open(self) -> None:
        super().open()
        if self.s.overlap:
            self._open_pipe(self._exchange_on_pipe, "easgd/exchange")

    def iteration(self, it: int) -> None:
        if self.it_total % self.s.tau == 0:
            self.recorder.start()
            if self.pipe is None:
                with monitor.span("easgd/exchange", worker=str(self.rank)):
                    new = self.srv.exchange(self.params)
                _assign(self.params, new)
            else:
                if self.pipe.busy():
                    self._collect_and_correct()
                # a copy: the next train step updates the parameters in
                # place while the exchange overlaps the next tau
                # iterations
                snap = [p.detach().clone() for p in self.params]
                self.pipe.submit((snap, publish(snap)))
            self.recorder.end("comm")
        with monitor.span("easgd/compute", worker=str(self.rank)):
            self.model.train_iter(it, self.recorder)

    def _exchange_on_pipe(self, payload):
        snap, ready = payload
        with _on_stream(self.model.device, self.pipe_stream):
            receive(snap, ready)
            new = self.srv.exchange(snap)
            return new, publish(new)

    def _collect_and_correct(self) -> None:
        """Apply the finished exchange's elastic force to the parameters
        the worker holds now (one period late)."""
        with monitor.span("easgd/exchange_collect", worker=str(self.rank)):
            (snap, _), (returned, ready) = self.pipe.collect()
        receive(returned, ready)
        _assign(self.params, easgd_apply_delta(self.params, snap, returned))

    def end_epoch(self, epoch: int) -> None:
        super().end_epoch(epoch)
        if self.rank == 0:
            self.s.epoch_done.release()

    def finish(self) -> None:
        if self.pipe is not None and self.pipe.busy():
            self._collect_and_correct()
        # the final elastic sync: the worker ends near the center
        _assign(self.params, self.srv.exchange(self.params))


class EASGD(_AsyncRule):
    """Elastic-averaging SGD (module docstring)."""

    name = "EASGD"

    def _prepare(self, devs, modelfile, modelclass, config, resume,
                 tau: int = 10, alpha: float = 0.5,
                 max_epochs: int | None = None, checkpoint: bool = True,
                 server_addr: str | None = None,
                 session_id: str | None = None, overlap: bool = False,
                 local_aggregation: bool = False, max_restarts: int = 0,
                 min_workers: int = 1, **kwargs):
        remote = self._remote(server_addr, session_id)
        if local_aggregation:
            if len(devs) * alpha > 1.0 + 1e-9:
                raise ValueError(
                    f"local_aggregation composes the period's elastic "
                    f"moves against ONE center version, so the center "
                    f"coefficient is n*alpha = {len(devs)}*{alpha} "
                    f"= {len(devs) * alpha:g} > 1 — the center "
                    "overshoots the worker mean every period and "
                    "oscillates/diverges.  Lower --alpha to <= "
                    f"1/{len(devs)} (the EASGD paper's beta = "
                    "N*alpha parameterization)")
        if tau < 1:
            raise ValueError(f"tau must be >= 1, got {tau}")
        self.tau, self.alpha, self.overlap = tau, alpha, overlap
        payload = self._setup(devs, modelfile, modelclass, config, resume,
                              checkpoint, max_epochs, **kwargs)
        if payload is not None:
            for m in self.models:
                _load_params(m, payload["params"])
            self._fast_forward()
        init = _params(self.models[0])
        if not remote:
            self.server = EASGDServer(init, alpha=alpha)
        elif self.sharded:
            # the session creator ships the initial center from this
            # thread, before any worker's step changes it
            self.server = ShardedEASGD(self.addrs, init, alpha=alpha,
                                       session_id=self.session_id)
        else:
            self.server = RemoteEASGD(self.addrs[0], init, alpha=alpha,
                                      session_id=self.session_id)
        if local_aggregation:
            self._aggregate("easgd", alpha)
        self._supervise(max_restarts, min_workers)
        self.epoch_done = threading.Semaphore(0)
        # validation owns a model of its own: worker 0's is being
        # trained by its thread meanwhile
        cls, cfg, model_kwargs = self._model_args
        self.val_model = cls(config=cfg, device=devs[0], **model_kwargs)
        self.val_model.compile_iter_fns("avg")
        self.val_recorder = Recorder(
            rank=0, size=len(devs), print_freq=self.model.config.print_freq,
            flops_per_sample=self.model.train_flops_per_sample)
        self._val_stream = (torch.cuda.Stream(devs[0])
                            if devs[0].type == "cuda" else None)
        self.val_results: list[dict] = []
        self.workers = [_EASGDWorker(self, i) for i in range(len(devs))]

    def connect(self):
        if self.addrs is None:
            return self.server
        if self.sharded:
            return ShardedEASGD(self.addrs, None, alpha=self.alpha,
                                session_id=self.session_id)
        return RemoteEASGD(self.addrs[0], None, alpha=self.alpha,
                           session_id=self.session_id)

    def _orchestrate(self, abort: threading.Event) -> None:
        """Validate (and checkpoint) the center after each of worker 0's
        epochs."""
        with _on_stream(self.val_model.device, self._val_stream):
            try:
                for epoch in range(self.start_epoch, self.n_epochs):
                    while not self.epoch_done.acquire(timeout=0.5):
                        if abort.is_set():
                            return
                        if self.sup is not None and self.sup.is_lost(0):
                            # worker 0 drives this cadence; lost, it
                            # releases no more epochs
                            return
                    self._validate_center(epoch)
            finally:
                if self._val_stream is not None:
                    self._val_stream.synchronize()

    def _validate_center(self, epoch: int) -> dict:
        """Validate the center on the validation model, checkpoint it, and
        close the epoch's record."""
        _assign(_params(self.val_model), self.server.get_center())
        val = self.val_model.val_epoch(self.val_recorder)
        self.val_results.append(val)
        self.val_batches += self.val_model.val_batches_run
        if self.ckpt is not None:
            self.ckpt.save(epoch, self.val_model.checkpoint_payload(epoch))
        self.val_recorder.epoch_summary(epoch, val.get("loss"),
                                        val.get("error"))
        return val

    def _run(self) -> None:
        self._run_worker_threads([w.run for w in self.workers],
                                 extra=[self._orchestrate])
        names = [n for n, _ in self.model.module.named_parameters()]
        self.result = {
            "val": self.val_results[-1] if self.val_results else {},
            "val_curve": self.val_results,
            "n_exchanges": self.server.n_exchanges,
            "center": dict(zip(names, self.server.get_center())),
            **self._aggregate_result()}


# -- ASGD -------------------------------------------------------------------


class _ASGDWorker(_Worker):
    rule = "asgd"

    def open(self) -> None:
        self.gstep = self.model.compile_grad_fn()
        self.it_total = 0
        self._open_store()
        if self.s.overlap:
            self._open_pipe(self._push_on_pipe, "asgd/push_pull")

    def iteration(self, it: int) -> None:
        m, rec = self.model, self.recorder
        rec.start()
        batch = next(m._train_iter)
        rec.end("wait")
        rec.start()
        with monitor.span("asgd/compute", worker=str(self.rank)):
            grads, new_ms, metrics = self.gstep(m._ensure_state(), batch,
                                                m._next_rng())
            # one copy to the host, which waits for this worker's stream
            loss, err = torch.stack([metrics["loss"].float(),
                                     metrics["error"].float()]).tolist()
        rec.end("calc")
        rec.start()
        grads = list(grads.values())
        if self.pipe is None:
            with monitor.span("asgd/push_pull", worker=str(self.rank)):
                fresh = self.srv.push_pull(grads)
            _assign(self.params, fresh)
        else:
            # take the PREVIOUS push's fresh center (it overlapped this
            # step's compute), then hand off this step's gradients
            if self.pipe.busy():
                self._collect()
            self.pipe.submit((grads, publish(grads)))
        _assign(dict(m.module.named_buffers()), new_ms)
        rec.end("comm")
        rec.train_metrics(loss, err, m.global_batch)

    def _push_on_pipe(self, payload):
        grads, ready = payload
        with _on_stream(self.model.device, self.pipe_stream):
            receive(grads, ready)
            fresh = self.srv.push_pull(grads)
            return fresh, publish(fresh)

    def _collect(self) -> None:
        with monitor.span("asgd/push_pull_collect", worker=str(self.rank)):
            _, (fresh, ready) = self.pipe.collect()
        receive(fresh, ready)
        _assign(self.params, fresh)

    def end_epoch(self, epoch: int) -> None:
        new_lr = self.model.adjust_hyperp(epoch + 1)
        if self.rank == 0:
            # the server's optimizer applies the updates, so the schedule
            # must reach it; rank 0 forwards it when ITS epoch ends, so a
            # decay may reach other workers' last pushes of their epoch
            # up to one epoch early (JAX's rule, on purpose)
            self.srv.set_lr(new_lr)
            if self.s.ckpt is not None:
                self.s.ckpt.save(epoch, self.s.checkpoint_payload(epoch))

    def finish(self) -> None:
        if self.pipe is not None and self.pipe.busy():
            # the last gradients reach the center before validation
            self._collect()


class ASGD(_AsyncRule):
    """Async parameter server (module docstring)."""

    name = "ASGD"

    def _prepare(self, devs, modelfile, modelclass, config, resume,
                 max_epochs: int | None = None, checkpoint: bool = True,
                 server_addr: str | None = None,
                 session_id: str | None = None, overlap: bool = False,
                 local_aggregation: bool = False, max_restarts: int = 0,
                 min_workers: int = 1, **kwargs):
        remote = self._remote(server_addr, session_id)
        self.overlap = overlap
        payload = self._setup(devs, modelfile, modelclass, config, resume,
                              checkpoint, max_epochs, **kwargs)
        if payload is not None:
            for m in self.models:
                _load_params(m, payload["params"])
        restored_opt = None if payload is None else payload["opt_state"]
        if self.sharded and restored_opt is not None:
            # per-shard optimizer states do not reassemble or scatter:
            # the resume re-seeds the center exactly and restarts the
            # server's momentum fresh (JAX's documented trade)
            print("[asgd] sharded resume: center restored exactly; "
                  "server optimizer momentum restarts fresh", flush=True)
            restored_opt = None
        init = _params(self.models[0])
        self.opt_cfg = self.model.optimizer_hyperparams()
        if not remote:
            self.server = ASGDServer(init, self.opt_cfg)
            if restored_opt is not None:
                self.server.set_opt_state(restored_opt)
        elif self.sharded:
            self.server = ShardedASGD(self.addrs, init, self.opt_cfg,
                                      session_id=self.session_id)
        else:
            self.server = RemoteASGD(self.addrs[0], init, self.opt_cfg,
                                     opt_state=restored_opt,
                                     session_id=self.session_id)
        if payload is not None:
            # the SERVER's center and optimizer state are ASGD's training
            # state; the restored state carries the old LR, so the
            # schedule is fast-forwarded onto the server
            self.server.set_lr(self._fast_forward())
        if local_aggregation:
            self._aggregate("asgd")
        self._supervise(max_restarts, min_workers)
        self.workers = [_ASGDWorker(self, i) for i in range(len(devs))]

    def connect(self):
        if self.addrs is None:
            return self.server
        if self.sharded:
            return ShardedASGD(self.addrs, None, self.opt_cfg,
                               session_id=self.session_id)
        return RemoteASGD(self.addrs[0], None, self.opt_cfg,
                          session_id=self.session_id)

    def checkpoint_payload(self, epoch: int) -> dict:
        """Worker 0's canonical payload with the server's center and
        optimizer state (the state ASGD trains; a shard fleet has no
        single optimizer state, so worker 0's own is kept, as in JAX)."""
        payload = self.model.checkpoint_payload(epoch)
        names = list(payload["params"])
        payload["params"] = dict(zip(names, self.server.get_center()))
        if getattr(self.server, "supports_opt_state", True):
            payload["opt_state"] = self.server.get_opt_state()
        return payload

    def _run(self) -> None:
        self._run_worker_threads([w.run for w in self.workers])
        center = self.server.get_center()
        val = self._validate(center)
        names = [n for n, _ in self.model.module.named_parameters()]
        self.result = {"val": val, "n_updates": self.server.n_updates,
                       "center": dict(zip(names, center)),
                       **self._aggregate_result()}


# -- GOSGD ------------------------------------------------------------------


class _GOSGDWorker(_Worker):
    rule = "gosgd"

    def __init__(self, session: "GOSGD", rank: int):
        super().__init__(session, rank)
        #: this worker's rank among every process's workers
        self.g_rank = rank + session.rank_offset
        self.rng = np.random.default_rng(self.model.config.seed
                                         + 31 * self.g_rank)

    def iteration(self, it: int) -> None:
        s, rank = self.s, self.rank
        self.recorder.start()
        self.merge_inbox()
        self.recorder.end("comm")
        self.model.train_iter(it, self.recorder)
        if s.n_total > 1 and self.rng.random() < s.p_push:
            dst = int(self.rng.integers(0, s.n_total - 1))
            dst = dst if dst < self.g_rank else dst + 1
            self.recorder.start()
            half = s.weights[rank] / 2.0
            with monitor.span("gosgd/push", worker=str(rank)):
                if self.srv.push(dst, self.params, half):
                    s.weights[rank] = half
            self.recorder.end("comm")

    def merge_inbox(self, scale_momentum: bool = True, hub=None) -> None:
        """Merge everything gossiped to this worker (the session's final
        drain, through the session's ``hub``, merges the parameters only,
        as JAX's does)."""
        s, rank = self.s, self.rank
        for recv, recv_w in (hub or self.srv or s.hub).drain(rank):
            own_w = s.weights[rank]
            merged, new_w = gosgd_merge(self.params, own_w, recv, recv_w)
            _assign(self.params, merged)
            if scale_momentum and s.merge_momentum == "scale" and new_w > 0:
                # momentum rides the same weighted average, the sender's
                # taken as 0: the stale-momentum divergence fix
                gosgd_scale_momentum(self.model._ensure_state().optimizer,
                                     own_w / new_w)
            s.weights[rank] = new_w

    def end_epoch(self, epoch: int) -> None:
        super().end_epoch(epoch)
        s = self.s
        if s.ckpt is None:
            return
        # each worker writes its OWN parameters from its own thread
        self.model.save(os.path.join(s.ckpt_dir,
                                     f"gosgd_w{self.rank}_{epoch}.npz"))
        if self.rank == 0:
            s.ckpt.save(epoch, self.model.checkpoint_payload(epoch))
            with open(os.path.join(s.ckpt_dir, f"gosgd_meta_{epoch}.json"),
                      "w") as f:
                json.dump({"epoch": epoch, "n_workers": len(s.models),
                           "weights": list(s.weights)}, f)
            _prune_gosgd_sidecars(s.ckpt_dir, s.ckpt.kept_epochs())

    def finish(self) -> None:
        self.srv.deactivate(self.rank)


class GOSGD(_AsyncRule):
    """Decentralized gossip SGD (module docstring)."""

    name = "GOSGD"

    def _prepare(self, devs, modelfile, modelclass, config, resume,
                 p_push: float = 0.1, max_epochs: int | None = None,
                 checkpoint: bool = True, server_addr: str | None = None,
                 n_total_workers: int | None = None, rank_offset: int = 0,
                 session_id: str | None = None,
                 merge_momentum: str = "scale",
                 local_aggregation: bool = False, max_restarts: int = 0,
                 min_workers: int = 1, **kwargs):
        remote = self._remote(server_addr, session_id)
        if merge_momentum not in ("scale", "keep"):
            raise ValueError(f"merge_momentum must be 'scale' or 'keep', "
                             f"got {merge_momentum!r}")
        if local_aggregation:
            raise ValueError(
                "GOSGD refuses hierarchical aggregation: a gossip push "
                "ships one worker's WHOLE (params, weight) to one "
                "random peer — there is no per-period center op to "
                "delta-sum or compose, so an intra-host aggregate has "
                "nothing exact to send")
        if self.sharded:
            raise ValueError(
                "GOSGD's gossip hub is unsharded — it rendezvouses WHOLE "
                "param trees, not an accumulating center, so there is "
                "nothing to leaf-range-partition; pass a single "
                "--server-addr (sharding applies to the EASGD/ASGD center)")
        n = len(devs)
        n_total = n_total_workers if n_total_workers is not None else n
        if not remote and (n_total != n or rank_offset):
            raise ValueError("n_total_workers/rank_offset need server_addr "
                             "(the shared gossip hub)")
        if not 0 <= rank_offset <= n_total - n:
            raise ValueError(f"rank_offset {rank_offset} with {n} local "
                             f"workers does not fit n_total_workers "
                             f"{n_total}")
        self.p_push, self.merge_momentum = p_push, merge_momentum
        self.n_total, self.rank_offset = n_total, rank_offset
        payload = self._setup(devs, modelfile, modelclass, config, resume,
                              checkpoint, max_epochs, **kwargs)
        self.hub = (RemoteGossipHub(self.addrs[0], n_total,
                                    rank_offset=rank_offset,
                                    session_id=self.session_id)
                    if remote else GossipHub(n))
        self.server = self.hub
        # the gossip weights (invariant: they sum to 1 over every
        # process's workers)
        self.weights = [1.0 / n_total] * n
        if payload is not None:
            self._restore_workers(payload)
            self._fast_forward()
        if max_restarts > 0:
            # no center to restart from: a failed worker is lost and the
            # hub stops taking pushes for it
            self.sup = WorkerSupervisor(
                n_workers=n, max_restarts=0, min_workers=min_workers,
                restart_from=None, on_lost=self.hub.deactivate,
                name=self.name)
        self.workers = [_GOSGDWorker(self, i) for i in range(n)]

    def connect(self):
        if self.addrs is None:
            return self.hub
        return RemoteGossipHub(self.addrs[0], self.n_total,
                               rank_offset=self.rank_offset,
                               session_id=self.session_id)

    def _restore_workers(self, payload: dict) -> None:
        """Every worker's parameters and weight from the epoch's sidecars
        (this process's share of the total weight); a checkpoint of
        another rule (or of another worker count) starts every worker
        from its parameters at equal weights."""
        epoch, n = self.restored_epoch, len(self.models)
        meta_path = os.path.join(self.ckpt_dir, f"gosgd_meta_{epoch}.json")
        paths = [os.path.join(self.ckpt_dir, f"gosgd_w{i}_{epoch}.npz")
                 for i in range(n)]
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        if (meta is not None and meta.get("n_workers") == n
                and all(os.path.exists(p) for p in paths)):
            # weight was in flight in peers' inboxes at the snapshot:
            # renormalize so the weights sum to 1 again
            restored = [float(w) for w in meta["weights"]]
            share = n / self.n_total
            total = sum(restored)
            self.weights[:] = [w / total * share for w in restored]
            for m, p in zip(self.models, paths):
                m.load(p)
        else:
            for m in self.models:
                _load_params(m, payload["params"])

    def _run(self) -> None:
        self._run_worker_threads([w.run for w in self.workers])
        self.result = self._consensus_result()

    def _consensus_result(self) -> dict:
        """Merge what was still in flight at shutdown (conserving the
        gossip weight), fold the weighted consensus on the host and
        validate it."""
        for w in self.workers:
            w.merge_inbox(scale_momentum=False, hub=self.hub)
        consensus = [p.detach().cpu() for p in _params(self.models[0])]
        acc_w = self.weights[0]
        for m, w in zip(self.models[1:], self.weights[1:]):
            consensus, acc_w = gosgd_merge(
                consensus, acc_w, [p.detach().cpu() for p in _params(m)], w)
        val = self._validate(consensus)
        names = [n for n, _ in self.model.module.named_parameters()]
        return {"val": val, "weights": list(self.weights),
                "consensus": dict(zip(names, consensus))}
