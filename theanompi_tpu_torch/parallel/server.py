"""In-process parameter stores for the asynchronous rules.

Counterpart of ``theanompi_tpu/parallel/server.py``: thread-safe stores
that the async rules' worker threads share (the reference ran them as
MPI ranks).  The center lives where JAX keeps it:

* :class:`EASGDServer` keeps the center on the host (in pinned memory
  when the workers train on a card); each exchange copies it to the
  calling worker's device, runs the elastic arithmetic there and copies
  the new center back;
* :class:`ASGDServer` keeps the center and its optimizer (the port's
  ``build_optimizer`` from the model's ``optimizer_hyperparams()``) on
  the first worker's device; a push copies the gradients there and
  returns a copy of the fresh center;
* :class:`GossipHub` holds one inbox per GOSGD worker.

PyTorch tensors are updated in place (JAX's arrays are immutable), so
every tensor that crosses a store is a copy that no later in-place step
of its source can change: the center an exchange or a push returns, the
parameters a gossip push enqueues, the center ``get_center`` returns.

Each worker thread launches on a CUDA stream of its own.  The stores run
on the calling thread's current stream, and every hand-off between
threads carries an event: a tensor written on one stream is read on
another only after that stream waits for the event, and is marked with
``record_stream`` so the caching allocator does not reuse its memory
early (:func:`publish` / :func:`receive`).  On the CPU both are no-ops.
``n_exchanges`` and ``n_updates`` are counted under the store's lock.
"""

from __future__ import annotations

import queue
from typing import Sequence

import torch

from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.parallel.exchanger import (
    easgd_both_updates,
    easgd_center_update_n,
)
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.utils.helper_funcs import (
    build_optimizer,
    set_learning_rate,
)

Tensors = Sequence[torch.Tensor]


def publish(tensors: Tensors) -> torch.cuda.Event | None:
    """An event recorded on the current stream of the tensors' card after
    the work that wrote them (None on the CPU): hand it on with them."""
    if not tensors or tensors[0].device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return ev


def receive(tensors: Tensors, event: torch.cuda.Event | None) -> None:
    """Make the current stream of the tensors' card wait for ``event``
    and keep their memory from reuse until that stream has passed this
    point (no-op on the CPU)."""
    if event is None:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(event)
    for t in tensors:
        t.record_stream(stream)


def _host_copy(params: Tensors) -> list[torch.Tensor]:
    """Host copies of ``params`` (pinned when they lie on a card)."""
    out = []
    for p in params:
        h = torch.empty(p.shape, dtype=p.dtype, device="cpu",
                        pin_memory=p.device.type == "cuda")
        h.copy_(p.detach())
        out.append(h)
    return out


class EASGDServer:
    """Center-parameter store with the elastic-averaging exchange."""

    def __init__(self, params: Tensors, alpha: float = 0.5):
        self.alpha = alpha
        self._lock = make_lock("EASGDServer._lock")
        self._center = _host_copy(params)  # guarded_by: self._lock
        self.n_exchanges = 0               # guarded_by: self._lock

    def _center_on(self, device: torch.device) -> list[torch.Tensor]:  # requires_lock: self._lock
        return [c.to(device, copy=True) for c in self._center]

    def exchange(self, worker_params: Tensors) -> list[torch.Tensor]:
        """One elastic exchange; returns the worker's new parameters (new
        tensors on the worker's device)::

            worker <- worker - a (worker - center)
            center <- center + a (worker - center)

        The arithmetic runs on the caller's device and stream; the new
        center's copy back to the host ends inside the lock, so exchange
        k+1 sees exchange k's center."""
        faults.fire("exchange", kind="easgd")
        with self._lock:
            center = self._center_on(worker_params[0].device)
            new_w, new_c = easgd_both_updates(list(worker_params), center,
                                              self.alpha)
            for host, c in zip(self._center, new_c):
                host.copy_(c)
            self.n_exchanges += 1
        return new_w

    def exchange_n(self, worker_mean: Tensors, n: int) -> list[torch.Tensor]:
        """Aggregated exchange: ``worker_mean`` is the mean of ``n``
        workers' parameters and the center moves by the closed form of n
        exchanges against one center version (``center += n * alpha *
        (mean - center)``).  Returns the PRE-update center on the mean's
        device; each worker computes its own elastic pull against it."""
        faults.fire("exchange", kind="easgd")
        n = int(n)
        if n < 1:
            raise ValueError(f"exchange_n needs n >= 1, got {n}")
        with self._lock:
            center = self._center_on(worker_mean[0].device)
            new_c = easgd_center_update_n(center, list(worker_mean),
                                          n * self.alpha)
            for host, c in zip(self._center, new_c):
                host.copy_(c)
            self.n_exchanges += n
        return center

    def get_center(self) -> list[torch.Tensor]:
        """A host copy of the center."""
        with self._lock:
            return [c.clone() for c in self._center]


class ASGDServer:
    """Async parameter server: workers push gradients, the server's
    optimizer applies them to the center, and the fresh center goes back.

    ``hyperparams`` is the model's ``optimizer_hyperparams()``: the
    ``learning_rate`` and ``build_optimizer``'s keywords."""

    def __init__(self, params: Tensors, hyperparams: dict):
        self.device = params[0].device
        self._lock = make_lock("ASGDServer._lock")
        # guarded_by: self._lock
        self._center = [p.detach().clone() for p in params]
        hp = dict(hyperparams)
        self._opt = build_optimizer(self._center, hp.pop("learning_rate"),
                                    **hp)  # guarded_by: self._lock
        self._ready: torch.cuda.Event | None = None  # guarded_by: self._lock
        self.n_updates = 0  # guarded_by: self._lock

    def _after_last_update(self) -> None:  # requires_lock: self._lock
        """The current stream waits for the last update of the center,
        which may have run on another thread's stream."""
        if self._ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready)

    def _apply(self, grads: Tensors) -> list[torch.Tensor]:  # requires_lock: self._lock
        self._after_last_update()
        for c, g in zip(self._center, grads, strict=True):
            c.grad = g.detach().to(self.device, copy=True)
        self._opt.step()
        for c in self._center:
            c.grad = None
        fresh = [c.clone() for c in self._center]
        self._ready = publish(self._center)
        return fresh

    def set_lr(self, lr: float) -> None:
        """Apply the epoch's learning rate to the SERVER's optimizer, the
        one that applies the updates (the workers' own are unused)."""
        with self._lock:
            set_learning_rate(self._opt, lr)

    def push_pull(self, grads: Tensors) -> list[torch.Tensor]:
        """Apply one worker's gradients to the center; returns a copy of
        the fresh center on the server's device."""
        faults.fire("exchange", kind="asgd")
        with self._lock:
            fresh = self._apply(grads)
            self.n_updates += 1
        return fresh

    def push_pull_n(self, grad_sum: Tensors, n: int) -> list[torch.Tensor]:
        """Aggregated push: ``grad_sum`` is the SUM of ``n`` workers'
        gradients, applied as ONE optimizer step; the update count grows
        by ``n``."""
        faults.fire("exchange", kind="asgd")
        n = int(n)
        if n < 1:
            raise ValueError(f"push_pull_n needs n >= 1, got {n}")
        with self._lock:
            fresh = self._apply(grad_sum)
            self.n_updates += n
        return fresh

    def get_center(self) -> list[torch.Tensor]:
        """A copy of the center on the server's device."""
        with self._lock:
            self._after_last_update()
            return [c.clone() for c in self._center]

    def get_opt_state(self) -> dict:
        """A copy of the server optimizer's state dict (per-parameter
        state indexed in parameter order, as a plain BSP optimizer's)."""
        with self._lock:
            self._after_last_update()
            sd = self._opt.state_dict()
            return {"state": {i: {k: v.clone() if torch.is_tensor(v) else v
                                  for k, v in per.items()}
                              for i, per in sd["state"].items()},
                    "param_groups": [dict(g) for g in sd["param_groups"]]}

    def set_opt_state(self, opt_state: dict) -> None:
        """Install a restored optimizer state (ASGD resume: the server's
        momentum and hyperparameters ARE the training state)."""
        with self._lock:
            self._after_last_update()
            self._opt.load_state_dict(opt_state)


class GossipHub:
    """Rendezvous for GOSGD's point-to-point pushes: one inbox per
    worker; senders never block."""

    def __init__(self, n_workers: int, maxsize: int = 64):
        self.n_workers = n_workers
        self._inboxes = [queue.Queue(maxsize=maxsize)
                         for _ in range(n_workers)]
        self._lock = make_lock("GossipHub._lock")
        self._active = [True] * n_workers  # guarded_by: self._lock

    def push(self, dst: int, params: Tensors, weight: float) -> bool:
        """Deliver a copy of ``params`` with ``weight`` to worker ``dst``;
        False if refused (a full inbox or a deactivated worker: the
        sender keeps its weight, so no gossip weight is lost).  The copy
        is made first; the check and the enqueue are one step under the
        lock :meth:`deactivate` takes, so a push either lands before the
        receiver's deactivation (and its final drain takes it) or is
        refused, never stranded in an inbox nobody drains."""
        faults.fire("exchange", kind="gosgd")
        copies = [p.detach().clone() for p in params]
        ready = publish(copies)
        with self._lock:
            if not self._active[dst]:
                return False
            try:
                self._inboxes[dst].put_nowait((copies, float(weight), ready))
                return True
            except queue.Full:
                return False

    def deactivate(self, rank: int) -> None:
        """Mark ``rank`` finished; peers stop pushing to it."""
        with self._lock:
            self._active[rank] = False

    def drain(self, rank: int) -> list[tuple[list[torch.Tensor], float]]:
        """Every pending delivery for worker ``rank`` (non-blocking), as
        ``(params, weight)``, ready for the caller's current stream."""
        out = []
        q = self._inboxes[rank]
        while True:
            try:
                params, weight, ev = q.get_nowait()
            except queue.Empty:
                return out
            receive(params, ev)
            out.append((params, weight))
