"""Sharded parameter service — the center pytree split across K
independent shard processes (docs/DESIGN.md
"Sharded parameter service").

EASGD/ASGD previously converged on ONE center process
(``parallel/service.py``): wire v2 made each round trip cheap, but
every worker still talked to the same socket, so the async host plane
topped out at one host's NIC and one Python GIL.  This module is the
sharded parameter server of the TensorFlow paper (arXiv:1605.08695)
rebuilt on our framed transport, applied to the elastic-averaging
rules of Theano-MPI (arXiv:1605.08325):

* **Leaf-range partitioning** (:func:`partition_ranges`): the center's
  tensors, in the stores' order (the module's ``parameters()``), are cut
  into K contiguous ranges balanced by bytes.  The partition is a pure
  function of (leaf byte sizes, K), so every client computes the same
  plan from its own model state — no plan distribution step.  Leaves
  are never split, so any per-leaf optimizer (the whole
  ``build_optimizer`` zoo — SGD/momentum, Adam(W), RMSProp, LARS) and
  the elastic-averaging update produce **byte-identical** math under
  any K (pinned by tests/test_shards.py).
* **Shard = one param service process** (:class:`ShardParamService`
  behind the same ``serve`` loop): each shard owns its leaf range as
  an ordinary EASGD/ASGD store, speaks wire v2 with its own HMAC
  session, and restarts like the tested single-server matrix — the
  per-shard client's session rejoin re-seeds ONLY that shard's leaf
  range from its last good sub-result.
* **Shard router** (:class:`ShardedEASGD` / :class:`ShardedASGD`, on
  ``service.ShardedServiceClient``): duck-types the single-center
  stores, scattering each full-tree op into K tagged sub-ops issued
  concurrently on per-shard exchange threads and reassembling the
  tree.
* **Cross-shard version fence**: every mutating sub-op carries a
  ``(client_id, seq)`` tag (one seq per full-tree op), each shard
  keeps a per-client vector clock, and a consistent read is two-phase
  — freeze all shards (blocking new exchanges, draining in-flight
  ones), read only if all vector clocks agree, release.  Checkpoints
  and exports therefore always restore a tree equal to some single
  global version, never a mix of exchange E's shard A with
  pre-E's shard B.

Trust model: each shard connection authenticates with the SAME
``THEANOMPI_TPU_SERVICE_KEY`` HMAC handshake but holds its own
session; compromising one shard port exposes only that shard's leaf
range (see docs/DESIGN.md for the full note).

GOSGD is deliberately NOT sharded: its hub is a rendezvous of whole
param trees, not an accumulating center — shard it and a gossip push
would straddle processes with nothing to reassemble.  The launcher and
the rule both refuse.

Launch one shard:  ``python -m theanompi_tpu_torch.parallel.shards
--port 45810 --shard-index 0 [--device cuda|cpu]`` — or let the
launcher's ``<rule> --shards K`` spawn and supervise the whole fleet
(:class:`ShardProcessGroup`, whose shards run on the CPU unless told
otherwise).

Copy of ``theanompi_tpu/parallel/shards.py`` over the port's service
(``parallel/service.py``): the routers split a list of tensors, the
shard's ``--device`` replaces JAX's ``--platform``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Sequence

import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.parallel import rpc
from theanompi_tpu_torch.parallel.partition import balanced_ranges
from theanompi_tpu_torch.parallel.service import (
    FenceBusy,
    ParamService,
    RemoteASGD,
    RemoteEASGD,
    ServiceClient,
    ShardNotReady,
    ShardedServiceClient,
    Tensors,
    _authkey,
    _device_of,
    host_arrays,
    to_tensors,
)

#: first port ``tmlocal --shards`` probes from (shard i binds a free
#: port, so this is cosmetic — the clients get explicit addresses)
DEFAULT_BASE_PORT = 45810


def _fence_timeout_s() -> float:
    """How long a shard honors a freeze with no release before
    auto-expiring it — a reader that died between freeze and release
    must not wedge training forever."""
    return float(os.environ.get(
        "THEANOMPI_TPU_SHARD_FENCE_TIMEOUT_S", "30"))


# ---------------------------------------------------------------------------
# Leaf-range partitioning
# ---------------------------------------------------------------------------


def partition_ranges(sizes: Sequence[int], n_shards: int
                     ) -> list[tuple[int, int]]:
    """Cut ``len(sizes)`` leaves into ``n_shards`` contiguous
    ``(lo, hi)`` ranges balanced by total bytes.

    Deterministic in (sizes, n_shards) — every client derives the same
    plan from its own copy of the model tree.  The greedy quantile
    walk lives in ``parallel/partition.py`` (shared with the bucketed
    gradient exchange, which derives its layer-ordered bucket plan
    from the same function — one algorithm, one audit surface); this
    wrapper keeps the shard-fleet error messages."""
    k, n = int(n_shards), len(sizes)
    if k < 1:
        raise ValueError(f"n_shards must be >= 1, got {k}")
    if n == 0:
        raise ValueError("cannot shard an empty tree")
    if k > n:
        raise ValueError(
            f"{k} shards over {n} leaves — a leaf is never split, so "
            "at most one shard per leaf (lower --shards)")
    return balanced_ranges(sizes, k)


def shard_addresses(server_addr: str | None) -> list[str] | None:
    """Parse the launcher/rules ``server_addr`` — a single ``host:port``
    or a comma-separated shard fleet — into a list (None when unset)."""
    if not server_addr:
        return None
    addrs = [a.strip() for a in server_addr.split(",") if a.strip()]
    if not addrs:
        raise ValueError(f"no addresses in server_addr {server_addr!r}")
    return addrs


# ---------------------------------------------------------------------------
# Server side: one shard of the center
# ---------------------------------------------------------------------------


class ShardParamService(ParamService):
    """A :class:`ParamService` that owns ONE leaf range of the center
    and adds the version-fence plane (module docstring):

    * ``shard_exchange`` / ``shard_push_pull`` — the tagged forms of
      ``easgd_exchange`` / ``asgd_push_pull``: same store arithmetic,
      plus fence admission (a frozen shard blocks new mutations) and
      vector-clock accounting ``{client_id: max seq}``;
    * ``shard_freeze (kind, session_id, token)`` — block new mutations,
      drain the in-flight one, return this shard's vector clock.  A
      fence held by ANOTHER token raises :class:`FenceBusy`
      (retryable client-side); a fence whose reader never released
      auto-expires after ``THEANOMPI_TPU_SHARD_FENCE_TIMEOUT_S``;
    * ``shard_release (kind, session_id, token)`` — lift the freeze
      (idempotent; a stranger's token is a no-op).

    Reads (``*_get_center`` …) are never blocked: the freeze exists
    exactly so the fence holder can read.  Everything else —
    init/join/rejoin session fencing, displacement fail-fast, the wire
    loop — is inherited unchanged, which is what makes a shard restart
    look like the already-tested server-restart matrix."""

    #: tagged mutating op -> the base-store op it wraps
    MUT_OPS = {"shard_exchange": "easgd_exchange",
               "shard_push_pull": "asgd_push_pull"}

    #: RPC-substrate control-pool routing (parallel/rpc.py): during a
    #: fence, frozen mutations legitimately PARK their executor
    #: workers in _admit — freeze/release and the fenced read/write
    #: ops must run on the control pool or the fence would starve
    #: behind the very mutations it holds back (the pool-level form of
    #: the dedicated-fence-connection rationale in docs/DESIGN.md)
    RPC_CONTROL_OPS = ParamService.RPC_CONTROL_OPS | frozenset({
        "shard_freeze", "shard_release", "shard_info",
        "easgd_get_center", "asgd_get_center", "asgd_get_opt_state",
        "asgd_set_lr",
    })

    def __init__(self, shard_index: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__(device=device)
        self.shard_index = int(shard_index)
        self._gate = make_lock("ShardParamService._gate")
        self._gate_cv = make_condition(self._gate,
                                       "ShardParamService._gate_cv")
        self._frozen: dict[str, str | None] = {}   # guarded_by: self._gate
        self._frozen_at: dict[str, float] = {}     # guarded_by: self._gate
        self._inflight: dict[str, int] = {}        # guarded_by: self._gate
        self._vclock: dict[str, dict[str, int]] = {}  # guarded_by: self._gate
        # monotone count of APPLIED mutations — unlike the vclock's
        # per-client max-seq, an at-least-once duplicate re-apply bumps
        # it, so the fence's post-read validation catches a duplicate
        # that slipped through an expired fence mid-read (the vclock
        # alone is blind to that torn cut)
        self._applied: dict[str, int] = {}         # guarded_by: self._gate

    # -- fence admission ----------------------------------------------

    def _admit(self, kind: str) -> None:
        """Block while ``kind`` is frozen (auto-expiring a stale
        fence), then count this mutation in-flight."""
        deadline = time.monotonic() + 2 * _fence_timeout_s()
        with self._gate_cv:
            while self._frozen.get(kind) is not None:
                if (time.monotonic() - self._frozen_at.get(kind, 0.0)
                        > _fence_timeout_s()):
                    # the reader died between freeze and release:
                    # training must not stay wedged on its corpse
                    self._frozen[kind] = None
                    self._gate_cv.notify_all()
                    monitor.inc("service/shard_fence_expired_total")
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"shard {self.shard_index}: {kind} mutation "
                        "blocked past twice the fence timeout")
                self._gate_cv.wait(0.05)
            self._inflight[kind] = self._inflight.get(kind, 0) + 1

    def _settle(self, kind: str, client_id: str | None = None,
                seq: int | None = None, count: int = 1) -> None:
        """Retire an in-flight mutation; on success record it in the
        vector clock (per-client max — an at-least-once duplicate of a
        lost-reply re-send must not read as a NEW exchange).  ``count``
        is the aggregate op's worker-count multiplier: one hierarchical
        exchange stands for ``count`` same-version worker exchanges,
        and the applied counter must say so — the fence's accounting
        stays identical to ``count`` independent exchanges."""
        with self._gate_cv:
            self._inflight[kind] = self._inflight.get(kind, 1) - 1
            if client_id is not None:
                vc = self._vclock.setdefault(kind, {})
                vc[client_id] = max(int(seq), vc.get(client_id, 0))
                self._applied[kind] = self._applied.get(kind, 0) \
                    + int(count)
            self._gate_cv.notify_all()

    def _freeze(self, kind: str, session_id: str, token: str) -> dict:
        # session fencing: a DISPLACED session fails fast (the reader's
        # whole training session is stale), but a missing store raises
        # the retryable ShardNotReady — the freeze raced this shard's
        # restart, and a worker's rejoin rebuilds the range shortly
        cur = self._sessions.get(kind)
        if cur is not None and cur != session_id:
            self._store(kind, session_id)  # raises the displaced error
        if self._stores.get(kind) is None or cur != session_id:
            raise ShardNotReady(
                f"{kind} session {session_id!r} is not live on shard "
                f"{self.shard_index} (restart in progress?)")
        t0 = time.monotonic()
        with self._gate_cv:
            cur = self._frozen.get(kind)
            if cur is not None and cur != token:
                if (time.monotonic() - self._frozen_at.get(kind, 0.0)
                        <= _fence_timeout_s()):
                    raise FenceBusy(
                        f"{kind} fence on shard {self.shard_index} is "
                        "held by another reader")
                monitor.inc("service/shard_fence_expired_total")
            self._frozen[kind] = token
            self._frozen_at[kind] = time.monotonic()
            while self._inflight.get(kind, 0) > 0:
                if time.monotonic() - t0 > _fence_timeout_s():
                    self._frozen[kind] = None
                    self._gate_cv.notify_all()
                    raise RuntimeError(
                        f"shard {self.shard_index}: freeze timed out "
                        f"waiting for an in-flight {kind} mutation")
                self._gate_cv.wait(0.05)
            return {"shard": self.shard_index,
                    "vclock": dict(self._vclock.get(kind, {})),
                    "applied": self._applied.get(kind, 0)}

    def _release(self, kind: str, session_id: str, token: str) -> str:
        with self._gate_cv:
            if self._frozen.get(kind) == token:
                self._frozen[kind] = None
                self._frozen_at.pop(kind, None)
                self._gate_cv.notify_all()
        return "released"

    # -- dispatch ------------------------------------------------------

    def handle(self, op: str, *args):
        base = self.MUT_OPS.get(op)
        if base is not None:
            if len(args) not in (4, 5) or not isinstance(args[0], str):
                raise ValueError(
                    f"{op} requires (session_id, payload, client_id, "
                    f"seq[, n_workers]) — got {len(args)} args")
            sid, payload, client_id, seq = args[:4]
            try:
                # validate BEFORE the store op: a mutation that applied
                # but could not be versioned would be invisible to the
                # fence's clock comparison — a silent torn-cut hole
                seq = int(seq)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{op} seq must be an int, got {seq!r}") from None
            # optional 5th arg: the hierarchical plane's worker-count
            # multiplier (parallel/aggregate.py) — the SAME tagged op,
            # dispatched to the aggregate store math, counted in the
            # fence accounting as n_workers same-version exchanges
            n_workers = None
            if len(args) == 5:
                try:
                    n_workers = int(args[4])
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{op} n_workers must be an int, "
                        f"got {args[4]!r}") from None
                if n_workers < 1:
                    raise ValueError(
                        f"{op} n_workers must be >= 1, got {n_workers}")
            kind = base.split("_", 1)[0]
            self._admit(kind)
            try:
                if n_workers is None:
                    out = super().handle(base, sid, payload)
                else:
                    out = super().handle(base + "_n", sid, payload,
                                         n_workers)
            except BaseException:
                self._settle(kind)  # failed mutations don't version
                raise
            self._settle(kind, str(client_id), seq,
                         count=1 if n_workers is None else n_workers)
            return out
        if op == "shard_freeze":
            return self._freeze(*args)
        if op == "shard_release":
            return self._release(*args)
        if op == "shard_info":
            return {"shard": self.shard_index}
        return super().handle(op, *args)


def serve_shard(host: str = "0.0.0.0", port: int = 0,
                shard_index: int = 0,
                ready_event: threading.Event | None = None,
                stop_event: threading.Event | None = None,
                authkey: bytes | None = None,
                device: str | torch.device = "cuda") -> None:
    """The param-service wire loop over a :class:`ShardParamService`."""
    from theanompi_tpu_torch.parallel.service import serve

    serve(host, port, ready_event=ready_event, stop_event=stop_event,
          authkey=authkey, service=ShardParamService(shard_index, device))


# ---------------------------------------------------------------------------
# Client side: per-shard session clients + routers
# ---------------------------------------------------------------------------


def _shard_transports(addresses: Sequence[str]) -> list | None:
    """One multiplexed transport per shard peer: the shard's session
    client and its fence control client become two streams on ONE
    socket — halving the router's fd count — which the selector loop's
    control-pool routing of ``shard_freeze``/``shard_release`` makes
    deadlock-free (see ``ShardedServiceClient``).  ON by default
    (``THEANOMPI_TPU_SHARD_MUX=0`` opts out) since the ``bench_rpc
    --soak`` byte-identity pins hold under sustained load; against a
    non-mux server the transports silently degrade to dedicated
    sockets, so the default is safe either way."""
    if os.environ.get("THEANOMPI_TPU_SHARD_MUX", "1") != "1":
        return None
    if os.environ.get("THEANOMPI_TPU_WIRE_PROTOCOL", "v2") == "v1":
        # mux streams are wire-v2 framed by construction; a client
        # pinned to v1 pickle keeps its dedicated sockets — the same
        # silent degradation as a non-mux server
        return None
    from theanompi_tpu_torch.parallel.rpc import MuxConnection

    return [MuxConnection(addr) for addr in addresses]


class _ShardEASGD(RemoteEASGD):
    """One shard's session client: a :class:`RemoteEASGD` whose tree is
    this shard's sub-list of leaves.  Inherits the whole
    reconnect/rejoin matrix — after a shard restart, ``_rejoin``
    re-seeds ONLY this shard's leaf range from its last good
    sub-result."""

    def exchange_tagged(self, sub_leaves: list, client_id: str,
                        seq: int, n_workers: int | None = None) -> list:
        """``n_workers`` marks an AGGREGATE sub-exchange (the
        hierarchical plane): same tagged op, a 5th multiplier arg, and
        the reply is this shard's PRE-update center range instead of
        the new worker range."""
        if n_workers is None:
            out = self.call("shard_exchange", self._sid, sub_leaves,
                            client_id, int(seq))
        else:
            out = self.call("shard_exchange", self._sid, sub_leaves,
                            client_id, int(seq), int(n_workers))
        self._rebuild = out
        return out

    def exchange(self, worker_params):  # pragma: no cover - guard
        raise RuntimeError("sharded exchanges must carry a version tag "
                           "— use exchange_tagged (via ShardedEASGD)")


class _ShardASGD(RemoteASGD):
    """One shard's ASGD session client (see :class:`_ShardEASGD`)."""

    def push_pull_tagged(self, sub_grads: list, client_id: str,
                         seq: int, n_workers: int | None = None) -> list:
        """``n_workers`` marks an AGGREGATE sub-push (see
        ``_ShardEASGD.exchange_tagged``); the reply stays the fresh
        center range either way."""
        if n_workers is None:
            out = self.call("shard_push_pull", self._sid, sub_grads,
                            client_id, int(seq))
        else:
            out = self.call("shard_push_pull", self._sid, sub_grads,
                            client_id, int(seq), int(n_workers))
        self._rebuild = out
        return out

    def push_pull(self, grads):  # pragma: no cover - guard
        raise RuntimeError("sharded pushes must carry a version tag — "
                           "use push_pull_tagged (via ShardedASGD)")


class _TreePlan:
    """The routers' plan: contiguous ranges of the parameter list, in
    the stores' order.  The session CREATOR derives it from the init
    params; a JOINER (params=None) derives it lazily from its first
    exchanged list — identical by construction, since the partition is
    a pure function of (tensor sizes, K) and all workers share one
    model."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.ranges: list[tuple[int, int]] | None = None

    def split(self, params: Tensors) -> list[list]:
        """Host copies of ``params`` (the wire's leaves), cut into the
        shards' ranges."""
        flat = host_arrays(params)
        if self.ranges is None:
            self.ranges = partition_ranges(
                [monitor.tree_bytes(a) for a in flat], self.n_shards)
        return [flat[lo:hi] for lo, hi in self.ranges]

    def join(self, subs: list[list], device) -> list[torch.Tensor]:
        """The shards' replies as one list of new tensors on ``device``."""
        if self.ranges is None:
            raise RuntimeError(
                "this sharded client has not seen the parameters yet — "
                "init with params, or exchange once, before reading the "
                "center")
        return to_tensors([x for sub in subs for x in sub], device)


class ShardedEASGD(ShardedServiceClient):
    """``EASGDServer`` API over K shards (drop-in for
    :class:`RemoteEASGD` in the EASGD rule).  The elastic exchange is
    element-wise, so K independent per-range exchanges reassemble to
    the exact single-center result — pinned byte-identical by
    tests/test_shards.py."""

    def __init__(self, addresses: Sequence[str], params: Tensors | None,
                 alpha: float, session_id: str = "default"):
        addresses = list(addresses)
        self._alpha = float(alpha)
        self._plan = _TreePlan(len(addresses))
        subs = (self._plan.split(params)
                if params is not None else [None] * len(addresses))
        transports = _shard_transports(addresses)
        clients = [_ShardEASGD(addr, sub, alpha=alpha,
                               session_id=session_id, transport=tr)
                   for addr, sub, tr in zip(addresses, subs,
                                            transports or
                                            [None] * len(addresses))]
        super().__init__(clients, "easgd", session_id,
                         transports=transports)

    def exchange(self, worker_params: Tensors) -> list[torch.Tensor]:
        subs = self._plan.split(worker_params)
        seq = self._next_seq()
        cid = self._client_id
        thunks = [
            (lambda c=c, sub=sub: c.exchange_tagged(sub, cid, seq))
            for c, sub in zip(self._shard_clients, subs)]
        return self._plan.join(self._scatter(thunks),
                               _device_of(worker_params))

    def exchange_n(self, worker_mean: Tensors,
                   n: int) -> list[torch.Tensor]:
        """Aggregated exchange over the fleet: ONE tagged sub-exchange
        per shard carries the n-worker mean + multiplier; the
        reassembled reply is the PRE-update center (see
        ``EASGDServer.exchange_n``) the aggregator fans back out."""
        subs = self._plan.split(worker_mean)
        seq = self._next_seq()
        cid = self._client_id
        n = int(n)
        thunks = [
            (lambda c=c, sub=sub: c.exchange_tagged(sub, cid, seq, n))
            for c, sub in zip(self._shard_clients, subs)]
        return self._plan.join(self._scatter(thunks),
                               _device_of(worker_mean))

    def fenced_center(self) -> tuple[list[torch.Tensor], dict]:
        """The consistent cut (host tensors) + the vector clock it froze
        at (the 'single global version' the checkpoint corresponds
        to)."""
        outs, vclock = self.fenced_read("easgd_get_center")
        return self._plan.join(outs, "cpu"), vclock

    def get_center(self) -> list[torch.Tensor]:
        return self.fenced_center()[0]

    @property
    def n_exchanges(self) -> int:
        # every full exchange lands once on every shard, so shard 0
        # speaks for the fleet
        return int(self._shard_clients[0].call("stats")
                   .get("n_exchanges", 0))


class ShardedASGD(ShardedServiceClient):
    """``ASGDServer`` API over K shards (drop-in for
    :class:`RemoteASGD` in the ASGD rule).  Each shard runs its own
    optimizer over its leaf range; the ``build_optimizer`` zoo is
    per-leaf, so the reassembled center is byte-identical to the
    single-center run.

    Optimizer-state caveat (documented in docs/RESILIENCE.md): the
    per-shard optimizer states do not reassemble into the single-tree
    optax structure (each shard holds its own hyperparam/count
    leaves), so sharded ASGD neither ships a restored ``opt_state`` at
    init nor serves ``get_opt_state`` — a sharded resume re-seeds the
    center exactly and restarts server momentum fresh, the same trade
    the service-restart rejoin already makes."""

    #: the ASGD rule checks this before trying to checkpoint/restore
    #: the server optimizer state through a sharded client
    supports_opt_state = False

    def __init__(self, addresses: Sequence[str], params: Tensors | None,
                 opt_cfg: dict, opt_state: dict | None = None,
                 session_id: str = "default"):
        if opt_state is not None:
            raise ValueError(
                "sharded ASGD cannot scatter a restored opt_state "
                "(per-shard optax states each hold their own "
                "hyperparam/count leaves); resume re-seeds the center "
                "and starts server momentum fresh — docs/RESILIENCE.md")
        addresses = list(addresses)
        self._plan = _TreePlan(len(addresses))
        subs = (self._plan.split(params)
                if params is not None else [None] * len(addresses))
        transports = _shard_transports(addresses)
        clients = [_ShardASGD(addr, sub, dict(opt_cfg),
                              session_id=session_id, transport=tr)
                   for addr, sub, tr in zip(addresses, subs,
                                            transports or
                                            [None] * len(addresses))]
        super().__init__(clients, "asgd", session_id,
                         transports=transports)

    def push_pull(self, grads: Tensors) -> list[torch.Tensor]:
        subs = self._plan.split(grads)
        seq = self._next_seq()
        cid = self._client_id
        thunks = [
            (lambda c=c, sub=sub: c.push_pull_tagged(sub, cid, seq))
            for c, sub in zip(self._shard_clients, subs)]
        return self._plan.join(self._scatter(thunks), _device_of(grads))

    def push_pull_n(self, grad_sum: Tensors,
                    n: int) -> list[torch.Tensor]:
        """Aggregated grad push over the fleet (see
        ``ShardedEASGD.exchange_n``): one tagged sub-push per shard,
        reassembling the fresh center."""
        subs = self._plan.split(grad_sum)
        seq = self._next_seq()
        cid = self._client_id
        n = int(n)
        thunks = [
            (lambda c=c, sub=sub: c.push_pull_tagged(sub, cid, seq, n))
            for c, sub in zip(self._shard_clients, subs)]
        return self._plan.join(self._scatter(thunks), _device_of(grad_sum))

    def set_lr(self, lr: float) -> None:
        """Fenced broadcast — every shard's optimizer applies updates,
        so the schedule must reach all of them, and it must not
        interleave with a concurrent worker's K-way push (the
        single-center store serializes set_lr vs push_pull under one
        lock; a bare broadcast would let one logical update apply with
        the old lr on some leaf ranges and the new lr on others).
        set_lr is idempotent, so the fence's validation-retry is
        safe."""
        self.fenced_op("asgd_set_lr", float(lr))

    def fenced_center(self) -> tuple[list[torch.Tensor], dict]:
        outs, vclock = self.fenced_read("asgd_get_center")
        return self._plan.join(outs, "cpu"), vclock

    def get_center(self) -> list[torch.Tensor]:
        return self.fenced_center()[0]

    def get_opt_state(self):
        raise RuntimeError(
            "sharded ASGD has no single-tree opt_state (class "
            "docstring); the rule checkpoints the worker's own "
            "opt_state structure instead")

    @property
    def n_updates(self) -> int:
        return int(self._shard_clients[0].call("stats")
                   .get("n_updates", 0))


# ---------------------------------------------------------------------------
# Shard fleet supervision (tmlocal --shards K, bench, preflight smoke)
# ---------------------------------------------------------------------------


class ShardProcessGroup:
    """Spawn K real shard processes and supervise them: a shard that
    dies is relaunched on its port (budget ``max_restarts`` per shard),
    and the clients' per-shard session rejoin re-seeds its leaf range
    on their next op — the server-restart matrix, per shard.

    Requires/exports ``THEANOMPI_TPU_SERVICE_KEY`` (a missing key is
    generated and exported exactly like a standalone service).
    The child processes inherit this environment, monitor dir
    included, so each shard writes its own ``service/*`` telemetry.
    ``device`` is passed to every shard as ``--device`` (default the
    CPU, as JAX's fleet defaults to its CPU platform), and
    ``compilation_cache_dir`` (the launcher's) as
    ``--compilation-cache-dir``.

    ``THEANOMPI_TPU_UNIX_SOCKETS=1`` puts the whole fleet on AF_UNIX
    listeners (JAX's switch): one socket file per shard, in a directory
    of its own under the temporary directory that :meth:`stop` removes.
    A port is still allocated per shard, so a platform without AF_UNIX
    (or a temporary directory too deep for a socket path) falls back to
    TCP silently, as JAX's does."""

    def __init__(self, n_shards: int, host: str = "127.0.0.1",
                 max_restarts: int = 1, device: str = "cpu",
                 ready_timeout_s: float = 180.0,
                 compilation_cache_dir: str | None = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.host = host
        self.max_restarts = int(max_restarts)
        self.device = str(device)
        self.n_shards = int(n_shards)
        self.compilation_cache_dir = compilation_cache_dir
        _authkey(generate=True)  # ensure + export the shared key
        self._lock = make_lock("ShardProcessGroup._lock")
        self._stopping = threading.Event()
        self._ports: list[int] = []
        self._sock_dir = (tempfile.mkdtemp(prefix="tmshard_")
                          if os.environ.get("THEANOMPI_TPU_UNIX_SOCKETS")
                          == "1" and rpc.have_af_unix() else None)
        self._socks: list[str | None] = []
        self._procs: list[subprocess.Popen] = []  # guarded_by: self._lock
        self._restarts: dict[int, int] = {}       # guarded_by: self._lock
        for i in range(n_shards):
            port = _free_port()
            self._ports.append(port)
            sock = (None if self._sock_dir is None else
                    os.path.join(self._sock_dir, f"shard{i}.sock"))
            # AF_UNIX paths hold at most 107 bytes
            self._socks.append(sock if sock and len(sock) < 100 else None)
            self._procs.append(self._spawn(i, port))
        self._wait_ready(ready_timeout_s)
        self._watcher = threading.Thread(
            target=self._watch, daemon=True, name="shard-group-watcher")
        self._watcher.start()

    @property
    def addresses(self) -> list[str]:
        return [f"{rpc.UNIX_PREFIX}{sock}" if sock else f"{self.host}:{p}"
                for sock, p in zip(self._socks, self._ports)]

    @property
    def server_addr(self) -> str:
        """The comma-joined form the launcher/rules consume."""
        return ",".join(self.addresses)

    def _spawn(self, index: int, port: int) -> subprocess.Popen:
        sock = self._socks[index]
        host = f"{rpc.UNIX_PREFIX}{sock}" if sock else self.host
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.parallel.shards",
               "--host", host, "--port", str(port),
               "--shard-index", str(index), "--device", self.device]
        if self.compilation_cache_dir:
            cmd += ["--compilation-cache-dir", self.compilation_cache_dir]
        return subprocess.Popen(cmd, env=self.shard_env())

    def shard_env(self) -> dict:
        """A shard's environment.  CPU shards share the host's cores: each
        gets a K-th of them for its arithmetic (``OMP_NUM_THREADS``,
        unless the caller set it), because K full-width thread pools
        running their merges at once oversubscribe the host and make K
        shards slower than one."""
        env = child_env()
        if self.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
            cores = (len(os.sched_getaffinity(0))
                     if hasattr(os, "sched_getaffinity")
                     else os.cpu_count() or 1)
            env["OMP_NUM_THREADS"] = str(max(1, cores // self.n_shards))
        return env

    def _wait_ready(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for i, addr in enumerate(self.addresses):
            while True:
                c, info = None, None
                try:
                    c = ServiceClient(addr)
                    info = c.call("shard_info")
                except Exception:
                    with self._lock:
                        rc = self._procs[i].poll()
                    if rc is not None:
                        self.stop()
                        raise RuntimeError(
                            f"shard {i} died during startup (rc={rc})")
                    if time.monotonic() > deadline:
                        self.stop()
                        raise RuntimeError(
                            f"shard {i} at {addr} never came up "
                            f"within {timeout_s}s")
                    time.sleep(0.3)
                finally:
                    # probe clients must not accumulate: a failed call
                    # would otherwise leak one authenticated
                    # connection per 0.3s retry
                    if c is not None:
                        c.close()
                if info is None:
                    continue
                if info.get("shard") != i:
                    # a stale process squatting on the port: fail
                    # LOUDLY and immediately — retrying would just
                    # convert a mis-wired fleet into a misleading
                    # 'never came up' timeout
                    self.stop()
                    raise RuntimeError(
                        f"address {addr} answered as shard "
                        f"{info.get('shard')!r}, expected shard {i} — "
                        "another process is listening on that port")
                break

    def _watch(self) -> None:
        while not self._stopping.wait(0.5):
            with self._lock:
                procs = list(self._procs)
            for i, proc in enumerate(procs):
                if proc.poll() is None or self._stopping.is_set():
                    continue
                with self._lock:
                    n = self._restarts.get(i, 0)
                    if n >= self.max_restarts:
                        continue  # budget spent: leave the corpse
                    self._restarts[i] = n + 1
                    self._procs[i] = self._spawn(i, self._ports[i])
                print(f"[shards] shard {i} died (rc={proc.returncode}); "
                      f"relaunched at {self.addresses[i]} "
                      f"({n + 1}/{self.max_restarts})",
                      file=sys.stderr, flush=True)
                monitor.inc("service/shard_restarts_total", shard=i)

    def restart_counts(self) -> dict[int, int]:
        with self._lock:
            return dict(self._restarts)

    def kill_shard(self, index: int) -> None:
        """Hard-kill one shard (fault-matrix smoke); the watcher
        relaunches it within a poll interval if budget remains."""
        with self._lock:
            self._procs[index].kill()

    def wait_restarted(self, index: int, timeout_s: float = 60.0) -> None:
        """Block until shard ``index`` answers pings again."""
        deadline = time.monotonic() + timeout_s
        addr = self.addresses[index]
        while True:
            c = None
            try:
                c = ServiceClient(addr)
                c.call("shard_info")
                return
            except Exception:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"shard {index} did not come back within "
                        f"{timeout_s}s")
                time.sleep(0.3)
            finally:
                if c is not None:
                    c.close()

    def stop(self) -> None:
        self._stopping.set()
        if getattr(self, "_watcher", None) is not None \
                and self._watcher.is_alive():
            self._watcher.join(timeout=5)
        with self._lock:
            procs = list(self._procs)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        if self._sock_dir is not None:
            # a terminated or killed shard leaves its socket file
            shutil.rmtree(self._sock_dir, ignore_errors=True)

    def __enter__(self) -> "ShardProcessGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def child_env() -> dict:
    """This process's environment with the package's root first on
    ``PYTHONPATH``, for a ``python -m theanompi_tpu_torch...`` child
    started from any working directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.parallel.shards",
        description="one shard of the partitioned parameter service "
                    "(PyTorch port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the shard's arithmetic runs: cuda "
                         "(default; raises without a card) or cpu")
    _kernels.add_cache_dir_option(ap)
    args = ap.parse_args(argv)
    _kernels.apply_cache_dir_option(args)
    from theanompi_tpu_torch._device import resolve_device

    device = resolve_device(args.device)
    print(f"[shards] shard {args.shard_index} listening on "
          f"{args.host}:{args.port} (device {device})", flush=True)
    # same telemetry posture as a standalone tmserver: request-driven
    # progress, no stall watchdog, a per-process file suffix so K
    # shards sharing a monitor dir never clobber each other
    with monitor.session(stall_after=float("inf"),
                         name=f"shard{args.shard_index}_{os.getpid()}"):
        monitor.progress(phase="serving")
        serve_shard(args.host, args.port, args.shard_index, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
