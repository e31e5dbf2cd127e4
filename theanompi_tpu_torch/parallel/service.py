"""DCN transport for the async rules — a parameter service over TCP.

The reference's EASGD/ASGD servers were dedicated MPI ranks and GOSGD
used point-to-point MPI sends; all of that rode the cluster fabric
(SURVEY.md §2.3/§3.3/§5.8 — mount empty, no file:line).  The TPU-native
split keeps ICI for what XLA schedules (BSP collectives) and gives the
async rules what MPI p2p gave the reference: a host-level transport
that crosses machines.

Design: ONE rule-agnostic service process hosts the same stores the
in-process path uses (``parallel/server.py`` — EASGDServer, ASGDServer,
GossipHub); stores are created lazily by the first ``*_init`` request,
so the service needs no model code or rule flag at launch.  Clients
mirror the stores' duck-type APIs, so a rule session is pointed at a
remote server by a single ``server_addr=`` argument — the in-process
store remains the fast local path.  When one service process becomes
the ceiling, ``parallel/shards.py`` partitions the center across K of
them (``server_addr`` becomes a comma-separated fleet; see
:class:`ShardedServiceClient` and docs/DESIGN.md "Sharded parameter
service").

Transport: the shared RPC substrate (``parallel/rpc.py``, docs/
DESIGN.md "RPC substrate") — a selector event loop,
``multiprocessing.connection``-framed
chunks with HMAC challenge/response auth under a handshake deadline,
speaking one of two protocols negotiated per connection at handshake
time (docs/DESIGN.md "Wire protocol v2"):

* **v2 framed** (default) — ``parallel/wire.py``: a fixed binary
  header + JSON skeleton per message with every ndarray sent as its
  own raw buffer via memoryview (zero-copy, never pickled), with
  per-payload options: ``none``/``zlib`` compression and an
  ``f32``/``bf16`` wire dtype (f32 leaves travel as bf16 and are
  restored to f32 on receive, so accumulation at the center stores
  stays f32).  The decoder is hardened: truncated/corrupt/oversized
  frames raise a typed ``WireDecodeError`` — never a hang — and the
  server drains + survives them.
* **v1 pickle** (legacy fallback) — length-prefixed pickled tuples; a
  client whose ``wire_hello`` is refused stays here, so old peers keep
  working.

The authkey gates access either way: the server REQUIRES
``THEANOMPI_TPU_SERVICE_KEY`` (auto-generating and printing a random
one when unset), and clients refuse to connect without it — there is
no default key, because the v1 fallback is pickle and a
publicly-known secret would be remote code execution for anyone who
can reach the port.  Even with auth, run the service on a trusted
network: the v1 path (and the v2 structural-escape decode, see
``wire.WireOptions.allow_pickle``) is not safe against a peer that
legitimately holds the key; v2's ARRAY path is pickle-free in both
directions.

Client-side env knobs (all also settable per-client):
``THEANOMPI_TPU_WIRE_PROTOCOL`` (``v2``/``v1``),
``THEANOMPI_TPU_WIRE_COMPRESSION`` (``none``/``zlib``),
``THEANOMPI_TPU_WIRE_DTYPE`` (``f32``/``bf16``).

Launch:  ``python -m theanompi_tpu_torch.parallel.service --port 45800``
(``--device cuda``, the default, or ``--device cpu``).

Copy of ``theanompi_tpu/parallel/service.py`` over the port's stores
(``parallel/server.py``).  What differs:

* **The trees.** A port client sends a worker's parameters (or
  gradients) as a list of numpy arrays in the stores' order, the
  module's ``parameters()``; the service talks port to port.  The
  conversion happens at the clients' edge: a worker's tensors go to the
  host through pinned buffers on the worker's current CUDA stream
  (``parallel/server.py`` ``_host_copy``), and every reply comes back as
  new tensors on the worker's device, so nothing a client returns
  aliases a wire buffer.
* **Where the arithmetic runs.** ``--device`` (default ``cuda``)
  replaces JAX's ``--platform``: the service's stores run their
  arithmetic on that device, as the in-process stores do, and a service
  told ``cuda`` on a machine without a card raises.
* **ASGD's optimizer state** (``asgd_get_opt_state`` and a resume's
  ``asgd_init``) is the port optimizer's state dict, its tensors as
  numpy arrays.
* **The client's handshake is bounded** (``rpc.connect_client``): a
  client that connects to a service that stops answering raises
  ``rpc.HandshakeTimeout`` instead of waiting forever.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
import uuid
from typing import Any, Sequence

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.parallel import rpc, shm, wire
from theanompi_tpu_torch.parallel.server import _host_copy
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.resilience.retry import CONNECTION_ERRORS, RetryPolicy

#: a list of tensors (or of numpy arrays on the wire side)
Tensors = Sequence[Any]

DEFAULT_PORT = 45800


def _authkey(generate: bool = False) -> bytes:
    """Shared secret for the wire protocol — NO hard-coded fallback
    : the transport is pickle, so a publicly-known
    default key would hand remote code execution to anyone who can
    reach the port.  Servers pass ``generate=True`` to mint a random
    per-session key when none is set (printed once, and exported into
    this process's environment so same-process clients — tests, a local
    service thread — inherit it); clients refuse outright."""
    key = os.environ.get("THEANOMPI_TPU_SERVICE_KEY")
    if key:
        return key.encode()
    if generate:
        import secrets

        key = secrets.token_hex(16)
        os.environ["THEANOMPI_TPU_SERVICE_KEY"] = key
        print(f"[service] THEANOMPI_TPU_SERVICE_KEY not set — generated "
              f"session key {key}; export it to every worker host",
              flush=True)
        return key.encode()
    raise RuntimeError(
        "THEANOMPI_TPU_SERVICE_KEY is not set — refusing to connect. "
        "The service transport is pickle; a default shared key would be "
        "publicly known and equivalent to no auth. Set the same key in "
        "the server and every worker environment (see docs/SCALING.md).")


# ---------------------------------------------------------------------------
# torch <-> the wire's leaves
# ---------------------------------------------------------------------------


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def host_arrays(values: Tensors) -> list:
    """The wire's leaves for a list of tensors: host copies as numpy
    arrays (a bf16 tensor stays a CPU bf16 tensor, the wire's bf16 leaf).
    From a card the copies go through pinned buffers on the current
    stream, which is synchronized before the bytes are read, so they are
    ordered after the work the caller's stream queued before (the
    worker's step).  Numpy input is copied."""
    values = list(values)
    if not values or not torch.is_tensor(values[0]):
        return [np.array(v) for v in values]
    hosts = _host_copy(values)
    dev = values[0].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return [h if h.dtype == torch.bfloat16 else h.numpy() for h in hosts]


def host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    """A new CPU tensor holding a copy of one numpy wire leaf, in
    page-locked memory when ``pin`` (the first half of
    :func:`to_tensors`' way to a card)."""
    h = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=pin)
    h.numpy()[...] = a
    return h


def to_tensors(leaves: Sequence[Any], device) -> list[torch.Tensor]:
    """New tensors on ``device`` from the wire's leaves (numpy arrays or
    CPU bf16 tensors): never views of a wire buffer.  To a card the
    bytes go through pinned buffers, copied on the current stream."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = []
    for a in leaves:
        if torch.is_tensor(a):
            out.append(a.to(device, copy=True))
            continue
        h = host_tensor(np.asarray(a), pin)
        out.append(h.to(device, non_blocking=True) if pin else h)
    return out


def _np_out(tensors: Sequence[torch.Tensor]) -> list:
    """A store's fresh result tensors as the wire's leaves."""
    out = []
    for t in tensors:
        t = t.detach().cpu()
        out.append(t if t.dtype == torch.bfloat16 else t.numpy())
    return out


def opt_state_to_wire(state: dict) -> dict:
    """An optimizer state dict (``ASGDServer.get_opt_state``) with its
    tensors as the wire's leaves."""
    return {"state": {int(i): {k: _np_out([v])[0] if torch.is_tensor(v)
                               else v for k, v in per.items()}
                      for i, per in state["state"].items()},
            "param_groups": [dict(g) for g in state["param_groups"]]}


def opt_state_from_wire(state: dict) -> dict:
    """The inverse of :func:`opt_state_to_wire` (CPU tensors; the
    optimizer's ``load_state_dict`` moves them to its parameters)."""
    def tensor(v):
        if torch.is_tensor(v) or isinstance(v, np.ndarray):
            return to_tensors([v], "cpu")[0]
        return v
    return {"state": {int(i): {k: tensor(v) for k, v in per.items()}
                      for i, per in state["state"].items()},
            "param_groups": [dict(g) for g in state["param_groups"]]}


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class ParamService:
    """Dispatches wire ops onto lazily-created parameter stores.

    Stores are scoped by a ``session_id``: the first ``*_init`` of a
    new session id replaces the previous session's store, so a
    long-lived ``tmserver`` serves consecutive training sessions
    without inheriting stale state (a finished GOSGD session leaves its
    hub fully deactivated; EASGD/ASGD would otherwise resume a dead
    run's center).  Workers of ONE session — including other hosts —
    must share the id (the rule generates one and hands it to every
    worker client; multi-host operators pass ``--session-id``).

    ``device`` (default ``cuda``) is where the stores' arithmetic runs;
    the card is required when asked for.  GOSGD's hub keeps its in-flight
    payloads on the host."""

    def __init__(self, device: str | torch.device = "cuda"):
        from theanompi_tpu_torch.parallel.server import (
            ASGDServer,
            EASGDServer,
            GossipHub,
        )

        self.device = resolve_device(device)
        self._classes = {"easgd": EASGDServer, "asgd": ASGDServer,
                         "gosgd": GossipHub}
        self._stores: dict[str, Any] = {}
        self._sessions: dict[str, str] = {}
        self._init_lock = threading.Lock()

    def _fresh(self, kind: str, session_id: str) -> bool:
        """True if the caller's init should (re)create the store —
        first init of this session id wins; same-session peers join."""
        if self._sessions.get(kind) == session_id:
            return False
        self._sessions[kind] = session_id
        return True

    def _tensors(self, leaves) -> list[torch.Tensor]:
        return to_tensors(leaves, self.device)

    def easgd_init(self, params: Tensors, alpha: float, session_id: str):
        with self._init_lock:
            if self._fresh("easgd", session_id):
                self._stores["easgd"] = self._classes["easgd"](
                    self._tensors(params), alpha=alpha)

    def asgd_init(self, params: Tensors, opt_cfg: dict,
                  opt_state: dict | None, session_id: str):
        with self._init_lock:
            if self._fresh("asgd", session_id):
                store = self._classes["asgd"](self._tensors(params),
                                              dict(opt_cfg))
                if opt_state is not None:  # resume
                    store.set_opt_state(opt_state_from_wire(opt_state))
                self._stores["asgd"] = store

    def gosgd_init(self, n_workers: int, session_id: str):
        with self._init_lock:
            if self._fresh("gosgd", session_id):
                self._stores["gosgd"] = self._classes["gosgd"](n_workers)

    def rejoin(self, kind: str, session_id: str, payload):
        """Session fencing for a worker reconnecting after a transport
        failure (docs/RESILIENCE.md).  Three cases:

        * the service never lost the session → plain join;
        * the session was DISPLACED by a newer one → refuse (same
          fail-fast as ``_store`` — a rejoined worker must not train
          against a stranger's center);
        * the service itself restarted (fresh process, no sessions) →
          rebuild the store from the surviving worker's payload —
          EASGD: (params, alpha) re-seeds the center from the worker's
          last good params; ASGD: (params, opt_cfg) re-seeds center +
          a FRESH optimizer state (server momentum is lost across a
          service restart — documented); GOSGD: (n_workers,) — the hub
          holds only in-flight gossip, which dies with the service.
        A client with no rebuild payload yet (a joiner before its
        first exchange) raises; its retry loop keeps rejoining until a
        payload-bearing peer has rebuilt the store."""
        with self._init_lock:
            cur = self._sessions.get(kind)
            if cur == session_id:
                return "joined"
            if cur is not None:
                raise SessionDisplaced(
                    f"{kind} session {session_id!r} was displaced by "
                    f"{cur!r}; refusing rejoin (this training session "
                    "is stale)")
            if payload is None:
                raise RuntimeError(
                    f"{kind} session {session_id!r} is gone (service "
                    "restart) and this client has no rebuild payload; "
                    "waiting for a peer that does")
            if kind == "easgd":
                params, alpha = payload
                self._stores["easgd"] = self._classes["easgd"](
                    self._tensors(params), alpha=float(alpha))
            elif kind == "asgd":
                params, opt_cfg = payload
                self._stores["asgd"] = self._classes["asgd"](
                    self._tensors(params), dict(opt_cfg))
            elif kind == "gosgd":
                (n_workers,) = payload
                self._stores["gosgd"] = self._classes["gosgd"](
                    int(n_workers))
            else:
                raise ValueError(f"unknown store kind {kind!r}")
            self._sessions[kind] = session_id
            monitor.inc("service/session_rebuilds_total", kind=kind)
            print(f"[service] rebuilt {kind} session {session_id!r} "
                  "from a rejoining worker's payload", flush=True)
            return "rebuilt"

    def join(self, kind: str, session_id: str):
        """Cheap membership check for non-creator workers: validates
        the session exists WITHOUT re-shipping the init payload (N
        workers x full param tree would be redundant wire traffic)."""
        with self._init_lock:
            if self._sessions.get(kind) != session_id:
                raise RuntimeError(
                    f"{kind} session {session_id!r} is not active on this "
                    "service; the session creator must init first")

    def _store(self, kind: str, session_id: str):
        """Fail FAST when the caller's session was displaced by a newer
        init — silently serving the replacement store would corrupt
        both trainings."""
        store = self._stores.get(kind)
        if store is None:
            raise RuntimeError(f"{kind} store not initialized; a worker "
                               f"must send {kind}_init first")
        if self._sessions.get(kind) != session_id:
            raise RuntimeError(
                f"{kind} session {session_id!r} was displaced by session "
                f"{self._sessions.get(kind)!r}; this training session is "
                "stale (two sessions are sharing one service store)")
        return store

    # -- dispatch: store ops carry (op, session_id, *args) --

    def handle(self, op: str, *args):
        if op in ("easgd_init", "asgd_init", "gosgd_init", "join",
                  "rejoin"):
            return getattr(self, op)(*args)
        if op == "stats":
            out = {}
            if "easgd" in self._stores:
                out["n_exchanges"] = self._stores["easgd"].n_exchanges
            if "asgd" in self._stores:
                out["n_updates"] = self._stores["asgd"].n_updates
            return out
        if op == "ping":
            return "pong"
        if op not in self.SESSION_OPS:
            raise ValueError(f"unknown op {op!r}")
        if not args or not isinstance(args[0], str):
            raise ValueError(
                f"{op} requires (session_id, ...) — got {len(args)} args "
                "with no session id; the client may predate the "
                "session-scoped protocol")
        sid, *rest = args
        if op == "easgd_exchange":
            (params,) = rest
            return _np_out(self._store("easgd", sid).exchange(
                self._tensors(params)))
        if op == "easgd_exchange_n":
            mean, n = rest
            return _np_out(self._store("easgd", sid).exchange_n(
                self._tensors(mean), n))
        if op == "easgd_get_center":
            return _np_out(self._store("easgd", sid).get_center())
        if op == "asgd_push_pull":
            (grads,) = rest
            return _np_out(self._store("asgd", sid).push_pull(
                self._tensors(grads)))
        if op == "asgd_push_pull_n":
            grad_sum, n = rest
            return _np_out(self._store("asgd", sid).push_pull_n(
                self._tensors(grad_sum), n))
        if op == "asgd_set_lr":
            return self._store("asgd", sid).set_lr(*rest)
        if op == "asgd_get_center":
            return _np_out(self._store("asgd", sid).get_center())
        if op == "asgd_get_opt_state":
            return opt_state_to_wire(
                self._store("asgd", sid).get_opt_state())
        if op == "gosgd_push":
            dst, params, weight = rest
            return self._store("gosgd", sid).push(
                int(dst), to_tensors(params, "cpu"), float(weight))
        if op == "gosgd_drain":
            return [(_np_out(params), weight) for params, weight
                    in self._store("gosgd", sid).drain(*rest)]
        if op == "gosgd_deactivate":
            return self._store("gosgd", sid).deactivate(*rest)
        raise AssertionError(f"op {op!r} in SESSION_OPS but unhandled")

    #: ops that carry (session_id, *args) — validated before unpacking
    SESSION_OPS = frozenset({
        "easgd_exchange", "easgd_exchange_n", "easgd_get_center",
        "asgd_push_pull", "asgd_push_pull_n",
        "asgd_set_lr", "asgd_get_center", "asgd_get_opt_state",
        "gosgd_push", "gosgd_drain", "gosgd_deactivate",
    })

    #: latency-critical ops the RPC substrate routes to its control
    #: pool (parallel/rpc.py): a session rejoin during a restart storm
    #: must not queue behind a pool full of parked exchanges
    RPC_CONTROL_OPS = frozenset({"join", "rejoin", "stats"})


class _ServiceRpcHooks(rpc.RpcHooks):
    """The param-service plane's seams into the shared RPC substrate
    (``parallel/rpc.py``): literal ``service/*`` series names so the
    TM403/404 docs-coverage lint keeps seeing every emission, and the
    request-driven progress heartbeat."""

    plane = "service"

    def on_connect(self) -> None:
        monitor.add_gauge("service/clients", 1.0)

    def on_disconnect(self) -> None:
        monitor.add_gauge("service/clients", -1.0)

    def on_request(self, op: str, ms: float) -> None:
        monitor.inc("service/requests_total", op=op)
        monitor.observe("service/rpc_ms", ms, op=op)
        # served work IS this process's progress
        monitor.progress(phase="serving")

    def on_error(self, op: str) -> None:
        monitor.inc("service/errors_total", op=op)

    def on_negotiate(self, opts: wire.WireOptions) -> None:
        monitor.inc("service/wire_negotiations_total",
                    compression=opts.compression, dtype=opts.dtype)


def serve(host: str = "0.0.0.0", port: int = DEFAULT_PORT,
          ready_event: threading.Event | None = None,
          stop_event: threading.Event | None = None,
          authkey: bytes | None = None,
          service: ParamService | None = None,
          max_workers: int | None = None,
          device: str | torch.device = "cuda") -> None:
    """Run the service until a ``shutdown`` op (or ``stop_event``) —
    the param-service plane of the shared RPC substrate
    (``parallel/rpc.py``, its selector event loop).  ``host`` may be
    ``unix:/path`` (an AF_UNIX listener, ``port`` ignored).

    ``authkey=None`` reads ``THEANOMPI_TPU_SERVICE_KEY`` — generating,
    printing, and exporting a random key into this process's environment
    when unset (the export is how a same-process client or spawned
    worker inherits it).  Pass ``authkey`` explicitly to avoid the env
    mutation, e.g. when embedding a service thread in a worker that also
    talks to OTHER services under different keys.

    ``service`` overrides the dispatcher — ``parallel/shards.py`` runs
    this same loop over a ``ShardParamService`` (version-fenced shard
    of a partitioned center), ``ingest/reader.py`` over an
    ``IngestReader``, ``ingest/coordinator.py`` over a coordinator.
    ``max_workers`` caps the selector loop's executor pool; a service
    that knows its admission bound exposes it as ``RPC_MAX_WORKERS``
    (in-flight work, never connection count, bounds thread count).
    ``device`` places a default ``ParamService``'s arithmetic."""
    if service is None:
        service = ParamService(device=device)
    if authkey is None:
        authkey = _authkey(generate=True)
    if max_workers is None:
        max_workers = getattr(service, "RPC_MAX_WORKERS", None)
    # backlog=64: the stdlib default is 1, and on Linux a connect that
    # overflows the accept queue looks ESTABLISHED to the client while
    # the server never saw it — a burst of legitimate connects (an
    # ingest trainer fleet, K shard clients, a reconnecting worker
    # pool) must queue, not wedge.
    rpc.serve(service, host, port, ready_event=ready_event,
              stop_event=stop_event, authkey=authkey,
              hooks=_ServiceRpcHooks(),
              max_workers=max_workers, backlog=64)


# ---------------------------------------------------------------------------
# Clients — duck-type the in-process stores (parallel/server.py)
# ---------------------------------------------------------------------------


def _default_wire_retry() -> RetryPolicy:
    """The client reconnect policy (env-tunable): enough patience for
    a parameter-service restart (process relaunch ~seconds), bounded
    so a permanently-gone service still fails in finite time."""
    return RetryPolicy(
        max_attempts=int(os.environ.get(
            "THEANOMPI_TPU_SERVICE_RETRIES", "8")),
        base_delay=0.1, max_delay=2.0, multiplier=2.0, jitter=0.5,
        deadline_s=float(os.environ.get(
            "THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "30")),
        name="service_client")


class ServiceError(RuntimeError):
    """A server-side 'err' reply — the op reached the service and was
    rejected there, so reconnecting cannot fix it (never retried)."""


class SessionDisplaced(RuntimeError):
    """A rejoin refused because a NEWER session owns the store.  Its
    class name rides the wire in the err reply (the service prefixes
    every error with ``type(e).__name__``), giving the client a typed
    marker to classify on instead of prose."""


class FenceBusy(RuntimeError):
    """A ``shard_freeze`` refused because another reader's fence holds
    the shard (``parallel/shards.py``).  Like :class:`SessionDisplaced`
    the class name rides the wire in the err reply, so the fence loop
    can classify it as retryable without matching prose."""


class ShardNotReady(RuntimeError):
    """A ``shard_freeze`` hit a shard whose session store is not (yet)
    live — typically the freeze raced a shard restart, before any
    worker's rejoin has rebuilt that shard's leaf range.  Retryable
    (the fence loop backs off while a payload-bearing worker rebuilds
    the store); a genuinely dead session exhausts the fence's bounded
    attempts instead of failing on the first race."""


#: sentinel: "no reply received yet" in ServiceClient.call's retry loop
_PENDING = object()

#: ops whose server-side effect is a destructive one-shot (a drain
#: pops inboxes; a push deposits gossip weight): once the request has
#: been SENT, a lost reply must NOT trigger a re-send — re-applying
#: would double-deliver weight or silently discard a drained payload,
#: breaking GOSGD's sum-of-weights conservation.  These ops get
#: at-MOST-once delivery across transport failures; everything else
#: (elastic exchanges, grad pushes, reads, inits) tolerates
#: at-least-once.
AT_MOST_ONCE_OPS = frozenset({"gosgd_push", "gosgd_drain"})


class ServiceClient:
    """One persistent authenticated connection; thread-safe call()
    with reconnect-with-backoff (resilience.retry): a transport
    failure mid-call closes the connection, backs off, reconnects,
    lets the subclass re-establish its session (``_rejoin`` — see
    ``ParamService.rejoin`` on service-restart semantics), and
    re-sends.  Delivery is AT-LEAST-ONCE across transport failures
    for ops whose double-application the rules' arithmetic tolerates
    (one extra elastic pull / duplicate grad push), but AT-MOST-ONCE
    for ``AT_MOST_ONCE_OPS`` (gossip push/drain): once such a request
    has been sent, a lost reply raises instead of re-sending — the
    server may have applied the destructive op already, and a silent
    re-apply would corrupt GOSGD's gossip-weight conservation
    (docs/RESILIENCE.md).  Server-side errors (``ServiceError``) are
    never retried.  ``authkey=None`` requires
    ``THEANOMPI_TPU_SERVICE_KEY`` (raising BEFORE any network touch
    when unset — there is no default key)."""

    def __init__(self, address: str, authkey: bytes | None = None,
                 retry: RetryPolicy | None = None,
                 protocol: str | None = None,
                 wire_opts: wire.WireOptions | None = None,
                 transport: "rpc.MuxConnection | None" = None):
        #: ``(host, port)``, or the socket path of a ``unix:/path``
        self.address: Any = rpc.client_address(address)
        self._authkey = authkey if authkey is not None else _authkey()
        self._retry = retry if retry is not None else _default_wire_retry()
        protocol = protocol or os.environ.get(
            "THEANOMPI_TPU_WIRE_PROTOCOL", "v2")
        if protocol not in ("v1", "v2"):
            raise ValueError(f"protocol must be 'v1' or 'v2', "
                             f"got {protocol!r}")
        self._want_v2 = protocol == "v2"
        self._wire_opts = (wire_opts if wire_opts is not None
                           else wire.WireOptions.from_env())
        #: negotiated per-connection: None = v1 pickle
        self._wire: wire.WireOptions | None = None
        #: trace grant from the hello: only then does _call_once wrap
        #: requests in the wire.TRACE_OP context envelope
        self._trace = False
        #: offer the shared-memory payload lane at hello time; a typed
        #: ShmRefusal flips this off and the client silently retries
        #: in-band (the lane's degradation contract)
        self._shm_on = True
        #: the lane channel THIS client negotiated (None when riding a
        #: mux transport, whose shared channel the transport owns)
        self._own_shm: "shm.ShmChannel | None" = None
        self._lock = threading.Lock()
        #: optional shared multiplexed transport (parallel/rpc.py):
        #: this client becomes one logical stream on the transport's
        #: socket instead of owning a socket — K clients to one peer
        #: then cost one fd and ONE reader thread between them.  The
        #: transport already negotiated wire options per-connection;
        #: against a non-mux server it silently hands back dedicated
        #: sockets and this client behaves exactly as before.
        self._transport = transport
        self._connect()

    def _connect(self) -> None:
        """(Re)establish the underlying conn + negotiated options."""
        if self._transport is not None:
            with self._lock:
                self._conn, pre = self._transport.connect_stream()
            if pre is not None:  # mux stream: negotiation is inherited
                if not self._want_v2:
                    raise ValueError(
                        "protocol='v1' cannot ride a multiplexed "
                        "transport — mux streams are wire-v2 framed")
                self._wire = pre
                self._trace = self._transport.trace
                return
        else:
            with self._lock:
                # guarded_by: self._lock
                self._conn = rpc.connect_client(self.address, self._authkey)
                rpc.set_nodelay(self._conn)
        self._negotiate()

    # -- transport -----------------------------------------------------

    @property
    def wire_protocol(self) -> str:
        """The protocol this connection actually negotiated."""
        return "v2" if self._wire is not None else "v1"

    def _negotiate(self) -> None:
        """Version negotiation at handshake time: one v1-pickled
        ``wire_hello`` round-trip.  A v2 server confirms and the
        connection switches to framed mode; a legacy server answers
        "unknown op" and the connection stays on v1 pickle — the
        fallback is silent by design (old tmservers keep working)."""
        self._wire = None
        self._trace = False
        self._own_shm = None
        if not self._want_v2:
            return
        offer = shm.client_offer() if self._shm_on else None
        with self._lock:
            self._conn.send((wire.HELLO_OP,
                             wire.hello_payload(self._wire_opts,
                                                shm_offer=offer)))
            status, payload = rpc.recv_deadline(self._conn)
        if (status == "ok" and isinstance(payload, dict)
                and payload.get("version") == wire.WIRE_VERSION):
            # a legacy server's reply simply omits "shm" and the lane
            # stays off — the same silent degradation as trace below
            self._own_shm = shm.client_channel(offer, payload)
            self._wire = wire.WireOptions(
                compression=payload.get("compression", "none"),
                dtype=payload.get("dtype", "f32"),
                allow_pickle=self._wire_opts.allow_pickle,
                shm=self._own_shm)
            # absent from a legacy server's reply — trace propagation
            # degrades silently, like compression/dtype
            self._trace = bool(payload.get("trace"))

    def _reconnect(self) -> None:
        ch, self._own_shm = self._own_shm, None
        if ch is not None:
            # leases of the dying connection must not wait out the
            # timeout; a shared mux channel is NOT ours to close
            ch.close()
        with self._lock:
            try:
                self._conn.close()
            except OSError:
                pass
        # the negotiation is per-connection (or per-transport) state —
        # _connect redoes it; a dead mux transport is re-established
        # by connect_stream inside
        self._connect()

    def _rejoin(self) -> None:
        """Subclass hook: re-establish server-side session state after
        a reconnect (the base client is session-less)."""

    def _call_once(self, op: str, *args):
        """One send/recv on the current connection; raises transport
        errors (retryable) or ServiceError (not).  Transport errors
        are tagged with whether the request had already been SENT —
        the retry loop needs it to keep AT_MOST_ONCE_OPS from being
        re-applied after a lost reply."""
        msg = (op, *args)
        if self._trace:
            # the caller's open span (or attached remote context)
            # becomes the server-side parent; nothing open -> plain
            # message, and the envelope is never sent without the
            # hello grant, so legacy servers never see TRACE_OP
            ctx = trace.inject()
            if ctx is not None:
                msg = (wire.TRACE_OP, ctx, *msg)
        with self._lock:
            sent = False
            try:
                if self._wire is not None:
                    wire.send_msg(self._conn, msg, self._wire)
                    sent = True
                    status, payload = wire.recv_msg(self._conn,
                                                    self._wire)
                else:
                    self._conn.send(msg)
                    sent = True
                    status, payload = self._conn.recv()
            except CONNECTION_ERRORS as e:
                # WireDecodeError lands here too (it subclasses
                # ConnectionError): a garbled reply stream is recovered
                # exactly like a dropped connection — reconnect,
                # renegotiate, re-send (at-most-once ops excepted)
                e._tm_sent = sent
                raise
        if status != "ok":
            raise ServiceError(f"service error for {op}: {payload}")
        return payload

    def call(self, op: str, *args):
        # fault plane (no-op without a plan): 'drop' synthesizes a
        # transport failure below so the Kth RPC exercises the real
        # reconnect path; 'delay' sleeps in fire(); 'raise' propagates
        fault = faults.fire("service_call", op=op)
        # byte/latency accounting only when telemetry is live: the
        # tree walk is cheap but not free, and the disabled path must
        # stay a pure transport
        mon = monitor.enabled()
        if mon:
            t0 = time.monotonic()
            monitor.inc("service/client_bytes_sent",
                        monitor.tree_bytes(args), op=op)
        t_start = time.monotonic()
        last: BaseException | None = None
        needs_rejoin = False
        payload = _PENDING
        for attempt in range(self._retry.max_attempts):
            if attempt:
                deadline = self._retry.deadline_s
                if (deadline is not None
                        and time.monotonic() - t_start > deadline):
                    break
                time.sleep(self._retry.delay(attempt - 1))
            try:
                if needs_rejoin:
                    # re-establish transport AND session before
                    # re-sending; a failure here (service still down,
                    # or the store not rebuilt yet — a payload-bearing
                    # peer may rebuild it any moment) re-enters the
                    # retry loop rather than sending an op the server
                    # must reject
                    self._reconnect()
                    self._rejoin()
                    needs_rejoin = False
                if fault == "drop":
                    fault = None  # drop once, then the retry proceeds
                    raise ConnectionResetError(
                        "injected service_call drop (fault plan)")
                payload = self._call_once(op, *args)
                break
            except ServiceError as e:
                if wire.ShmRefusal.__name__ in str(e):
                    # the server refused shm content in OUR frame (its
                    # lane state is gone — restart, swept lease, ...):
                    # the op never dispatched, so re-sending is safe
                    # even for at-most-once ops.  Disable the lane and
                    # reconnect in-band — silent degradation, never a
                    # caller-visible failure.
                    self._disable_shm()
                    last = e
                    needs_rejoin = True
                    monitor.inc("service/client_reconnects_total",
                                op=op)
                    continue
                if needs_rejoin:
                    # typed marker: the service prefixes every err
                    # reply with the exception class name, so this
                    # matches SessionDisplaced, not prose wording
                    if SessionDisplaced.__name__ in str(e):
                        # permanent: this session is stale (a newer
                        # one owns the store) — retrying would only
                        # dress a session error up as a network one
                        raise
                    last = e  # store not rebuilt yet — keep rejoining
                    continue
                if mon:
                    monitor.inc("service/client_errors_total", op=op)
                raise
            except CONNECTION_ERRORS as e:
                if isinstance(e, wire.ShmRefusal):
                    # the REPLY carried shm content this side must
                    # refuse — drop the lane before reconnecting so
                    # the re-negotiation omits the offer
                    self._disable_shm()
                if (op in AT_MOST_ONCE_OPS
                        and getattr(e, "_tm_sent", False)):
                    # the request reached the wire and the REPLY was
                    # lost: the server may have applied this
                    # destructive op already — surfacing beats
                    # silently corrupting gossip-weight conservation
                    raise ConnectionError(
                        f"reply lost for non-idempotent {op}; not "
                        "re-sending (the server may have applied it "
                        f"already): {e}") from e
                last = e
                needs_rejoin = True
                monitor.inc("service/client_reconnects_total", op=op)
        if payload is _PENDING:  # attempts or deadline exhausted
            elapsed = time.monotonic() - t_start
            if isinstance(last, ServiceError):
                # the TRANSPORT recovered; what never came back was
                # the session store — name the real problem
                raise ServiceError(
                    f"session not re-established for {op} after "
                    f"{elapsed:.1f}s: {last}") from last
            raise ConnectionError(
                f"service at {self.address} unreachable for {op} "
                f"after {elapsed:.1f}s: {last}") from last
        if mon:
            monitor.inc("service/client_bytes_recv",
                        monitor.tree_bytes(payload), op=op)
            monitor.observe("service/client_rpc_ms",
                            (time.monotonic() - t0) * 1e3, op=op)
        return payload

    def _disable_shm(self) -> None:
        """Silently degrade to in-band frames: the next (re)connect
        omits the shm offer.  A shared mux transport drops its lane
        for every sibling stream — it cannot renegotiate per stream —
        and their owners reconnect through their own retry loops."""
        self._shm_on = False
        if self._transport is not None:
            self._transport.disable_shm()

    def close(self) -> None:
        ch, self._own_shm = self._own_shm, None
        if ch is not None:
            ch.close()  # release leases the peer never acked
        # Deliberately does NOT take self._lock: an RPC thread wedged
        # in a blocking v1 recv holds the lock indefinitely, and
        # closing the fd out from under it is the only way another
        # thread can unstick it (the recv raises OSError/EOFError and
        # the retry loop surfaces it).  Liveness beats tidiness here.
        try:
            self._conn.close()  # lint: ok TM101
        except OSError:
            pass


class ShardedServiceClient:
    """Client-side shard router (docs/DESIGN.md "Sharded
    parameter service"): K per-shard session clients — each its own
    authenticated connection, :class:`RetryPolicy`, and rejoin state,
    so a single shard's restart is recovered exactly like the tested
    single-server restart matrix, re-seeding ONLY that shard's leaf
    range — plus the concurrency plumbing the subclasses
    (``parallel/shards.py`` ShardedEASGD / ShardedASGD, which own the
    tree partitioning) build on:

    * :meth:`_scatter` issues one sub-call per shard on dedicated
      exchange threads (``parallel/pipe.py`` — the same thread
      discipline the async rules' overlap plane uses) and collects ALL
      K results before re-raising the first failure, so a dead shard
      can never leave a sibling's sub-exchange dangling on the pipes'
      bounded-staleness barrier;
    * :meth:`fenced_read` is the cross-shard version fence — the
      two-phase consistent cut checkpoint/export reads through:
      **freeze** every shard (each blocks new exchanges and drains its
      in-flight one, returning its per-client vector clock), compare
      the clocks, and only **read + release** when they all agree.  A
      mismatch means some worker's full-tree exchange straddled the
      freeze (applied on one shard, still pending on another); the
      fence releases everything, backs off, and retries, so a
      checkpoint can never capture shard A after exchange E and shard
      B before it.

    Mutating sub-calls carry a ``(client_id, seq)`` tag — one ``seq``
    per FULL-tree operation, shared by all K sub-calls — which is what
    makes the vector clocks comparable across shards.  Delivery
    semantics are unchanged from the single-center client: elastic
    exchanges and grad pushes stay at-least-once across transport
    failures (a re-sent duplicate re-applies, exactly as documented
    for :class:`ServiceClient`), and the vector clock's per-client max
    keeps a duplicate from reading as a new exchange."""

    def __init__(self, shard_clients: list, kind: str, session_id: str,
                 transports: list | None = None):
        if not shard_clients:
            raise ValueError("need at least one shard client")
        self._shard_clients = list(shard_clients)
        self._kind = kind
        self._sid = str(session_id)
        #: optional per-shard rpc.MuxConnection transports shared by
        #: the data client and the fence client of each shard — one
        #: socket per PEER where granted.  Safe precisely because the
        #: selector loop routes shard_freeze/release (and the fenced
        #:  read/write ops) to its control pool: a freeze-parked
        #: mutation parks an executor worker, never the connection's
        #: read loop, so the fence no longer needs its own SOCKET to
        #: dodge head-of-line blocking — only its own stream.
        self._transports = list(transports) if transports else None
        #: tags this router's mutations in every shard's vector clock
        self._client_id = uuid.uuid4().hex
        self._router_lock = make_lock("ShardedServiceClient._router_lock")
        self._seq = 0        # guarded_by: self._router_lock
        self._pipes = None   # guarded_by: self._router_lock
        # the fence runs over its OWN control connections: a mutation
        # blocked by the freeze parks its connection's server handler
        # thread in fence admission, so freeze/read/release sharing
        # that connection would queue BEHIND the very exchange the
        # fence is holding back — head-of-line deadlock until the
        # fence auto-expires, and a read that then observes post-
        # freeze state (caught by the test suite's torn-cut pin)
        self._fence_clients: list[ServiceClient | None] = \
            [None] * len(shard_clients)  # guarded_by: self._router_lock

    @property
    def n_shards(self) -> int:
        return len(self._shard_clients)

    @property
    def wire_protocol(self) -> str:
        """Negotiated protocol (shards negotiate independently but
        from one env/default, so shard 0 speaks for the fleet)."""
        return self._shard_clients[0].wire_protocol

    # -- concurrent scatter/gather ------------------------------------

    def _next_seq(self) -> int:
        with self._router_lock:
            self._seq += 1
            return self._seq

    def _ensure_pipes(self) -> list:
        from theanompi_tpu_torch.parallel.pipe import _ExchangePipe

        with self._router_lock:
            if self._pipes is None:
                # lazily: a client used only for fenced reads (the
                # EASGD orchestrator) never spins exchange threads
                self._pipes = [
                    _ExchangePipe(lambda thunk: thunk(), "shard", i,
                                  span="shard_exchange")
                    for i in range(len(self._shard_clients))]
            return self._pipes

    def _reset_pipes(self) -> None:
        """Drop the exchange threads after a scatter failure: the
        pipes' sticky-error discipline is right for a worker loop (the
        supervisor rebuilds the whole client) but this router object
        may outlive the failure (the rule's creator handle does), so
        the next scatter gets fresh pipes instead of a poisoned
        barrier."""
        with self._router_lock:
            pipes, self._pipes = self._pipes, None
        for p in pipes or ():
            p.close()

    def _scatter(self, thunks: list):
        """Run one thunk per shard concurrently (each on its shard's
        exchange thread); returns results in shard order.  Collects
        every in-flight sub-call before re-raising the first failure."""
        pipes = self._ensure_pipes()
        for pipe, thunk in zip(pipes, thunks):
            pipe.submit(thunk)
        outs: list = []
        first_err: BaseException | None = None
        for pipe in pipes:
            try:
                _, out = pipe.collect()
                outs.append(out)
            except BaseException as e:
                outs.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            self._reset_pipes()
            raise first_err
        return outs

    # -- the cross-shard version fence --------------------------------

    def _fence_client(self, i: int) -> "ServiceClient":
        """The shard's dedicated control connection (lazy — a client
        that never fences opens no extra sockets)."""
        with self._router_lock:
            c = self._fence_clients[i]
        if c is None:
            c = ServiceClient(
                rpc.address_string(self._shard_clients[i].address),
                transport=(self._transports[i]
                           if self._transports else None))
            with self._router_lock:
                if self._fence_clients[i] is None:
                    self._fence_clients[i] = c
                else:  # lost a benign race; keep the first
                    c.close()
                    c = self._fence_clients[i]
        return c

    def fenced_read(self, read_op: str, max_attempts: int = 100):
        """Two-phase consistent cut over ``read_op`` (see
        :meth:`fenced_op`)."""
        return self.fenced_op(read_op, max_attempts=max_attempts)

    def fenced_op(self, op: str, *args, max_attempts: int = 100):
        """Two-phase consistent cut (class docstring): freeze all →
        compare vector clocks → run ``op`` on every shard →
        RE-VALIDATE → release, retrying on a straddling exchange, a
        concurrent reader's fence, or a shard mid-restart.  Returns
        ``(per-shard results in shard order, the cut's vector
        clock)``.

        ``op`` may also be a fleet-wide WRITE that must not interleave
        with any client's K-way scatter (ShardedASGD's ``set_lr``: a
        mid-broadcast push would apply with the old lr on some leaf
        ranges and the new lr on others — the single-center store
        serializes the two under one lock, and the fence is that
        lock's distributed form).  Such an op must be idempotent: a
        failed validation re-runs it on the next attempt.

        Two hardening rules beyond the happy path:

        * **Post-read validation.**  A fence the reader held too long
          auto-expires server-side (a dead reader must not wedge
          training), which could let a mutation slip onto a shard read
          later in the loop — a torn cut presented as consistent.  So
          after the reads, every shard is re-frozen with the SAME
          token and BOTH its vector clock and its applied-mutation
          counter compared to the pre-read ones; any drift discards
          the attempt.  The counter matters because the clock alone is
          blind to an at-least-once DUPLICATE re-apply (recorded as
          per-client max seq) slipping through an expired fence.  A
          cut is returned only when no mutation landed anywhere
          between first freeze and validation.
        * **Stable-divergence acceptance.**  Exact clock equality can
          become permanently unreachable: a client that died mid-
          scatter leaves its (client, seq) on some shards forever, and
          a restarted shard loses entries for clients that never
          exchange again.  A PENDING straddler applies within the
          release window between attempts (admission is notified on
          release), so clocks that stay bitwise-identical across 3
          consecutive frozen observations — with released windows
          between — are dead history, not in-flight work: the cut is
          accepted (``service/shard_fence_divergence_total``) with the
          per-client max clock.  The frozen state itself is still
          validated mutation-free; what is lost is only the claim that
          the dead client's partial op never happened — the system
          state already includes it, permanently.
        """
        token = uuid.uuid4().hex
        t0 = time.monotonic()
        last: BaseException | None = None
        n = self.n_shards
        prev_clocks: list | None = None
        stable = 0

        def freeze(i: int):
            return self._fence_client(i).call(
                "shard_freeze", self._kind, self._sid, token)

        for attempt in range(max_attempts):
            if attempt:
                # jittered to de-synchronize from a fixed exchange
                # cadence; short because the straddler completes as
                # soon as the release lands
                time.sleep(min(0.25, 0.005 * (1 << min(attempt, 5)))
                           * (0.5 + (hash((token, attempt)) % 100) / 100))
            err, infos = self._fanout(freeze)
            if err is not None:
                self._release(token)
                if self._fence_retryable(err):
                    last = err  # another reader's fence, a shard mid-
                    continue    # restart, or a connect refused while
                                # the process group relaunches it
                raise err
            clocks = [info["vclock"] for info in infos]
            applied = [info.get("applied") for info in infos]
            consistent = all(vc == clocks[0] for vc in clocks)
            if not consistent:
                stable = stable + 1 if clocks == prev_clocks else 0
                prev_clocks = clocks
                if stable < 2:
                    self._release(token)
                    monitor.inc("service/shard_fence_retries_total")
                    continue
                monitor.inc("service/shard_fence_divergence_total")
            try:
                op_err, outs = self._fanout(
                    lambda i: self._fence_client(i).call(op, self._sid,
                                                         *args))
                if op_err is None:
                    # post-op validation: re-freeze with the same
                    # token; drifted clocks OR applied counters mean an
                    # expired fence let a mutation (possibly a
                    # clock-invisible duplicate) through mid-op —
                    # discard the torn cut
                    op_err, post = self._fanout(freeze)
            finally:
                self._release(token)
            if op_err is not None:
                if self._fence_retryable(op_err):
                    last = op_err
                    continue
                raise op_err
            if ([p["vclock"] for p in post] != clocks
                    or [p.get("applied") for p in post] != applied):
                prev_clocks, stable = None, 0  # live mutator: not dead
                monitor.inc("service/shard_fence_retries_total")
                last = RuntimeError("fence expired mid-operation")
                continue
            monitor.observe("service/shard_fence_ms",
                            (time.monotonic() - t0) * 1e3)
            if consistent:
                return outs, clocks[0]
            merged: dict = {}
            for vc in clocks:
                for cid, seq in vc.items():
                    merged[cid] = max(seq, merged.get(cid, 0))
            return outs, merged
        raise RuntimeError(
            f"no consistent cut across {n} shards after "
            f"{max_attempts} freeze attempts "
            f"({time.monotonic() - t0:.1f}s): {last}")

    @staticmethod
    def _fence_retryable(e: BaseException) -> bool:
        """Fence-loop errors worth another attempt: another reader's
        fence, a shard whose store is mid-rejoin, or a transport
        failure (incl. a connect refused while the process group is
        relaunching the shard — ServiceClient construction has no
        retry of its own)."""
        if isinstance(e, ServiceError):
            return (FenceBusy.__name__ in str(e)
                    or ShardNotReady.__name__ in str(e))
        return isinstance(e, CONNECTION_ERRORS)

    def _fanout(self, fn) -> tuple[BaseException | None, list]:
        """Run ``fn(i)`` for every shard concurrently; returns (first
        error or None, per-shard results).  Used for the freeze /
        read / validate sweeps so the fence-hold time — during which
        every shard's mutations are parked — is ONE shard's latency,
        not the sum, and so a worker's K-way scatter has the smallest
        possible window to straddle the freeze."""
        n = self.n_shards
        outs: list = [None] * n
        errs: list = [None] * n
        # captured on the calling thread so every per-shard RPC stays
        # inside the caller's trace instead of rooting its own
        ctx = trace.capture()

        def run(i: int) -> None:
            try:
                with trace.attach_wire(ctx):
                    outs[i] = fn(i)
            except BaseException as e:
                errs[i] = e

        threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                    name=f"shard-fence-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return next((e for e in errs if e is not None), None), outs

    def _release(self, token: str) -> None:
        """Best-effort concurrent release of every shard: releasing a
        token a shard never froze is a server-side no-op, and an
        unreachable shard auto-expires its fence (ShardParamService
        fence timeout)."""
        def rel(i: int):
            try:
                return self._fence_client(i).call(
                    "shard_release", self._kind, self._sid, token)
            except Exception:
                return None

        self._fanout(rel)

    def close(self) -> None:
        self._reset_pipes()
        with self._router_lock:
            fence, self._fence_clients = (list(self._fence_clients),
                                          [None] * self.n_shards)
        for c in fence:
            if c is not None:
                c.close()
        for c in self._shard_clients:
            c.close()
        for t in self._transports or ():
            if t is not None:
                t.close()


def _device_of(values: Tensors) -> torch.device:
    """Where a reply goes: the device of the caller's tensors (the CPU
    for numpy input)."""
    values = list(values)
    if values and torch.is_tensor(values[0]):
        return values[0].device
    return torch.device("cpu")


class RemoteEASGD(ServiceClient):
    """EASGDServer API over the wire (rules/async_rules.py EASGD).

    ``session_id`` scopes the server-side store: the session CREATOR
    passes ``params`` (a list of tensors in the stores' order; first
    init of a new id creates the center; a later id replaces a finished
    session's store); additional worker clients of the same session pass
    ``params=None`` to join without re-shipping the parameters.  Every
    subsequent op carries the id — a displaced session fails fast
    instead of training against a stranger's center.  Replies are new
    tensors on the caller's device (:func:`to_tensors`).
    """

    def __init__(self, address: str, params: Tensors | None, alpha: float,
                 session_id: str = "default", transport=None):
        super().__init__(address, transport=transport)
        self._sid = str(session_id)
        self._alpha = float(alpha)
        # rebuild payload for a rejoin after a SERVICE restart: the
        # creator's init params, refreshed with every exchange result
        # (a joiner has none until its first exchange — its rejoin
        # waits for a payload-bearing peer, see ParamService.rejoin)
        self._rebuild = None if params is None else host_arrays(params)
        if params is None:
            self.call("join", "easgd", self._sid)
        else:
            self.call("easgd_init", self._rebuild, self._alpha, self._sid)

    def _rejoin(self) -> None:
        self._call_once(
            "rejoin", "easgd", self._sid,
            None if self._rebuild is None
            else (self._rebuild, self._alpha))

    def exchange(self, worker_params: Tensors) -> list[torch.Tensor]:
        out = self.call("easgd_exchange", self._sid,
                        host_arrays(worker_params))
        self._rebuild = out
        return to_tensors(out, _device_of(worker_params))

    def exchange_n(self, worker_mean: Tensors, n: int) -> list[torch.Tensor]:
        """Aggregated exchange (parallel/aggregate.py): one wire round
        trip for n co-located workers; returns the PRE-update center
        (see ``EASGDServer.exchange_n``) — a legitimate rebuild
        payload, so a post-aggregate rejoin re-seeds from it."""
        out = self.call("easgd_exchange_n", self._sid,
                        host_arrays(worker_mean), int(n))
        self._rebuild = out
        return to_tensors(out, _device_of(worker_mean))

    def get_center(self) -> list[torch.Tensor]:
        """A host copy of the center."""
        return to_tensors(self.call("easgd_get_center", self._sid), "cpu")

    @property
    def n_exchanges(self) -> int:
        return int(self.call("stats").get("n_exchanges", 0))


class RemoteASGD(ServiceClient):
    """ASGDServer API over the wire (see RemoteEASGD on sessions).
    ``opt_cfg`` is the model's ``optimizer_hyperparams()``; ``opt_state``
    a restored optimizer state dict (ASGD resume)."""

    def __init__(self, address: str, params: Tensors | None, opt_cfg: dict,
                 opt_state: dict | None = None,
                 session_id: str = "default", transport=None):
        super().__init__(address, transport=transport)
        self._sid = str(session_id)
        self._opt_cfg = dict(opt_cfg)
        # rebuild payload: latest known CENTER (init params, refreshed
        # by every push_pull reply).  A rejoin after a service restart
        # re-seeds the center from it with a fresh optimizer state —
        # server momentum does not survive a service restart.
        self._rebuild = None if params is None else host_arrays(params)
        if params is None:
            self.call("join", "asgd", self._sid)
        else:
            self.call("asgd_init", self._rebuild, self._opt_cfg,
                      None if opt_state is None
                      else opt_state_to_wire(opt_state), self._sid)

    def _rejoin(self) -> None:
        self._call_once(
            "rejoin", "asgd", self._sid,
            None if self._rebuild is None
            else (self._rebuild, self._opt_cfg))

    def push_pull(self, grads: Tensors) -> list[torch.Tensor]:
        out = self.call("asgd_push_pull", self._sid, host_arrays(grads))
        self._rebuild = out
        return to_tensors(out, _device_of(grads))

    def push_pull_n(self, grad_sum: Tensors, n: int) -> list[torch.Tensor]:
        """Aggregated grad push (parallel/aggregate.py): the delta-sum
        of n co-located workers' pushes in one wire round trip; the
        reply is the fresh center (see ``ASGDServer.push_pull_n``)."""
        out = self.call("asgd_push_pull_n", self._sid,
                        host_arrays(grad_sum), int(n))
        self._rebuild = out
        return to_tensors(out, _device_of(grad_sum))

    def set_lr(self, lr: float) -> None:
        self.call("asgd_set_lr", self._sid, float(lr))

    def get_center(self) -> list[torch.Tensor]:
        return to_tensors(self.call("asgd_get_center", self._sid), "cpu")

    def get_opt_state(self) -> dict:
        return opt_state_from_wire(
            self.call("asgd_get_opt_state", self._sid))

    @property
    def n_updates(self) -> int:
        return int(self.call("stats").get("n_updates", 0))


class RemoteGossipHub(ServiceClient):
    """GossipHub API over the wire.  ``rank_offset`` maps this host's
    local worker ranks onto the global gossip rank space when several
    hosts share one hub (see RemoteEASGD on sessions; gosgd_init is
    payload-free so every client may send it).  ``drain`` returns host
    tensors (the merge moves them to the receiver's device)."""

    def __init__(self, address: str, n_workers: int, rank_offset: int = 0,
                 session_id: str = "default", transport=None):
        super().__init__(address, transport=transport)
        self._sid = str(session_id)
        self.n_workers = n_workers
        self.rank_offset = rank_offset
        self.call("gosgd_init", int(n_workers), self._sid)

    def _rejoin(self) -> None:
        # always rebuildable: the hub holds only in-flight gossip,
        # which legitimately dies with the service
        self._call_once("rejoin", "gosgd", self._sid,
                        (int(self.n_workers),))

    def push(self, dst: int, params: Tensors, weight: float) -> bool:
        return self.call("gosgd_push", self._sid, int(dst),
                         host_arrays(params), float(weight))

    def drain(self, rank: int) -> list[tuple[list[torch.Tensor], float]]:
        return [(to_tensors(params, "cpu"), float(weight))
                for params, weight in self.call(
                    "gosgd_drain", self._sid, int(rank + self.rank_offset))]

    def deactivate(self, rank: int) -> None:
        self.call("gosgd_deactivate", self._sid,
                  int(rank + self.rank_offset))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.parallel.service",
        description="the async rules' parameter service (PyTorch port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default="cuda",
                    help="where the stores' arithmetic runs: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)
    service = ParamService(device=args.device)
    print(f"[service] listening on {args.host}:{args.port} "
          f"(device {service.device})", flush=True)
    # telemetry for a standalone service process: request counters,
    # per-op latency, connected-client gauge, heartbeat — activated by
    # $THEANOMPI_TPU_MONITOR (no-op otherwise).  The stall watchdog is
    # disabled (inf): a server's progress is request-driven, and an
    # idle service is healthy, not stuck — progress_age_s in the
    # heartbeat still shows time since the last served request.
    # distinct file suffix: a tmserver sharing THEANOMPI_TPU_MONITOR
    # with a trainer on the same host must not clobber rank0's files
    with monitor.session(stall_after=float("inf"),
                         name=f"service{os.getpid()}"):
        monitor.progress(phase="serving")
        serve(args.host, args.port, service=service)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
