"""Front-door router: one client stream, two fleets.

Counterpart of ``theanompi_tpu/frontdoor/router.py``.  The router ends
client ``generate`` streams and splits each across the disaggregated
roles: the prompt phase goes to a PREFILL replica
(``frontdoor/prefill.py``), the filled KV pages come back as raw wire
frames, and the token phase ships pages and manifest to a DECODE
replica's ``adopt`` op (``serving/server.py``).  One RPC per phase, so a
stream's decode leg stays on the backend that adopted its pages.  The
router forwards the page bytes verbatim and holds no model: it never
touches a device.

Every backend is ONE :class:`~theanompi_tpu_torch.parallel.rpc.
MuxConnection` (one socket, one reader thread) carrying a pool of
:class:`ServiceClient` streams, so a hundred concurrent streams to a
backend cost one socket.

Failures, per leg:

* **Overloaded** (typed, a backend's admission bound): try the next live
  backend of that role, once each; when every one sheds, the router
  sheds too and the client gets the typed ``Overloaded``.
* **Transport loss on the decode leg** (a replica died mid-stream):
  FAILOVER, re-prefill from the prompt (the manifest carries it) and
  adopt onto a survivor.  The adopt RPC returns the whole stream at
  once, so no token was delivered before the loss, and greedy decode
  makes the retried stream identical.  Port-only: a failover tries the
  backends that have not lost this stream first, and a transport loss
  also drops the backend's pooled clients (they rode the lost
  connection); JAX's router may send a failover back to the replica
  that just died and reuses the stale clients, so one dead replica could
  spend a stream's whole failover budget.
* **IncompatiblePages / ValueError** (typed refusals): passed to the
  client untouched.

Backend sets change at run time (``set_backends``, the autoscaler's
seam): a removed backend DRAINS (no new streams route to it, in-flight
streams finish, the last one out closes it), and the autoscaler kills
the process only once the router counts zero streams on it.  A decode
backend told to drain hands its live streams back as
``MigratedStream`` payloads, which the router adopts onto a survivor and
stitches (at most 8 migrations a stream).

Trace context rides the substrate's envelopes: the client's span
parents the router's dispatch span, whose context every backend RPC
carries, so ``tools/traces.py`` stitches client, router, prefill and
decode from one collector file.

Launch: ``python -m theanompi_tpu_torch.frontdoor.router --prefill
H:P,... --decode H:P,...`` for a bare router over running fleets;
``frontdoor/fleet.py`` spawns whole fleets and runs the router in its
own process.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock
from theanompi_tpu_torch.decode.migrate import IncompatiblePages
from theanompi_tpu_torch.frontdoor.prefill import PrefillClient
from theanompi_tpu_torch.parallel import rpc
from theanompi_tpu_torch.parallel.service import ServiceClient, ServiceError
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.resilience.retry import CONNECTION_ERRORS, RetryPolicy
from theanompi_tpu_torch.serving.batcher import Overloaded
from theanompi_tpu_torch.serving.server import InferenceClient

#: one above the prefill role's 45950
DEFAULT_PORT = 46000

#: the two downstream roles a router balances over
ROLES = ("prefill", "decode")

#: migrations of one stream before the router gives up on it
MAX_MIGRATIONS = 8


def _backend_retry() -> RetryPolicy:
    """Backend RPCs fail fast: the router owns recovery (next backend,
    re-prefill failover), so the transport must not sit in a reconnect
    loop against a replica the autoscaler just killed."""
    return RetryPolicy(max_attempts=1, name="frontdoor-backend")


class _Backend:
    """One downstream replica: a shared mux transport and a client pool.

    A client serializes its own ``call`` (one concurrent stream needs one
    client), so the pool hands each stream a private client riding the
    backend's single multiplexed socket."""

    def __init__(self, role: str, addr: str):
        self.role = role
        self.addr = addr
        self._cls = PrefillClient if role == "prefill" else InferenceClient
        self._lock = make_lock("frontdoor._Backend._lock")
        self._mux: rpc.MuxConnection | None = None  # guarded_by: self._lock
        self._free: list = []      # guarded_by: self._lock
        self.streams = 0           # guarded_by: self._lock
        self.draining = False      # guarded_by: self._lock
        self.errors = 0            # guarded_by: self._lock

    def _transport(self) -> rpc.MuxConnection:
        with self._lock:
            mux = self._mux
        if mux is not None:
            return mux
        mux = rpc.MuxConnection(self.addr)      # network IO: no lock
        with self._lock:
            if self._mux is None:
                self._mux = mux
                return mux
            extra = mux
        extra.close()
        return self._transport()

    def acquire(self):
        """A client for one stream (pooled), counting the stream in."""
        with self._lock:
            self.streams += 1
            if self._free:
                return self._free.pop()
        try:
            return self._cls(self.addr, transport=self._transport(),
                             retry=_backend_retry())
        except BaseException:
            with self._lock:
                self.streams -= 1
            raise

    def release(self, client, ok: bool) -> bool:
        """Return a stream's client; a transport-broken one is closed, not
        pooled, and so are the pooled ones: their streams rode the same
        lost connection (the transport reconnects for fresh clients).
        True when this was a draining backend's LAST stream: the caller
        then closes the backend."""
        stale = []
        with self._lock:
            self.streams -= 1
            if not ok:
                self.errors += 1
                stale, self._free = self._free, []
            if ok and not self.draining:
                self._free.append(client)
                return False
            draining = self.draining
            last = draining and self.streams == 0
        for c in (client, *stale):
            try:
                c.close()
            except Exception:
                pass
        return last

    def close(self) -> None:
        with self._lock:
            free, self._free = self._free, []
            mux, self._mux = self._mux, None
        for c in free:
            try:
                c.close()
            except Exception:
                pass
        if mux is not None:
            mux.close()

    def snapshot(self) -> dict:
        with self._lock:
            return {"addr": self.addr, "role": self.role,
                    "streams": self.streams, "draining": self.draining,
                    "errors": self.errors}


class Router:
    """Stream terminator and role balancer (module docstring)."""

    def __init__(self, prefill: list[str] | None = None,
                 decode: list[str] | None = None,
                 max_streams: int = 64, failover_attempts: int = 2):
        self.max_streams = int(max_streams)
        self.failover_attempts = int(failover_attempts)
        self._lock = make_lock("frontdoor.Router._lock")
        self._backends: dict[str, list[_Backend]] = {
            r: [] for r in ROLES}                 # guarded_by: self._lock
        self._rr = {r: 0 for r in ROLES}          # guarded_by: self._lock
        self._active = 0                          # guarded_by: self._lock
        self.n_streams = 0                        # guarded_by: self._lock
        self.n_shed = 0                           # guarded_by: self._lock
        self.n_failovers = 0                      # guarded_by: self._lock
        #: streams re-adopted onto a survivor after their decode backend
        #: drained mid-stream (scale-down page migration)
        self.n_migrations = 0                     # guarded_by: self._lock
        for addr in prefill or []:
            self.add_backend("prefill", addr)
        for addr in decode or []:
            self.add_backend("decode", addr)

    # -- backend set (the autoscaler's seam) ---------------------------

    def add_backend(self, role: str, addr: str) -> None:
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r} (want {ROLES})")
        addr = str(addr)
        with self._lock:
            for b in self._backends[role]:
                if b.addr == addr:
                    # re-adding a draining backend revives it (the
                    # autoscaler flip-flopped inside one drain window)
                    with b._lock:
                        b.draining = False
                    return
            self._backends[role].append(_Backend(role, addr))
        monitor.set_gauge("frontdoor/backends", self._role_size(role),
                          role=role)

    def remove_backend(self, role: str, addr: str) -> None:
        """Start DRAINING one backend: no new streams route to it; the
        in-flight ones finish and the last one out closes it.  The
        autoscaler kills the process only at ``streams == 0``
        (``backend_streams``), so a scale-down drops nothing."""
        drained = None
        with self._lock:
            for b in self._backends[role]:
                if b.addr == str(addr):
                    with b._lock:
                        b.draining = True
                        if b.streams == 0:
                            drained = b
                    break
            if drained is not None:
                self._backends[role].remove(drained)
        if drained is not None:
            drained.close()
        monitor.set_gauge("frontdoor/backends", self._role_size(role),
                          role=role)

    def set_backends(self, role: str, addrs: list[str]) -> None:
        """Reconcile one role's backend set (adds and drains)."""
        want = [str(a) for a in addrs]
        with self._lock:
            have = [b.addr for b in self._backends[role]]
        for a in want:
            if a not in have:
                self.add_backend(role, a)
        for a in have:
            if a not in want:
                self.remove_backend(role, a)

    def backend_streams(self, role: str, addr: str) -> int:
        """In-flight streams on one backend (0 also when it is already
        gone): the autoscaler's drain barrier."""
        with self._lock:
            for b in self._backends[role]:
                if b.addr == str(addr):
                    with b._lock:
                        return b.streams
        return 0

    def _role_size(self, role: str) -> int:
        with self._lock:
            return sum(1 for b in self._backends[role]
                       if not b.draining)

    def _candidates(self, role: str) -> list[_Backend]:
        """Live (not draining) backends in round-robin order, rotated one
        step a call: each stream starts on the next backend and fails
        over through the rest."""
        with self._lock:
            live = [b for b in self._backends[role] if not b.draining]
            if not live:
                return []
            start = self._rr[role] % len(live)
            self._rr[role] += 1
            return live[start:] + live[:start]

    def _drop_if_drained(self, b: _Backend) -> None:
        with self._lock:
            try:
                self._backends[b.role].remove(b)
            except ValueError:
                return  # a concurrent releaser already dropped it
        b.close()

    # -- request path --------------------------------------------------

    def _shed(self, role: str, msg: str) -> Overloaded:
        with self._lock:
            self.n_shed += 1
        monitor.inc("frontdoor/shed_total", role=role)
        return Overloaded(msg)

    def _prefill_leg(self, prompt: np.ndarray):
        """Prompt phase: the first willing prefill replica wins.  A typed
        ``Overloaded`` or a transport loss tries the next; any other
        typed error (a bad prompt) is raised: it would fail alike
        everywhere."""
        backends = self._candidates("prefill")
        if not backends:
            raise self._shed("prefill", "no live prefill backends (the "
                             "fleet is scaled to zero or still coming up)")
        t0 = time.perf_counter()
        last: BaseException | None = None
        for b in backends:
            client = b.acquire()
            ok = True
            try:
                manifest, k, v = client.prefill(prompt)
            except Overloaded as e:
                last = e
                continue
            except ServiceError:
                raise
            except CONNECTION_ERRORS as e:
                ok = False
                last = e
                continue
            finally:
                if b.release(client, ok):
                    self._drop_if_drained(b)
            monitor.inc("frontdoor/routed_total", role="prefill")
            monitor.observe("frontdoor/migrate_ms",
                            (time.perf_counter() - t0) * 1000.0)
            return manifest, k, v
        if isinstance(last, Overloaded):
            raise self._shed("prefill",
                             f"every prefill backend shed: {last}")
        raise ConnectionError(
            f"every prefill backend unreachable: {last}") from last

    def _decode_leg(self, manifest: dict, k, v, max_new,
                    lost: list | None = None):
        """Token phase: adopt the pages on one decode replica and run the
        stream there.  A transport loss raises ``ConnectionError`` for
        :meth:`generate`'s failover loop and adds the backend to
        ``lost``; backends in ``lost`` are tried after the others."""
        backends = self._candidates("decode")
        if lost:
            backends = ([b for b in backends if b.addr not in lost]
                        + [b for b in backends if b.addr in lost])
        if not backends:
            raise self._shed("decode", "no live decode backends (the "
                             "fleet is scaled to zero or still coming up)")
        last: Overloaded | None = None
        for b in backends:
            client = b.acquire()
            ok = True
            try:
                out = client.adopt(manifest, k, v, max_new)
            except Overloaded as e:
                last = e
                continue
            except CONNECTION_ERRORS as e:
                ok = False
                if lost is not None:
                    lost.append(b.addr)
                raise ConnectionError(
                    f"decode backend {b.addr} lost mid-stream: {e}"
                ) from e
            finally:
                if b.release(client, ok):
                    self._drop_if_drained(b)
            monitor.inc("frontdoor/routed_total", role="decode")
            return out
        raise self._shed("decode", f"every decode backend shed: {last}")

    def generate(self, prompt, max_new: int | None = None) -> np.ndarray:
        """One client stream across the two fleets: the generated token
        ids (first token included), the tokens a single-role decode
        server's ``generate`` gives for the same prompt.  A stream whose
        decode backend drains (scale-down) comes back as pages and
        partial tokens; the router adopts them onto a survivor and
        stitches the halves."""
        from theanompi_tpu_torch.decode.scheduler import MigratedStream

        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            if self._active >= self.max_streams:
                self.n_shed += 1
                monitor.inc("frontdoor/shed_total", role="router")
                raise Overloaded(
                    f"router admission: {self._active} streams in "
                    f"flight >= max_streams {self.max_streams}")
            self._active += 1
            self.n_streams += 1
        monitor.add_gauge("frontdoor/streams_active", 1.0)
        try:
            with monitor.span("page_migrate", phase="prefill"):
                manifest, k, v = self._prefill_leg(prompt)
            total: list[int] = []
            remaining = max_new
            failovers = 0
            migrations = 0
            #: decode backends that lost this stream: its failovers try
            #: every other live backend first
            lost: list[str] = []
            while True:
                try:
                    out = self._decode_leg(manifest, k, v, remaining, lost)
                except ConnectionError as e:
                    if failovers >= self.failover_attempts:
                        raise
                    failovers += 1
                    # the decode replica died mid-stream; none of this
                    # leg's tokens were delivered (adopt returns whole
                    # streams), so re-prefilling the manifest's prompt
                    # (the original one, or the resume prompt after a
                    # drain migration) and adopting onto a survivor gives
                    # the same greedy stream
                    with self._lock:
                        self.n_failovers += 1
                    monitor.inc("frontdoor/failovers_total")
                    print(f"[frontdoor] decode leg failover "
                          f"({failovers}/{self.failover_attempts}): "
                          f"{e}", flush=True)
                    seed = np.asarray(manifest["prompt"], np.int32)
                    with monitor.span("page_migrate", phase="failover"):
                        manifest, k, v = self._prefill_leg(seed)
                    continue
                if isinstance(out, MigratedStream):
                    # the backend drained: keep its partial tokens and
                    # adopt the exported pages onto a survivor; the
                    # resume manifest's first_token is the pending
                    # token, so nothing is lost or doubled
                    if migrations >= MAX_MIGRATIONS:
                        raise Overloaded(
                            f"stream migrated {MAX_MIGRATIONS} times "
                            "without finishing (decode fleet is "
                            "thrashing)")
                    migrations += 1
                    with self._lock:
                        self.n_migrations += 1
                    monitor.inc("frontdoor/drain_migrations_total")
                    total.extend(int(t) for t in out.tokens)
                    if remaining is not None:
                        remaining -= len(out.tokens)
                    manifest, k, v = out.manifest, out.k, out.v
                    continue
                return np.asarray(total + [int(t) for t in out],
                                  np.int32)
        finally:
            with self._lock:
                self._active -= 1
            monitor.add_gauge("frontdoor/streams_active", -1.0)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            backends = {r: [b.snapshot() for b in self._backends[r]]
                        for r in ROLES}
            out = {
                "role": "router",
                "active_streams": self._active,
                "max_streams": self.max_streams,
                "streams": self.n_streams,
                "shed": self.n_shed,
                "failovers": self.n_failovers,
                "migrations": self.n_migrations,
            }
        out["backends"] = backends
        return out

    def close(self) -> None:
        with self._lock:
            backends = [b for r in ROLES for b in self._backends[r]]
            self._backends = {r: [] for r in ROLES}
        for b in backends:
            b.close()

    # -- wire dispatch -------------------------------------------------

    def rpc_max_workers(self) -> int:
        # every admissible stream may wait in a handler for its whole
        # decode leg, plus slack for O(1) sheds and control ops
        return self.max_streams + 8

    def handle(self, op: str, *args):
        if op == "generate":
            prompt, max_new = args
            return self.generate(prompt,
                                 None if max_new is None else int(max_new))
        if op == "stats":
            return self.stats()
        if op == "set_backends":
            role, addrs = args
            self.set_backends(str(role), list(addrs))
            return "ok"
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


class _FrontdoorRpcHooks(rpc.RpcHooks):
    """The front door's seams into the RPC substrate: the
    ``frontdoor/*`` series and the ``router_route`` fault site."""

    plane = "frontdoor"

    def on_connect(self) -> None:
        monitor.add_gauge("frontdoor/clients", 1.0)

    def on_disconnect(self) -> None:
        monitor.add_gauge("frontdoor/clients", -1.0)

    def on_request(self, op: str, ms: float) -> None:
        monitor.inc("frontdoor/requests_total", op=op)
        monitor.observe("frontdoor/rpc_ms", ms, op=op)
        monitor.progress(phase="frontdoor")

    def on_error(self, op: str) -> None:
        monitor.inc("frontdoor/errors_total", op=op)

    def on_negotiate(self, opts) -> None:
        monitor.inc("frontdoor/wire_negotiations_total",
                    compression=opts.compression, dtype=opts.dtype)

    def fire(self, op: str) -> None:
        # 'raise' rejects this routed request (the client sees the typed
        # err), 'delay' adds router latency, with the fleets live
        faults.fire("router_route", op=op)


def serve(router: Router, host: str = "0.0.0.0",
          port: int = DEFAULT_PORT,
          ready_event: threading.Event | None = None,
          stop_event: threading.Event | None = None,
          authkey: bytes | None = None) -> None:
    """The RPC substrate over a :class:`Router`."""
    from theanompi_tpu_torch.parallel.service import _authkey

    if authkey is None:
        authkey = _authkey(generate=True)
    rpc.serve(router, host, port, ready_event=ready_event,
              stop_event=stop_event, authkey=authkey,
              hooks=_FrontdoorRpcHooks(),
              max_workers=router.rpc_max_workers())


class RouterClient(ServiceClient):
    """Wire client of the front door: what a serving client points at
    when the fleet is disaggregated.  The same ``generate`` and typed
    re-raises as :class:`~theanompi_tpu_torch.serving.server.
    InferenceClient`."""

    def generate(self, prompt, max_new: int | None = None) -> np.ndarray:
        try:
            return np.asarray(
                self.call("generate", np.asarray(prompt, np.int32),
                          None if max_new is None else int(max_new)),
                np.int32)
        except ServiceError as e:
            if Overloaded.__name__ in str(e):
                raise Overloaded(str(e)) from None
            if IncompatiblePages.__name__ in str(e):
                raise IncompatiblePages(str(e)) from None
            raise

    def stats(self) -> dict:
        return self.call("stats")

    def set_backends(self, role: str, addrs: list[str]) -> None:
        self.call("set_backends", str(role), [str(a) for a in addrs])

    def ping(self) -> str:
        return self.call("ping")

    def shutdown(self) -> None:
        self.call("shutdown")


# ---------------------------------------------------------------------------
# Entry point (a bare router over running fleets)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.frontdoor.router",
        description="front-door router of disaggregated serving "
                    "(PyTorch port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--prefill", default="", metavar="HOST:PORT,...",
                    help="comma-separated prefill backends")
    ap.add_argument("--decode", default="", metavar="HOST:PORT,...",
                    help="comma-separated decode backends (decode-mode "
                         "servers)")
    ap.add_argument("--max-streams", type=int, default=64)
    ap.add_argument("--failover-attempts", type=int, default=2)
    args = ap.parse_args(argv)
    prefill = [a for a in args.prefill.split(",") if a]
    decode = [a for a in args.decode.split(",") if a]
    with monitor.session(stall_after=float("inf"),
                         name=f"router{os.getpid()}"):
        monitor.progress(phase="frontdoor")
        router = Router(prefill=prefill, decode=decode,
                        max_streams=args.max_streams,
                        failover_attempts=args.failover_attempts)
        print(f"[frontdoor] ROUTER on {args.host}:{args.port} "
              f"({len(prefill)} prefill / {len(decode)} decode "
              f"backends, max_streams={args.max_streams})", flush=True)
        try:
            serve(router, args.host, args.port)
        finally:
            router.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
