"""One event plane — the selector-driven RPC substrate.

Every serving plane in this repo — param service, shard fleet, ingest
readers, eval serving, decode — used to run the same
thread-per-connection serve loop, which dies as connections grow: N
recv threads in one process convoy on the GIL (every IO wake pays the
interpreter's switch interval against whichever thread holds it), and
arXiv:1810.11112's characterization says communication *concurrency*,
not bandwidth, is what dominates at scale.  A host that should front a million
connections cannot spend a thread (and a convoy ticket) per socket.

This module replaces all five loops with ONE substrate behind
:func:`serve`:

* **the event plane**: one IO thread
  owns a ``selectors`` loop over every established connection (accept,
  frame reassembly, scatter-gather writes); blocking work
  (``service.handle``) runs on small per-op executor pools (a default
  pool sized by the plane's own admission bound, plus a tiny control
  pool so latency-critical ops — fence freeze/release, ping — can
  never starve behind parked mutations).  Single-digit threads per
  process at rest, independent of connection count.

What is deliberately byte-compatible with the old plane (so every
existing client keeps working unmodified):

* the ``multiprocessing.connection`` chunk framing (4-byte ``!i``
  length prefix, ``-1`` + ``!Q`` for >2 GiB chunks);
* the HMAC challenge/response handshake — reimplemented here only to
  add a **deadline**: a client that connects and never answers the
  challenge is reaped after ``THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S``
  instead of leaking an fd until shutdown;
* wire-v2 negotiation (``wire.accept_hello``), typed ``("err", ...)``
  replies, the ``shutdown`` op, and per-connection serial request
  order (replies are FIFO per stream, which the ingest client's
  pipelined fetch and the gossip at-most-once discipline both rely
  on).

What is new:

* **connection multiplexing** — a client may add ``"mux": True`` to
  its wire hello; the selector loop then treats the connection as many
  logical streams, each chunk preceded by a 4-byte stream-id envelope
  chunk.  Replies carry the same envelope, streams are served
  concurrently (requests are serial only *within* a stream), and one
  socket + ONE client-side reader thread replaces N sockets + N
  convoying recv threads (:class:`MuxConnection`).
* **scatter-gather zero-copy writes** — a v2 reply is queued as its
  ``encode_frame`` memoryviews and written with ``socket.sendmsg``
  (length prefixes and array buffers as separate iovecs): the arrays'
  bytes go from the store's numpy buffers to the kernel with no
  coalescing copy.
* **backpressure-aware write queues** — per-connection bounded byte
  budget; a worker whose reply would overflow it blocks (bounded) until
  the socket drains, so one slow client back-pressures its own
  requests instead of ballooning server memory.

Per-plane metric names and fault sites stay where they were: the
caller passes an :class:`RpcHooks` whose literal emissions live in the
plane's own module (``service/*`` vs ``serving/*``), which keeps the
TM403/404 docs-coverage lint honest.  This module's own telemetry is
the ``rpc/*`` family (docs/OBSERVABILITY.md "RPC substrate").

Copy of ``theanompi_tpu/parallel/rpc.py``, byte-compatible with it in
both directions.  Differences: the client's side of the handshake has a
deadline too (:func:`connect_client`), so a client that connects to a
server which stops answering raises :class:`HandshakeTimeout` instead of
waiting forever for the challenge; only the selector loop is ported
(JAX's thread-per-connection loop and its ``THEANOMPI_TPU_RPC_LOOP``
switch are not).  Addresses are TCP ``host:port`` or JAX's
``unix:/path`` form (an AF_UNIX listener, :func:`unix_path`).  A port
client still talks to a JAX server on either of its loops, over either
address form.
"""

from __future__ import annotations

import hmac as _hmac
import os
import pickle
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock
from theanompi_tpu_torch.monitor import trace as _trace
from theanompi_tpu_torch.parallel import shm, wire

__all__ = [
    "serve", "RpcHooks", "MuxConnection", "HandshakeTimeout",
    "wait_readable", "set_nodelay", "connect_client", "recv_deadline",
    "unix_path", "have_af_unix", "client_address", "address_string",
]

# -- address forms ----------------------------------------------------------

#: same-host fleets may listen on an AF_UNIX socket instead of TCP
#: loopback: ``serve(host="unix:/path")`` and the same string as a
#: client address.  Platforms without AF_UNIX silently fall back to
#: TCP (``127.0.0.1`` + the given port), as JAX's do.
UNIX_PREFIX = "unix:"


def unix_path(host) -> str | None:
    """The socket path of a ``unix:/path`` address form, or None for
    every TCP form."""
    if isinstance(host, str) and host.startswith(UNIX_PREFIX):
        return host[len(UNIX_PREFIX):]
    return None


def have_af_unix() -> bool:
    return hasattr(socket, "AF_UNIX")


def client_address(address):
    """What ``multiprocessing.connection.Client`` dials for an address
    string: the socket path (a ``str``, its AF_UNIX form) for
    ``unix:/path``, ``(host, port)`` for ``host:port`` (host defaulting to
    the loopback).  A tuple passes through."""
    if not isinstance(address, str):
        return address
    path = unix_path(address)
    if path is not None:
        return path
    host, _, port = address.rpartition(":")
    return (host or "127.0.0.1", int(port))


def address_string(address) -> str:
    """The inverse of :func:`client_address`."""
    if isinstance(address, str):
        return f"{UNIX_PREFIX}{address}"
    return f"{address[0]}:{address[1]}"

# -- knobs ------------------------------------------------------------------

#: handshake deadline: a connect that has not completed
#: the HMAC challenge/response within this window is reaped — an
#: un-negotiated dropped connect must not hold a handler/fd until
#: shutdown
def _handshake_timeout_s() -> float:
    return float(os.environ.get(
        "THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S", "10"))


def _default_workers() -> int:
    """Default executor width.  The right bound is the plane's own
    admission bound (callers pass it); this fallback covers planes
    without one.  Threads spawn on demand and this is a CAP, not a
    pre-spawn."""
    return int(os.environ.get("THEANOMPI_TPU_RPC_WORKERS", "16"))


#: per-connection write-queue budget: a worker blocks (bounded) once a
#: client's unsent replies exceed this many bytes
_WRITEQ_BYTES = int(os.environ.get(
    "THEANOMPI_TPU_RPC_WRITEQ_BYTES", str(256 << 20)))
#: how long a reply may stay blocked on a full write queue before the
#: connection is declared dead (a stalled client must not park a
#: worker forever)
_WRITEQ_TIMEOUT_S = float(os.environ.get(
    "THEANOMPI_TPU_RPC_WRITEQ_TIMEOUT_S", "60"))

#: chunk ceilings mirror the wire module's decoder ceilings
_MAX_CHUNK = wire.MAX_BUFFER_BYTES

#: iovecs per sendmsg call (IOV_MAX is >=1024 on Linux; stay well under)
_SENDMSG_IOVS = 64

_RECV_SIZE = 1 << 18
#: chunks this large are gathered in place (``_ChunkParser``)
_BIG_CHUNK = 1 << 20

# multiprocessing.connection chunk framing
_LEN = struct.Struct("!i")
_LEN8 = struct.Struct("!Q")
_ENVELOPE = struct.Struct(">I")

# the stdlib handshake protocol constants (multiprocessing.connection;
# stable across 3.x — re-declared defensively so a rename upstream
# cannot silently change our wire format)
try:  # pragma: no cover - import paths
    from multiprocessing.connection import (  # type: ignore
        CHALLENGE, FAILURE, MESSAGE_LENGTH, WELCOME,
    )
except ImportError:  # pragma: no cover
    CHALLENGE, WELCOME = b"#CHALLENGE#", b"#WELCOME#"
    FAILURE, MESSAGE_LENGTH = b"#FAILURE#", 20

from multiprocessing import AuthenticationError


class HandshakeTimeout(ConnectionError):
    """A peer connected but did not complete the HMAC handshake within
    the deadline — reaped, never served."""


# ---------------------------------------------------------------------------
# Plane hooks: per-plane metric names / fault sites stay in plane code
# ---------------------------------------------------------------------------


class RpcHooks:
    """Telemetry + fault seams a serving plane plugs into the shared
    loop.  Default: no-op (the substrate itself still emits ``rpc/*``).
    Concrete hooks live next to their metric-catalog rows
    (``parallel/service.py``, ``serving/server.py``) so every emission
    keeps a literal series name the TM403/404 lint can see."""

    #: plane tag for the substrate's own rpc/* series labels
    plane = "rpc"

    def on_connect(self) -> None:
        """An authenticated connection was established."""

    def on_disconnect(self) -> None:
        """A counted connection went away (incl. abrupt RST)."""

    def on_request(self, op: str, ms: float) -> None:
        """One request handled AND its reply fully serialized."""

    def on_error(self, op: str) -> None:
        """A request answered with a typed ``err`` reply (service
        exception, malformed request, wire decode failure, or a reply
        that failed to serialize — ``op`` names which)."""

    def on_negotiate(self, opts: wire.WireOptions) -> None:
        """A connection switched to wire v2."""

    def fire(self, op: str) -> None:
        """Per-request fault site (may raise/delay per the plan)."""


# ---------------------------------------------------------------------------
# HMAC handshake with a deadline (shared by both loops)
# ---------------------------------------------------------------------------


def set_nodelay(conn_or_sock) -> None:
    """Disable Nagle on a socket or a ``Connection``: every message
    here is a complete request or reply, and batching them behind
    delayed ACKs only adds tail latency.  Best-effort (non-TCP fds)."""
    try:
        fileno = conn_or_sock.fileno()
        s = socket.socket(fileno=os.dup(fileno))
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        finally:
            s.close()
    except OSError:
        pass


def _conn_recv_deadline(conn, deadline: float,
                        maxlength: int | None) -> bytes:
    remaining = deadline - time.monotonic()
    if remaining <= 0 or not conn.poll(remaining):
        raise HandshakeTimeout(
            "peer did not answer the HMAC handshake within its deadline")
    return conn.recv_bytes(maxlength)


class _DeadlineConn:
    """A ``Connection`` whose every receive waits at most until one
    deadline: hands the stdlib's own client handshake
    (``answer_challenge`` / ``deliver_challenge``) a bound."""

    def __init__(self, conn, deadline: float):
        self._conn, self._deadline = conn, deadline

    def send_bytes(self, buf) -> None:
        self._conn.send_bytes(buf)

    def recv_bytes(self, maxlength: int | None = None) -> bytes:
        return _conn_recv_deadline(self._conn, self._deadline, maxlength)


def connect_client(address, authkey: bytes,
                   timeout_s: float | None = None):
    """Open a ``multiprocessing.connection`` client to ``address``
    (:func:`client_address`'s form: ``(host, port)`` or a socket path)
    and run the stdlib's mutual HMAC handshake under a deadline
    (``THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S`` by default, the server's
    bound): a server that accepted the connect but never answers (one
    stopping, or a wedged one) raises :class:`HandshakeTimeout` instead
    of blocking the caller forever."""
    from multiprocessing.connection import (
        Client,
        answer_challenge,
        deliver_challenge,
    )

    if not isinstance(authkey, bytes):
        raise TypeError("authkey must be bytes")
    timeout_s = _handshake_timeout_s() if timeout_s is None else timeout_s
    conn = Client(address)  # no authkey: the handshake runs below
    try:
        guard = _DeadlineConn(conn, time.monotonic() + timeout_s)
        answer_challenge(guard, authkey)
        deliver_challenge(guard, authkey)
    except BaseException:
        conn.close()
        raise
    return conn


def recv_deadline(conn, timeout_s: float | None = None):
    """``conn.recv()`` that waits at most ``timeout_s`` (the handshake
    bound by default) for the reply: the wire hello's answer."""
    timeout_s = _handshake_timeout_s() if timeout_s is None else timeout_s
    if not conn.poll(timeout_s):
        raise HandshakeTimeout(
            f"peer did not answer the wire hello within {timeout_s:.0f}s")
    return conn.recv()


def _sock_recv_exact(sock: socket.socket, n: int,
                     deadline: float) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise HandshakeTimeout(
                "peer did not answer the HMAC handshake within the "
                f"{_handshake_timeout_s():.0f}s deadline")
        sock.settimeout(remaining)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            raise HandshakeTimeout(
                "peer did not answer the HMAC handshake within the "
                f"{_handshake_timeout_s():.0f}s deadline") from None
        if not chunk:
            raise EOFError("peer closed during handshake")
        buf += chunk
    return bytes(buf)


def _sock_recv_chunk(sock: socket.socket, deadline: float,
                     maxlength: int) -> bytes:
    (size,) = _LEN.unpack(_sock_recv_exact(sock, 4, deadline))
    if size == -1:
        (size,) = _LEN8.unpack(_sock_recv_exact(sock, 8, deadline))
    if size < 0 or size > maxlength:
        raise AuthenticationError(f"bad handshake message length {size}")
    return _sock_recv_exact(sock, size, deadline)


def _sock_send_chunk(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def handshake_server_sock(sock: socket.socket, authkey: bytes,
                          timeout_s: float) -> None:
    """Server handshake over a raw socket (selector loop)."""
    deadline = time.monotonic() + timeout_s
    message = os.urandom(MESSAGE_LENGTH)
    _sock_send_chunk(sock, CHALLENGE + message)
    digest = _hmac.new(authkey, message, "md5").digest()
    response = _sock_recv_chunk(sock, deadline, 256)
    if not _hmac.compare_digest(response, digest):
        _sock_send_chunk(sock, FAILURE)
        raise AuthenticationError("digest received was wrong")
    _sock_send_chunk(sock, WELCOME)
    message = _sock_recv_chunk(sock, deadline, 256)
    if not message.startswith(CHALLENGE):
        raise AuthenticationError(f"message = {message!r}")
    digest = _hmac.new(authkey, message[len(CHALLENGE):], "md5").digest()
    _sock_send_chunk(sock, digest)
    response = _sock_recv_chunk(sock, deadline, 256)
    if response != WELCOME:
        raise AuthenticationError("digest sent was rejected")


# ---------------------------------------------------------------------------
# A tiny elastic daemon pool (the per-op executors)
# ---------------------------------------------------------------------------


class _DaemonPool:
    """Spawn-on-demand daemon worker pool.

    ``concurrent.futures.ThreadPoolExecutor`` threads are non-daemon:
    a handler legitimately parked in a blocking service op (a
    freeze-blocked shard mutation) would wedge interpreter exit, which
    is exactly the failure the old loop's daemon handler threads
    avoided.  This pool keeps that property: daemon threads, created
    only when every existing worker is busy, capped at ``max_workers``
    (the plane's admission bound — in-flight work bounds thread count,
    connection count never does)."""

    def __init__(self, name: str, max_workers: int):
        if max_workers < 1:
            raise ValueError(f"need >= 1 worker, got {max_workers}")
        self.name = name
        self._max = int(max_workers)
        self._lock = make_lock(f"_DaemonPool.{name}")
        self._cond = make_condition(self._lock, f"_DaemonPool.{name}.cond")
        self._tasks: deque = deque()  # guarded_by: self._lock
        self._idle = 0                # guarded_by: self._lock
        self._n = 0                   # guarded_by: self._lock
        self._spawned = 0             # guarded_by: self._lock
        self._closed = False          # guarded_by: self._lock

    def submit(self, fn: Callable[[], None]) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError(f"pool {self.name} is shut down")
            self._tasks.append(fn)
            # a notified worker counts as idle until it wakes, so one
            # idle worker may already owe an earlier task: notify only
            # when the idle workers cover every queued task, else spawn
            # (a second task must not wait out a first that blocks)
            if self._idle >= len(self._tasks):
                self._cond.notify()
                return
            if self._n < self._max:
                self._n += 1
                self._spawned += 1
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self.name}-{self._spawned}")
                t.start()
            # else: every worker busy and at cap — the task waits its
            # turn (the queue is bounded by in-flight streams, each of
            # which has at most one request here)

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._tasks and not self._closed:
                    self._idle += 1
                    self._cond.wait()
                    self._idle -= 1
                if self._closed:
                    self._n -= 1
                    return
                fn = self._tasks.popleft()
            try:
                fn()
            except Exception as e:  # a task must never kill a worker
                print(f"[rpc] {self.name} task failed: "
                      f"{type(e).__name__}: {e}", flush=True)

    def shutdown(self) -> None:
        """Stop accepting work and wake every idle worker to exit.
        Pending tasks are dropped (their connections are closing);
        busy workers exit after their current task."""
        with self._cond:
            self._closed = True
            self._tasks.clear()
            self._cond.notify_all()

    def join(self, timeout_s: float = 5.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._n == 0:
                    return
            time.sleep(0.01)


def _control_ops(service) -> frozenset:
    """Ops routed to the control pool: latency-critical / never-block
    ops that must not starve behind parked mutations (the shard fence's
    freeze/release while the default pool holds freeze-blocked
    exchanges — the distributed form of the dedicated-fence-connection
    rationale in docs/DESIGN.md)."""
    return frozenset({"ping"}) | frozenset(
        getattr(service, "RPC_CONTROL_OPS", ()))


# ---------------------------------------------------------------------------
# The selector loop (the event plane)
# ---------------------------------------------------------------------------


class _ChunkParser:
    """Incremental multiprocessing.connection chunk framing: feed
    bytes, yields complete chunks.  Owned by the IO thread.

    A chunk of at least ``_BIG_CHUNK`` bytes is gathered into one
    buffer of its declared size, each read copied once into place, and
    handed out as that ``bytearray`` (an array leaf's buffer): growing
    one accumulator by appends would copy a large chunk many times."""

    __slots__ = ("_acc", "_want", "_long", "_big", "_got")

    def __init__(self):
        self._acc = bytearray()
        self._want = -1  # <0: reading a length prefix
        self._long = False
        self._big: bytearray | None = None
        self._got = 0

    def feed(self, data: bytes) -> list[bytes]:
        out: list[bytes] = []
        if self._big is not None:
            data = self._fill(data, out)
            if self._big is not None:
                return out
        self._acc += data
        acc = self._acc
        while True:
            if self._want < 0:
                need = 8 if self._long else 4
                if len(acc) < need:
                    break
                if self._long:
                    (size,) = _LEN8.unpack_from(acc)
                    self._long = False
                else:
                    (size,) = _LEN.unpack_from(acc)
                    if size == -1:
                        del acc[:4]
                        self._long = True
                        continue
                del acc[:need]
                if size < 0 or size > _MAX_CHUNK:
                    raise wire.WireDecodeError(
                        f"peer chunk declares {size} bytes "
                        f"(> {_MAX_CHUNK}); closing connection")
                self._want = size
            if len(acc) < self._want:
                if self._want >= _BIG_CHUNK:
                    self._big, self._got = bytearray(self._want), 0
                    rest = bytes(acc)
                    acc.clear()
                    rest = self._fill(rest, out)
                    if self._big is not None:
                        break
                    acc += rest
                    continue
                break
            out.append(bytes(acc[:self._want]))
            del acc[:self._want]
            self._want = -1
        return out

    def _fill(self, data: bytes, out: list) -> bytes:
        """Copy ``data`` into the big chunk; when it is complete, hand it
        out and return the bytes after it."""
        n = min(len(data), self._want - self._got)
        self._big[self._got:self._got + n] = memoryview(data)[:n]
        self._got += n
        if self._got < self._want:
            return b""
        out.append(self._big)
        self._big, self._want = None, -1
        return bytes(memoryview(data)[n:])


class _Stream:
    """One logical request/reply stream (stream 0 = an unmuxed
    connection).  Frame-reassembly fields are IO-thread-owned; the
    serial-dispatch fields are shared with workers under the
    connection's stream lock."""

    __slots__ = ("sid", "head", "nbufs", "bufs", "busy", "pending")

    def __init__(self, sid: int):
        self.sid = sid
        self.head: bytes | None = None
        self.nbufs = 0
        self.bufs: list | None = None
        self.busy = False      # guarded_by: conn._slock
        self.pending = deque()  # guarded_by: conn._slock

    def reset_frame(self) -> None:
        self.head, self.nbufs, self.bufs = None, 0, None


class _SelConn:
    """Per-connection state for the selector loop.

    Ownership: frame parsing (``parser``/``streams``/``cur_sid``/
    ``wire_opts``/``mux``) is touched only by the IO thread; the write
    queue and the per-stream dispatch queues are the two seams shared
    with worker threads, each under its own lock.  ``wire_opts`` is
    read by workers when encoding replies — safe because it is written
    exactly once (at hello time) strictly before any request of the
    negotiated protocol can be dispatched."""

    def __init__(self, sock: socket.socket, server: "_SelectorServer"):
        self.sock = sock
        self.fd = sock.fileno()
        self.server = server
        self.parser = _ChunkParser()
        self.wire_opts: wire.WireOptions | None = None
        self.mux = False
        # trace grant — written once at hello (IO thread) strictly
        # before any enveloped request, read by workers: same
        # ordering argument as wire_opts above
        self.trace = False
        self.cur_sid: int | None = None
        self.streams: dict[int, _Stream] = {}
        self.events = selectors.EVENT_READ
        #: the actual send seam: guards ``out`` and the socket write.
        #: Lock order: _outlock -> _wlock (never the reverse).
        self._outlock = make_lock("rpc._SelConn._outlock")
        self.out: deque = deque()   # guarded_by: self._outlock
        self._wlock = make_lock("rpc._SelConn._wlock")
        self._wcond = make_condition(self._wlock,
                                     "rpc._SelConn._wcond")
        self._wq: deque = deque()   # guarded_by: self._wlock
        self._wbytes = 0            # guarded_by: self._wlock
        self._wclosed = False       # guarded_by: self._wlock
        self._slock = make_lock("rpc._SelConn._slock")

    # -- worker-side write API -----------------------------------------

    def enqueue(self, chunks: list, sid: int | None) -> int:
        """Queue one reply message (its chunks become iovecs) and wake
        the IO thread.  Blocks while the connection's unsent bytes
        exceed the budget — the backpressure seam.  Returns the bytes
        queued; raises ``ConnectionError`` if the peer is gone or the
        queue stays full past the deadline."""
        # one envelope per CHUNK (not per message) — the client reader
        # demuxes chunk-by-chunk, exactly mirroring the request side
        items: list = []
        for c in chunks:
            n = c.nbytes if isinstance(c, memoryview) else len(c)
            if sid is not None:
                items.append(_LEN.pack(4) + _ENVELOPE.pack(sid))
            if n > 0x7FFFFFFF:
                items.append(_LEN.pack(-1) + _LEN8.pack(n))
            else:
                items.append(_LEN.pack(n))
            if n:
                items.append(c)
        nbytes = sum(i.nbytes if isinstance(i, memoryview) else len(i)
                     for i in items)
        deadline = time.monotonic() + _WRITEQ_TIMEOUT_S
        with self._wcond:
            stalled = False
            while (self._wbytes + nbytes > _WRITEQ_BYTES
                   and self._wbytes > 0 and not self._wclosed):
                if not stalled:
                    stalled = True
                    monitor.inc("rpc/backpressure_stalls_total",
                                plane=self.server.hooks.plane)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        "write queue full for "
                        f"{_WRITEQ_TIMEOUT_S:.0f}s (stalled client); "
                        "dropping connection")
                self._wcond.wait(remaining)
            if self._wclosed:
                raise ConnectionError("connection closed")
            self._wq.extend(items)
            self._wbytes += nbytes
        # fast path: send from THIS worker thread when no other thread
        # holds the send seam — the common unloaded case then skips
        # the wake-pipe → select → sendmsg round trip entirely.  A
        # held lock or a
        # partial write falls back to the IO thread.
        if self._outlock.acquire(blocking=False):
            try:
                residue = self._send_locked()
            except OSError as e:
                self.server.request_close(self)
                raise ConnectionError(f"send failed: {e}") from e
            finally:
                self._outlock.release()
            if residue:
                self.server.request_flush(self)
        else:
            self.server.request_flush(self)
        return nbytes

    def _send_locked(self) -> bool:  # requires_lock: self._outlock
        """Drain the queue and scatter-gather write as much as the
        socket accepts (``sendmsg`` over the frames' memoryviews — the
        zero-copy path).  Returns True when unsent bytes remain (the
        caller arms EVENT_WRITE via the IO thread).  Raises ``OSError``
        on a dead socket — the caller routes the close."""
        with self._wlock:
            if self._wq:
                self.out.extend(self._wq)
                self._wq.clear()
        out = self.out
        sent_total = 0
        try:
            while out:
                iovs = []
                for item in out:
                    iovs.append(item)
                    if len(iovs) >= _SENDMSG_IOVS:
                        break
                try:
                    n = self.sock.sendmsg(iovs)
                except (BlockingIOError, InterruptedError):
                    break
                sent_total += n
                while n and out:
                    head = out[0]
                    size = (head.nbytes if isinstance(head, memoryview)
                            else len(head))
                    if n >= size:
                        out.popleft()
                        n -= size
                    else:
                        mv = (head if isinstance(head, memoryview)
                              else memoryview(head))
                        out[0] = mv[n:]
                        n = 0
        finally:
            if sent_total:
                self.wrote(sent_total)
        return bool(out)

    def wrote(self, nbytes: int) -> None:
        with self._wcond:
            self._wbytes -= nbytes
            self._wcond.notify_all()

    def close_write(self) -> None:
        with self._wcond:
            self._wclosed = True
            self._wq.clear()
            self._wcond.notify_all()


class _SelectorServer:
    """The event plane: one IO thread (the ``serve`` caller), a
    handshake pool, and the per-op executor pools."""

    def __init__(self, service, host: str, port: int,
                 stop_event: threading.Event, authkey: bytes,
                 hooks: RpcHooks, max_workers: int,
                 backlog: int = 64):
        self.service = service
        self.hooks = hooks
        self.stop_event = stop_event
        self.authkey = authkey
        self._control = _control_ops(service)
        plane = hooks.plane
        self.pool = _DaemonPool(f"rpc-worker-{plane}", max_workers)
        self.ctl_pool = _DaemonPool(f"rpc-ctl-{plane}",
                                    max(2, min(4, max_workers)))
        self.hs_pool = _DaemonPool(f"rpc-hs-{plane}", 8)
        self.sel = selectors.DefaultSelector()
        path = unix_path(host)
        if path is not None and not have_af_unix():  # pragma: no cover
            path, host = None, "127.0.0.1"  # silent TCP fallback
        self._unix_path = path
        if path is not None:
            try:  # a stale socket file from a killed predecessor
                os.unlink(path)
            except OSError:
                pass
            self.listener = socket.socket(socket.AF_UNIX,
                                          socket.SOCK_STREAM)
            self.listener.bind(path)
        else:
            self.listener = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
            self.listener.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
        self.listener.listen(backlog)
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ, "accept")
        # wake pipe: workers/handshakes signal the IO thread
        self._wr, self._ww = os.pipe()
        os.set_blocking(self._wr, False)
        os.set_blocking(self._ww, False)
        self.sel.register(self._wr, selectors.EVENT_READ, "wake")
        self._plock = make_lock("rpc._SelectorServer._plock")
        self._pending_ready: list = []   # guarded_by: self._plock
        self._pending_flush: list = []   # guarded_by: self._plock
        self._pending_close: list = []   # guarded_by: self._plock
        self.conns: dict[int, _SelConn] = {}  # io-thread owned

    # -- cross-thread signalling ---------------------------------------

    def _wake(self) -> None:
        try:
            os.write(self._ww, b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wake is already pending, or closing

    def register_ready(self, sock: socket.socket) -> None:
        with self._plock:
            self._pending_ready.append(sock)
        self._wake()

    def request_flush(self, conn: _SelConn) -> None:
        with self._plock:
            self._pending_flush.append(conn)
        self._wake()

    def request_close(self, conn: _SelConn) -> None:
        with self._plock:
            self._pending_close.append(conn)
        self._wake()

    # -- accept + handshake --------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self.listener.accept()
            except (BlockingIOError, OSError):
                return
            try:
                self.hs_pool.submit(
                    lambda s=sock: self._handshake(s))
            except RuntimeError:  # shutting down
                sock.close()
                return

    def _handshake(self, sock: socket.socket) -> None:
        try:
            handshake_server_sock(sock, self.authkey,
                                  _handshake_timeout_s())
        except (HandshakeTimeout, AuthenticationError, EOFError,
                OSError):
            monitor.inc("rpc/handshake_reaped_total",
                        plane=self.hooks.plane, loop="selector")
            try:
                sock.close()
            except OSError:
                pass
            return
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        sock.setblocking(False)
        self.register_ready(sock)

    # -- the IO loop ----------------------------------------------------

    def run(self) -> None:
        try:
            while not self.stop_event.is_set():
                for key, events in self.sel.select(0.25):
                    what = key.data
                    if what == "accept":
                        self._accept()
                    elif what == "wake":
                        self._drain_wake()
                    else:
                        conn = what
                        if events & selectors.EVENT_WRITE:
                            self._flush(conn)
                        if events & selectors.EVENT_READ:
                            self._read(conn)
        finally:
            self._shutdown()

    def _drain_wake(self) -> None:
        try:
            while os.read(self._wr, 4096):
                pass
        except (BlockingIOError, OSError):
            pass
        with self._plock:
            ready, self._pending_ready = self._pending_ready, []
            flush, self._pending_flush = self._pending_flush, []
            close, self._pending_close = self._pending_close, []
        for sock in ready:
            if self.stop_event.is_set():
                sock.close()
                continue
            conn = _SelConn(sock, self)
            self.conns[conn.fd] = conn
            self.sel.register(sock, selectors.EVENT_READ, conn)
            self.hooks.on_connect()
            monitor.inc("rpc/connections_total",
                        plane=self.hooks.plane, loop="selector")
        for conn in flush:
            if conn.fd in self.conns:
                self._flush(conn)
        for conn in close:
            if conn.fd in self.conns:
                self._close_conn(conn)

    def _read(self, conn: _SelConn) -> None:
        try:
            data = conn.sock.recv(_RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)  # EOF — incl. RST'd mid-frame peers
            return
        try:
            chunks = conn.parser.feed(data)
        except wire.WireDecodeError:
            self._close_conn(conn)
            return
        for chunk in chunks:
            if not self._on_chunk(conn, chunk):
                self._close_conn(conn)
                return

    def _on_chunk(self, conn: _SelConn, chunk: bytes) -> bool:
        """One framed chunk; False = unrecoverable, close."""
        if conn.mux:
            if conn.cur_sid is None:
                if len(chunk) != 4:
                    return False  # envelope desync
                (conn.cur_sid,) = _ENVELOPE.unpack(chunk)
                return True
            sid, conn.cur_sid = conn.cur_sid, None
        else:
            sid = 0
        st = conn.streams.get(sid)
        if st is None:
            st = conn.streams[sid] = _Stream(sid)
            monitor.add_gauge("rpc/open_streams", 1.0,
                              plane=self.hooks.plane)
        if conn.mux and not chunk and st.head is None:
            # zero-length chunk outside a frame = client stream close
            del conn.streams[sid]
            monitor.add_gauge("rpc/open_streams", -1.0,
                              plane=self.hooks.plane)
            return True
        if conn.wire_opts is None:
            try:
                # the legacy v1 protocol IS pickle — same documented
                # authkey-gated trust surface the old loop's
                # Connection.recv() had (docs/DESIGN.md security
                # note); the v2 path decodes with allow_pickle=False
                msg = pickle.loads(chunk)  # lint: ok TM302
            except Exception as e:
                # corrupt/unpicklable v1 request: typed diagnostic
                # instead of silently killing the connection
                self.hooks.on_error("malformed")
                return self._queue_err(conn, st,
                                       f"{type(e).__name__}: {e}")
            return self._dispatch(conn, st, msg)
        if st.head is None:
            try:
                _, nbufs, _ = wire.parse_header(chunk)
            except wire.WireDecodeError as e:
                # unparseable header: following chunks are
                # unidentifiable — same close-the-connection policy
                # as an undrainable frame
                self.hooks.on_error("wire_decode")
                self._queue_err(conn, st, f"{type(e).__name__}: {e}")
                return False
            if nbufs:
                st.head, st.nbufs, st.bufs = chunk, nbufs, []
                return True
            head, bufs = chunk, []
        else:
            st.bufs.append(chunk)
            if len(st.bufs) < st.nbufs:
                return True
            head, bufs = st.head, st.bufs
            st.reset_frame()
        try:
            msg = wire.decode_frame(head, bufs, conn.wire_opts)
        except wire.WireDecodeError as e:
            # every declared buffer was consumed (chunk framing keeps
            # the stream aligned) — the connection survives
            self.hooks.on_error("wire_decode")
            return self._queue_err(conn, st,
                                   f"{type(e).__name__}: {e}")
        wire.account_recv(msg, len(head), sum(len(b) for b in bufs))
        return self._dispatch(conn, st, msg)

    #: sentinel op for a pre-built reply routed through the stream's
    #: serial queue — an error for a PIPELINED bad request must queue
    #: behind the in-flight request's reply, or FIFO-matched clients
    #: (the ingest fetch loop) would pair replies with the wrong pulls
    _REPLY_OP = "__rpc_reply__"

    def _queue_err(self, conn: _SelConn, st: _Stream,
                   diag: str) -> bool:
        return self._submit(conn, st, self._REPLY_OP, ("err", diag))

    def _dispatch(self, conn: _SelConn, st: _Stream, msg) -> bool:
        if not isinstance(msg, tuple) or not msg:
            self.hooks.on_error("malformed")
            # via the stream's serial queue, like every error reply —
            # replying ahead of an in-flight pipelined request would
            # mispair a FIFO-matched client's replies
            return self._queue_err(conn, st, "malformed request")
        op, *args = msg
        if op == wire.HELLO_OP:
            # negotiation runs inline on the IO thread (cheap, and it
            # must be ordered with the framing switch): reply on the
            # CURRENT protocol, then switch.  allow_mux=True — this
            # loop demultiplexes.
            try:
                negotiated, hello_reply, mux = wire.accept_hello(
                    args[0] if args else None, allow_mux=True,
                    allow_shm=True)
            except wire.WireProtocolError as e:
                return self._reply_io(conn, st.sid,
                                      ("err",
                                       f"{type(e).__name__}: {e}"))
            ok = self._reply_io(conn, st.sid, ("ok", hello_reply))
            conn.wire_opts = negotiated
            conn.trace = bool(hello_reply.get("trace"))
            if mux:
                conn.mux = True
                # stream 0 was only the pre-mux channel — retire it
                # (and its gauge count, or every mux grant would leak
                # +1 in rpc/open_streams)
                if conn.streams.pop(0, None) is not None:
                    monitor.add_gauge("rpc/open_streams", -1.0,
                                      plane=self.hooks.plane)
                monitor.inc("rpc/mux_connections_total",
                            plane=self.hooks.plane)
            self.hooks.on_negotiate(negotiated)
            return ok
        if op == "shutdown":
            self._reply_io(conn, st.sid, ("ok", None))
            self._flush(conn)
            self.stop_event.set()
            return True
        ctx = None
        if op == wire.TRACE_OP and conn.trace and len(args) >= 2:
            # caller's trace context rides as an envelope; only
            # unwrapped when the hello granted it (otherwise the op
            # falls through to the service's unknown-op error)
            ctx, op, *args = args
        return self._submit(conn, st, op, args, ctx)

    def _submit(self, conn: _SelConn, st: _Stream, op, args,
                ctx=None) -> bool:
        with conn._slock:
            if st.busy:
                st.pending.append((op, args, ctx))
                return True
            st.busy = True
        pool = self.ctl_pool if op in self._control else self.pool
        try:
            pool.submit(
                lambda: self._run_stream(conn, st, op, args, ctx))
        except RuntimeError:  # shutting down
            return False
        return True

    # -- worker side ------------------------------------------------------

    def _run_stream(self, conn: _SelConn, st: _Stream, op, args,
                    ctx=None) -> None:
        """Execute requests of ONE stream serially (replies stay FIFO
        per stream; streams of one connection run concurrently)."""
        while True:
            if op == self._REPLY_OP:
                self._reply(conn, st.sid, args)  # pre-built diagnostic
            else:
                self._run_one(conn, st.sid, op, args, ctx)
            with conn._slock:
                if st.pending:
                    op, args, ctx = st.pending.popleft()
                    continue
                st.busy = False
                return

    def _run_one(self, conn: _SelConn, sid: int, op, args,
                 ctx=None) -> None:
        t0 = time.monotonic()
        try:
            self.hooks.fire(op)
            if ctx is not None:
                with _trace.attach_wire(ctx), \
                        monitor.span("rpc_handle", op=op):
                    result = self.service.handle(op, *args)
            else:
                with monitor.span("rpc_handle", op=op):
                    result = self.service.handle(op, *args)
        except Exception as e:  # surfaced client-side
            self.hooks.on_error(op)
            self._reply(conn, sid, ("err", f"{type(e).__name__}: {e}"))
            return
        sent = self._reply(conn, sid, ("ok", result), op=op)
        if sent is True:
            self.hooks.on_request(op, (time.monotonic() - t0) * 1e3)

    def _reply(self, conn: _SelConn, sid: int, payload,
               op: str = "reply"):
        """Encode + enqueue one reply.  True = queued; 'degraded' = a
        serialize/encode failure converted to an err diagnostic
        (charged to ``op``); False = peer gone."""
        try:
            chunks, stats = self._encode(conn, payload)
        except Exception as e:
            self.hooks.on_error(op)
            try:
                chunks, stats = self._encode(
                    conn, ("err", f"{type(e).__name__}: {e}"))
            except Exception:
                self.request_close(conn)
                return False
            try:
                conn.enqueue(chunks, sid if conn.mux else None)
            except ConnectionError:
                self.request_close(conn)
                return False
            return "degraded"
        try:
            conn.enqueue(chunks, sid if conn.mux else None)
        except ConnectionError:
            self.request_close(conn)
            return False
        if stats is not None:
            wire.account_send(stats)
        return True

    def _encode(self, conn: _SelConn, payload):
        if conn.wire_opts is None:
            return [pickle.dumps(payload)], None
        head, bufs, stats = wire.encode_frame(payload, conn.wire_opts)
        return [head, *bufs], stats

    def _reply_io(self, conn: _SelConn, sid: int, payload) -> bool:
        """Reply from the IO thread (hello/shutdown/decode errors) —
        must never block on backpressure, so it bypasses the budget
        wait (these replies are tiny)."""
        try:
            chunks, _ = self._encode(conn, payload)
        except Exception:
            return False
        items: list = []
        for c in chunks:
            n = c.nbytes if isinstance(c, memoryview) else len(c)
            if conn.mux:
                items.append(_LEN.pack(4) + _ENVELOPE.pack(sid))
            items.append(_LEN.pack(n) if n <= 0x7FFFFFFF
                         else _LEN.pack(-1) + _LEN8.pack(n))
            if n:
                items.append(c)
        # count the bytes into the budget (no blocking — the IO thread
        # must never stall — but _send_locked's wrote() decrements by
        # everything sent, so uncounted items would drive the budget
        # negative and quietly disable backpressure)
        nbytes = sum(i.nbytes if isinstance(i, memoryview) else len(i)
                     for i in items)
        with conn._wcond:
            if conn._wclosed:
                return False
            conn._wbytes += nbytes
        with conn._outlock:
            conn.out.extend(items)
        self._flush(conn)
        return self.conns.get(conn.fd) is conn

    # -- write path -------------------------------------------------------

    def _flush(self, conn: _SelConn) -> None:
        """IO-thread write: drain + send, then arm/disarm EVENT_WRITE
        for whatever the socket would not take."""
        try:
            with conn._outlock:
                residue = conn._send_locked()
        except OSError:
            self._close_conn(conn)
            return
        want = selectors.EVENT_READ
        if residue:
            want |= selectors.EVENT_WRITE
        if want != conn.events and self.conns.get(conn.fd) is conn:
            conn.events = want
            self.sel.modify(conn.sock, want, conn)

    # -- teardown ---------------------------------------------------------

    def _close_conn(self, conn: _SelConn) -> None:
        # identity check, not just fd membership: a deferred
        # request_close can land after this conn died AND a new
        # connection reused its fd number — tearing down the
        # newcomer would zombie it (unflushable, double-decremented
        # gauge, leaked selector entry)
        if self.conns.get(conn.fd) is not conn:
            return
        del self.conns[conn.fd]
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.close_write()
        try:
            conn.sock.close()
        except OSError:
            pass
        n_streams = len(conn.streams)
        conn.streams.clear()
        if n_streams:
            monitor.add_gauge("rpc/open_streams", -float(n_streams),
                              plane=self.hooks.plane)
        ch = getattr(conn.wire_opts, "shm", None)
        if ch is not None:
            # release every lease this connection's acks never covered
            # (the lane's teardown contract)
            ch.close()
        self.hooks.on_disconnect()

    def _shutdown(self) -> None:
        try:
            self.sel.unregister(self.listener)
        except (KeyError, ValueError):
            pass
        self.listener.close()
        if self._unix_path is not None:
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass
        for conn in list(self.conns.values()):
            self._close_conn(conn)
        for pool in (self.pool, self.ctl_pool, self.hs_pool):
            pool.shutdown()
        for pool in (self.pool, self.ctl_pool, self.hs_pool):
            pool.join(timeout_s=2.0)
        try:
            self.sel.unregister(self._wr)
        except (KeyError, ValueError):
            pass
        os.close(self._wr)
        os.close(self._ww)
        self.sel.close()


# ---------------------------------------------------------------------------
# The one serve() every plane calls
# ---------------------------------------------------------------------------


def serve(service, host: str = "0.0.0.0", port: int = 0, *,
          ready_event: threading.Event | None = None,
          stop_event: threading.Event | None = None,
          authkey: bytes,
          hooks: RpcHooks | None = None,
          max_workers: int | None = None,
          backlog: int = 64) -> None:
    """Run ``service`` (anything with ``handle(op, *args)``) behind the
    RPC substrate until ``stop_event`` (or a ``shutdown`` op).

    ``host`` may be the ``unix:/path`` address form: the listener binds
    an AF_UNIX socket at ``/path`` (``port`` ignored), removes a stale
    file there first and its own at shutdown, and the same string works
    as a client address everywhere a ``host:port`` does.

    ``max_workers`` caps the default executor pool —
    pass the plane's own admission bound (serving queue, ingest
    max_inflight) so in-flight work, never connection count, bounds
    thread count."""
    if stop_event is None:
        stop_event = threading.Event()  # so the shutdown op works
    hooks = hooks or RpcHooks()
    server = _SelectorServer(
        service, host, port, stop_event, authkey, hooks,
        max_workers=(max_workers if max_workers is not None
                     else _default_workers()),
        backlog=backlog)
    if ready_event is not None:
        ready_event.set()
    server.run()


# ---------------------------------------------------------------------------
# Client side: multiplexed transport (many streams, one socket)
# ---------------------------------------------------------------------------


class _ChunkQueue:
    """Inbound chunk buffer for one client stream (reader thread
    produces, the stream's user consumes)."""

    def __init__(self):
        self._lock = make_lock("rpc._ChunkQueue._lock")
        self._cond = make_condition(self._lock,
                                    "rpc._ChunkQueue._cond")
        self._items: deque = deque()          # guarded_by: self._lock
        self._err: BaseException | None = None  # guarded_by: self._lock

    def put(self, chunk: bytes) -> None:
        with self._cond:
            self._items.append(chunk)
            self._cond.notify_all()

    def put_err(self, err: BaseException) -> None:
        with self._cond:
            if self._err is None:
                self._err = err
            self._cond.notify_all()

    def poll(self, timeout: float | None = 0.0) -> bool:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while True:
                if self._items:
                    return True
                if self._err is not None:
                    return True  # the recv will raise
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)

    def get(self) -> bytes:
        with self._cond:
            while not self._items:
                if self._err is not None:
                    raise self._err
                self._cond.wait()
            return self._items.popleft()


class MuxStream:
    """Connection-like view of one logical stream on a
    :class:`MuxConnection` — the subset ``ServiceClient`` and
    ``wire.send_msg``/``recv_msg`` use (``send``/``recv``/
    ``send_bytes``/``recv_bytes``/``poll``/``close``)."""

    def __init__(self, transport: "MuxConnection", sid: int,
                 q: _ChunkQueue, gen: int):
        self._transport = transport
        self.sid = sid
        self._q = q
        self._gen = gen
        self.closed = False

    def send_bytes(self, buf) -> None:
        self._transport._send(self.sid, buf, self._gen)

    def send(self, obj) -> None:
        self.send_bytes(pickle.dumps(obj, protocol=2))

    def recv_bytes(self, maxlength: int | None = None) -> bytes:
        chunk = self._q.get()
        if maxlength is not None and len(chunk) > maxlength:
            raise OSError("bad message length")
        return chunk

    def recv(self):
        # client-side decode of a reply from the server this client
        # authenticated to — the same trust the stdlib Connection.recv
        # path has always had; mux data traffic itself is v2-framed
        return pickle.loads(self.recv_bytes())  # lint: ok TM302

    def poll(self, timeout: float | None = 0.0) -> bool:
        return self._q.poll(timeout)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._transport._close_stream(self.sid, self._gen)
            self._q.put_err(EOFError("stream closed"))


def _shutdown(conn) -> None:
    """Shut a connection's socket down without closing its fd: a reader
    thread blocked on it wakes with EOF and closes the fd itself.  The
    reader is the fd's only closer: a second thread closing it could
    close (or leave the reader reading from) a socket that reused the
    fd number meanwhile."""
    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
        try:
            s.shutdown(socket.SHUT_RDWR)
        finally:
            s.close()
    except (OSError, TypeError, ValueError):
        pass


class MuxConnection:
    """Client transport: ONE authenticated socket + ONE reader thread
    carrying many logical streams (the GIL-convoy fix on the client
    side — N convoying recv threads become one select-free reader).

    ``connect_stream()`` hands out Connection-like streams; pass the
    transport to ``ServiceClient(..., transport=...)`` and K clients
    share the socket.  Against a server that does not grant mux (JAX's
    threaded loop, an old tmserver) every ``connect_stream`` silently
    falls back to a dedicated authenticated socket — same behavior as
    today, so callers never need to know which substrate answered."""

    def __init__(self, address, authkey: bytes | None = None,
                 wire_opts: wire.WireOptions | None = None):
        self.address = client_address(address)
        if authkey is None:
            from theanompi_tpu_torch.parallel.service import _authkey

            authkey = _authkey()
        self._authkey = authkey
        self._want = (wire_opts if wire_opts is not None
                      else wire.WireOptions.from_env())
        self._lock = make_lock("rpc.MuxConnection._lock")
        #: write-interleave lock: one (envelope, chunk) pair at a time
        self._wlock = make_lock("rpc.MuxConnection._wlock")
        self._conn = None           # guarded_by: self._lock
        self._mux: bool | None = None  # guarded_by: self._lock
        self._wire: wire.WireOptions | None = None  # guarded_by: self._lock
        self._trace = False         # guarded_by: self._lock
        #: offer the shared-memory lane on (re)connect; flipped off by
        #: disable_shm() after a typed refusal, and every stream of
        #: this transport reconnects in-band
        self._shm_on = True         # guarded_by: self._lock
        self._streams: dict[int, _ChunkQueue] = {}  # guarded_by: self._lock
        self._next_sid = 1          # guarded_by: self._lock
        self._gen = 0               # guarded_by: self._lock
        self._closed = False        # guarded_by: self._lock
        #: the current connection's reader thread, its fd's one closer
        self._reader: threading.Thread | None = None  # guarded_by: self._lock
        with self._lock:
            self._connect_locked()

    # -- connection management -----------------------------------------

    def _connect_locked(self) -> None:  # requires_lock: self._lock
        conn = connect_client(self.address, self._authkey)
        set_nodelay(conn)
        offer = shm.client_offer() if self._shm_on else None
        try:
            conn.send((wire.HELLO_OP,
                       dict(wire.hello_payload(self._want,
                                               shm_offer=offer),
                            mux=True)))
            status, payload = recv_deadline(conn)
        except Exception:
            conn.close()
            raise
        granted = (status == "ok" and isinstance(payload, dict)
                   and payload.get("version") == wire.WIRE_VERSION
                   and payload.get("mux"))
        if not granted:
            # dedicated-socket fallback: this probe connection is
            # already v2-switched server-side with no stream to own
            # it — drop it; connect_stream opens plain sockets
            conn.close()
            self._mux = False
            self._conn = None
            self._wire = None
            return
        self._mux = True
        self._conn = conn
        self._wire = wire.WireOptions(
            compression=payload.get("compression", "none"),
            dtype=payload.get("dtype", "f32"),
            allow_pickle=self._want.allow_pickle,
            shm=shm.client_channel(offer, payload))
        # the shared hello negotiated for every stream on this socket;
        # ServiceClient reads it when it skips its own hello
        self._trace = bool(payload.get("trace"))
        self._gen += 1
        self._reader = threading.Thread(
            target=self._read_loop, args=(conn, self._gen),
            daemon=True,
            name=(f"rpc-mux-reader-"
                  f"{'unix' if isinstance(self.address, str) else self.address[1]}"
                  f"-g{self._gen}"))
        self._reader.start()

    @property
    def mux(self) -> bool:
        with self._lock:
            return bool(self._mux)

    @property
    def trace(self) -> bool:
        """Whether the shared hello granted trace propagation."""
        with self._lock:
            return self._trace

    def connect_stream(self):
        """-> (conn-like, negotiated WireOptions | None).

        Mux mode: a new logical stream + the connection's negotiated
        options (the caller skips its own hello).  Fallback mode: a
        fresh dedicated authenticated socket and ``None`` (the caller
        negotiates as it always did).  A dead mux transport is
        re-established here — the reconnect seam ``ServiceClient``'s
        retry loop drives."""
        with self._lock:
            if self._closed:
                raise ConnectionError("transport closed")
            if self._mux and self._conn is None:
                # dead transport: re-establish (a server restart may
                # also downgrade us to the non-mux fallback below)
                self._connect_locked()
            if not self._mux:
                conn = connect_client(self.address, self._authkey)
                set_nodelay(conn)
                return conn, None
            sid = self._next_sid
            self._next_sid += 1
            q = _ChunkQueue()
            self._streams[sid] = q
            return MuxStream(self, sid, q, self._gen), self._wire

    def _read_loop(self, conn, gen: int) -> None:
        """The one reader: envelope chunk → payload chunk → route.  It
        alone closes ``conn``'s fd, when the connection ends (a
        :func:`_shutdown` from ``close()`` ends it too)."""
        try:
            while True:
                env = conn.recv_bytes(4)
                chunk = conn.recv_bytes(_MAX_CHUNK)
                (sid,) = _ENVELOPE.unpack(env)
                with self._lock:
                    q = self._streams.get(sid)
                if q is not None:
                    q.put(chunk)
        except (EOFError, OSError, TypeError) as e:
            err = (e if isinstance(e, (EOFError, OSError))
                   else EOFError("transport closed"))
            with self._lock:
                if self._gen != gen or self._conn is not conn:
                    return  # dropped by close()/disable_shm(), or a
                    # newer connection owns the streams now
                self._conn = None
                streams, self._streams = self._streams, {}
                w, self._wire = self._wire, None
            ch = getattr(w, "shm", None)
            if ch is not None:
                ch.close()  # leases the dead peer never acked
            for q in streams.values():
                q.put_err(ConnectionResetError(
                    f"mux transport to {self.address} lost: {err}"))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- stream-side internals -----------------------------------------

    def _send(self, sid: int, buf, gen: int) -> None:
        with self._lock:
            conn = self._conn
            if conn is None or gen != self._gen \
                    or sid not in self._streams:
                raise ConnectionResetError(
                    f"mux transport to {self.address} is gone; "
                    "reconnect via connect_stream()")
        try:
            with self._wlock:
                conn.send_bytes(_ENVELOPE.pack(sid))
                conn.send_bytes(buf)
        except (OSError, EOFError, ValueError) as e:
            raise ConnectionResetError(
                f"mux transport to {self.address} lost mid-send: {e}"
            ) from e

    def _close_stream(self, sid: int, gen: int) -> None:
        with self._lock:
            self._streams.pop(sid, None)
            conn = self._conn if gen == self._gen else None
        if conn is not None:
            try:
                with self._wlock:
                    conn.send_bytes(_ENVELOPE.pack(sid))
                    conn.send_bytes(b"")  # server-side stream retire
            except (OSError, EOFError, ValueError):
                pass

    def disable_shm(self) -> None:
        """Degrade this transport to in-band frames after a typed
        :class:`wire.ShmRefusal`: drop the current connection (its
        streams fail with ``ConnectionResetError``, so their owners
        reconnect through their ordinary retry loops) and never offer
        the lane again from this transport."""
        with self._lock:
            if not self._shm_on:
                return
            self._shm_on = False
            conn, self._conn = self._conn, None
            streams, self._streams = self._streams, {}
            w, self._wire = self._wire, None
        ch = getattr(w, "shm", None)
        if ch is not None:
            ch.close()
        for q in streams.values():
            q.put_err(ConnectionResetError(
                f"shm lane to {self.address} disabled; reconnect"))
        if conn is not None:
            _shutdown(conn)  # its reader closes the fd

    def close(self) -> None:
        """Drop the connection and wait (bounded) for its reader, which
        closes the fd once the shutdown wakes it."""
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
            streams, self._streams = self._streams, {}
            w, self._wire = self._wire, None
            reader = self._reader
        ch = getattr(w, "shm", None)
        if ch is not None:
            ch.close()
        for q in streams.values():
            q.put_err(EOFError("transport closed"))
        if conn is not None:
            _shutdown(conn)
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wait_readable(conns, timeout: float) -> list:
    """``multiprocessing.connection.wait`` generalized over
    :class:`MuxStream` objects (which have no fileno to select on):
    real connections go through the stdlib wait; when any stream is in
    the set, fall back to a fine-grained poll sweep.  Used by the
    ingest client's pipelined fetch loop so it can mix plain and
    muxed reader pipes."""
    from multiprocessing.connection import wait as _wait

    plain = [c for c in conns if not isinstance(c, MuxStream)]
    muxed = [c for c in conns if isinstance(c, MuxStream)]
    if not muxed:
        return _wait(plain, timeout=timeout)
    deadline = time.monotonic() + timeout
    while True:
        ready = [c for c in muxed if c.poll(0)]
        if plain:
            ready += _wait(plain, timeout=0)
        if ready:
            return ready
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return []
        time.sleep(min(0.002, remaining))
