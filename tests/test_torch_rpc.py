"""The port's RPC substrate (``theanompi_tpu_torch/parallel/rpc.py``)
against the JAX package's (``tests/test_rpc.py``).

* **Across the packages:** a JAX client gets the right answers from a
  port ``rpc.serve`` server and a port client from a JAX server (on
  either of JAX's loops), on dedicated sockets and on a multiplexed
  transport, with the shared-memory lane granted (its leaves out of
  band, byte-identical) and on the bf16 wire.
* **One loop:** the port serves on its selector loop only, whatever
  ``THEANOMPI_TPU_RPC_LOOP`` says (JAX's switch to its threaded loop);
  a port ``MuxConnection`` falls back to a socket per stream against
  JAX's threaded loop, which grants no multiplexing.
* **The bounded client handshake:** a client that connects to a server
  that never answers raises ``HandshakeTimeout`` within its deadline
  (the JAX client would wait forever); the server's own deadline reaps a
  silent connect, as in JAX.
* Typed errors, the v1 pickle fallback, wrong keys and a corrupt frame
  that the connection survives.

A server thread of either package is stopped before each test returns;
every shm segment is released (port arena by the fixture below, JAX's
by the suite's guard) within the test.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np
import pytest

from theanompi_tpu.parallel import rpc as jrpc
from theanompi_tpu.parallel import service as jservice
from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu.monitor import trace as jtrace
from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.parallel import rpc, service, shm

KEY = b"rpc-test"


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY.decode())
    monkeypatch.setenv("THEANOMPI_TPU_SHM_MIN_BYTES", "1024")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "2")
    yield
    shm.release_all()
    jshm.release_all()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Echo:
    RPC_CONTROL_OPS = frozenset()

    def handle(self, op, *args):
        if op == "echo":
            return args[0]
        if op == "double":
            return {k: v * 2 for k, v in args[0].items()}
        if op == "boom":
            raise ValueError("boom goes the service")
        if op == "ctx":  # the trace context this request was served in
            return trace.inject() or jtrace.inject()
        raise ValueError(f"unknown op {op!r}")


class Server:
    """A server thread of one package's ``rpc.serve`` over :class:`Echo`,
    on a TCP port or, given ``path``, on ``unix:<path>``."""

    def __init__(self, rpc_mod, path=None):
        self.port = free_port()
        self.path = path
        host = "127.0.0.1" if path is None else f"unix:{path}"
        self.ready, self.stop_ev = threading.Event(), threading.Event()
        self.thread = threading.Thread(
            target=rpc_mod.serve, args=(Echo(), host, self.port),
            kwargs=dict(ready_event=self.ready, stop_event=self.stop_ev,
                        authkey=KEY), daemon=True)
        self.thread.start()
        assert self.ready.wait(10)
        self.addr = f"127.0.0.1:{self.port}" if path is None else host

    def stop(self):
        self.stop_ev.set()
        try:  # unblock a JAX threaded loop's accept()
            if self.path is None:
                socket.create_connection(("127.0.0.1", self.port),
                                         2).close()
            else:
                with socket.socket(socket.AF_UNIX) as s:
                    s.settimeout(2)
                    s.connect(self.path)
        except OSError:
            pass
        self.thread.join(timeout=15)
        assert not self.thread.is_alive()


@pytest.fixture
def servers():
    made = []

    def make(rpc_mod, path=None):
        made.append(Server(rpc_mod, path))
        return made[-1]
    yield make
    for s in made:
        s.stop()


def payload(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 40)).astype(np.float32),
            "i": np.arange(10, dtype=np.int64),
            "u8": rng.integers(0, 255, (50, 50), dtype=np.uint8)}


def assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


PAIRS = {"jax-client/port-server": (jservice, rpc),
         "port-client/jax-server": (service, jrpc)}

#: the servers a port peer meets: the port's own (one loop) and JAX's on
#: each of its loops (``THEANOMPI_TPU_RPC_LOOP``, read by JAX only)
SERVERS = {"port": (rpc, None), "jax-selector": (jrpc, "selector"),
           "jax-threaded": (jrpc, "threaded")}


@pytest.mark.parametrize("pair,loop", [
    ("jax-client/port-server", None),
    ("port-client/jax-server", "selector"),
    ("port-client/jax-server", "threaded")])
def test_answers_across_packages(pair, loop, monkeypatch, servers):
    if loop is not None:
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", loop)
    client_mod, server_rpc = PAIRS[pair]
    srv = servers(server_rpc)
    c = client_mod.ServiceClient(srv.addr)
    try:
        assert c.wire_protocol == "v2"
        x = payload()
        assert_same(c.call("echo", x), x)
        doubled = c.call("double", x)
        assert_same(doubled, {k: v * 2 for k, v in x.items()})
        assert c.call("echo", ["a", 1, None, (2.5, b"b")]) == \
            ["a", 1, None, (2.5, b"b")]
        with pytest.raises(client_mod.ServiceError, match="boom goes"):
            c.call("boom")
        # the lane was granted (same host) and carried the big leaves
        assert c._own_shm is not None
    finally:
        c.close()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bf16_and_zlib_wire_across_packages(pair, servers):
    client_mod, server_rpc = PAIRS[pair]
    srv = servers(server_rpc)
    opts = client_mod.wire.WireOptions(compression="zlib", dtype="bf16")
    c = client_mod.ServiceClient(srv.addr, wire_opts=opts)
    try:
        c._disable_shm()  # in-band, so the bf16 rounding applies
        c._reconnect()
        x = payload(1)
        got = c.call("echo", x)
        assert got["w"].dtype == np.float32
        np.testing.assert_allclose(got["w"], x["w"], rtol=2 ** -8)
        assert got["w"].tobytes() != x["w"].tobytes()
        assert_same({k: got[k] for k in ("i", "u8")},
                    {k: x[k] for k in ("i", "u8")})
    finally:
        c.close()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_v1_pickle_across_packages(pair, servers):
    client_mod, server_rpc = PAIRS[pair]
    srv = servers(server_rpc)
    c = client_mod.ServiceClient(srv.addr, protocol="v1")
    try:
        assert c.wire_protocol == "v1"
        assert c.call("echo", [1, "two"]) == [1, "two"]
    finally:
        c.close()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_mux_transport_across_packages(pair, monkeypatch, servers):
    monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", "selector")
    client_mod, server_rpc = PAIRS[pair]
    srv = servers(server_rpc)
    mux_cls = (jrpc if client_mod is jservice else rpc).MuxConnection
    t = mux_cls(srv.addr)
    clients = [client_mod.ServiceClient(srv.addr, transport=t)
               for _ in range(3)]
    try:
        assert t.mux
        outs = [None] * 3

        def go(i):
            outs[i] = clients[i].call("echo", payload(i))
        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        for i in range(3):
            assert_same(outs[i], payload(i))
    finally:
        for c in clients:
            c.close()
        t.close()


@pytest.mark.parametrize("knob", [None, "selector", "threaded"])
def test_port_serves_its_selector_loop_whatever_the_knob(knob, monkeypatch,
                                                         servers):
    """The port has one loop: ``serve`` takes no loop and ignores JAX's
    switch, and the loop it runs grants multiplexing (JAX's threaded
    loop does not)."""
    import inspect

    if knob is None:
        monkeypatch.delenv("THEANOMPI_TPU_RPC_LOOP", raising=False)
    else:
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", knob)
    assert "loop" not in inspect.signature(rpc.serve).parameters
    srv = servers(rpc)
    t = rpc.MuxConnection(srv.addr)
    try:
        assert t.mux
        c = service.ServiceClient(srv.addr, transport=t)
        assert_same(c.call("echo", payload(3)), payload(3))
        c.close()
    finally:
        t.close()


def test_mux_close_leaves_the_fd_to_its_reader(servers, monkeypatch):
    """``MuxConnection.close()`` only shuts the socket down; the reader
    thread, woken by it, is the one closer of the fd, and ``close()``
    returns after it.  A second closer raced the reader: the fd number,
    reused by the next connection, was closed or read from under it
    (a client connecting right after a closed transport saw "bad
    message length" or EBADF)."""
    srv = servers(rpc)
    t = rpc.MuxConnection(srv.addr)
    c = service.ServiceClient(srv.addr, transport=t)
    assert c.call("echo", 7) == 7
    reader, conn = t._reader, t._conn
    closes: list = []
    fd_close = conn._close

    def counting_close():
        closes.append(threading.current_thread().name)
        fd_close()

    conn._close = counting_close
    t.close()
    assert not reader.is_alive()
    assert closes == [reader.name] and conn.closed
    c.close()
    for _ in range(3):  # the next connections are whole
        c2 = service.ServiceClient(srv.addr)
        assert c2.call("echo", 8) == 8
        c2.close()


def test_port_mux_falls_back_against_jax_threaded_loop(monkeypatch,
                                                       servers):
    """JAX's threaded loop grants no multiplexing: the port's transport
    gives each client a socket of its own, and the answers are right."""
    monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", "threaded")
    srv = servers(jrpc)
    t = rpc.MuxConnection(srv.addr)
    clients = [service.ServiceClient(srv.addr, transport=t)
               for _ in range(2)]
    try:
        assert not t.mux
        for i, c in enumerate(clients):
            assert_same(c.call("echo", payload(i)), payload(i))
    finally:
        for c in clients:
            c.close()
        t.close()


# -- unix:/path addresses ---------------------------------------------------


@pytest.mark.parametrize("pair,loop", [
    ("jax-client/port-server", None),
    ("port-client/jax-server", "selector"),
    ("port-client/jax-server", "threaded"),
    ("port-client/port-server", None)])
def test_unix_address_across_packages(pair, loop, monkeypatch, servers,
                                      tmp_path):
    """``unix:/path`` through each package's ``serve`` and the other's
    client: the listener binds the socket file, a dedicated client and a
    multiplexed transport (mux granted by a selector loop, a socket of
    its own per stream on JAX's threaded one) get every array back
    bitwise, and the server removes its file when it stops."""
    if loop is not None:
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", loop)
    # in band: the lane over unix: is test_torch_shm.py's case
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    client_mod, server_rpc = PAIRS.get(pair, (service, rpc))
    path = str(tmp_path / "echo.sock")
    srv = servers(server_rpc, path)
    assert os.path.exists(path)
    assert rpc.unix_path(srv.addr) == jrpc.unix_path(srv.addr) == path
    t = (jrpc if client_mod is jservice else rpc).MuxConnection(srv.addr)
    clients = [client_mod.ServiceClient(srv.addr),
               client_mod.ServiceClient(srv.addr, transport=t)]
    try:
        assert t.mux == (loop != "threaded")
        for i, c in enumerate(clients):
            assert c.wire_protocol == "v2"
            assert_same(c.call("echo", payload(i)), payload(i))
            assert_same(c.call("double", payload(i)),
                        {k: v * 2 for k, v in payload(i).items()})
    finally:
        for c in clients:
            c.close()
        t.close()
    srv.stop()
    assert not os.path.exists(path), "the server left its socket file"


def test_unix_address_forms():
    """The port reads and writes JAX's address forms."""
    assert rpc.UNIX_PREFIX == jrpc.UNIX_PREFIX == "unix:"
    for a in ("unix:/tmp/x.sock", "127.0.0.1:5", "h:7", "unix:"):
        assert rpc.unix_path(a) == jrpc.unix_path(a)
    assert rpc.client_address("unix:/tmp/x.sock") == "/tmp/x.sock"
    assert rpc.client_address("h:7") == ("h", 7)
    assert rpc.client_address(":7") == ("127.0.0.1", 7)
    for a in ("unix:/tmp/x.sock", "h:7"):
        assert rpc.address_string(rpc.client_address(a)) == a
    assert rpc.have_af_unix() == jrpc.have_af_unix()


def test_port_shm_lane_takes_leaves_out_of_band(servers):
    srv = servers(jrpc)
    c = service.ServiceClient(srv.addr)
    try:
        x = payload(2)
        head, bufs, stats = service.wire.encode_frame(("echo", x),
                                                      c._wire)
        # w and u8 are over the 1 KiB threshold: out of band
        assert stats._shm_oob == x["w"].nbytes + x["u8"].nbytes
        c._wire.shm.cancel(stats._shm_lease)
        assert_same(c.call("echo", x), x)
    finally:
        c.close()


# -- handshakes -------------------------------------------------------------


def test_client_handshake_is_bounded(monkeypatch):
    """A listener that accepts the connect (the kernel's backlog) but
    never answers: the port's client raises ``HandshakeTimeout`` within
    its deadline."""
    monkeypatch.setenv("THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S", "0.5")
    with socket.socket() as lsock:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)
        addr = lsock.getsockname()
        t0 = time.monotonic()
        with pytest.raises(rpc.HandshakeTimeout):
            rpc.connect_client(addr, KEY)
        with pytest.raises(rpc.HandshakeTimeout):
            service.ServiceClient(f"127.0.0.1:{addr[1]}",
                                  retry=service.RetryPolicy(max_attempts=1))
        assert time.monotonic() - t0 < 5.0


def test_client_handshake_against_a_stopped_server(monkeypatch, servers):
    """A server whose stop was requested while a client connects: the
    client fails within its deadline instead of hanging."""
    monkeypatch.setenv("THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S", "1")
    srv = servers(rpc)
    srv.stop()
    t0 = time.monotonic()
    with pytest.raises((rpc.HandshakeTimeout, ConnectionError, EOFError)):
        rpc.connect_client(("127.0.0.1", srv.port), KEY)
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("server", list(SERVERS))
def test_server_reaps_a_silent_connect(server, monkeypatch, servers):
    server_rpc, loop = SERVERS[server]
    if loop is not None:
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", loop)
    monkeypatch.setenv("THEANOMPI_TPU_RPC_HANDSHAKE_TIMEOUT_S", "0.3")
    srv = servers(server_rpc)
    with socket.create_connection(("127.0.0.1", srv.port)) as s:
        s.settimeout(5)
        s.recv(4096)  # the challenge
        # send nothing: the server reaps the connection at its deadline
        end = s.recv(4096)
        while end:
            end = s.recv(4096)
    c = service.ServiceClient(srv.addr)
    try:
        assert c.call("echo", 7) == 7
    finally:
        c.close()


def test_wrong_key_is_refused(servers):
    from multiprocessing import AuthenticationError

    srv = servers(rpc)
    with pytest.raises(AuthenticationError):
        rpc.connect_client(("127.0.0.1", srv.port), b"wrong")
    c = jservice.ServiceClient(srv.addr)  # the right key still works
    try:
        assert c.call("echo", "ok") == "ok"
    finally:
        c.close()


def test_corrupt_frame_gets_a_typed_error_and_the_connection_survives(
        servers):
    srv = servers(rpc)
    c = jservice.ServiceClient(srv.addr)
    try:
        c._disable_shm()
        c._reconnect()
        w = jservice.wire
        with c._lock:
            # aligned (declares no buffers) but its skeleton is not JSON
            c._conn.send_bytes(w._HEADER.pack(w.MAGIC, w.WIRE_VERSION, 0,
                                              0, 9) + b"not json!")
            status, msg = w.recv_msg(c._conn, c._wire)
        assert status == "err" and "WireDecodeError" in msg
        assert c.call("echo", 3) == 3
    finally:
        c.close()


def test_chunk_parser_splits_like_jax_with_big_chunks():
    """The selector loop's chunk framing gathers a chunk of 1 MiB or more
    in place: fed the same stream in random splits, it yields JAX's
    chunks, byte for byte."""
    import os
    import random
    import struct

    rng = random.Random(0)
    for _ in range(20):
        chunks = [os.urandom(rng.choice([0, 3, 5000, (1 << 20) - 1,
                                         1 << 20, 1500000]))
                  for _ in range(rng.randint(1, 4))]
        stream = b"".join(struct.pack("!i", len(c)) + c for c in chunks)
        ours, theirs = rpc._ChunkParser(), jrpc._ChunkParser()
        got, want, i = [], [], 0
        while i < len(stream):
            n = rng.choice([1, 7, 4096, 1 << 18, 1 << 21])
            got += ours.feed(stream[i:i + n])
            want += theirs.feed(stream[i:i + n])
            i += n
        assert [bytes(g) for g in got] == want == chunks


@pytest.mark.parametrize("pair", list(PAIRS))
def test_large_in_band_frames_across_packages(pair, servers, monkeypatch):
    """Leaves of several MiB in-band (the lane off) both ways."""
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    client_mod, server_rpc = PAIRS[pair]
    srv = servers(server_rpc)
    c = client_mod.ServiceClient(srv.addr)
    try:
        rng = np.random.default_rng(9)
        x = {"big": rng.standard_normal(1 << 20).astype(np.float32),
             "mid": rng.standard_normal(300_001).astype(np.float32)}
        assert_same(c.call("echo", x), x)
    finally:
        c.close()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_trace_context_crosses_packages(pair, servers):
    """With tracing on at both ends, a caller's attached context rides
    the granted envelope and the handler runs under it."""
    client_mod, server_rpc = PAIRS[pair]
    ctx = {"t": "a" * 16, "s": "b" * 16, "x": 1}
    for mod in (trace, jtrace):
        mod.set_enabled(True)
    try:
        srv = servers(server_rpc)
        c = client_mod.ServiceClient(srv.addr)
        try:
            assert c._trace
            tmod = jtrace if client_mod is jservice else trace
            with tmod.attach_wire(ctx):
                assert c.call("ctx") == ctx
            assert c.call("ctx") is None
        finally:
            c.close()
    finally:
        trace.reset_for_tests()
        jtrace.reset_for_tests()


def test_daemon_pool_second_task_never_waits_behind_a_blocking_first():
    """A task submitted right after another, while one worker is idle,
    gets a worker of its own: the notified worker still counts as idle
    until it wakes, so the pool used to hand both tasks to it and the
    second waited for the first to end (a ``stats`` or ``drain`` RPC
    parked behind a whole ``adopt`` stream).  Many rounds, each with a
    first task that blocks until the second has run."""
    pool = rpc._DaemonPool("rpc-pin", max_workers=8)
    try:
        for _ in range(200):
            idle = threading.Event()
            pool.submit(idle.set)     # leaves one idle worker behind
            assert idle.wait(5)
            time.sleep(0.001)
            second = threading.Event()
            first_done = threading.Event()
            pool.submit(lambda: (second.wait(5), first_done.set()))
            pool.submit(second.set)
            assert second.wait(2), "the second task waited behind the first"
            assert first_done.wait(5)
    finally:
        pool.shutdown()
        pool.join()
