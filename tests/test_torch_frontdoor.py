"""The port's front door (theanompi_tpu_torch/frontdoor) and fleet prefix
cache (decode/fleetcache.py) on the CPU, held against the JAX package.

The LM pair of test_torch_decode.py (2 layers, d_model 64, 4 heads, vocab
64, the same numpy weights on both sides through the parameter bridge),
f32, exported by each package into its own directory; page geometry 4
tokens x 8 pages, 4 sequences, one prefill bucket of 8.  Everything runs
in this process over real loopback sockets with ``device="cpu"``; the
classes mirror JAX's ``tests/test_frontdoor.py``:

* ``TestRefusalMatrix``: ``manifest_incompatibility``,
  ``pages_incompatibility``, ``prefix_manifest`` and
  ``prefix_incompatibility`` return JAX's answers, string for string; a
  geometry-mismatched adopt is refused with the typed
  ``IncompatiblePages`` over the wire and the connection keeps serving;
* ``TestPrefill``: the port's prefill manifest equals JAX's
  ``PrefillServer``'s field for field, the first token is identical, and
  the exported k/v match JAX's on the prompt's positions within
  ``rtol=1e-5`` and ``atol=1e-5 * max|JAX|`` (f32, the same operations
  summed in other orders; they read about 3e-7 of the largest value);
  the page bytes the client receives are the bytes the server sent;
  ``export_pages_batch`` equals per-sequence ``export_pages`` bit for
  bit; admission sheds typed;
* ``TestRouter``: router streams give JAX's single-role greedy tokens
  (``DecodeSession``), token for token: plain, concurrent, failed over,
  drain-migrated (the autoscaler's drain-first scale-down) and
  fleet-cache-hit streams; shedding and refusals stay typed end to end;
  scale-up drops nothing, a removed backend drains before it closes; the
  ``router_route`` fault site;
* ``TestHysteresis`` and ``TestAutoscaler``: the controller's decisions
  and the signal fold equal JAX's on the same injected clock, loads and
  stats;
* ``TestFleetCache``: the authority's ops and the lease refusal matrix
  over the wire, eviction while leased, a cross-replica fleet hit whose
  tokens are JAX's;
* ``TestPrefillCoalescing``: N concurrent prefills run as ONE batch
  (``n_batches == 1``), each result held against JAX's serial path
  (``admit`` plus ``export_pages``; JAX's own coalescing test has been
  red since the seed run).

A slow-marked test runs ``DisaggregatedFleet`` as real child processes
with ``device="cpu"``.  The shared-memory lane is off
(``THEANOMPI_TPU_WIRE_SHM=0``); every socket, server thread and client
is closed before a test returns.
"""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode import Pair, prompts
from test_torch_train import two_torch_threads  # noqa: F401
from theanompi_tpu.decode import fleetcache as jfleetcache
from theanompi_tpu.decode import migrate as jmigrate
from theanompi_tpu.frontdoor import autoscale as jautoscale
from theanompi_tpu.frontdoor import prefill as jprefill
from theanompi_tpu.serving import export as jexport
from theanompi_tpu_torch.decode import DecodeSession, fleetcache
from theanompi_tpu_torch.decode.migrate import (
    GEOMETRY_FIELDS,
    IncompatiblePages,
    manifest_incompatibility,
    page_manifest,
    pages_incompatibility,
)
from theanompi_tpu_torch.frontdoor import (
    Autoscaler,
    HysteresisController,
    PrefillClient,
    PrefillServer,
    Router,
    RouterClient,
)
from theanompi_tpu_torch.frontdoor import autoscale as pautoscale
from theanompi_tpu_torch.frontdoor import prefill as prefill_mod
from theanompi_tpu_torch.frontdoor import router as router_mod
from theanompi_tpu_torch.parallel.service import ServiceError
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving import (
    InferenceClient,
    InferenceServer,
    Overloaded,
    export_model,
    serve,
)

KEY = "frontdoor-test-key"
DIMS = dict(vocab=64, seq_len=16, n_layers=2, d_model=64, n_heads=4)
GEO = dict(page_size=4, pages_per_seq=8, max_seqs=4, prefill_buckets=(8,))
pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.fixture(autouse=True)
def _wire_env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    yield
    faults.clear()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_greedy(lm, prompt, n: int) -> list[int]:
    """JAX's single-role greedy tokens (its ``DecodeSession``)."""
    return lm.jax_greedy(prompt, n, buckets=(8,))


def assert_pages_close(port, want, length: int):
    """Port pages against JAX's on the prompt's first ``length`` ring
    positions (the rest of a row holds whatever a page held before)."""
    def live(a):
        a = np.asarray(a, np.float64)
        return a.reshape(a.shape[0], -1, *a.shape[3:])[:, :length]

    w = live(want)
    np.testing.assert_allclose(live(port), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The pair, its port export and its JAX export (each package its own
    directory)."""
    pair = Pair(DIMS, seed=1)
    root = tmp_path_factory.mktemp("frontdoor")
    pair.port_dir = str(root / "port")
    export_model(pair.port, pair.port_dir, version=0)
    pair.jax.state = pair.jax.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, pair.params))
    pair.jax_dir = str(root / "jax")
    jexport.export_model(pair.jax, pair.jax_dir, version=0)
    return pair


def decode_server(lm, **over) -> InferenceServer:
    return InferenceServer(lm.port_dir, replicas=1, reload_poll_s=0,
                           decode=True, device="cpu",
                           decode_opts=dict(GEO, **over)).start()


def _serve_thread(target_serve, obj, port):
    """``target_serve(obj, ...)`` on 127.0.0.1:port in a thread; returns
    (addr, stop_event, thread)."""
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=target_serve,
                         args=(obj, "127.0.0.1", port, ready, stop),
                         daemon=True)
    t.start()
    assert ready.wait(30)
    return f"127.0.0.1:{port}", stop, t


@pytest.fixture(scope="module")
def servers(lm):
    """The servers, built once: the port's prefill server (also the fleet
    cache authority), two geometry-matched decode servers (A, B), one
    mismatched (C, page size 2), and JAX's prefill server.  No sockets
    here: the wire is per test."""
    pre = PrefillServer(lm.port_dir, max_pending=8, device="cpu", **GEO)
    srv = [decode_server(lm), decode_server(lm), decode_server(lm,
                                                                page_size=2)]
    jpre = jprefill.PrefillServer(lm.jax_dir, model=lm.jax, max_pending=8,
                                  warmup=False, **GEO)
    yield dict(prefill_server=pre, srv_a=srv[0], srv_b=srv[1],
               srv_c=srv[2], jax_prefill=jpre)
    for s in srv:
        s.stop()


class _Wire:
    """Serve loops started in one test and stopped at its end."""

    def __init__(self):
        self.stops, self.threads = [], []

    def up(self, target_serve, obj) -> str:
        addr, stop, t = _serve_thread(target_serve, obj, _free_port())
        self.stops.append(stop)
        self.threads.append(t)
        return addr

    def close(self):
        for stop in self.stops:
            stop.set()
        for t in self.threads:
            t.join(timeout=10)
            assert not t.is_alive()


@pytest.fixture()
def wire():
    w = _Wire()
    yield w
    w.close()


@pytest.fixture()
def stack(servers, wire):
    return dict(servers,
                prefill=wire.up(prefill_mod.serve,
                                servers["prefill_server"]),
                decode_a=wire.up(serve, servers["srv_a"]),
                decode_b=wire.up(serve, servers["srv_b"]),
                mismatch=wire.up(serve, servers["srv_c"]))


class _served_router:
    """Serve ``router`` on a free port; hand out clients; close the
    router, its loop and the clients on exit."""

    def __init__(self, router: Router):
        self.router = router
        self.clients: list[RouterClient] = []

    def __enter__(self):
        self.addr, self._stop, self._t = _serve_thread(
            router_mod.serve, self.router, _free_port())
        return self

    def client(self) -> RouterClient:
        c = RouterClient(self.addr)
        self.clients.append(c)
        return c

    def __exit__(self, *exc):
        for c in self.clients:
            c.close()
        self._stop.set()
        self._t.join(timeout=10)
        self.router.close()


def _stat(addr: str, key: str) -> int:
    c = InferenceClient(addr)
    try:
        return sum(r.get(key, 0) for r in c.stats()["replicas"])
    finally:
        c.close()


# ---------------------------------------------------------------------------
# the manifest, pages and prefix refusal matrix
# ---------------------------------------------------------------------------


class TestRefusalMatrix:
    def _cfg_and_pages(self, stack):
        """A prefilled stream's manifest and pages from the port, and the
        two packages' cache configs."""
        sess = stack["prefill_server"].session
        prompt = np.arange(1, 6, dtype=np.int32)
        with stack["prefill_server"]._lock:
            seq, logits = sess.admit(prompt)
            k, v = (a.numpy() for a in sess.export_pages(seq))
            man = page_manifest(sess.cfg, prompt, seq.length,
                                int(np.argmax(logits)))
            sess.release(seq)
        return sess.cfg, stack["jax_prefill"].session.cfg, man, k, v

    def test_compatible_passes(self, stack):
        cfg, jcfg, man, k, v = self._cfg_and_pages(stack)
        assert manifest_incompatibility(man, cfg) is None
        assert pages_incompatibility(man, k, v, cfg) is None
        assert jmigrate.pages_incompatibility(man, k, v, jcfg) is None

    def test_every_geometry_field_refused_as_jax(self, stack):
        cfg, jcfg, man, k, v = self._cfg_and_pages(stack)
        for f in GEOMETRY_FIELDS:
            bad = dict(man)
            bad[f] = "float64" if f == "dtype" else int(man[f]) + 1
            reason = manifest_incompatibility(bad, cfg)
            assert reason is not None and f in reason, (f, reason)
            assert reason == jmigrate.manifest_incompatibility(bad, jcfg)

    def test_missing_fields_and_lies_refused_as_jax(self, stack):
        cfg, jcfg, man, k, v = self._cfg_and_pages(stack)
        cases = [({x: y for x, y in man.items() if x != f}, k, v)
                 for f in (*GEOMETRY_FIELDS, "length", "prompt",
                           "first_token")]
        cases += [(dict(man, length=0), k, v),
                  (dict(man, prompt=man["prompt"] + [1]), k, v),
                  # the manifest can lie about the arrays
                  (man, k[:, :1], v), (man, k, v.astype(np.float64))]
        for m, kk, vv in cases:
            got = pages_incompatibility(m, kk, vv, cfg)
            assert got is not None
            assert got == jmigrate.pages_incompatibility(m, kk, vv, jcfg)

    def test_prefix_manifest_and_incompatibility_equal_jax(self, stack):
        cfg, jcfg, man, k, v = self._cfg_and_pages(stack)
        prefix = np.asarray(man["prompt"][:4], np.int32)
        pm = fleetcache.prefix_manifest(cfg, prefix, version=3)
        assert pm == jfleetcache.prefix_manifest(jcfg, prefix, version=3)
        pk, pv = k[:, :1], v[:, :1]
        cases = [(pm, pk, pv), ("nope", pk, pv),
                 ({x: y for x, y in pm.items() if x != "n_tokens"}, pk, pv),
                 (dict(pm, page_size=8), pk, pv),
                 (dict(pm, dtype="bfloat16"), pk, pv),
                 (dict(pm, n_tokens=3, prefix=pm["prefix"][:3]), pk, pv),
                 (dict(pm, n_tokens=36, prefix=list(range(36))), pk, pv),
                 (dict(pm, prefix=pm["prefix"] + [1]), pk, pv),
                 (pm, k[:, :2], pv), (pm, pk, pv.astype(np.float64))]
        got = [fleetcache.prefix_incompatibility(m, a, b, cfg)
               for m, a, b in cases]
        assert got == [jfleetcache.prefix_incompatibility(m, a, b, jcfg)
                       for m, a, b in cases]
        assert got[0] is None and all(got[1:])

    def test_mismatch_refused_over_wire_connection_survives(self, stack,
                                                             lm):
        """Geometry-correct pages shipped to the page-size-2 server: the
        typed ``IncompatiblePages`` rides the wire, and the same client
        connection (and the replica) keep serving."""
        _, _, man, k, v = self._cfg_and_pages(stack)
        c = InferenceClient(stack["mismatch"])
        try:
            with pytest.raises(IncompatiblePages,
                               match="page geometry mismatch"):
                c.adopt(man, k, v, 4)
            out = c.generate(np.asarray(man["prompt"], np.int32), 4)
            assert out.tolist() == jax_greedy(lm, man["prompt"], 4)
            assert sum(r.get("adopt_refused", 0)
                       for r in c.stats()["replicas"]) >= 1
        finally:
            c.close()


# ---------------------------------------------------------------------------
# prefill.py
# ---------------------------------------------------------------------------


class TestPrefill:
    def test_manifest_first_token_and_pages_equal_jax(self, stack):
        port, jpre = stack["prefill_server"], stack["jax_prefill"]
        for p in prompts(31, 5, 8, 3):
            man, pages = port.prefill(p)
            jman, jpages = jpre.prefill(p)
            assert man == jman           # first_token included
            for got, want in zip(pages, jpages):
                assert got.dtype == np.float32
                assert_pages_close(got, want, len(p))

    def test_pages_byte_identical_over_wire(self, stack):
        """The page bytes the client receives are exactly the bytes the
        server handler returned (raw frames, no re-encoding)."""
        server = stack["prefill_server"]
        sent = {}
        orig = server.prefill

        def spy(prompt):
            man, raw = orig(prompt)
            sent["k"], sent["v"] = raw
            return man, raw

        server.prefill = spy
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        c = PrefillClient(stack["prefill"])
        try:
            man, k, v = c.prefill(prompt)
        finally:
            c.close()
            del server.prefill
        assert man["prompt"] == prompt.tolist()
        assert man["length"] == len(prompt)
        for got, want in ((k, sent["k"]), (v, sent["v"])):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()

    def test_export_pages_batch_equals_per_sequence(self, lm):
        sess = DecodeSession(lm.port, **GEO)
        seqs = [sess.admit(p)[0] for p in prompts(32, 5, 8, 2)]
        batch = sess.export_pages_batch(seqs)
        assert len(batch) == len(seqs)
        for seq, (k, v) in zip(seqs, batch):
            k1, v1 = sess.export_pages(seq)
            assert torch.equal(k, k1) and torch.equal(v, v1)
            assert k.device.type == "cpu"
        for seq in seqs:
            sess.release(seq)

    def test_admission_shed_is_typed(self, lm):
        server = PrefillServer(lm.port_dir, max_pending=0, warmup=False,
                               device="cpu", **GEO)
        with pytest.raises(Overloaded, match="max_pending"):
            server.prefill(np.asarray([1, 2, 3], np.int32))
        assert server.stats()["overloaded"] == 1
        with pytest.raises(ValueError, match="prompt length"):
            PrefillServer(lm.port_dir, warmup=False, device="cpu",
                          **GEO).prefill(np.arange(9, dtype=np.int32))

    def test_cuda_device_without_a_card_raises(self, lm):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="is_available"):
            PrefillServer(lm.port_dir, warmup=False, **GEO)


# ---------------------------------------------------------------------------
# router.py
# ---------------------------------------------------------------------------


class TestRouter:
    def test_stream_equals_jax_single_role(self, stack, lm):
        """router(prefill, pages over the wire, adopt) equals the port's
        single-role decode server and JAX's greedy tokens."""
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"]])
        with _served_router(router) as sr:
            single = InferenceClient(stack["decode_b"])
            try:
                for p in prompts(17, 5, 7, 8):
                    got = sr.client().generate(p, 10)
                    assert got.tolist() == single.generate(p, 10).tolist()
                    assert got.tolist() == jax_greedy(lm, p, 10)
            finally:
                single.close()
            st = sr.client().stats()
            assert st["streams"] == 3
            assert st["shed"] == 0 and st["failovers"] == 0

    def test_concurrent_streams_all_equal_jax(self, stack, lm):
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"], stack["decode_b"]])
        with _served_router(router) as sr:
            ps = prompts(23, *(5 + i % 4 for i in range(6)))
            outs = [None] * len(ps)
            clients = [sr.client() for _ in ps]

            def run(i):
                outs[i] = clients[i].generate(ps[i], 8)

            ths = [threading.Thread(target=run, args=(i,))
                   for i in range(len(ps))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            for p, o in zip(ps, outs):
                assert o is not None and o.tolist() == jax_greedy(lm, p, 8)

    def test_dead_decode_backend_fails_over_to_jax_tokens(self, stack, lm):
        dead = f"127.0.0.1:{_free_port()}"  # nobody listening
        router = Router(prefill=[stack["prefill"]],
                        decode=[dead, stack["decode_a"]])
        router._rr["decode"] = 0  # the dead backend is tried first
        prompt = np.asarray([2, 7, 1, 8], np.int32)
        try:
            assert router.generate(prompt, 8).tolist() == \
                jax_greedy(lm, prompt, 8)
            st = router.stats()
            assert st["failovers"] == 1 and st["shed"] == 0
        finally:
            router.close()

    def test_failover_budget_exhausts_to_connection_error(self, stack):
        dead = f"127.0.0.1:{_free_port()}"
        router = Router(prefill=[stack["prefill"]], decode=[dead],
                        failover_attempts=1)
        try:
            with pytest.raises(ConnectionError):
                router.generate(np.asarray([1, 2, 3], np.int32), 4)
            assert router.stats()["failovers"] == 1
        finally:
            router.close()

    def test_overload_sheds_typed_end_to_end(self, stack):
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"]], max_streams=0)
        with _served_router(router) as sr:
            with pytest.raises(Overloaded, match="max_streams"):
                sr.client().generate(np.asarray([1, 2], np.int32), 4)
        router = Router(prefill=[stack["prefill"]], decode=[])
        with _served_router(router) as sr:
            c = sr.client()
            with pytest.raises(Overloaded, match="decode"):
                c.generate(np.asarray([1, 2], np.int32), 4)
            assert c.stats()["shed"] >= 1   # the connection survives

    def test_incompatible_backend_propagates_typed(self, stack):
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["mismatch"]])
        with _served_router(router) as sr:
            c = sr.client()
            with pytest.raises(IncompatiblePages,
                               match="page geometry mismatch"):
                c.generate(np.asarray([1, 2, 3], np.int32), 4)
            assert c.stats()["active_streams"] == 0

    def test_router_route_fault_site(self, stack, lm):
        """'raise' at ``router_route`` rejects one routed request with a
        typed err; the connection and the fleets keep serving."""
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"]])
        with _served_router(router) as sr:
            c = sr.client()
            faults.install([{"site": "router_route", "op": "generate",
                             "nth": 1}])
            p = np.asarray([5, 3, 5], np.int32)
            with pytest.raises(ServiceError, match="FaultInjected"):
                c.generate(p, 4)
            faults.clear()
            assert c.generate(p, 4).tolist() == jax_greedy(lm, p, 4)

    def test_scale_up_admits_with_zero_dropped_streams(self, stack, lm):
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"]])
        adopted_b0 = _stat(stack["decode_b"], "adopted")
        with _served_router(router) as sr:
            prompt = np.asarray([4, 4, 2], np.int32)
            want = jax_greedy(lm, prompt, 6)
            assert sr.client().generate(prompt, 6).tolist() == want
            router.add_backend("decode", stack["decode_b"])
            outs = [None] * 4
            clients = [sr.client() for _ in outs]

            def run(i):
                outs[i] = clients[i].generate(prompt, 6)

            ths = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            assert all(o is not None and o.tolist() == want for o in outs)
            assert sr.client().stats()["shed"] == 0
        assert _stat(stack["decode_b"], "adopted") > adopted_b0

    def test_scale_down_drains_before_close(self, stack, lm):
        router = Router(prefill=[stack["prefill"]],
                        decode=[stack["decode_a"], stack["decode_b"]])
        try:
            with router._lock:
                b = next(x for x in router._backends["decode"]
                         if x.addr == stack["decode_b"])
            inflight = b.acquire()  # one stream parked on B
            router.remove_backend("decode", stack["decode_b"])
            assert router.backend_streams("decode", stack["decode_b"]) == 1
            assert all(x.addr != stack["decode_b"]
                       for x in router._candidates("decode"))
            prompt = np.asarray([6, 1, 6], np.int32)
            assert router.generate(prompt, 5).tolist() == \
                jax_greedy(lm, prompt, 5)
            assert b.release(inflight, ok=True) is True
            router._drop_if_drained(b)
            assert router.backend_streams("decode", stack["decode_b"]) == 0
            assert all(s["addr"] != stack["decode_b"]
                       for s in router.stats()["backends"]["decode"])
        finally:
            router.close()

    def test_drain_first_scale_down_migrates_to_jax_tokens(self, stack, lm,
                                                           wire):
        """The autoscaler's scale-down of a decode backend with a stream
        in flight: the backend drains, hands the stream back as pages,
        the router adopts them on the survivor, and the stitched tokens
        are JAX's."""
        victim_srv = decode_server(lm)
        try:
            victim = wire.up(serve, victim_srv)
            router = Router(prefill=[stack["prefill"]],
                            decode=[victim, stack["decode_a"]])
            router._rr["decode"] = 0   # the stream starts on the victim
            group = _FakeGroup([stack["decode_a"], victim])
            scaler = Autoscaler(router, {"decode": group}, {},
                                drain_timeout_s=30.0)
            (p,) = prompts(33, 5)
            n = 200
            res = {}
            # 10 ms a decode step: the drain lands mid-stream
            faults.install([{"site": "decode_step", "action": "delay",
                             "delay_s": 0.01, "times": -1}])
            t = threading.Thread(
                target=lambda: res.setdefault("out", router.generate(p, n)))
            t.start()
            probe = InferenceClient(victim)
            try:
                deadline = time.monotonic() + 30
                while probe.stats()["tokens"] < 5:
                    assert time.monotonic() < deadline
                    time.sleep(0.002)
            finally:
                probe.close()
            assert scaler._scale_down("decode") == victim
            t.join(60)
            scaler.stop()
            faults.clear()
            assert res["out"].tolist() == jax_greedy(lm, p, n)
            st = router.stats()
            assert st["migrations"] == 1 and st["shed"] == 0
            assert group.released == [victim]
            assert all(s["addr"] != victim
                       for s in st["backends"]["decode"])
            router.close()
        finally:
            victim_srv.stop()


# ---------------------------------------------------------------------------
# autoscale.py: the controller and the signal fold, against JAX's
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class TestHysteresis:
    def test_validation(self):
        with pytest.raises(ValueError, match="down < up"):
            HysteresisController(up=0.2, down=0.8)
        with pytest.raises(ValueError, match="min_size"):
            HysteresisController(min_size=3, max_size=2)

    def test_hold_then_up_then_cooldown(self):
        clk = _Clock()
        c = HysteresisController(up=0.8, down=0.2, hold=2,
                                 cooldown_s=10.0, max_size=4, clock=clk)
        assert c.decide(0.9, 1) == 0
        assert c.decide(0.9, 1) == 1
        assert c.decide(0.9, 2) == 0
        assert c.decide(0.9, 2) == 0
        clk.t = 11.0
        assert c.decide(0.9, 2) == 1

    def test_dead_band_resets_breaches(self):
        c = HysteresisController(up=0.8, down=0.2, hold=2, cooldown_s=0.0,
                                 clock=_Clock())
        assert [c.decide(x, 1) for x in (0.9, 0.5, 0.9, 0.9)] == \
            [0, 0, 0, 1]

    def test_down_and_size_clamps(self):
        c = HysteresisController(up=0.8, down=0.2, hold=2, cooldown_s=0.0,
                                 min_size=1, max_size=2, clock=_Clock())
        assert [c.decide(x, s) for x, s in ((0.1, 2), (0.1, 2), (0.1, 1),
                                            (0.1, 1), (0.9, 2), (0.9, 2))] \
            == [0, -1, 0, 0, 0, 0]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_decisions_equal_jax(self, seed):
        """One random load sequence and clock on both controllers: the
        same decisions, poll for poll, with the size following them."""
        rng = np.random.default_rng(seed)
        kw = dict(up=0.7, down=0.3, hold=int(rng.integers(1, 4)),
                  cooldown_s=float(rng.uniform(0, 5)), min_size=1,
                  max_size=4)
        pc, jc = _Clock(), _Clock()
        port = HysteresisController(clock=pc, **kw)
        ref = jautoscale.HysteresisController(clock=jc, **kw)
        size, got, want = 2, [], []
        for load, dt in zip(rng.uniform(0, 1, 200), rng.uniform(0, 2, 200)):
            pc.t = jc.t = pc.t + float(dt)
            d = port.decide(float(load), size)
            got.append(d)
            want.append(ref.decide(float(load), size))
            size += d
        assert got == want and any(got)


class _FakeGroup:
    def __init__(self, addrs):
        self._addrs = list(addrs)
        self.grown = 0
        self.released: list[str] = []

    def addresses(self):
        return list(self._addrs)

    def __len__(self):
        return len(self._addrs)

    def grow(self):
        self.grown += 1
        addr = f"127.0.0.1:{9000 + self.grown}"
        self._addrs.append(addr)
        return addr

    def release(self, addr):
        self._addrs.remove(addr)
        self.released.append(addr)


class _FakeRouter:
    def __init__(self):
        self.log: list[tuple] = []

    def add_backend(self, role, addr):
        self.log.append(("add", role, addr))

    def remove_backend(self, role, addr):
        self.log.append(("remove", role, addr))

    def backend_streams(self, role, addr):
        return 0


class TestAutoscaler:
    def _scaler(self, stats_map, mod=pautoscale, **ctl):
        group = _FakeGroup(list(stats_map))
        router = _FakeRouter()
        ctl.setdefault("hold", 1)
        ctl.setdefault("cooldown_s", 0.0)
        ctl.setdefault("clock", _Clock())
        scaler = mod.Autoscaler(
            router, {"decode": group},
            {"decode": mod.HysteresisController(**ctl)},
            drain_timeout_s=0.2)
        scaler._stats = lambda addr: stats_map.get(addr)
        return scaler, group, router

    def test_replica_load_fold_equals_jax(self):
        stats = [
            ("a", {"role": "prefill", "inflight": 4, "max_pending": 8,
                   "overloaded": 0}),
            ("b", {"overloaded": 0, "replicas": [
                {"pending": 2, "active": 3, "free_pages": 8,
                 "intertoken_ms": {"p99": 25.0}}]}),
            ("b", {"overloaded": 0, "replicas": [
                {"pending": 9, "active": 1, "free_pages": 2,
                 "intertoken_ms": None}, {"pending": 0}]}),
            ("c", {"role": "prefill", "inflight": 0, "max_pending": 8,
                   "overloaded": 5}),
            ("c", {"role": "prefill", "inflight": 0, "max_pending": 8,
                   "overloaded": 6}),
            ("c", {"role": "prefill", "inflight": 1, "max_pending": 0,
                   "overloaded": 6})]
        for slo in (None, 10.0):
            port, _, _ = self._scaler({})
            ref, _, _ = self._scaler({}, mod=jautoscale)
            port.slo_p99_ms = ref.slo_p99_ms = slo
            got = [port._replica_load(a, s) for a, s in stats]
            assert got == [ref._replica_load(a, s) for a, s in stats]
        assert got[:2] == [pytest.approx(0.5), pytest.approx(2.5)]
        assert got[3:5] == [0.0, 1.0]   # the first count only primes

    def test_tick_scales_up_on_load(self):
        scaler, group, router = self._scaler({"127.0.0.1:8001": {
            "role": "prefill", "inflight": 8, "max_pending": 8,
            "overloaded": 0}})
        scaler.tick()
        assert group.grown == 1
        assert router.log == [("add", "decode", "127.0.0.1:9001")]
        assert scaler.events == [("decode", "up", "127.0.0.1:9001")]

    def test_tick_drains_then_releases_on_idle(self):
        idle = {"role": "prefill", "inflight": 0, "max_pending": 8,
                "overloaded": 0}
        scaler, group, router = self._scaler(
            {"127.0.0.1:8001": idle, "127.0.0.1:8002": idle})
        scaler.tick()
        assert router.log == [("remove", "decode", "127.0.0.1:8002")]
        assert group.released == ["127.0.0.1:8002"]
        assert scaler.events == [("decode", "down", "127.0.0.1:8002")]
        scaler.tick()   # at min_size the controller stops shrinking
        assert group.released == ["127.0.0.1:8002"]

    def test_dead_replica_does_not_end_the_loop(self):
        scaler, group, router = self._scaler({"127.0.0.1:8001": None})
        scaler.tick()
        assert router.log == [] and group.released == []


# ---------------------------------------------------------------------------
# the fleet prefix cache: authority ops and the lease refusal matrix
# ---------------------------------------------------------------------------


class TestFleetCache:
    def test_register_then_lookup_ships_identical_bytes(self, stack, lm):
        sess = DecodeSession(lm.port, **GEO)
        c = fleetcache.FleetCacheClient(stack["prefill"])
        try:
            (prompt,) = prompts(41, 8)
            assert c.lookup(prompt) is None
            seq, _ = sess.admit(prompt)
            k, v = sess.export_page_ids([int(seq.page_row[0])])
            man = fleetcache.prefix_manifest(sess.cfg, prompt[:4])
            assert c.register_prefix(man, k, v)["added"] is True
            got = c.lookup(prompt)
            assert got is not None
            m2, k2, v2, lease = got
            assert m2["n_tokens"] == 4
            assert m2["prefix"] == prompt[:4].tolist()
            assert k2.tobytes() == k.numpy().tobytes()
            assert v2.tobytes() == v.numpy().tobytes()
            c.decref(lease)
            sess.release(seq)
        finally:
            c.close()

    def test_lease_refusal_matrix_over_wire(self, stack):
        pre = stack["prefill_server"]
        c = fleetcache.FleetCacheClient(stack["prefill"])
        try:
            with pytest.raises(fleetcache.LeaseError, match="lease"):
                c.decref("lease-0-999999")           # foreign
            (prompt,) = prompts(42, 8)
            pre.prefill(prompt)       # a cold prefill seeds the cache
            man, k, v, lease = c.lookup(prompt)
            c.decref(lease)
            with pytest.raises(fleetcache.LeaseError, match="lease"):
                c.decref(lease)                      # double decref
            with pytest.raises(IncompatiblePages, match="page_size"):
                c.register_prefix(dict(man, page_size=8), k, v)
            got = c.lookup(prompt)   # the same connection still answers
            assert got is not None
            c.decref(got[3])
            assert pre.stats()["fleet_cache_leases"] == 0
        finally:
            c.close()

    def test_evict_while_leased_pages_survive(self, stack):
        pre = stack["prefill_server"]
        sess = pre.session
        (prompt,) = prompts(43, 8)
        pre.prefill(prompt)
        _, _, lease = pre.cache_lookup(prompt)
        page_ids = list(pre._leases[lease])
        with pre._lock:
            sess.prefix_cache.evict_all()
        assert all(sess.pool.refcount(p) >= 1 for p in page_ids)
        pre.cache_decref(lease)
        assert all(sess.pool.refcount(p) == 0 for p in page_ids)

    def test_cross_replica_fleet_hit_gives_jax_tokens(self, stack, lm):
        """A session with the authority as its fleet cache turns a local
        miss into an adopted local hit, and registers its own cold
        prefixes back; its tokens are JAX's and no lease is left."""
        pre = stack["prefill_server"]
        (prompt, p2) = prompts(44, 8, 8)
        pre.prefill(prompt)          # the authority caches prompt[:4]
        sess = DecodeSession(lm.port, **GEO)
        sess.fleet = fleetcache.FleetCacheClient(stack["prefill"])
        try:
            leases0 = len(pre._leases)
            seq, lg = sess.admit(prompt)   # miss -> fetch -> local hit
            assert sess.prefix_cache.hits == 1
            assert len(pre._leases) == leases0
            out = [int(np.argmax(lg))]
            for _ in range(5):
                l2 = sess.decode([seq], np.asarray([out[-1]], np.int32))
                out.append(int(np.argmax(l2[0])))
            assert out == jax_greedy(lm, prompt, 6)
            sess.admit(p2)           # a cold admit registers its prefix
            got = pre.cache_lookup(p2)
            assert got is not None and got[0]["n_tokens"] == 4
            pre.cache_decref(got[2])
        finally:
            sess.fleet.close()

    def test_fleet_hit_stream_through_router_gives_jax_tokens(self, stack,
                                                              lm, wire):
        """A second prefill replica pointed at the authority: a routed
        prompt whose page-aligned prefix only the authority holds is a
        fleet hit there (a lease taken and returned), and the stream's
        tokens are JAX's."""
        pre = stack["prefill_server"]
        peer = PrefillServer(lm.port_dir, device="cpu",
                             fleet_cache=stack["prefill"], **GEO)
        try:
            peer_addr = wire.up(prefill_mod.serve, peer)
            (seed_prompt,) = prompts(45, 7)
            pre.prefill(seed_prompt)   # only the authority holds it
            prompt = np.concatenate([seed_prompt[:4], [9, 9, 9]]).astype(
                np.int32)
            hits0 = pre.stats()["prefix_cache"]["hits"]
            router = Router(prefill=[peer_addr], decode=[stack["decode_a"]])
            try:
                got = router.generate(prompt, 8)
            finally:
                router.close()
            assert got.tolist() == jax_greedy(lm, prompt, 8)
            assert pre.stats()["prefix_cache"]["hits"] == hits0 + 1
            assert pre.stats()["fleet_cache_leases"] == 0
            assert peer.stats()["prefix_cache"]["hits"] == 1
        finally:
            peer.session.fleet.close()


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------


class TestPrefillCoalescing:
    def test_concurrent_prefills_coalesce_into_one_batch(self, lm):
        """4 concurrent ``prefill`` calls ride ONE batched program (the
        leader waits out the oldest prompt's deadline); each caller's
        manifest equals JAX's serial path (``admit`` plus
        ``export_pages``) and its pages match JAX's."""
        pre = PrefillServer(lm.port_dir, max_pending=8, warmup=False,
                            prefill_delay_ms=250.0, device="cpu", **GEO)
        ps = prompts(46, *(6 + i % 3 for i in range(4)))
        results = [None] * 4

        def run(i):
            results[i] = pre.prefill(ps[i])

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert pre.n_batches == 1 and pre.n_prefills == 4
        jsess = lm.jax_session(4, 8, (8,))
        for p, (man, pages) in zip(ps, results):
            seq, logits = jsess.admit(p)
            jk, jv = jsess.export_pages(seq)
            want = jmigrate.page_manifest(jsess.cfg, p, seq.length,
                                          int(np.argmax(logits)))
            jsess.release(seq)
            assert man == want
            assert_pages_close(pages[0], jk, len(p))
            assert_pages_close(pages[1], jv, len(p))


# ---------------------------------------------------------------------------
# the real-subprocess fleet (slow set)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_disaggregated_fleet_subprocess_roundtrip(lm, monkeypatch):
    """``DisaggregatedFleet`` on the CPU: real prefill and decode child
    processes (``--device cpu``), the router in this process, one client
    stream with JAX's tokens."""
    from theanompi_tpu_torch.frontdoor.fleet import DisaggregatedFleet

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    with DisaggregatedFleet(lm.port_dir, prefill=1, decode=1,
                            device="cpu", **GEO) as fleet:
        c = RouterClient(fleet.router_addr)
        try:
            prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
            assert c.generate(prompt, 8).tolist() == \
                jax_greedy(lm, prompt, 8)
            st = c.stats()
            assert st["streams"] == 1 and st["shed"] == 0
        finally:
            c.close()
    assert not torch.cuda.is_initialized()
