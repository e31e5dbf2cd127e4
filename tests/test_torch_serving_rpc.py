"""The serving plane over TCP on the CPU: ``serve()`` and
``InferenceClient`` on loopback, eval and decode servers, quantized
exports, hot reload and the fault sites.

* Eval: a narrow ResNet (stage sizes (1, 1, 1, 1), width 8, 10 classes,
  32-pixel crops, f32) exported f32, bf16 and int8.  ``infer`` over TCP
  is bit-identical to the in-process ``InferenceServer.submit`` of the
  same rows, and the f32 answers match the JAX package's eval of the
  same weights (test_torch_serving.py's ``ref``; ``rtol=1e-4,
  atol=1e-5``).  ``stats``, ``reload`` (a new version, then a refused
  int8 publish with the typed ``IncompatibleExport``) and a ``serve_rpc``
  fault the client survives.
* Decode: the LM pair of test_torch_decode.py (2 layers, d_model 64, 4
  heads, vocab 64, the same weights as JAX's); ``generate`` over TCP
  gives JAX's ``DecodeSession``'s greedy tokens, also when the JAX
  package's own client asks; hot-reload refusal; a stream drained from
  one server and adopted by another (``drain_migrate``, ``adopt``) ends
  on the tokens it would have made in place; the ``decode_step`` and
  ``page_migrate`` fault sites; the draft export's refusal matrix.

The shared-memory lane is off (``THEANOMPI_TPU_WIRE_SHM=0``), so no
``tmshm_*`` segment is made; every server thread is shut down and every
client closed before a test returns.
"""

import contextlib
import socket
import threading
import time

import numpy as np
import pytest

from test_torch_decode import VOCAB, Pair, prompts  # noqa: F401
from test_torch_serving import close, port_model, ref  # noqa: F401
from test_torch_train import two_torch_threads  # noqa: F401
from theanompi_tpu.serving import export as jexport
from theanompi_tpu_torch.decode.scheduler import MigratedStream
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.parallel.service import ServiceError
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving import (
    BatchPolicy,
    IncompatibleExport,
    InferenceClient,
    InferenceServer,
    InferenceSession,
    draft_incompatibility,
    export_model,
    load_export,
    serve,
)

KEY = "serving-rpc-test-key"
pytestmark = pytest.mark.usefixtures("two_torch_threads")
DECODE_OPTS = dict(page_size=4, pages_per_seq=8, max_seqs=4,
                   prefill_buckets=(8,))


@pytest.fixture(autouse=True)
def _wire_env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    yield
    faults.clear()


@pytest.fixture(scope="module")
def lm():
    return Pair(dict(vocab=VOCAB, seq_len=16, n_layers=2, d_model=64,
                     n_heads=4), seed=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def served(server: InferenceServer):
    """``serve(server)`` on a loopback port in a thread; yields a client
    factory; shuts the loop, the clients and the server down."""
    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=serve, args=(server, "127.0.0.1", port,
                                             ready, stop), daemon=True)
    t.start()
    assert ready.wait(30)
    clients = []

    def client() -> InferenceClient:
        c = InferenceClient(f"127.0.0.1:{port}")
        clients.append(c)
        return c

    try:
        yield client
    finally:
        stop.set()
        for c in clients:
            c.close()
        t.join(10)
        server.stop()
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# Eval serving over TCP
# ---------------------------------------------------------------------------


class TestEvalServing:
    def test_infer_stats_reload_and_fault_over_tcp(self, ref, tmp_path):
        d = str(tmp_path / "export")
        export_model(port_model(ref.v0), d, version=0)
        server = InferenceServer(d, replicas=1, device="cpu",
                                 reload_poll_s=0,
                                 policy=BatchPolicy(max_batch=4)).start()
        with served(server) as client:
            c = client()
            got = c.infer(ref.rows[:3])
            assert np.array_equal(got, server.submit(ref.rows[:3]))
            assert close(got, ref.want0[:3])
            st = c.stats()
            assert st["decode"] is False and st["batches"] == 2
            assert st["rows"] == 6 and st["version"] == 0
            export_model(port_model(ref.v1), d, version=1)
            assert c.reload() == 1
            assert close(c.infer(ref.rows[3:7]), ref.want1[3:7])
            export_model(port_model(ref.v1), d, version=2,
                         weight_dtype="int8")
            with pytest.raises(IncompatibleExport, match="weight_dtype"):
                c.reload()
            with pytest.raises(IncompatibleExport):
                c.reload()
            assert server.version == 1
            faults.install([{"site": "serve_rpc", "op": "infer",
                             "nth": 1}])
            with pytest.raises(ServiceError, match="FaultInjected"):
                c.infer(ref.rows[:1])
            faults.clear()
            assert close(c.infer(ref.rows[:2]), ref.want1[:2])
            assert c.call("ping") == "pong"

    @pytest.mark.parametrize("wd", ["bf16", "int8"])
    def test_quantized_export_over_tcp(self, ref, tmp_path, wd):
        """A quantized export serves over TCP bit-identically to the
        in-process session of the same dequantized weights, near the f32
        answers (within 5% relative L2 per row)."""
        d = str(tmp_path / wd)
        export_model(port_model(ref.v0), d, version=0, weight_dtype=wd)
        loaded = load_export(d)
        assert loaded.meta["weight_dtype"] == wd
        session = InferenceSession(port_model(None), state=loaded.state,
                                   version=0)
        server = InferenceServer(d, replicas=1, device="cpu",
                                 reload_poll_s=0,
                                 policy=BatchPolicy(max_batch=8)).start()
        with served(server) as client:
            got = client().infer(ref.rows[:8])
        assert np.array_equal(got, session.infer(ref.rows[:8]))
        rel = (np.linalg.norm(got - ref.want0[:8], axis=1)
               / np.linalg.norm(ref.want0[:8], axis=1))
        assert rel.max() < 0.05, rel


# ---------------------------------------------------------------------------
# Decode serving over TCP
# ---------------------------------------------------------------------------


def decode_server(export_dir: str, **opts) -> InferenceServer:
    return InferenceServer(export_dir, replicas=1, reload_poll_s=0,
                           decode=True, device="cpu",
                           decode_opts=dict(DECODE_OPTS, **opts)).start()


class TestDecodeServing:
    def test_generate_over_wire_two_streams(self, lm, tmp_path):
        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0)
        pa, pb = prompts(8, 5, 7)
        with served(decode_server(d)) as client:
            outs = [None, None]
            cs = [client(), client()]

            def run(i, p):
                outs[i] = cs[i].generate(p, 10)

            ths = [threading.Thread(target=run, args=(i, p))
                   for i, p in enumerate((pa, pb))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            for p, o in zip((pa, pb), outs):
                assert o is not None and o.dtype == np.int32
                assert o.tolist() == lm.jax_greedy(p, 10, buckets=(8,))
            st = cs[0].stats()
            assert st["decode"] is True and st["tokens"] == 20
            assert st["replicas"][0]["compiles"]["decode"] >= 1
            with pytest.raises(ServiceError, match="generate"):
                cs[0].infer(np.zeros((1, 16), np.int32))

    def test_jax_client_generates_on_the_port_server(self, lm, tmp_path):
        from theanompi_tpu.serving import InferenceClient as JaxClient

        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0)
        (p,) = prompts(9, 6)
        with served(decode_server(d)) as client:
            jc = JaxClient(client().address[0] + ":"
                           + str(client().address[1]))
            try:
                got = jc.generate(p, 8)
                assert got.tolist() == lm.jax_greedy(p, 8, buckets=(8,))
                assert jc.stats()["tokens"] == 8
            finally:
                jc.close()

    def test_reload_refuses_incompatible_then_accepts(self, lm, tmp_path):
        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0)
        server = decode_server(d)
        with served(server) as client:
            c = client()
            export_model(lm.port, d, version=1, weight_dtype="int8")
            for _ in range(2):
                with pytest.raises(IncompatibleExport, match="weight_dtype"):
                    c.reload()
            assert server.version == 0
            assert len(c.generate(np.asarray([1, 2, 3], np.int32), 4)) == 4
            export_model(lm.port, d, version=2)
            assert c.reload() == 2 and server.version == 2

    def test_decode_mode_requires_capable_export(self, ref, tmp_path):
        d = str(tmp_path / "cnn")
        export_model(port_model(ref.v0), d, version=0)
        assert load_export(d).meta["decode"] is False
        with pytest.raises(ValueError, match="decode-capable"):
            InferenceServer(d, reload_poll_s=0, decode=True, device="cpu")

    def test_drained_stream_adopted_by_another_server(self, lm, tmp_path):
        """``drain_migrate`` on server A while a stream generates: the
        caller gets a ``MigratedStream`` over the wire; ``adopt`` on
        server B finishes it, and the stitched tokens are JAX's."""
        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0)
        (p,) = prompts(10, 5)
        n = 200  # within DecodePolicy.max_new_cap (256)
        want = lm.jax_greedy(p, n, buckets=(8,))
        with served(decode_server(d)) as client_a, \
                served(decode_server(d)) as client_b:
            a = client_a()
            res = {}
            t = threading.Thread(
                target=lambda: res.setdefault("out", a.generate(p, n)))
            t.start()
            probe = client_a()
            for _ in range(2000):
                if probe.stats()["tokens"] >= 5:
                    break
                time.sleep(0.005)
            assert probe.drain_migrate() == 1
            t.join(60)
            out = res["out"]
            assert isinstance(out, MigratedStream)
            assert 5 <= len(out.tokens) < n
            assert out.manifest["first_token"] == want[len(out.tokens)]
            b = client_b()
            faults.install([{"site": "page_migrate", "side": "adopt",
                             "nth": 1}])
            with pytest.raises(ServiceError, match="FaultInjected"):
                b.adopt(out.manifest, out.k, out.v, n - len(out.tokens))
            faults.clear()
            rest = b.adopt(out.manifest, out.k, out.v, n - len(out.tokens))
            assert out.tokens + rest.tolist() == want

    def test_decode_step_fault_over_wire_restarts_replica(self, lm,
                                                          tmp_path):
        d = str(tmp_path / "export")
        export_model(lm.port, d, version=0)
        (p,) = prompts(11, 4)
        server = decode_server(d)
        with served(server) as client:
            c = client()
            faults.install([{"site": "decode_step", "replica": 0,
                             "nth": 2}])
            with pytest.raises(ServiceError, match="FaultInjected"):
                c.generate(p, 6)
            faults.clear()
            assert c.generate(p, 6).tolist() == lm.jax_greedy(
                p, 6, buckets=(8,))
            st = c.stats()
            assert st["replicas"][0]["restarts"] == 1
            assert st["live_replicas"] == 1


# ---------------------------------------------------------------------------
# Draft exports (speculative decoding)
# ---------------------------------------------------------------------------


def _lm(vocab=VOCAB, **dims) -> TransformerLM:
    net = dict(vocab=vocab, seq_len=16, n_layers=1, d_model=16, n_heads=1)
    net.update(dims)
    return TransformerLM(config=ModelConfig(batch_size=4,
                                            compute_dtype="float32"),
                         device="cpu", **net)


class TestDraftServing:
    def test_draft_incompatibility_matrix_equals_jax(self):
        target = {"decode": True, "net": {"vocab": 32, "seq_len": 16,
                                          "d_model": 16, "n_layers": 2,
                                          "n_heads": 2}}
        ok = {"decode": True, "net": {"vocab": 32, "seq_len": 16,
                                      "d_model": 8, "n_layers": 1,
                                      "n_heads": 1}}
        cases = [(target, ok), (target, dict(ok, decode=False)),
                 (target, dict(ok, net=dict(ok["net"], vocab=16))),
                 (dict(target, net=dict(target["net"], seq_len=4096)), ok)]
        got = [draft_incompatibility(t, d) for t, d in cases]
        assert got == [jexport.draft_incompatibility(t, d)
                       for t, d in cases]
        assert got[0] is None and all(got[1:])

    def test_draft_reload_refusal_matrix(self, lm, tmp_path):
        d, dd = str(tmp_path / "export"), str(tmp_path / "draft")
        export_model(lm.port, d, version=0)
        export_model(lm.port, dd, version=0, weight_dtype="bf16")
        (p,) = prompts(24, 5)
        want = lm.jax_greedy(p, 6, buckets=(8,))
        server = decode_server(d, draft_export_dir=dd, speculate_k=3)
        try:
            assert server.generate(p, 6).tolist() == want
            export_model(_lm(vocab=16), dd, version=1)
            with pytest.raises(IncompatibleExport, match="vocab"):
                server.check_draft_reload()
            export_model(_lm(), dd, version=2)
            with pytest.raises(IncompatibleExport, match="net dims"):
                server.check_draft_reload()
            with pytest.raises(IncompatibleExport):
                server.check_draft_reload()
            assert server.draft_version == 0
            export_model(lm.port, dd, version=3, weight_dtype="bf16")
            assert server.check_draft_reload() == 3
            assert server.generate(p, 6).tolist() == want
            st = server.stats()
            assert st["draft_version"] == 3 and st["accept_rate"] is not None
        finally:
            server.stop()

    def test_incompatible_draft_refused_at_construction(self, lm, tmp_path):
        d, dd = str(tmp_path / "export"), str(tmp_path / "draft")
        export_model(lm.port, d, version=0)
        export_model(_lm(vocab=16), dd, version=0)
        with pytest.raises(IncompatibleExport, match="vocab"):
            decode_server(d, draft_export_dir=dd)
