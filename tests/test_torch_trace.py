"""The port's span linkage (``theanompi_tpu_torch/monitor/trace.py``,
``spans.py``) against the JAX package's (``tests/test_trace.py``, all
but ``TestGenerateStitch``, which waits for the port's decode).

* The hello grant is bilateral and absent when tracing is off; a
  malformed context is ignored.
* One EASGD exchange against two port shards, under a root span, is
  ONE trace with zero orphans as ``tools/traces.py`` assembles it from
  the port's event files, and the root reaches every server span.
* A JAX client's span parents a port server's ``rpc_handle`` span, and
  a port client's span a JAX server's, over one wire context.
* The span record, the id format, the sampling roll and ``inject`` from
  the open span are JAX's.
* Tracing off: no ids, no trace fields, no event files, no export
  series.
"""

from __future__ import annotations

import glob
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from theanompi_tpu import monitor as jmonitor
from theanompi_tpu.monitor import trace as jtrace
from theanompi_tpu.parallel import rpc as jrpc
from theanompi_tpu.parallel import service as jservice
from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.monitor import export, trace
from theanompi_tpu_torch.monitor.spans import Span, current_span
from theanompi_tpu_torch.parallel import rpc, service, shm, wire
from theanompi_tpu_torch.parallel.shards import ShardedEASGD, serve_shard

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
import traces as traces_tool  # noqa: E402  (tools/traces.py, stdlib-only)

KEY = "trace-test"


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "4")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "10")
    for var in (trace.ENV_VAR, trace.COLLECTOR_ENV_VAR, monitor.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    monitor.reset_for_tests()
    jmonitor.reset_for_tests()
    yield
    monitor.reset_for_tests()
    jmonitor.reset_for_tests()
    shm.release_all()
    jshm.release_all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Hello negotiation
# ---------------------------------------------------------------------------


class TestHelloNegotiation:
    def test_disabled_hello_has_no_trace_key(self):
        payload = wire.hello_payload(wire.WireOptions())
        assert "trace" not in payload
        _, reply, _ = wire.accept_hello(payload)
        assert "trace" not in reply

    def test_grant_requires_both_sides(self):
        payload = dict(wire.hello_payload(wire.WireOptions()), trace=True)
        _, reply, _ = wire.accept_hello(payload)
        assert "trace" not in reply
        trace.set_enabled(True)
        _, reply, _ = wire.accept_hello(payload)
        assert reply.get("trace") is True
        _, reply, _ = wire.accept_hello(wire.hello_payload(
            wire.WireOptions(), trace=False))
        assert "trace" not in reply

    def test_attach_wire_rejects_malformed_ctx(self):
        trace.set_enabled(True)
        for bad in (None, {}, {"t": 7, "s": "a"},
                    {"t": "x" * 40, "s": "a"}, {"t": "", "s": "a"}):
            with trace.attach_wire(bad):
                assert trace.inject() is None


# ---------------------------------------------------------------------------
# Span linkage, record format, sampling
# ---------------------------------------------------------------------------


class _Sink:
    """Stands in for the exporter: collects what ``record_span``
    emits."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, ev):
        self.events.append(ev)


class TestLinkage:
    def test_ids_and_nesting(self):
        trace.set_enabled(True)
        with Span("root") as root:
            with Span("child") as child:
                assert current_span() is child
                assert trace.inject() == {"t": root.trace_id,
                                          "s": child.span_id, "x": 1}
        assert len(root.trace_id) == len(root.span_id) == 16
        int(root.trace_id, 16)
        assert child.trace_id == root.trace_id
        assert child.parent_id == root.span_id and root.parent_id is None

    def test_remote_context_parents_a_span(self):
        trace.set_enabled(True)
        with trace.attach_wire({"t": "a" * 16, "s": "b" * 16, "x": 0}):
            assert trace.inject() == {"t": "a" * 16, "s": "b" * 16,
                                      "x": 0}
            with Span("served") as sp:
                assert (sp.trace_id, sp.parent_id, sp.sampled) == (
                    "a" * 16, "b" * 16, False)
        assert trace.inject() is None

    def test_record_matches_jax_record(self, monkeypatch):
        """A finished span emits JAX's record, key for key."""
        sink, jsink = _Sink(), _Sink()
        monkeypatch.setattr(export, "_exporter", sink)
        from theanompi_tpu.monitor import export as jexport
        from theanompi_tpu.monitor.spans import Span as JSpan

        monkeypatch.setattr(jexport, "_exporter", jsink)
        trace.set_enabled(True)
        jtrace.set_enabled(True)
        with pytest.raises(KeyError):
            with Span("outer", op="x"):
                raise KeyError("k")
        with pytest.raises(KeyError):
            with JSpan("outer", op="x"):
                raise KeyError("k")
        (ev,), (jev,) = sink.events, jsink.events
        assert set(ev) == set(jev)
        for k in ("event", "parent", "name", "labels", "err"):
            assert ev[k] == jev[k], k
        assert ev["err"] is True and ev["dur_s"] >= 0

    @pytest.mark.parametrize("sample", [0.0, 1.0])
    def test_sampling_decides_at_the_root(self, sample, monkeypatch):
        sink = _Sink()
        monkeypatch.setattr(export, "_exporter", sink)
        monkeypatch.setenv(trace.SAMPLE_ENV_VAR, str(sample))
        monkeypatch.setenv(trace.ENV_VAR, "1")
        trace.activate_from_env()
        assert trace.enabled()
        for _ in range(5):
            with Span("root") as root:
                with Span("leaf") as leaf:
                    pass
            assert leaf.sampled == root.sampled == bool(sample)
        assert len(sink.events) == (10 if sample else 0)

    def test_partial_sampling_is_whole_or_absent(self, monkeypatch):
        sink = _Sink()
        monkeypatch.setattr(export, "_exporter", sink)
        trace.set_enabled(True, sample=0.5)
        roots = []
        for _ in range(64):
            with Span("root") as root:
                with Span("leaf"):
                    pass
            roots.append(root.sampled)
        assert 0 < sum(roots) < 64
        by_trace: dict = {}
        for ev in sink.events:
            by_trace.setdefault(ev["trace"], []).append(ev["name"])
        assert all(sorted(v) == ["root", "root/leaf"]
                   for v in by_trace.values())
        assert len(by_trace) == sum(roots)


# ---------------------------------------------------------------------------
# One EASGD exchange against a 2-shard fleet = ONE trace, zero orphans
# ---------------------------------------------------------------------------


def _start_shard_fleet(k: int):
    fleet = []
    for i in range(k):
        port = _free_port()
        ready, stop = threading.Event(), threading.Event()
        t = threading.Thread(target=serve_shard,
                             args=("127.0.0.1", port, i, ready, stop),
                             kwargs=dict(device="cpu"), daemon=True)
        t.start()
        assert ready.wait(10)
        fleet.append({"addr": f"127.0.0.1:{port}", "thread": t,
                      "stop": stop})
    return fleet


def _stop_shard_fleet(fleet):
    for s in fleet:
        s["stop"].set()
        try:
            service.ServiceClient(s["addr"]).call("shutdown")
        except Exception:
            pass
        s["thread"].join(timeout=5)


class TestExchangeStitch:
    def test_two_shard_exchange_is_one_trace(self, tmp_path, monkeypatch):
        monkeypatch.setenv(trace.ENV_VAR, "1")
        rng = np.random.default_rng(0)
        tree = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((8, 4), (9,))]
        fleet = _start_shard_fleet(2)
        try:
            with monitor.session(run_dir=str(tmp_path)):
                srv = ShardedEASGD([s["addr"] for s in fleet], tree,
                                   alpha=0.5, session_id="trace-ex")
                with monitor.span("exchange_period"):
                    srv.exchange([t + 0.1 for t in tree])
                srv.close()
        finally:
            _stop_shard_fleet(fleet)
        files = glob.glob(str(tmp_path / "events_*.jsonl"))
        assert [os.path.basename(f) for f in files] == ["events_rank0.jsonl"]
        assembled = traces_tool.assemble(
            traces_tool.load_events(str(tmp_path)))
        ours = [spans for spans in assembled.values()
                if any(s["name"] == "exchange_period" for s in spans)]
        assert len(ours) == 1
        spans = ours[0]
        assert traces_tool.orphans(spans) == []
        handled = [s for s in spans if s["name"] == "rpc_handle"]
        assert len(handled) >= 2, [s["name"] for s in spans]
        (root,) = [s for s in spans if s["name"] == "exchange_period"]
        by_id = {s["span"]: s for s in spans}
        for s in handled:
            node = s
            while node["parent"] is not None:
                node = by_id[node["parent"]]
            assert node["span"] == root["span"]
        path = traces_tool.critical_path(spans)
        assert path and path[0]["span"] == root["span"] and len(path) >= 2


class _Echo:
    RPC_CONTROL_OPS = frozenset()

    def handle(self, op, *args):
        if op == "echo":
            return args[0]
        raise ValueError(f"unknown op {op!r}")


@pytest.mark.parametrize("pair", ["jax-client/port-server",
                                  "port-client/jax-server"])
def test_span_parents_a_server_span_across_packages(pair, tmp_path,
                                                    monkeypatch):
    """Both packages' monitors run in this process, each with tracing
    and an event file of its own; the client's span is the parent of
    the other package's ``rpc_handle`` span, and ``tools/traces.py``
    assembles the two files into one trace with zero orphans."""
    monkeypatch.setenv(trace.ENV_VAR, "1")
    client_mon, client_svc, server_rpc = (
        (jmonitor, jservice, rpc) if pair.startswith("jax")
        else (monitor, service, jrpc))
    server_mon = monitor if client_mon is jmonitor else jmonitor
    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=server_rpc.serve,
                         args=(_Echo(), "127.0.0.1", port),
                         kwargs=dict(ready_event=ready, stop_event=stop,
                                     authkey=KEY.encode()), daemon=True)
    t.start()
    assert ready.wait(10)
    try:
        with server_mon.session(run_dir=str(tmp_path), name="server"), \
                client_mon.session(run_dir=str(tmp_path), name="client"):
            c = client_svc.ServiceClient(f"127.0.0.1:{port}")
            try:
                with client_mon.span("client_root"):
                    assert c.call("echo", 5) == 5
            finally:
                c.close()
    finally:
        stop.set()
        try:
            socket.create_connection(("127.0.0.1", port), 2).close()
        except OSError:
            pass
        t.join(timeout=15)
    recs = traces_tool.load_events(str(tmp_path))
    assert {r["role"] for r in recs} == {"client", "server"}
    ours = [s for s in traces_tool.assemble(recs).values()
            if any(x["name"] == "client_root" for x in s)]
    assert len(ours) == 1
    names = sorted(s["name"] for s in ours[0])
    assert names == ["client_root", "rpc_handle"]
    assert traces_tool.orphans(ours[0]) == []


# ---------------------------------------------------------------------------
# Disabled-mode byte identity
# ---------------------------------------------------------------------------


class TestDisabledNoOp:
    def test_no_artifacts_no_series_no_span_fields(self, tmp_path):
        assert not trace.enabled()
        with monitor.session(run_dir=str(tmp_path)):
            with monitor.span("step") as sp:
                opened = monitor.open_spans()
                assert opened and all("trace" not in d and "span" not in d
                                      for d in opened)
                assert sp.trace_id is None
            snap = monitor.registry().snapshot()
            assert monitor._state.exporter is None  # noqa: SLF001
        names = {r["name"] for r in snap}
        assert not any(n.startswith("monitor/export") for n in names)
        assert not glob.glob(str(tmp_path / "events_*.jsonl"))
        assert not (tmp_path / "fleet.jsonl").exists()

    def test_untraced_wire_messages_unchanged(self):
        assert trace.inject() is None
        trace.set_enabled(True)
        assert trace.inject() is None  # no open span, no remote ctx
