"""The port's event export and telemetry collector
(``theanompi_tpu_torch/monitor/{export,collector}.py``) against the JAX
package's (``tests/test_trace.py``'s exporter, collector and tools
cases), and the launcher's ``--collector`` with ``--ingest``.

* The exporter's bounded buffer drops and counts; a dead collector
  degrades it to its local file; the event files rotate by size.
* The collector merges the sender's identity and clock offset into
  every record; hello answers clocks; a malformed batch is refused.
* Across the packages: the port's collector takes JAX's exporter and
  the port's, and JAX's collector takes both, and ``tools/traces.py``
  reads each merged ``fleet.jsonl`` as one trace with zero orphans
  (spans of both packages linked by one wire context);
  ``tools/tmtop.py`` renders the port's metrics events.
* ``CollectorProcess`` spawns, answers and stops; the launcher refuses
  ``--collector`` without ``--monitor-dir`` and across hosts.
* End to end on the CPU: ``launcher BSP -D 1 --ingest <coordinator>
  --collector --monitor-dir D`` trains a tiny ResNet from a port reader
  fleet whose spans ship to a collector writing the same
  ``D/fleet.jsonl``; the trainer's and the fleet's spans link into one
  trace, and the metrics, Prometheus and heartbeat files are there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from theanompi_tpu import monitor as jmonitor
from theanompi_tpu.monitor import collector as jcollector
from theanompi_tpu.monitor import export as jexport
from theanompi_tpu.monitor import trace as jtrace
from theanompi_tpu.monitor.registry import MetricsRegistry as JRegistry
from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu_torch import launcher, monitor
from theanompi_tpu_torch.data.imagenet import prepare_imagenet_shards
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.monitor import trace
from theanompi_tpu_torch.monitor.collector import (
    CollectorProcess,
    TelemetryCollector,
    read_fleet,
    serve_collector,
)
from theanompi_tpu_torch.monitor.export import Exporter, RotatingJsonlWriter
from theanompi_tpu_torch.monitor.registry import MetricsRegistry
from theanompi_tpu_torch.parallel import service, shm

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "tools"))
import tmtop  # noqa: E402  (tools/tmtop.py, stdlib-only)
import traces as traces_tool  # noqa: E402  (tools/traces.py)

KEY = "collector-test"


class TinyShardResNet(ResNet50):
    """A launcher model: ResNet at stage sizes (1, 1, 1, 1), width 8,
    32-pixel crops, 10 classes, f32, on the shard tree its config's
    ``data_dir`` names."""

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device, stage_sizes=(1, 1, 1, 1), width=8,
                         n_classes=10, crop=32)

    @classmethod
    def default_config(cls):
        return dataclasses.replace(
            ResNet50.default_config(), batch_size=16, n_epochs=1,
            compute_dtype="float32", print_freq=0)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "2")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "5")
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


def _counter(registry, name: str) -> float:
    return sum(r.get("value", 0.0) for r in registry.snapshot()
               if r["name"] == name)


def _wait_for(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class Collector:
    """A collector server thread of one package writing ``run_dir``."""

    def __init__(self, serve, run_dir: str):
        self.port = _free_port()
        self.addr = f"127.0.0.1:{self.port}"
        self.ready, self.stop_ev = threading.Event(), threading.Event()
        self.thread = threading.Thread(
            target=serve, args=("127.0.0.1", self.port, run_dir, self.ready,
                                self.stop_ev), daemon=True)
        self.thread.start()
        assert self.ready.wait(10)

    def stop(self) -> None:
        self.stop_ev.set()
        try:
            service.ServiceClient(self.addr).call("shutdown")
        except Exception:
            pass
        self.thread.join(timeout=15)
        assert not self.thread.is_alive()


# ---------------------------------------------------------------------------
# Exporter: bounded drops, collector death, rotation
# ---------------------------------------------------------------------------


class TestExporter:
    def test_full_buffer_drops_and_counts(self, tmp_path):
        for exporter_cls, reg in ((Exporter, MetricsRegistry()),
                                  (jexport.Exporter, JRegistry())):
            ex = exporter_cls(str(tmp_path), "t0", 0, reg, capacity=4)
            for i in range(10):  # never started: the buffer only fills
                ex.emit({"event": "span", "i": i})
            st = ex.stats()
            assert st["buffered"] == 4 and st["dropped"] == 6
            assert _counter(reg, "monitor/export_dropped_total") == 6.0
            ex.stop()

    def test_collector_death_degrades_to_local(self, tmp_path):
        col_dir = tmp_path / "col"
        col = Collector(serve_collector, str(col_dir))
        reg = MetricsRegistry()
        ex = Exporter(str(tmp_path), "t9", 3, reg, collector=col.addr,
                      flush_s=0.05).start()
        try:
            ex.emit({"event": "span", "name": "alive", "trace": "aa",
                     "span": "bb", "t_wall": time.time(), "dur_s": 0.01})
            assert _wait_for(lambda: _counter(
                reg, "monitor/export_batches_total") >= 1)
            spans = [r for r in read_fleet(str(col_dir / "fleet.jsonl"))
                     if r.get("event") == "span"]
            assert spans and spans[0]["role"] == "t9" \
                and spans[0]["rank"] == 3 and "offset_s" in spans[0]
            col.stop()
            before = _counter(reg, "monitor/export_errors_total")
            for i in range(3):
                ex.emit({"event": "span", "name": f"after{i}"})
                time.sleep(0.1)
            assert _wait_for(lambda: _counter(
                reg, "monitor/export_errors_total") > before)
        finally:
            if not col.stop_ev.is_set():
                col.stop()
            ex.stop()
        names = {r.get("name") for r in traces_tool.load_events(
            str(tmp_path))}
        assert {"alive", "after0"} <= names

    def test_rotation_keeps_n_and_counts(self, tmp_path):
        w = RotatingJsonlWriter(str(tmp_path / "e.jsonl"), max_bytes=120,
                                keep=2)
        jw = jexport.RotatingJsonlWriter(str(tmp_path / "j.jsonl"),
                                         max_bytes=120, keep=2)
        for i in range(40):
            line = json.dumps({"i": i, "pad": "x" * 40})
            w.write_lines([line])
            jw.write_lines([line])
        assert w.rotations == jw.rotations >= 2
        for suffix in ("", ".1", ".2"):
            assert (tmp_path / f"e.jsonl{suffix}").read_text() == \
                (tmp_path / f"j.jsonl{suffix}").read_text()
        assert not os.path.exists(tmp_path / "e.jsonl.3")
        assert traces_tool.load_events(str(tmp_path / "e.jsonl"))[-1][
            "i"] == 39


# ---------------------------------------------------------------------------
# Collector service semantics
# ---------------------------------------------------------------------------


class TestCollector:
    def test_ingest_merges_identity_and_counts(self, tmp_path):
        meta = {"pid": 7, "role": "rank0", "rank": 0, "offset_s": 0.25,
                "rtt_s": 0.01}
        events = [{"event": "span", "name": "a"},
                  {"event": "span", "name": "b"}, "garbage"]
        col = TelemetryCollector(str(tmp_path / "p"))
        jcol = jcollector.TelemetryCollector(str(tmp_path / "j"))
        assert col.handle("collector_export", meta, events) == 2
        assert jcol.handle("collector_export", meta, events) == 2
        st = col.handle("collector_stats")
        assert st["events"] == 2 and st["batches"] == 1 \
            and st["senders"] == 1
        assert (tmp_path / "p" / "fleet.jsonl").read_text() == \
            (tmp_path / "j" / "fleet.jsonl").read_text()

    def test_hello_answers_clocks(self, tmp_path):
        reply = TelemetryCollector(str(tmp_path)).handle(
            "collector_hello", {"pid": 1, "role": "x"})
        assert abs(reply["t_wall"] - time.time()) < 5.0
        assert "t_mono" in reply

    def test_malformed_batch_refused(self, tmp_path):
        col = TelemetryCollector(str(tmp_path))
        with pytest.raises(ValueError):
            col.handle("collector_export", "notadict", [])
        with pytest.raises(ValueError):
            col.handle("collector_export", {})

    def test_collector_process_spawns_and_stops(self, tmp_path):
        cp = CollectorProcess(str(tmp_path), ready_timeout_s=60)
        try:
            assert os.environ[trace.COLLECTOR_ENV_VAR] == cp.addr
            assert cp.stats()["events"] == 0
        finally:
            cp.stop()
        assert trace.COLLECTOR_ENV_VAR not in os.environ
        assert cp.stats() is None


# ---------------------------------------------------------------------------
# Across the packages: one fleet.jsonl, one trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collector_pkg", ["port", "jax"])
def test_both_exporters_make_one_trace(collector_pkg, tmp_path,
                                       monkeypatch):
    """A JAX span parents a port span through one wire context; both
    packages' sessions ship to one collector, and ``tools/traces.py``
    reads its fleet.jsonl as one linked trace across two roles."""
    serve = serve_collector if collector_pkg == "port" \
        else jcollector.serve_collector
    col = Collector(serve, str(tmp_path / "col"))
    monkeypatch.setenv(trace.ENV_VAR, "1")
    monkeypatch.setenv(trace.COLLECTOR_ENV_VAR, col.addr)
    try:
        with jmonitor.session(run_dir=str(tmp_path), name="jaxside"), \
                monitor.session(run_dir=str(tmp_path), name="portside"):
            with jmonitor.span("jax_root"):
                ctx = jtrace.inject()
                with trace.attach_wire(ctx), monitor.span("port_child"):
                    time.sleep(0.01)
    finally:
        col.stop()
    recs = read_fleet(str(tmp_path / "col" / "fleet.jsonl"))
    # the in-process collector's own rpc_handle spans ship too (a
    # standalone collector strips tracing); read the two of interest
    spans = [r for r in recs if r.get("event") == "span"
             and r["name"] in ("jax_root", "port_child")]
    assert {r["role"] for r in spans} == {"jaxside", "portside"}
    assert all("offset_s" in r and "pid" in r for r in spans)
    (tid,) = {r["trace"] for r in spans}
    assembled = traces_tool.assemble(recs)[tid]
    assert sorted(s["name"] for s in assembled) == ["jax_root",
                                                    "port_child"]
    assert traces_tool.orphans(assembled) == []
    assert traces_tool.main([str(tmp_path / "col" / "fleet.jsonl"),
                             "--trace", tid, "--require-procs", "1",
                             "--require-zero-orphans"]) == 0


def test_tmtop_renders_port_metrics(tmp_path, capsys):
    col = Collector(serve_collector, str(tmp_path))
    reg = MetricsRegistry()
    ex = Exporter(str(tmp_path / "local"), "ingest_reader0_1", 0, reg,
                  collector=col.addr, flush_s=0.05,
                  metrics_every_s=0.05).start()
    try:
        for _ in range(12):
            reg.observe("step_ms", 12.5)
        ex.emit({"event": "span", "name": "x"})
        assert _wait_for(lambda: any(
            r.get("event") == "metrics"
            for r in read_fleet(str(tmp_path / "fleet.jsonl"))))
    finally:
        ex.stop()
        col.stop()
    assert tmtop.main([str(tmp_path), "--once"]) == 0
    out = capsys.readouterr().out
    assert "ingest_reader0_1" in out and "1 processes" in out
    assert "12.5" in out


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


class TestLauncherFlag:
    def test_collector_requires_monitor_dir(self):
        with pytest.raises(SystemExit, match="--monitor-dir"):
            launcher.main(["BSP", "--collector", "-m", "x", "-c", "y"])

    def test_collector_is_single_host(self):
        with pytest.raises(SystemExit, match="single-host"):
            launcher.main(["BSP", "--collector", "--monitor-dir", "d",
                           "--multihost", "--coordinator", "h:2",
                           "--nhosts", "2", "--host-id", "0", "-m", "x",
                           "-c", "y"])

    def test_flags_leave_the_unported_list(self):
        args = launcher.parse_args(["BSP", "--collector", "--monitor-dir",
                                    "d", "-m", "x", "-c", "y"])
        assert args.collector and args.monitor_dir == "d"
        assert "--collector" not in launcher.UNPORTED_OPTIONS


def test_launcher_ingest_and_collector_end_to_end(tmp_path, monkeypatch):
    from theanompi_tpu_torch.ingest.coordinator import (
        IngestCoordinator,
        serve_coordinator,
    )
    from theanompi_tpu_torch.ingest.reader import IngestReader, serve_reader

    rng = np.random.default_rng(2)
    data = str(tmp_path / "shards")
    for part, n in (("train", 128), ("val", 32)):
        prepare_imagenet_shards(
            rng.integers(0, 255, size=(n, 36, 36, 3), dtype=np.uint8),
            rng.integers(0, 10, size=n).astype(np.int64), data, part,
            shard_size=64)
    run = tmp_path / "run"
    # the reader fleet: two readers and a coordinator on server threads
    # of this process, shipping to a collector that writes run/fleet.jsonl
    col = Collector(serve_collector, str(run))
    monkeypatch.setenv(trace.ENV_VAR, "1")
    monkeypatch.setenv(trace.COLLECTOR_ENV_VAR, col.addr)
    servers, addrs, stops = [], [], []

    def start(target, obj):
        port = _free_port()
        ready, stop = threading.Event(), threading.Event()
        t = threading.Thread(target=target,
                             args=("127.0.0.1", port, obj, ready, stop),
                             daemon=True)
        t.start()
        assert ready.wait(30)
        servers.append(t)
        stops.append((stop, f"127.0.0.1:{port}"))
        return f"127.0.0.1:{port}"

    out = tmp_path / "result.json"
    try:
        with monitor.session(run_dir=str(run), name="ingest_fleet"):
            readers = [IngestReader(data, seed=0, reader_id=i)
                       for i in range(2)]
            addrs = [start(serve_reader, r) for r in readers]
            coord_addr = start(serve_coordinator,
                               IngestCoordinator(addrs,
                                                 probe_interval_s=0.5))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [TESTS] + [p for p in os.environ.get(
                    "PYTHONPATH", "").split(os.pathsep) if p]))
            proc = subprocess.run(
                [sys.executable, "-m", "theanompi_tpu_torch.launcher",
                 "BSP", "-D", "1", "--platform", "cpu", "-m",
                 "test_torch_collector", "-c", "TinyShardResNet",
                 "--set", f"data_dir={data}", "--set", "seed=0",
                 "--snapshot-dir",
                 str(tmp_path / "snap"), "--ingest", coord_addr,
                 "--collector", "--monitor-dir", str(run),
                 "--result-json", str(out)],
                env=env, capture_output=True, text=True, timeout=240)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            served = [r.stats()["served"] for r in readers]
    finally:
        for stop, addr in stops:
            stop.set()
            try:
                service.ServiceClient(addr).call("shutdown")
            except Exception:
                pass
        for t in servers:
            t.join(timeout=15)
        col.stop()
    res = json.loads(out.read_text())
    (rec,) = res["records"]
    assert rec["train_steps"] == 8 and sum(served) == 8
    assert all(s > 0 for s in served)
    recs = read_fleet(str(run / "fleet.jsonl"))
    spans = [r for r in recs if r.get("event") == "span"]
    roles = {r["role"] for r in spans}
    assert {"rank0", "ingest_fleet"} <= roles
    assert traces_tool.orphans(traces_tool.spans_of(recs)) == []
    linked = [s for s in traces_tool.assemble(recs).values()
              if {"rank0", "ingest_fleet"} <= {x["role"] for x in s}]
    assert linked, "no trace links the trainer and the fleet"
    names = {s["name"] for s in spans}
    assert {"ingest_request", "ingest_pull", "rpc_handle",
            "bsp/epoch"} <= names
    for f in ("metrics_rank0.jsonl", "metrics_rank0.prom",
              "heartbeat_rank0.json"):
        assert (run / f).exists(), f
    metrics = {json.loads(line)["name"]: json.loads(line)
               for line in open(run / "metrics_rank0.jsonl")}
    assert metrics["ingest/loader_batches_total"]["labels"] == {
        "source": "remote"}
