"""The port's telemetry (``theanompi_tpu_torch/monitor``) against the JAX
package's (``tests/test_monitor.py``), case for case.

The same writes, made from a seed with numpy, go into both registries;
their snapshots, Prometheus dumps, histogram states, heartbeat and
postmortem files agree key for key (exactly, where a value does not
depend on the clock).  Spans nest per thread, are visible across
threads, record on an exception and enter ``torch.profiler.
record_function``; the disabled facade makes zero registry writes and
writes no file; the BSP session writes its metrics, Prometheus,
heartbeat and postmortem files.

The port's series keep their own labels: ``span_ms{span=...}`` where
JAX writes ``name``, and ``step_ms{phase, worker}`` (JAX: ``worker``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from theanompi_tpu import monitor as jmonitor
from theanompi_tpu.monitor.health import HeartbeatReporter as JHeartbeat
from theanompi_tpu.monitor.health import StragglerDetector as JStraggler
from theanompi_tpu.monitor.postmortem import build_postmortem as jbuild
from theanompi_tpu.monitor.registry import Histogram as JHistogram
from theanompi_tpu.monitor.registry import MetricsRegistry as JRegistry
from theanompi_tpu.monitor.registry import tree_bytes as jtree_bytes
from theanompi_tpu.monitor.registry import tree_dtypes as jtree_dtypes
from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.monitor.health import (
    HeartbeatReporter,
    StragglerDetector,
)
from theanompi_tpu_torch.monitor.postmortem import build_postmortem
from theanompi_tpu_torch.monitor.registry import (
    Histogram,
    MetricsRegistry,
    tree_bytes,
    tree_dtypes,
)
from theanompi_tpu_torch.monitor.spans import Span, open_spans


@pytest.fixture(autouse=True)
def fresh_monitor(monkeypatch):
    monkeypatch.delenv(monitor.ENV_VAR, raising=False)
    monitor.reset_for_tests()
    jmonitor.reset_for_tests()
    yield
    monitor.reset_for_tests()
    jmonitor.reset_for_tests()


def _both(fn):
    """Apply the same writes to a port and a JAX registry."""
    regs = MetricsRegistry(), JRegistry()
    for r in regs:
        fn(r)
    return regs


def _no_ts(snap):
    return [{k: v for k, v in rec.items() if k != "ts"} for rec in snap]


# ---------------------------------------------------------------------------
# registry math
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    def writes(r):
        r.inc("req")
        r.inc("req", 4)
        r.set_gauge("clients", 3)
        r.add_gauge("clients", -1)
    port, jax_ = _both(writes)
    assert port.value("req") == jax_.value("req") == 5
    assert port.value("clients") == jax_.value("clients") == 2


def test_label_isolation():
    def writes(r):
        r.inc("rpc", 1, op="a")
        r.inc("rpc", 10, op="b")
        r.inc("rpc", 100, op="a")
        r.inc("multi", 1, x="1", y="2")
        r.inc("multi", 1, y="2", x="1")  # label order must not split
    port, jax_ = _both(writes)
    for labels in ({"op": "a"}, {"op": "b"}):
        assert port.value("rpc", **labels) == jax_.value("rpc", **labels)
    assert port.value("rpc", op="a") == 101
    assert port.value("multi", x="1", y="2") == 2
    assert _no_ts(port.snapshot()) == _no_ts(jax_.snapshot())


def test_kind_conflict_raises():
    for r in (MetricsRegistry(), JRegistry()):
        r.inc("metric")
        with pytest.raises(TypeError):
            r.observe("metric", 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_math_and_percentiles(seed):
    values = np.random.default_rng(seed).standard_normal(300) * 10
    h, jh = Histogram(), JHistogram()
    for v in values:
        h.observe(float(v))
        jh.observe(float(v))
    assert h.state() == jh.state()
    for q in (1, 50, 95, 99, 100):
        assert h.percentile(q) == jh.percentile(q)
    ramp = Histogram()
    for v in range(1, 101):
        ramp.observe(float(v))
    assert (ramp.percentile(50), ramp.percentile(95),
            ramp.percentile(99)) == (50.0, 95.0, 99.0)


def test_histogram_percentile_edges():
    h, jh = Histogram(), JHistogram()
    assert h.percentile(50) is None
    assert h.state() == jh.state()
    assert h.state()["p50"] is None and h.state()["min"] is None
    h.observe(7.5)
    jh.observe(7.5)
    assert h.percentile(99) == 7.5 and h.state()["mean"] == 7.5
    assert h.state() == jh.state()


def test_histogram_ring_bounds_memory():
    h, jh = Histogram(ring=8), JHistogram(ring=8)
    for v in range(1000):
        h.observe(float(v))
        jh.observe(float(v))
    assert h.count == 1000 and h.sum == pytest.approx(sum(range(1000)))
    assert h.percentile(50) >= 992.0
    assert h.state() == jh.state()


def test_registry_thread_safety():
    r = MetricsRegistry()

    def work():
        for _ in range(1000):
            r.inc("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert r.value("n") == 8000 and r.write_count == 8000


def test_snapshot_jsonl_and_prometheus(tmp_path):
    rng = np.random.default_rng(4)
    obs = rng.uniform(0.1, 9.0, 40)

    def writes(r):
        r.inc("service/requests_total", 3, op="ping")
        r.set_gauge("rpc/open_streams", 2.0, plane="service")
        for v in obs:
            r.observe("rpc_ms", float(v), op="ping")
    port, jax_ = _both(writes)
    # the exposition text is byte-identical for the same series
    assert port.to_prometheus() == jax_.to_prometheus()
    prom = port.to_prometheus()
    assert 'theanompi_service_requests_total{op="ping"} 3' in prom
    assert "# TYPE theanompi_rpc_ms summary" in prom
    path = port.write_jsonl(str(tmp_path / "m.jsonl"))
    jpath = jax_.write_jsonl(str(tmp_path / "j.jsonl"))
    recs = [json.loads(line) for line in open(path)]
    jrecs = [json.loads(line) for line in open(jpath)]
    assert _no_ts(recs) == _no_ts(jrecs)
    assert {r["name"]: r for r in recs}["rpc_ms"]["count"] == 40


def test_prometheus_escapes_label_values():
    port, jax_ = _both(lambda r: r.inc("errs", 1, op='get"x\\y\nz'))
    prom = port.to_prometheus()
    assert prom == jax_.to_prometheus()
    assert 'op="get\\"x\\\\y\\nz"' in prom
    assert "\nz\"" not in prom


def test_tree_bytes_and_dtypes():
    tree = {"a": np.zeros((4, 4), np.float32), "b": np.zeros(3, np.uint8)}
    assert tree_bytes(tree) == jtree_bytes(tree) == 4 * 4 * 4 + 3
    assert tree_dtypes(tree) == jtree_dtypes(tree) == "float32,uint8"
    assert tree_bytes({"s": "not-an-array"}) == 0
    as_torch = {"a": torch.zeros((4, 4)), "b": [torch.zeros(3,
                                                            dtype=torch.uint8)]}
    assert tree_bytes(as_torch) == 67
    assert tree_dtypes(as_torch) == "float32,uint8"


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_nesting_and_registry_feed():
    r = MetricsRegistry()
    with Span("outer", registry=r):
        with Span("inner", registry=r):
            time.sleep(0.01)
    inner = r.get("span_ms", span="outer/inner")
    assert inner.count == 1 and inner.sum >= 10.0
    assert r.get("span_ms", span="outer").sum >= inner.sum


def test_span_fence_on_cpu_tensors():
    r = MetricsRegistry()
    with Span("fenced", registry=r, fence={"x": torch.ones(32),
                                           "y": [torch.zeros(4, 4)]}):
        pass
    assert r.get("span_ms", span="fenced").count == 1


def test_span_enters_record_function():
    """A span shows up by name in a torch profiler trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with Span("monitor_probe_span"):
            torch.ones(8) + 1
    assert "monitor_probe_span" in {e.key for e in prof.key_averages()}


def test_open_spans_visible_across_threads():
    release, started = threading.Event(), threading.Event()

    def worker():
        with Span("worker-phase"):
            started.set()
            release.wait(timeout=5)

    t = threading.Thread(target=worker, name="spanthread")
    t.start()
    try:
        assert started.wait(timeout=5)
        opened = open_spans()
        assert "worker-phase" in [s["name"] for s in opened]
        assert {"name", "thread", "age_s", "labels"} == set(opened[0])
    finally:
        release.set()
        t.join()
    assert "worker-phase" not in [s["name"] for s in open_spans()]


def test_span_records_on_exception():
    r = MetricsRegistry()
    with pytest.raises(ValueError):
        with Span("dies", registry=r):
            raise ValueError("boom")
    assert r.get("span_ms", span="dies").count == 1
    assert r.value("span_errors_total", span="dies") == 1
    assert open_spans() == []


# ---------------------------------------------------------------------------
# heartbeat / watchdog / straggler
# ---------------------------------------------------------------------------


def test_heartbeat_file_freshness(tmp_path):
    hb = HeartbeatReporter(str(tmp_path), rank=3, interval=0.05,
                           stall_after=60)
    hb.start()
    try:
        hb.progress(phase="train", step=12)
        time.sleep(0.15)
        rec = json.load(open(tmp_path / "heartbeat_rank3.json"))
    finally:
        hb.stop()
    jrec = JHeartbeat(str(tmp_path / "j"), rank=3).state()
    assert set(rec) == set(jrec)
    assert rec["rank"] == 3 and rec["phase"] == "train"
    assert rec["step"] == 12 and rec["stalled"] is False
    assert time.time() - rec["written"] < 5.0
    assert rec["progress_age_s"] < 5.0


def test_watchdog_flags_stall(tmp_path, capsys):
    r = MetricsRegistry()
    hb = HeartbeatReporter(str(tmp_path), rank=0, registry=r,
                           interval=0.05, stall_after=0.15)
    hb.start()
    try:
        hb.progress(phase="device_init")
        time.sleep(0.4)
        rec = json.load(open(tmp_path / "heartbeat_rank0.json"))
        assert rec["stalled"] is True
        assert r.value("health/stalls_total", phase="device_init") >= 1
        hb.progress(phase="train", step=1)
        assert hb.state()["stalled"] is False
        assert r.value("health/stall_recoveries_total") >= 1
    finally:
        hb.stop()
    assert "WATCHDOG" in capsys.readouterr().err


def test_heartbeat_tracks_workers(tmp_path):
    hb = HeartbeatReporter(str(tmp_path), rank=0, interval=5)
    jhb = JHeartbeat(str(tmp_path), rank=0, interval=5)
    for h in (hb, jhb):
        h.progress(phase="train", step=4, worker=1)
        h.progress(phase="train", step=9, worker=2)
    state, jstate = hb.state(), jhb.state()
    assert state["workers"]["1"]["step"] == 4
    assert state["workers"]["2"]["step"] == 9
    assert ({k: {kk: vv for kk, vv in w.items() if kk != "progress_age_s"}
             for k, w in state["workers"].items()}
            == {k: {kk: vv for kk, vv in w.items()
                    if kk != "progress_age_s"}
                for k, w in jstate["workers"].items()})


def test_straggler_detection_matches_jax():
    """The same seeded step times flag and unflag the same workers on
    the same observations."""
    rng = np.random.default_rng(7)
    det = StragglerDetector(factor=2.0, window=16, min_samples=4,
                            registry=MetricsRegistry())
    jdet = JStraggler(factor=2.0, window=16, min_samples=4,
                      registry=JRegistry())
    flags, jflags = [], []
    for step in range(48):
        for w in range(3):
            slow = w == 2 and 8 <= step < 24
            t = float(rng.uniform(0.009, 0.012) * (10 if slow else 1))
            flags.append(det.observe(w, t))
            jflags.append(jdet.observe(w, t))
        if step == 20:
            assert det.stragglers() == jdet.stragglers() == [2]
    assert flags == jflags and any(flags)
    assert det.stragglers() == []
    assert det.registry.value("health/straggler_flags_total",
                              worker="2") == 1


def test_straggler_needs_two_workers():
    det = StragglerDetector(min_samples=2)
    for _ in range(10):
        assert det.observe(0, 1.0) is False


def test_straggler_persistent_two_worker_case():
    det = StragglerDetector(factor=2.0, window=8, min_samples=4)
    for _ in range(16):
        det.observe(0, 0.010)
        det.observe(1, 0.100)
    assert det.observe(1, 0.100) is True
    assert det.stragglers() == [1]


# ---------------------------------------------------------------------------
# facade: sessions, the no-op contract, postmortem
# ---------------------------------------------------------------------------


def test_disabled_is_noop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with monitor.session() as live:  # no dir anywhere: off
        assert live is False
        monitor.inc("a")
        monitor.set_gauge("b", 1)
        monitor.add_gauge("b", 1)
        monitor.observe("c", 2.0)
        monitor.observe_step(0.01, phase="train", step=1, worker=0)
        monitor.progress(phase="x")
        with monitor.span("s", fence=torch.ones(3)):
            pass
        assert monitor.flush() is None
        assert monitor.dump_postmortem(RuntimeError("x")) is None
        assert monitor.snapshot_path() is None
    assert monitor.registry().write_count == 0
    assert monitor.registry().series_names() == set()
    assert os.listdir(tmp_path) == []  # no artifacts


def test_env_var_enables(tmp_path, monkeypatch):
    monkeypatch.setenv(monitor.ENV_VAR, str(tmp_path))
    with monitor.session() as live:
        assert live and monitor.enabled()
        monitor.inc("via_env")
        assert monitor.flush() == str(tmp_path / "metrics_rank0.jsonl")
    assert not monitor.enabled()
    recs = [json.loads(line)
            for line in open(tmp_path / "metrics_rank0.jsonl")]
    assert any(r["name"] == "via_env" for r in recs)
    assert {r["name"]: r for r in recs}["monitor/enabled"]["value"] == 0.0
    prom = (tmp_path / "metrics_rank0.prom").read_text()
    assert "theanompi_via_env 1.0" in prom
    assert (tmp_path / "heartbeat_rank0.json").exists()


def test_named_session_files(tmp_path):
    with monitor.session(run_dir=str(tmp_path), rank=2,
                         name="service77"):
        monitor.inc("x")
    names = sorted(os.listdir(tmp_path))
    assert names == ["heartbeat_service77.json", "metrics_service77.jsonl",
                     "metrics_service77.prom"]
    assert json.load(open(tmp_path / "heartbeat_service77.json"))[
        "rank"] == 2


def test_consecutive_sessions_get_fresh_registries(tmp_path):
    with monitor.session(run_dir=str(tmp_path / "run1")):
        monitor.inc("steps", 5)
    with monitor.session(run_dir=str(tmp_path / "run2")):
        monitor.inc("steps", 2)
    r2 = [json.loads(line)
          for line in open(tmp_path / "run2" / "metrics_rank0.jsonl")]
    assert next(r for r in r2 if r["name"] == "steps")["value"] == 2


def test_session_activation_failure_does_not_leak_depth(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_MONITOR_INTERVAL", "5s")  # bad
    with pytest.raises(ValueError):
        with monitor.session(run_dir=str(tmp_path)):
            pass
    monkeypatch.delenv("THEANOMPI_TPU_MONITOR_INTERVAL")
    with monitor.session(run_dir=str(tmp_path)) as live:
        assert live and monitor.enabled()
        monitor.inc("recovered")
    assert monitor.registry().value("recovered") == 1


def test_nested_sessions_share_state(tmp_path):
    with monitor.session(run_dir=str(tmp_path)):
        with monitor.session(run_dir=str(tmp_path / "ignored")):
            monitor.inc("n")
        assert monitor.enabled()
        monitor.inc("n")
    assert not monitor.enabled()
    recs = [json.loads(line)
            for line in open(tmp_path / "metrics_rank0.jsonl")]
    assert next(r for r in recs if r["name"] == "n")["value"] == 2
    assert not (tmp_path / "ignored").exists()


def test_postmortem_on_injected_exception(tmp_path):
    release, started = threading.Event(), threading.Event()

    def worker():
        with Span("worker/exchange"):
            started.set()
            release.wait(timeout=10)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert started.wait(timeout=5)
        with pytest.raises(RuntimeError, match="injected"):
            with monitor.session(run_dir=str(tmp_path)):
                monitor.observe_step(0.020, phase="train", step=1)
                monitor.observe_step(0.021, phase="train", step=2)
                with monitor.span("train/epoch0"):
                    raise RuntimeError("injected failure")
    finally:
        release.set()
        t.join()
    pm = json.load(open(tmp_path / "postmortem_rank0.json"))
    assert pm["exception"]["type"] == "RuntimeError"
    assert "injected failure" in pm["exception"]["message"]
    assert "RuntimeError" in pm["exception"]["traceback"]
    assert "worker/exchange" in [s["name"] for s in pm["open_spans"]]
    assert pm["recent_step_ms"] == [20.0, 21.0]
    assert any(m["name"] == "step_ms" for m in pm["metrics"])
    errs = [m for m in pm["metrics"] if m["name"] == "span_errors_total"]
    assert any(m["labels"]["span"] == "train/epoch0" for m in errs)


def test_build_postmortem_matches_jax():
    try:
        raise KeyError("lost")
    except KeyError as e:
        exc = e
    port = build_postmortem(1, exc, MetricsRegistry(), [0.5, 0.25])
    jax_ = jbuild(1, exc, JRegistry(), [0.5, 0.25])
    assert set(port) == set(jax_)
    for key in ("rank", "pid", "exception", "recent_step_ms", "metrics",
                "open_spans"):
        assert port[key] == jax_[key], key


def test_observe_step_feeds_histogram_and_straggler(tmp_path):
    with monitor.session(run_dir=str(tmp_path)):
        for _ in range(8):
            monitor.observe_step(0.010, phase="train", worker=0)
            monitor.observe_step(0.010, phase="train", worker=1)
        flagged = False
        for _ in range(8):
            flagged = monitor.observe_step(0.100, phase="train", worker=2)
        assert flagged is True
        reg = monitor.registry()
        assert reg.get("step_ms", phase="train", worker="0").count == 8
        assert reg.get("step_ms", phase="train", worker="2").count == 8
        hb = json.load(open(monitor.snapshot_path().replace(
            "metrics_rank0.jsonl", "heartbeat_rank0.json")))
        assert hb["rank"] == 0


# ---------------------------------------------------------------------------
# rule-loop integration
# ---------------------------------------------------------------------------


def _tiny_resnet(tmp_path):
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    cfg = dataclasses.replace(
        ModelConfig(), batch_size=16, n_epochs=1, print_freq=10**9,
        snapshot_dir=str(tmp_path / "snap"), compute_dtype="float32")
    data = ImageNet_data(crop=32, synthetic_n=80, synthetic_pool=8,
                         synthetic_store=36, n_classes=10)
    return ResNet50(config=cfg, device="cpu", stage_sizes=(1, 1, 1, 1),
                    width=8, n_classes=10, crop=32, data=data)


def test_bsp_session_emits_telemetry(tmp_path):
    """5 CPU BSP steps with monitoring on: the step histogram, the
    phase spans, a fresh heartbeat at the epoch's end and the
    Prometheus dump."""
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    run = tmp_path / "mon"
    run_bsp_session(_tiny_resnet(tmp_path), max_epochs=1,
                    checkpoint=False, monitor_dir=str(run))
    recs = [json.loads(line) for line in open(run / "metrics_rank0.jsonl")]
    by: dict = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    (steps,) = by["step_ms"]
    assert steps["kind"] == "histogram" and steps["count"] == 5
    assert steps["p50"] is not None and steps["sum"] > 0
    assert {"calc", "wait"} <= {r["labels"]["section"]
                                for r in by["recorder/section_ms"]}
    spans = {r["labels"]["span"] for r in by["span_ms"]}
    assert {"bsp/compile", "bsp/epoch", "bsp/epoch/bsp/validate"} <= spans
    assert by["ingest/loader_batches_total"][0]["labels"] == {
        "source": "local"}
    hb = json.load(open(run / "heartbeat_rank0.json"))
    assert time.time() - hb["written"] < 60
    assert hb["stalled"] is False and hb["phase"] == "epoch_end"
    assert "theanompi_step_ms_count" in (run / "metrics_rank0.prom"
                                         ).read_text()


def test_bsp_session_disabled_zero_writes(tmp_path):
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    run_bsp_session(_tiny_resnet(tmp_path), max_epochs=1,
                    checkpoint=False)
    assert monitor.registry().write_count == 0
    assert monitor.registry().series_names() == set()


def test_bsp_crash_writes_postmortem(tmp_path):
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    model = _tiny_resnet(tmp_path)
    calls = {"n": 0}
    orig = model.train_iter

    def dying_train_iter(it, recorder):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("injected step crash")
        return orig(it, recorder)

    model.train_iter = dying_train_iter
    run = tmp_path / "mon"
    with pytest.raises(RuntimeError, match="injected step crash"):
        run_bsp_session(model, max_epochs=1, checkpoint=False,
                        monitor_dir=str(run))
    pm = json.load(open(run / "postmortem_rank0.json"))
    assert pm["exception"]["type"] == "RuntimeError"
    assert len(pm["recent_step_ms"]) == 2
    assert any(m["name"] == "step_ms" for m in pm["metrics"])
