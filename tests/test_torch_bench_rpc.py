"""The port's RPC bench (``theanompi_tpu_torch/tools/bench_rpc.py``) against
the JAX tool (``tools/bench_rpc.py``) and servers of both packages.

* The soak client (multiplexed readers checking every reply bitwise while
  gossip writers interleave large frames) against a JAX server on its
  threaded loop: no multiplexing granted, and identity holds over the
  dedicated sockets it falls back to; against the port's own service the
  transports multiplex.
* The smoke gate exits 1 on each planted miss; ``--loops threaded``
  (JAX's loop, not ported) is refused with exit 2; the convoy bar is the
  JAX tool's constant.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import service as jservice
from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu_torch.parallel import service, shm
from theanompi_tpu_torch.tools import _bench
from theanompi_tpu_torch.tools import bench_rpc as br

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOAD = 16 * 256  # 16 KB of f32


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "bench-rpc-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    yield
    shm.release_all()
    jshm.release_all()


def _ref():
    return np.random.default_rng(0).random(PAYLOAD).astype(np.float32)


def test_convoy_bar_is_the_jax_tools():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_rpc", os.path.join(tools, "bench_rpc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    (jax_bar,) = [v for k, v in vars(mod).items()
                  if k.endswith("CONVOY_BASELINE_PULLS_S")]
    assert br.CONVOY_BASELINE_PULLS_S == jax_bar
    assert br.SESSION == mod.SESSION


@pytest.mark.parametrize("server", ["jax-threaded", "port"])
def test_soak_holds_identity(server, monkeypatch):
    """JAX's threaded loop grants no mux: the same client code falls back
    to a socket a stream and every reply is still the seeded tree; the
    port's selector loop multiplexes."""
    port = _bench.free_port()
    addr = f"127.0.0.1:{port}"
    ready, stop = threading.Event(), threading.Event()
    if server == "jax-threaded":
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", "threaded")
        th = threading.Thread(target=jservice.serve,
                              args=("127.0.0.1", port, ready, stop),
                              daemon=True)
    else:
        th = threading.Thread(target=service.serve,
                              args=("127.0.0.1", port, ready, stop),
                              kwargs=dict(device="cpu"), daemon=True)
    th.start()
    assert ready.wait(10)
    init = (jservice.RemoteEASGD(addr, {"w": _ref()}, alpha=0.5,
                                 session_id=br.SESSION)
            if server == "jax-threaded" else
            service.RemoteEASGD(addr, [torch.from_numpy(_ref())], alpha=0.5,
                                session_id=br.SESSION))
    try:
        r = br.soak_against(addr, 1.0, PAYLOAD, n_transports=2,
                            streams_per=2)
    finally:
        init.close()
        stop.set()
        try:  # the threaded loop wakes on its next accept
            socket.create_connection(("127.0.0.1", port), 2).close()
        except OSError:
            pass
        th.join(timeout=15)
    assert r["mux_granted"] == (server == "port")
    assert r["byte_mismatches"] == 0 and r["errors"] == []
    assert r["reads"] > 0 and r["writes"] > 0
    loop = "selector" if server == "port" else "threaded"
    assert br.soak_failures({loop: r}) == []


def test_soak_gate_exits_1_on_a_planted_miss():
    good = {"reads": 10, "writes": 3, "byte_mismatches": 0, "errors": [],
            "mux_granted": True}
    assert br.soak_failures({"selector": good}) == []
    for miss in ({"byte_mismatches": 1}, {"errors": ["reader: EOFError"]},
                 {"writes": 0}, {"mux_granted": False}):
        assert br.soak_failures({"selector": {**good, **miss}}), miss


def _result(p99_lo=10.0, p99_top=200.0, top=200, pulls=1500.0, mux=500.0,
            conns_total=None, requests=100):
    return {"connscale": [
                {"loop": "selector", "conns": 8, "pulls_s": 1700.0,
                 "p99_ms": p99_lo},
                {"loop": "selector", "conns": top, "pulls_s": pulls,
                 "p99_ms": p99_top}],
            "convoy": {"mux_pipelined": {"pulls_s": mux}},
            "monitor_evidence": {
                "rpc_connections_total": top if conns_total is None
                else conns_total,
                "requests_total": requests}}


def test_smoke_gate_exits_1_on_a_planted_miss():
    assert br.smoke_verdict(_result(), 200) == 0
    for miss in ({"p99_top": 1000.0},       # p99 per connection not flat
                 {"pulls": 900.0},          # < 1000 pulls/s at the top
                 {"mux": 399.0},            # < 10x the convoy bar
                 {"conns_total": 150},      # rpc/connections_total short
                 {"requests": 0},           # no service/requests_total
                 {"top": 100}):             # top point under the floor
        r = _result(**miss)
        assert br.smoke_verdict(r, 200) == 1, miss
        assert r["smoke"]["failures"]


def test_monitor_evidence_reads_the_servers_jsonl(tmp_path):
    with open(tmp_path / "metrics_service7.jsonl", "w") as f:
        for rec in ({"name": "rpc/connections_total", "labels": {},
                     "value": 208.0},
                    {"name": "service/requests_total",
                     "labels": {"op": "easgd_get_center"}, "value": 99.0},
                    {"name": "service/rpc_ms",
                     "labels": {"op": "easgd_get_center"}, "p99": 3.5}):
            f.write(json.dumps(rec) + "\n")
    assert br.monitor_evidence(str(tmp_path)) == {
        "rpc_connections_total": 208.0, "requests_total": 99.0,
        "server_rpc_p99_ms": 3.5}


def test_threaded_loop_is_refused(capsys):
    assert br.main(["--loops", "threaded", "--device", "cpu"]) == 2
    assert "threaded" in capsys.readouterr().err
