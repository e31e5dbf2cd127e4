"""Local aggregation (``theanompi_tpu_torch/parallel/aggregate.py``)
against the JAX package's (``tests/test_aggregate.py``).

Values lie on a lattice (multiples of 2**-10, |x| <= 4) so every sum,
mean and elastic pull is exact in f32: an aggregated EASGD period equals
n direct exchanges at ONE center version bit for bit (the limit is 0 on
the lattice; off it, the mean's and the n-fold move's roundings differ
from n separate moves by a few f32 ulps of the center), ASGD's delta sum
equals n sequential SGD pushes, and the port's aggregator returns JAX's
aggregator's bytes.  While the aggregator is down, or a peer never
submits, a worker falls back to a direct exchange, and every fallback is
counted (``aggregate/fallbacks_total`` and ``LocalAggregator.
fallbacks``).  The rules run local aggregation in threaded sessions
(in-process and through a service), and the launcher's
``--local-aggregation`` writes zero fallbacks into its result.
"""

from __future__ import annotations

import json
import os
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel.aggregate import AggregatedExchange as JaxPort
from theanompi_tpu.parallel.aggregate import LocalAggregator as JaxAgg
from theanompi_tpu.parallel.server import EASGDServer as JaxEASGDServer
from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.parallel import service
from theanompi_tpu_torch.parallel.aggregate import (
    AggregatedExchange,
    AggregatorDown,
    LocalAggregator,
)
from theanompi_tpu_torch.parallel.server import ASGDServer, EASGDServer

ALPHA = 0.25
SHAPES = ((8, 4), (33,), (2, 2, 2))


def lattice(seed, lo=-2 ** 12, hi=2 ** 12):
    rng = np.random.default_rng(seed)
    return [(rng.integers(lo, hi, s) * 2.0 ** -10 + 0.0).astype(np.float32)
            for s in SHAPES]


def tensors(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def assert_bytes_equal(got, want, what=""):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.tobytes() == np.asarray(w).tobytes(), what


def closed_form_easgd(center, workers, alpha):
    a = np.float32(alpha)
    new_c = [c + a * sum(w[i] - c for w in workers)
             for i, c in enumerate(center)]
    new_ws = [[x - a * (x - c) for x, c in zip(w, center)] for w in workers]
    return new_c, new_ws


def run_period(ports, payloads, op="exchange"):
    outs, errs = [None] * len(ports), [None] * len(ports)

    def run(i):
        try:
            outs[i] = getattr(ports[i], op)(payloads[i])
        except BaseException as e:
            errs[i] = e
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(ports))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(e is None for e in errs), errs
    return outs


def test_easgd_periods_equal_direct_exchanges_at_one_version():
    c0 = lattice(0)
    srv = EASGDServer(tensors(c0), alpha=ALPHA)
    agg = LocalAggregator("easgd", srv, alpha=ALPHA)
    ports = [AggregatedExchange(agg, i, lambda: srv) for i in range(4)]
    workers = [lattice(10 + i) for i in range(4)]
    ref_c, ref_ws = c0, workers
    try:
        for _ in range(3):
            outs = run_period(ports, [tensors(w) for w in workers])
            ref_c, ref_ws = closed_form_easgd(ref_c, ref_ws, ALPHA)
            for out, ref in zip(outs, ref_ws):
                assert_bytes_equal(out, ref, "worker pull")
            workers = [[t.numpy() for t in o] for o in outs]
        assert_bytes_equal(srv.get_center(), ref_c, "center")
        assert srv.n_exchanges == 12
        assert (agg.flights, agg.fallbacks) == (3, 0)
    finally:
        for p in ports:
            p.close()


def test_easgd_aggregate_matches_jax_aggregator():
    c0 = lattice(1)
    psrv = EASGDServer(tensors(c0), alpha=ALPHA)
    jsrv = JaxEASGDServer(c0, alpha=ALPHA)
    pagg = LocalAggregator("easgd", psrv, alpha=ALPHA)
    jagg = JaxAgg("easgd", jsrv, alpha=ALPHA)
    pports = [AggregatedExchange(pagg, i, lambda: psrv) for i in range(4)]
    jports = [JaxPort(jagg, i, lambda: jsrv) for i in range(4)]
    try:
        workers = [lattice(20 + i) for i in range(4)]
        pout = run_period(pports, [tensors(w) for w in workers])
        jout = run_period(jports, workers)
        for p, j in zip(pout, jout):
            assert_bytes_equal(p, jax.tree.leaves(j))
        assert_bytes_equal(psrv.get_center(),
                           jax.tree.leaves(jax.device_get(
                               jsrv.get_center())))
    finally:
        for p in pports + jports:
            p.close()


def test_asgd_delta_sum_equals_sequential_pushes():
    c0 = lattice(3)
    hp = {"learning_rate": 0.125}
    direct = ASGDServer(tensors(c0), hp)
    srv = ASGDServer(tensors(c0), hp)
    agg = LocalAggregator("asgd", srv)
    ports = [AggregatedExchange(agg, i, lambda: srv) for i in range(4)]
    gs = [lattice(30 + i, -8, 9) for i in range(4)]
    try:
        for _ in range(3):
            for g in gs:
                direct.push_pull(tensors(g))
            outs = run_period(ports, [tensors(g) for g in gs],
                              op="push_pull")
            for o in outs:
                assert_bytes_equal(o, srv.get_center(), "fan-out")
        assert_bytes_equal(srv.get_center(), direct.get_center())
        assert srv.n_updates == direct.n_updates == 12
    finally:
        for p in ports:
            p.close()


def test_kill_falls_back_direct_and_counts_then_rejoins(tmp_path):
    srv = EASGDServer(tensors(lattice(0)), alpha=ALPHA)
    agg = LocalAggregator("easgd", srv, alpha=ALPHA)
    ports = [AggregatedExchange(agg, i, lambda: srv) for i in range(2)]
    try:
        with monitor.session(str(tmp_path)):
            run_period(ports, [tensors(lattice(10 + i)) for i in range(2)])
            agg.kill("test kill")
            assert not agg.alive()
            run_period(ports, [tensors(lattice(12 + i)) for i in range(2)])
            fallbacks = monitor.registry().snapshot()
            agg.restart()
            run_period(ports, [tensors(lattice(14 + i)) for i in range(2)])
        assert srv.n_exchanges == 6
        assert (agg.flights, agg.fallbacks) == (2, 2)
        assert "aggregate/fallbacks_total" in json.dumps(fallbacks)
    finally:
        for p in ports:
            p.close()


def test_quorum_timeout_withdraws_and_falls_back():
    srv = EASGDServer(tensors(lattice(0)), alpha=ALPHA)
    agg = LocalAggregator("easgd", srv, alpha=ALPHA, wait_timeout_s=0.3)
    agg.register(1)  # never submits
    port = AggregatedExchange(agg, 0, lambda: srv)
    try:
        out = port.exchange(tensors(lattice(5)))
        assert len(out) == 3
        assert srv.n_exchanges == 1 and agg.fallbacks == 1
    finally:
        port.close()


def test_leave_shrinks_the_quorum_and_kinds_are_checked():
    srv = EASGDServer(tensors(lattice(0)), alpha=ALPHA)
    agg = LocalAggregator("easgd", srv, alpha=ALPHA)
    ports = [AggregatedExchange(agg, i, lambda: srv) for i in range(3)]
    ports[2].close()
    run_period(ports[:2], [tensors(lattice(10 + i)) for i in range(2)])
    assert srv.n_exchanges == 2
    for p in ports[:2]:
        p.close()
    with pytest.raises(ValueError, match="easgd/asgd only"):
        LocalAggregator("gosgd", object())
    with pytest.raises(ValueError, match="alpha"):
        LocalAggregator("easgd", object())
    with pytest.raises(AggregatorDown):
        LocalAggregator("asgd", srv).exchange(0, [])


# -- the rules and the launcher ---------------------------------------------


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    import test_torch_async_rules as rules_tests

    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "agg-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    return rules_tests


@pytest.mark.parametrize("remote", [False, True], ids=["in-process",
                                                        "service"])
def test_easgd_session_aggregates_every_period(tiny, tmp_path, remote):
    from theanompi_tpu_torch import EASGD

    srv = None
    kw = {}
    if remote:
        srv = _thread_service()
        kw["server_addr"] = srv.addr
    try:
        rule = EASGD().init(devices=2, device="cpu", modelfile=tiny.HERE,
                            modelclass="TinyCifar",
                            config=tiny.tiny_cfg(tmp_path), tau=4,
                            alpha=0.5, checkpoint=False,
                            local_aggregation=True, **kw)
        res = tiny.finish(rule)
    finally:
        if srv is not None:
            srv.stop()
    # 8 iterations a worker at tau 4: 2 periods + the final sync
    assert res["aggregate"] == {"flights": 3, "fallbacks": 0}
    assert res["n_exchanges"] == 6
    assert all(torch.isfinite(t).all() for t in res["center"].values())


def test_asgd_session_aggregates_every_push(tiny, tmp_path):
    from theanompi_tpu_torch import ASGD

    rule = ASGD().init(devices=2, device="cpu", modelfile=tiny.HERE,
                       modelclass="TinyCifar",
                       config=tiny.tiny_cfg(tmp_path), checkpoint=False,
                       local_aggregation=True)
    res = tiny.finish(rule)
    assert res["aggregate"] == {"flights": 8, "fallbacks": 0}
    assert res["n_updates"] == 16


def test_launcher_local_aggregation(tiny, tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", tiny.TESTS)
    out = tmp_path / "r.json"
    rc = tiny._launch(["EASGD", "-D", "2", "--platform", "cpu", "-m",
                       tiny.HERE, "-c", "TinyCifar", "--epochs", "1",
                       "--set", "batch_size=8", "--set", "print_freq=0",
                       "--snapshot-dir", str(tmp_path), "--tau", "4",
                       "--alpha", "0.5", "--local-aggregation",
                       "--result-json", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["aggregate"] == {"flights": 3, "fallbacks": 0}
    assert res["n_exchanges"] == 6


class _ThreadService:
    def __init__(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.ready, self.stop_ev = threading.Event(), threading.Event()
        self.thread = threading.Thread(
            target=service.serve, args=("127.0.0.1", self.port),
            kwargs=dict(ready_event=self.ready, stop_event=self.stop_ev,
                        device="cpu"), daemon=True)
        self.thread.start()
        assert self.ready.wait(10)
        self.addr = f"127.0.0.1:{self.port}"

    def stop(self):
        self.stop_ev.set()
        try:
            socket.create_connection(("127.0.0.1", self.port), 2).close()
        except OSError:
            pass
        self.thread.join(timeout=15)


def _thread_service():
    return _ThreadService()
