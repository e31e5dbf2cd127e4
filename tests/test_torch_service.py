"""The port's parameter service (``theanompi_tpu_torch/parallel/
service.py``).

* **Against JAX's service.** The port's ``ParamService.handle`` and
  JAX's are driven with the same numpy sequence: an EASGD exchange and
  ``exchange_n``, ASGD with SGD (momentum) and with Adam and a
  ``set_lr`` between pushes, GOSGD pushes and drains.  The centers agree
  within 1e-6 relative (as ``test_torch_async_stores.py`` holds the
  in-process stores), the counts exactly.
* **Remote against in-process.** The deterministic two-worker EASGD,
  ASGD and GOSGD schedules of ``test_torch_async_schedule.py`` (from the
  JAX model's weights) run once through a service process
  (``python -m theanompi_tpu_torch.parallel.service --device cpu``) and
  once through the in-process stores: every worker and the center are
  bit-identical (and the in-process schedule is held within 1e-5 of
  JAX's there).
* JAX's behaviour kept: no default key, sessions and displacement, the
  rejoin after a restart of the service, ASGD's optimizer state for the
  server-state checkpoint, the ``service_call`` fault site; and the
  port's own: ``--device cuda`` raises without a card.

The shared-memory lane is off here (``THEANOMPI_TPU_WIRE_SHM=0``): a
client's parked segments would outlive the suite's 2 s segment guard in
tests running beside these (``test_torch_shm.py`` and
``test_torch_rpc.py`` cover the lane).  Every spawned process has a
deadline of its own.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import service as jservice
from theanompi_tpu_torch import ASGD, EASGD, GOSGD
from theanompi_tpu_torch.parallel import rpc, service
from theanompi_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "service-test"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "4")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "20")


class ThreadService:
    """``service.serve`` on a thread over a CPU ``ParamService``."""

    def __init__(self, port: int | None = None):
        self.port = port or free_port()
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
        assert not self.thread.is_alive()


@pytest.fixture(params=["socket", "mux"])
def local_service(request):
    """A thread service and a client factory: each client on a socket of
    its own, or all of them as streams of one multiplexed socket
    (``rpc.MuxConnection``, as the shard router connects)."""
    s = ThreadService()
    t = rpc.MuxConnection(s.addr) if request.param == "mux" else None

    def remote(cls, *args, **kw):
        return cls(s.addr, *args, transport=t, **kw)
    yield remote
    if t is not None:
        assert t.mux
        t.close()
    s.stop()


def arrays(seed, shapes=((6, 5), (5,), (3, 2, 2))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def assert_close(got, want, rtol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


# -- the service against JAX's ----------------------------------------------


def test_easgd_handle_matches_jax():
    port, jax_ = service.ParamService(device="cpu"), jservice.ParamService()
    init = arrays(0)
    for s in (port, jax_):
        s.handle("easgd_init", init, 0.25, "s")
    for k in range(3):
        w = arrays(10 + k)
        assert_close(port.handle("easgd_exchange", "s", w),
                     jax_.handle("easgd_exchange", "s", w))
    mean = arrays(20)
    assert_close(port.handle("easgd_exchange_n", "s", mean, 2),
                 jax_.handle("easgd_exchange_n", "s", mean, 2))
    assert_close(port.handle("easgd_get_center", "s"),
                 jax_.handle("easgd_get_center", "s"))
    assert port.handle("stats") == jax_.handle("stats") == {
        "n_exchanges": 5}


@pytest.mark.parametrize("opt_cfg", [
    {"learning_rate": 0.1, "optimizer": "sgd", "momentum": 0.9,
     "weight_decay": 1e-3},
    {"learning_rate": 0.01, "optimizer": "adam"}])
def test_asgd_handle_matches_jax_across_set_lr(opt_cfg):
    port, jax_ = service.ParamService(device="cpu"), jservice.ParamService()
    init = arrays(1)
    for s in (port, jax_):
        s.handle("asgd_init", init, dict(opt_cfg), None, "s")
    for k in range(4):
        if k == 2:
            for s in (port, jax_):
                s.handle("asgd_set_lr", "s", opt_cfg["learning_rate"] / 10)
        g = arrays(30 + k)
        assert_close(port.handle("asgd_push_pull", "s", g),
                     jax_.handle("asgd_push_pull", "s", g))
    gsum = arrays(40)
    assert_close(port.handle("asgd_push_pull_n", "s", gsum, 3),
                 jax_.handle("asgd_push_pull_n", "s", gsum, 3))
    assert port.handle("stats") == jax_.handle("stats") == {"n_updates": 7}
    state = port.handle("asgd_get_opt_state", "s")
    assert state["param_groups"][0]["lr"] == pytest.approx(
        opt_cfg["learning_rate"] / 10)
    assert all(isinstance(v, np.ndarray) or np.isscalar(v)
               for per in state["state"].values() for v in per.values())


def test_gosgd_handle_matches_jax():
    port, jax_ = service.ParamService(device="cpu"), jservice.ParamService()
    for s in (port, jax_):
        s.handle("gosgd_init", 3, "s")
    pushes = [(1, arrays(50), 0.25), (1, arrays(51), 0.125),
              (2, arrays(52), 0.5)]
    for dst, p, w in pushes:
        assert port.handle("gosgd_push", "s", dst, p, w) is \
            jax_.handle("gosgd_push", "s", dst, p, w) is True
    port.handle("gosgd_deactivate", "s", 0)
    jax_.handle("gosgd_deactivate", "s", 0)
    assert port.handle("gosgd_push", "s", 0, arrays(53), 0.1) is \
        jax_.handle("gosgd_push", "s", 0, arrays(53), 0.1) is False
    for rank in (1, 2, 0):
        got = port.handle("gosgd_drain", "s", rank)
        want = jax_.handle("gosgd_drain", "s", rank)
        assert [w for _, w in got] == [w for _, w in want]
        for (gp, _), (wp, _) in zip(got, want):
            assert_close(gp, jax.tree.leaves(wp), rtol=0)


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    with pytest.raises(RuntimeError, match="cuda"):
        service.ParamService()
    with pytest.raises(RuntimeError, match="cuda"):
        service.main(["--device", "cuda", "--port", "1"])


# -- clients over the wire --------------------------------------------------


def test_remote_clients_return_new_tensors(local_service):
    params = [torch.tensor(a) for a in arrays(2)]
    c = local_service(service.RemoteEASGD, params, alpha=0.5,
                            session_id="a")
    try:
        w = [p + 1 for p in params]
        out = c.exchange(w)
        for o, p, x in zip(out, params, w):
            assert torch.is_tensor(o) and o.dtype == torch.float32
            torch.testing.assert_close(o, x - 0.5, rtol=0, atol=1e-6)
            o.add_(1)  # a copy: writable, and nothing else changes
        center = c.get_center()
        for ct, p in zip(center, params):
            torch.testing.assert_close(ct, p + 0.5, rtol=0, atol=1e-6)
        assert c.n_exchanges == 1
    finally:
        c.close()


def test_session_scoping_and_displacement(local_service):
    p = [torch.zeros(2)]
    s1 = local_service(service.RemoteEASGD, p, alpha=0.5, session_id="a")
    worker = local_service(service.RemoteEASGD, None, alpha=0.5,
                                 session_id="a")
    try:
        torch.testing.assert_close(worker.exchange([torch.ones(2)])[0],
                                   torch.full((2,), 0.5))
        s2 = local_service(service.RemoteEASGD, p, alpha=0.5,
                                 session_id="b")
        with pytest.raises(RuntimeError, match="displaced"):
            s1.exchange([torch.ones(2)])
        with pytest.raises(RuntimeError, match="not active"):
            local_service(service.RemoteEASGD, None, alpha=0.5,
                                session_id="zzz")
        s2.exchange([torch.ones(2)])
        s2.close()
    finally:
        s1.close()
        worker.close()


def test_rejoin_after_a_service_restart(monkeypatch):
    """The service dies and comes back on the same port with no
    sessions: the creator's next exchange reconnects and rebuilds the
    store from its last good result (JAX's rejoin), and a joiner rejoins
    the rebuilt session."""
    srv = ThreadService()
    c = service.RemoteASGD(srv.addr, [torch.zeros(3)],
                           {"learning_rate": 0.5}, session_id="r")
    joiner = service.RemoteASGD(srv.addr, None, {"learning_rate": 0.5},
                                session_id="r")
    try:
        first = c.push_pull([torch.ones(3)])
        torch.testing.assert_close(first[0], torch.full((3,), -0.5))
        srv.stop()
        srv = ThreadService(srv.port)
        again = c.push_pull([torch.ones(3)])  # rebuilt from `first`
        torch.testing.assert_close(again[0], torch.full((3,), -1.0))
        torch.testing.assert_close(joiner.push_pull([torch.ones(3)])[0],
                                   torch.full((3,), -1.5))
        assert c.n_updates == 2
    finally:
        c.close()
        joiner.close()
        srv.stop()


def test_asgd_opt_state_round_trips_for_the_checkpoint(local_service):
    cfg = {"learning_rate": 0.1, "optimizer": "sgd", "momentum": 0.9}
    params = [torch.tensor(a) for a in arrays(3)]
    c = local_service(service.RemoteASGD, params, cfg, session_id="o")
    try:
        for k in range(2):
            c.push_pull([torch.tensor(a) for a in arrays(60 + k)])
        state = c.get_opt_state()
        center = c.get_center()
        buf = state["state"][0]["momentum_buffer"]
        assert torch.is_tensor(buf) and buf.shape == (6, 5)
        g = [torch.tensor(a) for a in arrays(62)]
        want = c.push_pull(g)
        # a resumed session seeded with the center and the state steps
        # exactly as the original did
        r = local_service(service.RemoteASGD, center, cfg, opt_state=state,
                               session_id="o2")
        try:
            assert all(torch.equal(a, b)
                       for a, b in zip(r.push_pull(g), want))
        finally:
            r.close()
    finally:
        c.close()


def test_no_default_key(monkeypatch):
    monkeypatch.delenv("THEANOMPI_TPU_SERVICE_KEY")
    with pytest.raises(RuntimeError, match="THEANOMPI_TPU_SERVICE_KEY"):
        service.ServiceClient("127.0.0.1:1")
    srv = ThreadService()
    try:
        generated = os.environ.get("THEANOMPI_TPU_SERVICE_KEY")
        assert generated and generated != KEY
        c = service.ServiceClient(srv.addr)
        assert c.call("ping") == "pong"
        c.close()
    finally:
        srv.stop()


def test_service_call_fault_drop_reconnects(local_service):
    faults.install([{"site": "service_call", "op": "easgd_exchange",
                     "nth": 2, "action": "drop"}])
    c = local_service(service.RemoteEASGD, [torch.zeros(2)], alpha=0.5,
                            session_id="f")
    try:
        for _ in range(3):
            c.exchange([torch.ones(2)])
        assert c.n_exchanges == 3
    finally:
        faults.clear()
        c.close()


# -- remote schedules against in-process ------------------------------------


@pytest.fixture(scope="module")
def service_process():
    """``python -m theanompi_tpu_torch.parallel.service --device cpu`` in
    a process of its own, for the module."""
    port = free_port()
    env = dict(os.environ, THEANOMPI_TPU_SERVICE_KEY=KEY,
               THEANOMPI_TPU_WIRE_SHM="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.service",
         "--host", "127.0.0.1", "--port", str(port), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    old = os.environ.get("THEANOMPI_TPU_SERVICE_KEY")
    os.environ["THEANOMPI_TPU_SERVICE_KEY"] = KEY
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                c = service.ServiceClient(f"127.0.0.1:{port}")
                assert c.call("ping") == "pong"
                c.close()
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "no service in 60 s"
                time.sleep(0.3)
        yield f"127.0.0.1:{port}"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        if old is None:
            os.environ.pop("THEANOMPI_TPU_SERVICE_KEY", None)
        else:
            os.environ["THEANOMPI_TPU_SERVICE_KEY"] = old


def run_schedule(rule_cls, n_images, epochs, iters, **opts):
    """A two-worker round-robin schedule of the schedule tests' Cifar10
    model (from the JAX model's weights); returns every worker's
    parameters, the center and the counts."""
    import test_torch_async_schedule as sched

    jcfg, pcfg = sched.configs()
    params0 = sched.initial_params(sched.jax_workers(jcfg, n_images, n=1)[0])
    rule = sched.port_rule(rule_cls, pcfg, n_images, params0, **opts)
    try:
        ws = rule.workers
        for w in ws:
            w.open()
        for epoch in range(epochs):
            for w in ws:
                assert w.model.begin_epoch(epoch) == iters
            for it in range(iters):
                for w in ws:
                    w.step(it)
            if rule_cls is ASGD:
                for w in ws:
                    w.end_epoch(epoch)
        for w in ws:
            w.finish()
            w.close()
        if rule_cls is GOSGD:
            for w in ws:
                w.merge_inbox(scale_momentum=False, hub=rule.hub)
            center, count = [], list(rule.weights)
        elif rule_cls is EASGD:
            center, count = rule.server.get_center(), rule.server.n_exchanges
        else:
            center, count = rule.server.get_center(), rule.server.n_updates
        return ([p.detach().clone() for w in ws for p in w.params],
                [c.clone() for c in center], count)
    finally:
        rule.close()


@pytest.mark.parametrize("rule_cls,n_images,epochs,iters,opts", [
    (EASGD, 128, 1, 8, {"tau": 2, "alpha": 0.5}),
    (ASGD, 48, 2, 3, {}),
    (GOSGD, 64, 1, 4, {"p_push": 1.0}),
], ids=["easgd", "asgd", "gosgd"])
def test_remote_schedule_is_bit_identical_to_in_process(
        service_process, rule_cls, n_images, epochs, iters, opts):
    local = run_schedule(rule_cls, n_images, epochs, iters, **opts)
    remote = run_schedule(rule_cls, n_images, epochs, iters,
                          server_addr=service_process, **opts)
    assert local[2] == remote[2]
    assert len(local[0]) == len(remote[0]) > 0
    for a, b in zip(local[0] + local[1], remote[0] + remote[1]):
        assert torch.equal(a, b)


# -- the rules and the launcher over a service ------------------------------


@pytest.fixture
def rules_tests(monkeypatch):
    import test_torch_async_rules as rt

    monkeypatch.setenv("PYTHONPATH", rt.TESTS)
    return rt


def launch_async(rt, tmp_path, name, rule, *extra, devices="2"):
    out = tmp_path / f"{name}.json"
    rc = rt._launch([rule, "-D", devices, "--platform", "cpu", "-m",
                     rt.HERE, "-c", "TinyCifar", "--epochs", "1", "--set",
                     "batch_size=8", "--set", "print_freq=0",
                     "--snapshot-dir", str(tmp_path / name),
                     "--result-json", str(out), *extra], timeout=60)
    assert rc == 0
    return json.loads(out.read_text())


def test_launcher_easgd_over_a_service(rules_tests, tmp_path):
    srv = ThreadService()
    try:
        res = launch_async(rules_tests, tmp_path, "e", "EASGD", "--tau",
                           "4", "--server-addr", srv.addr,
                           "--session-id", "launch")
    finally:
        srv.stop()
    assert res["n_exchanges"] == 6
    assert all(np.isfinite(v) for v in res["val"].values())


def test_gosgd_across_two_launcher_processes(rules_tests, tmp_path):
    """Two launchers of one worker each share one hub: global ranks 0 and
    1 of 2, one session id; the gossip weight of both sums to 1."""
    srv = ThreadService()
    results = {}
    try:
        def run(r):
            results[r] = launch_async(
                rules_tests, tmp_path, f"g{r}", "GOSGD", "--p-push", "1.0",
                "--server-addr", srv.addr, "--n-total-workers", "2",
                "--rank-offset", str(r), "--session-id", "shared-hub",
                devices="1")
        threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        srv.stop()
    assert sorted(results) == [0, 1]
    w = results[0]["weights"] + results[1]["weights"]
    assert len(w) == 2 and sum(w) == pytest.approx(1.0, abs=1e-6)
    assert results[0]["iterations"] == results[1]["iterations"] == 16


def test_remote_asgd_resume_restores_the_server_state(rules_tests,
                                                     tmp_path):
    """An ASGD session (one worker: a deterministic order of pushes)
    checkpoints the service's center and optimizer state; a resumed
    session seeds the service with them: its center is the resumed
    in-process session's, bit for bit."""
    rt = rules_tests
    srv = ThreadService()

    def session(name, resume, **kw):
        cfg = rt.tiny_cfg(tmp_path / name, n_epochs=2, momentum=0.9)
        rule = ASGD().init(devices=1, device="cpu", modelfile=rt.HERE,
                           modelclass="TinyCifar", config=cfg,
                           max_epochs=1, resume=resume, **kw)
        return rt.finish(rule)

    try:
        centers = []
        for name, kw in (("remote", {"server_addr": srv.addr}),
                         ("local", {})):
            session(name, False, **kw)
            centers.append(session(name, True, **kw)["center"])
    finally:
        srv.stop()
    remote, local = centers
    assert list(remote) == list(local)
    assert all(torch.equal(remote[k], local[k]) for k in remote)


@pytest.mark.parametrize("argv,match", [
    (["GOSGD", "--local-aggregation"], "applies to EASGD/ASGD only"),
    (["BSP", "--local-aggregation"], "applies to EASGD/ASGD only"),
    (["BSP", "--server-addr", "h:1"], "applies to EASGD/ASGD/GOSGD only"),
    (["EASGD", "--n-total-workers", "2"], "applies to GOSGD only")])
def test_launcher_refusal_matrix(argv, match):
    from theanompi_tpu_torch import launcher

    with pytest.raises(SystemExit, match=match):
        launcher.main(argv + ["-m", "x", "-c", "y"])


def test_gossip_push_racing_a_deactivation_is_never_stranded(monkeypatch):
    """A push still copying its payload when the receiver deactivates and
    drains for the last time is refused (the sender keeps its weight),
    never enqueued after that drain: the weights of two GOSGD processes
    sharing a hub sum to 1 (the race the two-launcher test caught)."""
    from theanompi_tpu_torch.parallel import server

    hub = server.GossipHub(2)
    copying, resume = threading.Event(), threading.Event()
    real = server.publish

    def slow_publish(tensors):
        copying.set()
        assert resume.wait(10)
        return real(tensors)
    monkeypatch.setattr(server, "publish", slow_publish)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        ok=hub.push(0, [torch.ones(3)], 0.25)))
    t.start()
    assert copying.wait(10)
    hub.deactivate(0)
    assert hub.drain(0) == []
    resume.set()
    t.join(10)
    assert out["ok"] is False
    assert hub.drain(0) == []
