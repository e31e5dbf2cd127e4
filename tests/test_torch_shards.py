"""The port's shard fleet (``theanompi_tpu_torch/parallel/shards.py``)
against the JAX package's (``tests/test_shards.py``).

* ``partition_ranges`` is JAX's plan for the same sizes.
* ``ShardParamService``'s version fence (freeze, admission, vector
  clock, applied counter, typed ``FenceBusy``/``ShardNotReady``) as in
  JAX's unit test, and its tagged exchanges equal JAX's shard service's.
* A fleet of two spawned shard processes (``ShardProcessGroup``, on the
  CPU): ``ShardedEASGD``/``ShardedASGD`` are bit-identical to the
  in-process stores every exchange, the fenced read is one version, a
  killed shard is relaunched by the group and its leaf range rebuilt
  from the client's last good sub-result (JAX's rejoin arithmetic), the
  sibling shard untouched.
* ``launcher ASGD --shards 2`` runs a session over its own fleet, and
  JAX's refusal matrix for ``--shards``.

The lane is off (``THEANOMPI_TPU_WIRE_SHM=0``): a shard process's
parked segments would outlive the suite's 2 s segment guard in tests
running beside these.  The fleet and every launcher run have deadlines
of their own (60 s).
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from theanompi_tpu.parallel.shards import ShardParamService as JaxShard
from theanompi_tpu.parallel.shards import partition_ranges as jax_ranges
from theanompi_tpu_torch import launcher
from theanompi_tpu_torch.parallel.server import ASGDServer, EASGDServer
from theanompi_tpu_torch.parallel.service import FenceBusy, ShardNotReady
from theanompi_tpu_torch.parallel.shards import (
    ShardedASGD,
    ShardedEASGD,
    ShardParamService,
    ShardProcessGroup,
    partition_ranges,
    shard_addresses,
)

KEY = "shards-test"
SHAPES = ((40, 30), (30,), (30, 20), (20,), (7, 7, 3))


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "20")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "45")


def params(seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) + shift).astype(
        np.float32)) for s in SHAPES]


@pytest.mark.parametrize("sizes,k", [
    ([100, 1, 1, 1, 50, 50, 7], 3), ([8] * 10, 4), ([5, 0, 0, 5], 2),
    ([3, 1, 4, 1, 5, 9, 2, 6], 1)])
def test_partition_ranges_are_jax_ranges(sizes, k):
    assert partition_ranges(sizes, k) == jax_ranges(sizes, k)
    with pytest.raises(ValueError, match="at most one shard per leaf"):
        partition_ranges(sizes, len(sizes) + 1)


def test_shard_addresses():
    assert shard_addresses(None) is None
    assert shard_addresses("a:1, b:2,") == ["a:1", "b:2"]
    with pytest.raises(ValueError, match="no addresses"):
        shard_addresses(" , ")


def test_fence_unit_semantics_and_jax_arithmetic():
    svc = ShardParamService(3, device="cpu")
    jsvc = JaxShard(3)
    with pytest.raises(ShardNotReady):
        svc.handle("shard_freeze", "easgd", "s", "t0")
    init = [np.zeros(4, np.float32)]
    svc.handle("easgd_init", init, 0.5, "s")
    jsvc.handle("easgd_init", init, 0.5, "s")
    info = svc.handle("shard_freeze", "easgd", "s", "t1")
    assert info == {"shard": 3, "vclock": {}, "applied": 0}
    with pytest.raises(FenceBusy):
        svc.handle("shard_freeze", "easgd", "s", "t2")
    admitted = threading.Event()
    out = {}

    def mutate():
        out["port"] = svc.handle("shard_exchange", "s",
                                 [np.ones(4, np.float32)], "c", 1)
        admitted.set()
    t = threading.Thread(target=mutate, daemon=True)
    t.start()
    assert not admitted.wait(0.3)  # frozen: the mutation is parked
    svc.handle("shard_release", "easgd", "s", "t1")
    assert admitted.wait(5)
    t.join(5)
    want = jsvc.handle("shard_exchange", "s", [np.ones(4, np.float32)],
                       "c", 1)
    np.testing.assert_array_equal(out["port"][0], np.asarray(want[0]))
    with pytest.raises(ValueError, match="seq"):
        svc.handle("shard_exchange", "s", [np.ones(4, np.float32)], "c",
                   "bogus")
    # the aggregate form: the 5th argument multiplies the count
    got = svc.handle("shard_exchange", "s", [np.ones(4, np.float32)], "c",
                     2, 2)
    want = jsvc.handle("shard_exchange", "s", [np.ones(4, np.float32)], "c",
                       2, 2)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    info = svc.handle("shard_freeze", "easgd", "s", "t3")
    assert info["vclock"] == {"c": 2} and info["applied"] == 3
    svc.handle("shard_release", "easgd", "s", "t3")
    assert svc.handle("stats") == jsvc.handle("stats")


@pytest.fixture(scope="module")
def fleet():
    old = os.environ.get("THEANOMPI_TPU_SERVICE_KEY")
    os.environ["THEANOMPI_TPU_SERVICE_KEY"] = KEY
    os.environ["THEANOMPI_TPU_WIRE_SHM"] = "0"
    group = ShardProcessGroup(2, max_restarts=1, ready_timeout_s=60)
    try:
        yield group
    finally:
        group.stop()
        os.environ.pop("THEANOMPI_TPU_WIRE_SHM", None)
        if old is None:
            os.environ.pop("THEANOMPI_TPU_SERVICE_KEY", None)
        else:
            os.environ["THEANOMPI_TPU_SERVICE_KEY"] = old


def test_sharded_easgd_is_bit_identical_every_exchange(fleet):
    p0 = params(0)
    local = EASGDServer(p0, alpha=0.5)
    srv = ShardedEASGD(fleet.addresses, p0, alpha=0.5, session_id="e")
    joiner = ShardedEASGD(fleet.addresses, None, alpha=0.5, session_id="e")
    try:
        for n in range(4):
            w = params(10 + n)
            c = joiner if n % 2 else srv
            got, want = c.exchange(w), local.exchange(w)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        mean = params(20)
        got, want = srv.exchange_n(mean, 2), local.exchange_n(mean, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        cut, vclock = srv.fenced_center()
        assert all(torch.equal(a, b)
                   for a, b in zip(cut, local.get_center()))
        assert sorted(vclock.values()) == [2, 3]
        assert srv.n_exchanges == local.n_exchanges == 6
    finally:
        srv.close()
        joiner.close()


def test_cpu_shards_share_the_cores(monkeypatch):
    """K CPU shards each get a K-th of the cores for their arithmetic
    (K full-width pools made the 2-shard exchange slower than one shard,
    ``bench_exchange --shards 2 --smoke``); a caller's own
    ``OMP_NUM_THREADS`` wins, and a card's shards are left alone."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    group = ShardProcessGroup.__new__(ShardProcessGroup)
    group.device, group.n_shards = "cpu", 2
    cores = len(os.sched_getaffinity(0))
    assert group.shard_env()["OMP_NUM_THREADS"] == str(max(1, cores // 2))
    group.n_shards = 4 * cores
    assert group.shard_env()["OMP_NUM_THREADS"] == "1"
    group.device = "cuda"
    assert "OMP_NUM_THREADS" not in group.shard_env()
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    group.device = "cpu"
    assert group.shard_env()["OMP_NUM_THREADS"] == "3"


def test_fleet_on_unix_sockets(monkeypatch):
    """``THEANOMPI_TPU_UNIX_SOCKETS=1`` (JAX's switch) puts the fleet on
    AF_UNIX listeners: the addresses are ``unix:/path``, the routers'
    exchanges and the fenced read are the in-process store's bit for bit,
    and ``stop`` leaves no socket file behind."""
    monkeypatch.setenv("THEANOMPI_TPU_UNIX_SOCKETS", "1")
    p0 = params(0)
    local = EASGDServer(p0, alpha=0.5)
    group = ShardProcessGroup(2, max_restarts=0, ready_timeout_s=60)
    paths = []
    try:
        paths = [a[len("unix:"):] for a in group.addresses]
        assert all(a.startswith("unix:") for a in group.addresses)
        assert all(os.path.exists(p) for p in paths)
        srv = ShardedEASGD(group.addresses, p0, alpha=0.5, session_id="u")
        try:
            for n in range(2):
                w = params(30 + n)
                got, want = srv.exchange(w), local.exchange(w)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            cut, _ = srv.fenced_center()
            assert all(torch.equal(a, b)
                       for a, b in zip(cut, local.get_center()))
        finally:
            srv.close()
    finally:
        group.stop()
    assert paths and not any(os.path.exists(p) for p in paths)
    assert not os.path.exists(os.path.dirname(paths[0]))


def test_sharded_asgd_is_bit_identical_across_set_lr(fleet):
    p0 = params(1)
    hp = {"learning_rate": 0.1, "optimizer": "sgd", "momentum": 0.9}
    local = ASGDServer(p0, hp)
    srv = ShardedASGD(fleet.addresses, p0, hp, session_id="a")
    try:
        for n in range(4):
            if n == 2:
                srv.set_lr(0.01)
                local.set_lr(0.01)
            g = params(30 + n)
            assert all(torch.equal(a, b) for a, b in
                       zip(srv.push_pull(g), local.push_pull(g)))
        assert srv.n_updates == 4
        assert srv.supports_opt_state is False
        with pytest.raises(ValueError, match="opt_state"):
            ShardedASGD(fleet.addresses, p0, hp, opt_state={"state": {}},
                        session_id="a2")
    finally:
        srv.close()


def test_killed_shard_restarts_and_rejoins(fleet):
    """Kill shard 1: the group relaunches it; the next exchange rejoins
    and rebuilds ONLY its range from the client's last good sub-result
    (``new_w = w - a (w - last)``), shard 0's count runs on."""
    srv = ShardedEASGD(fleet.addresses, params(2), alpha=0.5,
                       session_id="kill")
    try:
        last = None
        for n in range(3):
            last = srv.exchange(params(2, shift=0.1 * (n + 1)))
        fleet.kill_shard(1)
        fleet.wait_restarted(1, timeout_s=60)
        w = params(2, shift=0.4)
        out = srv.exchange(w)
        assert srv._shard_clients[0].call("stats")["n_exchanges"] == 4
        assert srv._shard_clients[1].call("stats")["n_exchanges"] == 1
        lo, hi = srv._plan.ranges[1]
        for j in range(lo, hi):
            want = w[j] - 0.5 * (w[j] - last[j])
            assert torch.equal(out[j], want)
        cut, vclock = srv.fenced_center()
        assert vclock[srv._client_id] == 4
        assert all(torch.isfinite(c).all() for c in cut)
        assert fleet.restart_counts() == {1: 1}
    finally:
        srv.close()


# -- the launcher -----------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["GOSGD", "--shards", "2"], "--shards applies to EASGD/ASGD only"),
    (["EASGD", "--shards", "2", "--server-addr", "h:1"], "not both"),
    (["ASGD", "--shards", "0"], "--shards must be >= 1"),
    (["EASGD", "--shards", "2", "--multihost", "--coordinator", "h:1",
      "--nhosts", "2", "--host-id", "0"], "single-host")])
def test_launcher_shards_refusal_matrix(argv, match):
    with pytest.raises(SystemExit, match=match):
        launcher.main(argv + ["-m", "x", "-c", "y"])


def test_launcher_asgd_over_its_own_shard_fleet(tmp_path, monkeypatch):
    import test_torch_async_rules as rules_tests

    monkeypatch.setenv("PYTHONPATH", rules_tests.TESTS)
    out = tmp_path / "r.json"
    rc = rules_tests._launch(
        ["ASGD", "-D", "2", "--platform", "cpu", "-m", rules_tests.HERE,
         "-c", "TinyCifar", "--epochs", "1", "--set", "batch_size=8",
         "--set", "print_freq=0", "--snapshot-dir", str(tmp_path),
         "--shards", "2", "--result-json", str(out)], timeout=60)
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["n_updates"] == 16 and res["rule"] == "ASGD"
    assert all(np.isfinite(v) for v in res["val"].values())


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_launcher_fleet_runs_on_the_workers_platform(platform, monkeypatch):
    """``--shards K`` gives every shard the workers' ``--platform`` as its
    ``--device``, and the workers the fleet's ``--server-addr``."""
    import argparse

    from theanompi_tpu_torch.parallel import shards as shards_mod

    made, spawned = [], []

    class Group:
        server_addr = "127.0.0.1:1,127.0.0.1:2"

        def __init__(self, n, **kw):
            made.append((n, kw))

        def stop(self):
            made.append("stopped")

    monkeypatch.setattr(shards_mod, "ShardProcessGroup", Group)
    monkeypatch.setattr(launcher, "_spawn",
                        lambda args, argv: spawned.append(argv) or 0)
    args = argparse.Namespace(shards=2, platform=platform, max_restarts=0)
    assert launcher.spawn(args, ["ASGD", "--shards", "2", "-m", "x"]) == 0
    assert made == [(2, {"device": platform, "max_restarts": 1}),
                    "stopped"]
    assert spawned == [["ASGD", "-m", "x", "--server-addr",
                        Group.server_addr]]
