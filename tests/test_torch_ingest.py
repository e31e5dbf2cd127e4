"""The port's distributed ingest (``theanompi_tpu_torch/ingest``) against
the JAX package's (``tests/test_ingest.py``), case for case, over real
sockets (readers and coordinators on server threads, the wire loop the
standalone processes run).

* **Streams across the packages, byte for byte.** The port's
  ``RemoteBatchSource`` pulls from JAX readers (and a JAX coordinator),
  JAX's ``RemoteBatchSource`` pulls from port readers, and each pulls
  from its own package's fleet: over fleet sizes 1-3 and trainer ranks
  1-2, every stream equals the local loader's exactly (both packages'
  loaders give the same bytes for the same shard tree and seed).
* The plan math and ``EpochOrder`` against JAX's; backpressure by the
  typed ``Overloaded``; reader death with and without a coordinator;
  the shared-memory lane once, in one process; the ``unix:`` refusal.
* ``begin_epoch`` switches on ``THEANOMPI_TPU_INGEST`` on a tiny ResNet;
  the launcher's ``--ingest`` refusals.

Every wait on a stream has a deadline (:func:`drain`).  The shared
memory lane is off (``THEANOMPI_TPU_WIRE_SHM=0``) except in the lane's
own test, which releases its segments before it returns.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

from theanompi_tpu.data.imagenet import ImageNet_data as JImageNet_data
from theanompi_tpu.ingest import client as jclient
from theanompi_tpu.ingest import coordinator as jcoordinator
from theanompi_tpu.ingest import order as jorder
from theanompi_tpu.ingest import protocol as jprotocol
from theanompi_tpu.ingest import reader as jreader
from theanompi_tpu.parallel import service as jservice
from theanompi_tpu.parallel import shm as jshm
from theanompi_tpu_torch import launcher
from theanompi_tpu_torch.data.imagenet import (
    ImageNet_data,
    prepare_imagenet_shards,
)
from theanompi_tpu_torch.ingest import client, coordinator, protocol, reader
from theanompi_tpu_torch.ingest.order import EpochOrder
from theanompi_tpu_torch.parallel import service, shm

KEY = "test-torch-ingest"
SEED = 3
BATCH = 32

#: each package's ingest modules, for a fleet or a client of either
PKG = {"port": (reader, coordinator, client, service),
       "jax": (jreader, jcoordinator, jclient, jservice)}


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", KEY)
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRIES", "2")
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_RETRY_DEADLINE_S", "5")
    monkeypatch.delenv(protocol.ENV_VAR, raising=False)
    yield
    shm.release_all()
    jshm.release_all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def shard_tree(tmp_path_factory):
    """700 uint8 samples in 7 shard files of 100 (batches straddle file
    boundaries at global batch 32), written by the port."""
    d = str(tmp_path_factory.mktemp("torch_ingest_shards"))
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(700, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=700).astype(np.int64)
    prepare_imagenet_shards(imgs, labels, d, shard_size=100)
    return d


def _dataset(pkg: str, data_dir: str, seed: int = SEED, **kw):
    cls = ImageNet_data if pkg == "port" else JImageNet_data
    kw.setdefault("augment_on_device", True)
    return cls(data_dir=data_dir, crop=8, seed=seed, **kw)


class Fleet:
    """Server-thread readers (+ an optional coordinator) of one package
    on real ports."""

    def __init__(self, pkg: str, data_dir: str, n: int, seed: int = SEED,
                 coordinator: bool = False, max_inflight: int = 8,
                 probe_interval_s: float = 0.3):
        rmod, cmod, _, self.svc = PKG[pkg]
        self.readers, self.threads, self.addrs = [], [], []
        self.stops: list[threading.Event] = []
        for i in range(n):
            r = rmod.IngestReader(data_dir, seed=seed, reader_id=i,
                                  max_inflight=max_inflight)
            self.addrs.append(self._start(rmod.serve_reader, r))
            self.readers.append(r)
        self.coordinator = self.coordinator_addr = None
        if coordinator:
            self.coordinator = cmod.IngestCoordinator(
                list(self.addrs), probe_interval_s=probe_interval_s)
            self.coordinator_addr = self._start(cmod.serve_coordinator,
                                                self.coordinator)

    def _start(self, serve, obj) -> str:
        port = _free_port()
        ready, stop = threading.Event(), threading.Event()
        t = threading.Thread(target=serve,
                             args=("127.0.0.1", port, obj, ready, stop),
                             daemon=True)
        t.start()
        assert ready.wait(30)
        self.threads.append(t)
        self.stops.append(stop)
        return f"127.0.0.1:{port}"

    @property
    def ingest_addrs(self) -> list[str]:
        return ([self.coordinator_addr] if self.coordinator_addr
                else list(self.addrs))

    def kill(self, addr: str) -> None:
        """Shut one server down from a client, as a process death looks
        to the other clients."""
        c = self.svc.ServiceClient(addr)
        try:
            c.call("shutdown")
        except Exception:
            pass
        c.close()

    def forget(self, index: int) -> None:
        """Drop a reader already shut down by :meth:`kill`."""
        self.addrs.pop(index)
        self.stops.pop(index)
        self.threads.pop(index).join(timeout=10)

    def stop(self) -> None:
        for stop in self.stops:
            stop.set()
        for addr in ([self.coordinator_addr] if self.coordinator_addr
                     else []) + list(self.addrs):
            host, port = addr.rsplit(":", 1)
            try:  # a JAX threaded loop wakes on its next accept
                socket.create_connection((host, int(port)), 2).close()
            except OSError:
                pass
        for t in self.threads:
            t.join(timeout=15)
            assert not t.is_alive(), "server thread did not exit"


@pytest.fixture
def fleets():
    made = []

    def make(*args, **kw):
        made.append(Fleet(*args, **kw))
        return made[-1]
    yield make
    for f in made:
        f.stop()


def drain(src, n: int | None = None, timeout_s: float = 60.0) -> list:
    """``n`` batches (all, by default) of ``src`` within a deadline; a
    stream that stalls fails the test instead of hanging the suite."""
    box: dict = {"out": []}

    def run():
        try:
            it = iter(src)
            while n is None or len(box["out"]) < n:
                try:
                    box["out"].append(next(it))
                except StopIteration:
                    return
        except BaseException as e:  # surfaced below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        src.close()  # the consumer's next() raises once closed
        t.join(10)
        pytest.fail(f"the stream stalled past {timeout_s}s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def local_stream(ds, epoch, rank=0, size=1):
    return list(ds.train_batches(epoch, BATCH, rank, size))


def assert_streams_equal(remote, local):
    assert len(remote) == len(local)
    for i, ((rx, ry), (lx, ly)) in enumerate(zip(remote, local)):
        rx, ry = np.asarray(rx), np.asarray(ry)
        assert rx.dtype == lx.dtype and np.array_equal(rx, lx), i
        assert ry.dtype == ly.dtype and np.array_equal(ry, ly), i


# ---------------------------------------------------------------------------
# Pure plan / order math
# ---------------------------------------------------------------------------


class TestPartition:
    @pytest.mark.parametrize("n,k,rot", [(10, 3, 0), (10, 2, 1), (2, 3, 0),
                                         (0, 2, 1), (97, 4, 3)])
    def test_matches_jax(self, n, k, rot):
        readers = [f"r{i}" for i in range(k)]
        owners = protocol.partition_batches(n, readers, rotation=rot)
        assert owners == jprotocol.partition_batches(n, readers,
                                                     rotation=rot)
        for i in range(n):
            assert protocol.owner_of(owners, i) == \
                jprotocol.owner_of(owners, i)

    def test_covers_contiguously(self):
        owners = protocol.partition_batches(10, ["a", "b", "c"])
        assert owners == [(0, 4, "a"), (4, 7, "b"), (7, 10, "c")]

    def test_rotation_spreads_concurrent_ranks(self):
        r0 = protocol.partition_batches(10, ["a", "b"], rotation=0)
        r1 = protocol.partition_batches(10, ["a", "b"], rotation=1)
        assert [(lo, hi) for lo, hi, _ in r0] == \
            [(lo, hi) for lo, hi, _ in r1]
        assert [a for _, _, a in r1] == ["b", "a"]

    def test_out_of_range_and_validation(self):
        with pytest.raises(IndexError):
            protocol.owner_of(protocol.partition_batches(4, ["a"]), 4)
        with pytest.raises(ValueError):
            protocol.partition_batches(4, [])
        with pytest.raises(ValueError):
            protocol.partition_batches(-1, ["a"])

    def test_addresses_parse(self, monkeypatch):
        assert protocol.ingest_addresses("h:1, g:2,") == ["h:1", "g:2"]
        assert protocol.ingest_addresses("") is None
        assert protocol.ingest_addresses() is None
        monkeypatch.setenv(protocol.ENV_VAR, "x:9")
        assert protocol.ingest_addresses() == ["x:9"] == \
            jprotocol.ingest_addresses()
        with pytest.raises(ValueError):
            protocol.ingest_addresses("no-port")

    def test_unix_addresses_are_refused_by_name(self, shard_tree):
        """The port's rpc.py has no unix: listeners (ROADMAP.md §C)."""
        with pytest.raises(ValueError, match="unix: socket addresses"):
            protocol.ingest_addresses("unix:/tmp/reader.sock")
        with pytest.raises(ValueError, match="unix: socket addresses"):
            client.RemoteBatchSource(["unix:/tmp/reader.sock"],
                                     data=_dataset("port", shard_tree),
                                     epoch=0, global_batch=BATCH)


class TestEpochOrder:
    @pytest.mark.parametrize("rank,size", [(0, 1), (0, 2), (1, 2)])
    def test_byte_identical_to_both_loaders(self, shard_tree, rank, size):
        ds, jds = _dataset("port", shard_tree), _dataset("jax", shard_tree)
        for epoch in (0, 2):
            local = local_stream(ds, epoch, rank, size)
            assert_streams_equal(local_stream(jds, epoch, rank, size),
                                 local)
            order = EpochOrder(ds.train_files, ds._file_sizes, SEED, epoch,
                               rank, size)
            jord = jorder.EpochOrder(ds.train_files, ds._file_sizes, SEED,
                                     epoch, rank, size)
            assert order.n_batches(BATCH) == len(local) \
                == ds.n_train_batches_for(epoch, BATCH, rank, size)
            assert order.offsets == jord.offsets
            remote = [order.assemble(i, BATCH)
                      for i in range(order.n_batches(BATCH))]
            assert_streams_equal(remote, local)

    def test_out_of_range_and_files_for_batches(self, shard_tree):
        ds = _dataset("port", shard_tree)
        order = EpochOrder(ds.train_files, ds._file_sizes, SEED, 0)
        jord = jorder.EpochOrder(ds.train_files, ds._file_sizes, SEED, 0)
        n = order.n_batches(BATCH)
        with pytest.raises(IndexError):
            order.assemble(n, BATCH)
        for lo, hi in ((0, n), (0, 2), (3, 3), (5, 11)):
            assert order.files_for_batches(lo, hi, BATCH) == \
                jord.files_for_batches(lo, hi, BATCH)
        assert order.files_for_batches(0, 2, BATCH) == [0]


# ---------------------------------------------------------------------------
# Streams over real sockets, across the packages
# ---------------------------------------------------------------------------


#: (client package, fleet package)
DIRECTIONS = [("port", "jax"), ("jax", "port"), ("port", "port")]


class TestRemoteStream:
    @pytest.mark.parametrize("n_readers,size", [(1, 1), (2, 2), (3, 1),
                                                (3, 2)])
    @pytest.mark.parametrize("client_pkg,fleet_pkg", DIRECTIONS)
    def test_streams_byte_identical(self, shard_tree, fleets, n_readers,
                                    size, client_pkg, fleet_pkg):
        """Every direction, fleet size and trainer rank yields EXACTLY
        the local loader's stream."""
        fleet = fleets(fleet_pkg, shard_tree, n_readers)
        ds = _dataset(client_pkg, shard_tree)
        cmod = PKG[client_pkg][2]
        for rank in range(size):
            with cmod.RemoteBatchSource(fleet.ingest_addrs, data=ds,
                                        epoch=1, global_batch=BATCH,
                                        rank=rank, size=size) as src:
                remote = drain(src)
            assert_streams_equal(remote, local_stream(
                _dataset("port", shard_tree), 1, rank, size))
        if n_readers > 1:
            assert all(r.stats()["served"] > 0 for r in fleet.readers)

    @pytest.mark.parametrize("client_pkg,fleet_pkg", DIRECTIONS)
    def test_through_a_coordinator(self, shard_tree, fleets, client_pkg,
                                   fleet_pkg):
        fleet = fleets(fleet_pkg, shard_tree, 2, coordinator=True)
        cmod = PKG[client_pkg][2]
        with cmod.RemoteBatchSource(fleet.ingest_addrs,
                                    data=_dataset(client_pkg, shard_tree),
                                    epoch=2, global_batch=BATCH) as src:
            remote = drain(src)
        assert_streams_equal(remote, local_stream(
            _dataset("port", shard_tree), 2))
        assert fleet.coordinator.stats()["plans"] >= 1

    def test_port_client_against_jax_threaded_loop(self, shard_tree,
                                                   fleets, monkeypatch):
        """JAX's threaded loop grants no multiplexing: the port's pipes
        fall back to a socket each, and the stream is unchanged."""
        monkeypatch.setenv("THEANOMPI_TPU_RPC_LOOP", "threaded")
        fleet = fleets("jax", shard_tree, 2)
        with client.RemoteBatchSource(fleet.ingest_addrs,
                                      data=_dataset("port", shard_tree),
                                      epoch=0, global_batch=BATCH) as src:
            remote = drain(src)
            assert not any(t.mux for t in src._transports.values())
        assert_streams_equal(remote, local_stream(
            _dataset("port", shard_tree), 0))

    def test_mux_pipes_and_spans(self, shard_tree, fleets, tmp_path,
                                 monkeypatch):
        """Mux on (the default): one granted transport per reader; under
        a traced monitor session every pull opens ``ingest_request`` and
        ``ingest_pull`` spans and feeds ``ingest/pull_ms``."""
        from theanompi_tpu_torch import monitor

        monkeypatch.setenv("THEANOMPI_TPU_TRACE", "1")
        fleet = fleets("port", shard_tree, 2)
        with monitor.session(run_dir=str(tmp_path)):
            with client.RemoteBatchSource(
                    fleet.ingest_addrs, data=_dataset("port", shard_tree),
                    epoch=1, global_batch=BATCH) as src:
                remote = drain(src)
                assert src._transports and all(
                    t.mux for t in src._transports.values())
            reg = monitor.registry()
            n = len(remote)
            assert sum(reg.get("ingest/pull_ms", reader=a).count
                       for a in fleet.addrs) == n
            assert sum(reg.get("span_ms", span="ingest_request", reader=a,
                               index=str(i)) is not None
                       for a in fleet.addrs for i in range(n)) == n
            assert reg.value("ingest/plan_refreshes_total") is None
        monitor.reset_for_tests()
        assert_streams_equal(remote, local_stream(
            _dataset("port", shard_tree), 1))

    def test_v1_pin_keeps_a_socket_per_pipe(self, shard_tree, fleets,
                                            monkeypatch):
        """A wire pinned to v1 never negotiates multiplexing: no shared
        transport is opened, and the stream is unchanged."""
        monkeypatch.setenv("THEANOMPI_TPU_WIRE_PROTOCOL", "v1")
        fleet = fleets("port", shard_tree, 2)
        with client.RemoteBatchSource(fleet.ingest_addrs,
                                      data=_dataset("port", shard_tree),
                                      epoch=0, global_batch=BATCH) as src:
            remote = drain(src)
            assert not src._mux and not src._transports
        assert_streams_equal(remote, local_stream(
            _dataset("port", shard_tree), 0))

    def test_shm_lane_in_process(self, shard_tree, monkeypatch):
        """The shared-memory lane (granted between two ends on one host)
        carries the batches out of band, byte-identically; every segment
        is released before the test returns."""
        monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "1")
        monkeypatch.setenv("THEANOMPI_TPU_SHM_MIN_BYTES", "1024")
        before = set(shm.segment_names())
        fleet = Fleet("port", shard_tree, 1)
        try:
            with client.RemoteBatchSource(
                    fleet.ingest_addrs, data=_dataset("port", shard_tree),
                    epoch=0, global_batch=BATCH) as src:
                remote = drain(src)
                assert any(t._wire is not None and t._wire.shm is not None
                           for t in src._transports.values())
            assert_streams_equal(remote, local_stream(
                _dataset("port", shard_tree), 0))
        finally:
            fleet.stop()
        shm.release_all()
        assert not set(shm.segment_names()) - before

    def test_meta_mismatch_refused(self, shard_tree, fleets):
        fleet = fleets("jax", shard_tree, 2)
        with pytest.raises(ValueError, match="different dataset"):
            client.RemoteBatchSource(
                fleet.ingest_addrs,
                data=_dataset("port", shard_tree, seed=SEED + 1),
                epoch=0, global_batch=BATCH)

    def test_host_augmented_and_synthetic_refused(self, shard_tree, fleets):
        fleet = fleets("port", shard_tree, 1)
        with pytest.raises(ValueError, match="augment"):
            client.RemoteBatchSource(
                fleet.ingest_addrs,
                data=_dataset("port", shard_tree, augment_on_device=False),
                epoch=0, global_batch=BATCH)
        synth = ImageNet_data(crop=8, seed=SEED)
        with pytest.raises(RuntimeError, match="synthetic"):
            synth.ingest_signature()
        with pytest.raises(RuntimeError, match="synthetic"):
            client.RemoteBatchSource(fleet.ingest_addrs, data=synth,
                                     epoch=0, global_batch=BATCH)

    def test_signature_matches_jax(self, shard_tree):
        assert _dataset("port", shard_tree).ingest_signature() == \
            _dataset("jax", shard_tree).ingest_signature()


class TestBackpressure:
    def test_overload_is_typed_and_bounded(self, shard_tree, fleets):
        fleet = fleets("port", shard_tree, 1, max_inflight=1)
        r = fleet.readers[0]
        assert r._admission.acquire(blocking=False)
        # a JAX client reads the port reader's typed refusal
        c = jservice.ServiceClient(fleet.addrs[0])
        try:
            with pytest.raises(jservice.ServiceError, match="Overloaded"):
                c.call(protocol.OP_BATCH, 0, 0, 1, BATCH, 0)
            r._admission.release()
            x, y = c.call(protocol.OP_BATCH, 0, 0, 1, BATCH, 0)
            assert x.shape == (BATCH, 8, 8, 3)
        finally:
            c.close()

    def test_client_backs_off_and_retries(self, shard_tree, fleets):
        fleet = fleets("jax", shard_tree, 1, max_inflight=1)
        r = fleet.readers[0]
        assert r._admission.acquire(blocking=False)
        src = client.RemoteBatchSource(fleet.ingest_addrs,
                                       data=_dataset("port", shard_tree),
                                       epoch=0, global_batch=BATCH,
                                       depth=2)
        try:
            time.sleep(0.3)  # the fetch thread meets Overloaded now
            assert r.stats()["served"] == 0
            r._admission.release()
            assert_streams_equal(drain(src), local_stream(
                _dataset("port", shard_tree), 0))
        finally:
            src.close()

    def test_slow_trainer_bounds_reader_memory(self, shard_tree, fleets):
        fleet = fleets("port", shard_tree, 2)
        depth = 3
        src = client.RemoteBatchSource(fleet.ingest_addrs,
                                       data=_dataset("port", shard_tree),
                                       epoch=0, global_batch=BATCH,
                                       depth=depth)
        try:
            drain(src, n=1)  # consume ONE batch, then stall
            time.sleep(0.5)
            served = sum(r.stats()["served"] for r in fleet.readers)
            assert served <= 1 + depth, served
            time.sleep(0.3)
            assert sum(r.stats()["served"] for r in fleet.readers) \
                == served
        finally:
            src.close()

    def test_closed_source_raises_instead_of_waiting(self, shard_tree,
                                                     fleets):
        fleet = fleets("port", shard_tree, 1)
        src = client.RemoteBatchSource(fleet.ingest_addrs,
                                       data=_dataset("port", shard_tree),
                                       epoch=0, global_batch=BATCH)
        src.close()
        with pytest.raises(RuntimeError, match="closed"):
            next(src)


class TestReaderDeath:
    @pytest.mark.parametrize("with_coordinator", [False, True])
    @pytest.mark.parametrize("fleet_pkg", ["port", "jax"])
    def test_failover_byte_identical(self, shard_tree, fleets,
                                     with_coordinator, fleet_pkg):
        """A reader dies mid-epoch: the port's client re-partitions over
        the survivor (static fleet) or has the coordinator verify and
        reassign, and the stream stays byte-identical."""
        fleet = fleets(fleet_pkg, shard_tree, 2,
                       coordinator=with_coordinator)
        local = local_stream(_dataset("port", shard_tree), 1)
        src = client.RemoteBatchSource(fleet.ingest_addrs,
                                       data=_dataset("port", shard_tree),
                                       epoch=1, global_batch=BATCH,
                                       depth=2)
        try:
            remote = drain(src, n=3)
            dead = fleet.addrs[1]
            fleet.kill(dead)
            fleet.forget(1)
            remote += drain(src)
        finally:
            src.close()
        assert_streams_equal(remote, local)
        if with_coordinator:
            stats = fleet.coordinator.stats()
            assert stats["reassignments"] >= 1
            assert stats["readers"][dead] is False

    def test_report_dead_verifies_first(self, shard_tree, fleets):
        fleet = fleets("port", shard_tree, 2, coordinator=True)
        c = jservice.ServiceClient(fleet.coordinator_addr)
        try:
            out = c.call(protocol.OP_REPORT_DEAD, fleet.addrs[0])
            assert out["dead"] is False
            assert fleet.coordinator.stats()["readers"][fleet.addrs[0]]
        finally:
            c.close()

    def test_plan_pinned_and_equal_to_jax(self, shard_tree, fleets):
        fleet = fleets("port", shard_tree, 2, coordinator=True)
        c = service.ServiceClient(fleet.coordinator_addr)
        try:
            p1 = c.call(protocol.OP_PLAN, 0, 1, 2, BATCH, 10)
            assert p1 == c.call(protocol.OP_PLAN, 0, 1, 2, BATCH, 10)
            assert [tuple(o) for o in p1["owners"]] == \
                jprotocol.partition_batches(10, fleet.addrs, rotation=1)
            assert c.call(protocol.OP_INFO)["kind"] == "coordinator"
        finally:
            c.close()

    def test_concurrent_assigns_never_join_unstarted_thread(self,
                                                            shard_tree):
        r = reader.IngestReader(shard_tree, seed=SEED, reader_id=0)
        errs: list = []

        def assign(i):
            try:
                for _ in range(5):
                    r._assign(0, i % 2, 2, BATCH, 0, 3)
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=assign, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        r.shutdown()
        assert not errs, errs
        assert r.stats()["assigned"] == {"0/0/2": [0, 3], "0/1/2": [0, 3]}


# ---------------------------------------------------------------------------
# The launcher and the model seam
# ---------------------------------------------------------------------------


class TestLauncherFlag:
    def test_serve_refuses_ingest(self):
        with pytest.raises(SystemExit, match="TRAINING"):
            launcher.main(["SERVE", "--ingest", "h:1", "-m", "x", "-c", "y"])

    @pytest.mark.parametrize("spec", ["not-an-address", "unix:/tmp/r.sock",
                                      ","])
    def test_bad_spec_fails_fast(self, spec):
        with pytest.raises(SystemExit, match="--ingest"):
            launcher.main(["BSP", "--ingest", spec, "-m", "x", "-c", "y"])

    def test_multihost_refuses_ingest(self):
        with pytest.raises(SystemExit, match="single-host"):
            launcher.main(["BSP", "--ingest", "h:1", "--multihost",
                           "--coordinator", "h:2", "--nhosts", "2",
                           "--host-id", "0", "-m", "x", "-c", "y"])

    def test_bsp_over_two_processes_refuses_ingest(self):
        with pytest.raises(SystemExit, match="one training process"):
            launcher.main(["BSP", "-D", "2", "--platform", "cpu",
                           "--ingest", "h:1", "-m",
                           "theanompi_tpu_torch.models.cifar10", "-c",
                           "Cifar10_model"])

    def test_flag_parses_and_reaches_the_workers(self):
        args = launcher.parse_args(["ASGD", "--ingest", "h:1,g:2", "-m", "x",
                                    "-c", "y"])
        assert args.ingest == "h:1,g:2"
        assert "--ingest" not in launcher.UNPORTED_OPTIONS


class TestEndToEnd:
    def test_begin_epoch_switches_on_env(self, shard_tree, tmp_path,
                                         fleets, monkeypatch):
        """With THEANOMPI_TPU_INGEST set, begin_epoch stages the SAME
        batches through the DevicePrefetcher as the local loader, and
        cleanup_iter closes the remote source."""
        from theanompi_tpu_torch.models.base import ModelConfig
        from theanompi_tpu_torch.models.resnet50 import ResNet50

        rng = np.random.default_rng(1)
        d = str(tmp_path / "e2e")
        prepare_imagenet_shards(
            rng.integers(0, 255, size=(256, 40, 40, 3), dtype=np.uint8),
            rng.integers(0, 10, size=256).astype(np.int64), d,
            shard_size=64)
        ds = ImageNet_data(data_dir=d, crop=32, seed=0, n_classes=10)
        model = ResNet50(config=ModelConfig(batch_size=16, n_epochs=1,
                                            print_freq=0),
                         device="cpu", stage_sizes=(1, 1, 1, 1), width=8,
                         n_classes=10, crop=32, data=ds)
        n_local = model.begin_epoch(0)
        local = [tuple(t.clone() for t in next(model._train_iter))
                 for _ in range(n_local)]
        assert model._ingest_source is None
        model.cleanup_iter()

        fleet = fleets("port", d, 2, seed=0, coordinator=True)
        monkeypatch.setenv(protocol.ENV_VAR, fleet.coordinator_addr)
        n_remote = model.begin_epoch(0)
        assert n_remote == n_local == 16
        assert model._train_prefetcher._source == "remote"
        remote = [next(model._train_iter) for _ in range(n_remote)]
        assert model._ingest_source is not None
        model.cleanup_iter()
        assert model._ingest_source is None
        for (rx, ry), (lx, ly) in zip(remote, local):
            assert torch.equal(rx, lx) and torch.equal(ry, ly)
        model.cleanup()

    def test_begin_epoch_refuses_ingest_on_a_process_group(
            self, shard_tree, monkeypatch):
        """A rank of a process group reads its own block of every global
        batch; with THEANOMPI_TPU_INGEST set, begin_epoch refuses
        instead of training from the local loader in silence."""
        from theanompi_tpu_torch.models.base import ModelConfig
        from theanompi_tpu_torch.models.resnet50 import ResNet50

        model = ResNet50(config=ModelConfig(batch_size=16, n_epochs=1,
                                            print_freq=0),
                         device="cpu", stage_sizes=(1, 1, 1, 1), width=8,
                         n_classes=10, crop=8,
                         data=_dataset("port", shard_tree))
        model.n_workers = 2  # what a two-rank group reports
        monkeypatch.setenv(protocol.ENV_VAR, "127.0.0.1:1")
        with pytest.raises(ValueError, match="one training process"):
            model.begin_epoch(0)
        assert model._ingest_source is None
        model.cleanup()
