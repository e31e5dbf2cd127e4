"""The port's overlap pipe, worker supervisor and straggler detector.

Case for case the JAX package's ``tests/test_async_overlap.py::
TestExchangePipe`` and ``tests/test_resilience.py::TestWorkerSupervisor``
(and ``tests/test_monitor.py``'s straggler cases), against the port's
copies: ``parallel/pipe.py``, ``resilience/supervisor.py``,
``monitor/health.py`` and ``monitor.observe_step(..., worker=)``.  One
difference from JAX, pinned here: the port's ``_ExchangePipe.close()``
drops a request its thread has not started and joins the thread, so no
pipe outlives its worker.  No JAX is imported.
"""

import threading
import time

import pytest

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.monitor.health import StragglerDetector
from theanompi_tpu_torch.monitor.registry import MetricsRegistry
from theanompi_tpu_torch.parallel.pipe import _ExchangePipe
from theanompi_tpu_torch.resilience.faults import FaultInjected
from theanompi_tpu_torch.resilience.supervisor import WorkerSupervisor


class TestExchangePipe:
    def test_overlap_hides_rpc_behind_compute(self, tmp_path):
        """With compute time ~ exchange time the worker's collect wait is
        a small part of the exchange span, and the rounds pipeline."""
        rpc_s = compute_s = 0.15
        rounds = 3
        with monitor.session(str(tmp_path)):
            pipe = _ExchangePipe(
                lambda p: (time.sleep(rpc_s), p)[1], "test/exchange", 0)
            try:
                t0 = time.monotonic()
                for i in range(rounds):
                    pipe.submit({"x": i})
                    time.sleep(compute_s)  # the overlapped compute
                    with monitor.span("test/exchange_collect", worker="0"):
                        payload, result = pipe.collect()
                    assert result == {"x": i}
                wall = time.monotonic() - t0
            finally:
                pipe.close()
            reg = monitor.registry()
            rpc = reg.get("span_ms", span="test/exchange_rpc", worker="0")
            col = reg.get("span_ms", span="test/exchange_collect",
                          worker="0")
            assert rpc.count == rounds
            assert col.sum < 0.5 * rpc.sum, (col.sum, rpc.sum)
            assert wall < 0.75 * rounds * (rpc_s + compute_s), wall

    def test_bounded_staleness_barrier(self):
        pipe = _ExchangePipe(lambda p: p, "test/exchange", 0)
        try:
            pipe.submit(1)
            with pytest.raises(RuntimeError, match="outstanding"):
                pipe.submit(2)
            payload, result = pipe.collect()
            assert (payload, result) == (1, 1)
            pipe.submit(3)  # collect released the barrier
            assert pipe.collect() == (3, 3)
        finally:
            pipe.close()

    def test_exchange_error_carried_to_worker(self):
        def boom(_):
            raise FaultInjected("injected fault at exchange")

        pipe = _ExchangePipe(boom, "test/exchange", 1)
        try:
            pipe.submit({"g": 1})
            with pytest.raises(FaultInjected, match="injected"):
                pipe.collect()
            with pytest.raises(FaultInjected, match="injected"):
                pipe.submit({"g": 2})
        finally:
            pipe.close()

    def test_close_is_idempotent_with_uncollected_result(self):
        pipe = _ExchangePipe(lambda p: p, "test/exchange", 0)
        pipe.submit(1)  # never collected
        time.sleep(0.05)
        pipe.close()
        pipe.close()
        assert not pipe._thread.is_alive()

    def test_close_with_queued_request_stops_thread(self):
        """close() racing a still-queued request stops and joins the
        thread: the running exchange finishes, the queued one is
        dropped, the finished result stays collectable."""
        entered, release = threading.Event(), threading.Event()
        ran = []

        def fn(p):
            ran.append(p)
            entered.set()
            release.wait(5)
            return p

        pipe = _ExchangePipe(fn, "test/exchange", 0)
        pipe.submit(1)
        assert entered.wait(5)
        pipe._req.put_nowait(2)  # a request sitting in the queue
        timer = threading.Timer(0.1, release.set)
        timer.start()
        try:
            pipe.close()
        finally:
            timer.join(5)
        assert not pipe._thread.is_alive()
        assert ran == [1]
        assert pipe.collect() == (1, 1)


class TestWorkerSupervisor:
    def test_restart_within_budget_completes(self):
        died = {"n": 0}
        restarted = []

        def worker(abort):
            if died["n"] < 2:
                died["n"] += 1
                raise FaultInjected("boom")

        sup = WorkerSupervisor(n_workers=1, max_restarts=2,
                               restart_from=restarted.append)
        sup.run([worker])
        assert restarted == [0, 0]
        assert sup.restart_counts() == {0: 2}
        assert sup.lost_workers() == []

    def test_budget_exhausted_quorum_lost_aborts(self):
        def worker(abort):
            raise FaultInjected("always dies")

        sup = WorkerSupervisor(n_workers=1, max_restarts=1,
                               restart_from=lambda r: None)
        with pytest.raises(FaultInjected):
            sup.run([worker])
        assert sup.lost_workers() == [0]

    def test_lost_worker_with_quorum_continues(self):
        lost_hook, finished = [], []

        def dying(abort):
            raise FaultInjected("dead on arrival")

        def healthy(abort):
            finished.append(True)

        sup = WorkerSupervisor(n_workers=2, max_restarts=1, min_workers=1,
                               restart_from=None, on_lost=lost_hook.append)
        sup.run([dying, healthy])  # must NOT raise
        assert lost_hook == [0]
        assert finished == [True]
        assert sup.lost_workers() == [0]

    def test_quorum_loss_aborts_peers(self):
        def dying(abort):
            raise FaultInjected("dead")

        def patient(abort):
            for _ in range(500):
                if abort.is_set():
                    return
                time.sleep(0.01)

        sup = WorkerSupervisor(n_workers=2, max_restarts=0, min_workers=2,
                               restart_from=None)
        t0 = time.monotonic()
        with pytest.raises(FaultInjected):
            sup.run([dying, patient])
        assert time.monotonic() - t0 < 4.0  # peers aborted, not run out

    def test_base_exception_is_fatal_despite_budget(self):
        def worker(abort):
            raise KeyboardInterrupt()

        sup = WorkerSupervisor(n_workers=1, max_restarts=5,
                               restart_from=lambda r: None)
        with pytest.raises(KeyboardInterrupt):
            sup.run([worker])
        assert sup.restart_counts() == {}

    def test_failing_restart_hook_aborts(self):
        def worker(abort):
            raise FaultInjected("boom")

        def bad_restart(rank):
            raise ConnectionError("center unreachable")

        sup = WorkerSupervisor(n_workers=1, max_restarts=3,
                               restart_from=bad_restart)
        with pytest.raises(ConnectionError):
            sup.run([worker])

    def test_extra_target_failure_aborts(self):
        def worker(abort):
            for _ in range(500):
                if abort.is_set():
                    return
                time.sleep(0.01)

        def orchestrator(abort):
            raise RuntimeError("validation exploded")

        sup = WorkerSupervisor(n_workers=1, max_restarts=2,
                               restart_from=lambda r: None)
        with pytest.raises(RuntimeError, match="validation exploded"):
            sup.run([worker], extra=[orchestrator])

    def test_restart_resumes_worker_closure_state(self):
        """A supervised re-invocation resumes at the epoch the worker
        died in, through state kept outside the target."""
        seen = []
        progress = {"epoch": 0}

        def worker(abort):
            for epoch in range(progress["epoch"], 3):
                progress["epoch"] = epoch
                seen.append(epoch)
                if epoch == 1 and seen.count(1) == 1:
                    raise FaultInjected("die mid-epoch 1")

        sup = WorkerSupervisor(n_workers=1, max_restarts=1,
                               restart_from=lambda r: None)
        sup.run([worker])
        assert seen == [0, 1, 1, 2]  # epoch 0 NOT re-run

    def test_note_straggler_edges(self, tmp_path):
        sup = WorkerSupervisor(n_workers=2, max_restarts=1,
                               restart_from=lambda r: None)
        with monitor.session(run_dir=str(tmp_path)):
            sup.note_straggler(1, True)
            sup.note_straggler(1, True)   # no double count
            assert sup.stragglers() == [1]
            sup.note_straggler(1, False)  # recovery clears
            assert sup.stragglers() == []
            sup.note_straggler(1, True)
            assert monitor.registry().get(
                "resilience/straggler_handoffs_total",
                worker=1).value == 2


class TestStraggler:
    def test_flags_slow_worker(self):
        r = MetricsRegistry()
        det = StragglerDetector(factor=2.0, window=16, min_samples=4,
                                registry=r)
        for _ in range(8):
            det.observe(0, 0.010)
            det.observe(1, 0.011)
        flagged = [det.observe(2, 0.100) for _ in range(8)]
        assert flagged[-1] is True
        assert det.stragglers() == [2]
        assert r.get("health/straggler_flags_total", worker=2).value == 1
        for _ in range(16):  # recovery un-flags
            det.observe(2, 0.010)
        assert det.stragglers() == []

    def test_needs_two_workers(self):
        det = StragglerDetector(min_samples=2)
        for _ in range(10):
            assert det.observe(0, 1.0) is False

    def test_persistent_two_worker_case(self):
        det = StragglerDetector(factor=2.0, window=8, min_samples=4)
        for _ in range(16):
            det.observe(0, 0.010)
            det.observe(1, 0.100)
        assert det.observe(1, 0.100) is True
        assert det.stragglers() == [1]

    def test_observe_step_feeds_histogram_and_straggler(self, tmp_path):
        assert monitor.observe_step(1.0, worker=0) is False  # monitor off
        with monitor.session(run_dir=str(tmp_path)):
            for _ in range(8):
                monitor.observe_step(0.010, phase="train", worker=0)
                monitor.observe_step(0.010, phase="train", worker=1)
            flagged = False
            for _ in range(8):
                flagged = monitor.observe_step(0.100, phase="train",
                                               worker=2)
            assert flagged is True
            reg = monitor.registry()
            assert reg.get("step_ms", phase="train", worker="0").count == 8
            assert reg.get("step_ms", phase="train", worker="2").count == 8
            # a step without a worker (BSP) keeps its old series
            assert monitor.observe_step(0.5, phase="train") is False
            assert reg.get("step_ms", phase="train").count == 1
