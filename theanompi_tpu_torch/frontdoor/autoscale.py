"""Signal-driven autoscaling of the disaggregated serving fleet.

Counterpart of ``theanompi_tpu/frontdoor/autoscale.py``.  Three layers:

* :class:`HysteresisController`: the decision unit, a load scalar in and
  ``+1 / -1 / 0`` out.  Hysteresis (distinct up and down thresholds), a
  hold (``hold`` consecutive breaches, so one hot poll never scales) and
  a cooldown after each event, all against an injected clock.
* :class:`RoleGroup`: one role's supervised child processes on free
  local ports; a watcher thread relaunches a dead replica on its port
  within a restart budget, and an intentional removal (scale-down)
  leaves supervision first, so a drained replica stays dead.
* :class:`Autoscaler`: the loop.  It polls each role's replicas for the
  signals they already report (queue depth, page-pool occupancy,
  inter-token p99, overload counts), folds them into one load scalar per
  role, asks the controller, and acts on the router's backend set.

Scale events drop nothing: scale-up spawns the replica, waits until it
answers, and only then adds it to the router (new traffic lands on a
warm replica); scale-down removes the backend from the router first
(drain: no new streams route to it), tells a decode replica to hand its
live streams back as pages, waits for the router to count zero streams
on it, and only then stops the process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.analysis.lockgraph import make_lock


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class HysteresisController:
    """Scale decision: hysteresis, breach hold and cooldown.

    ``decide(load, size)`` returns ``+1`` (grow), ``-1`` (shrink) or
    ``0``.  A decision needs ``hold`` CONSECUTIVE polls breaching the
    same threshold, at least ``cooldown_s`` since the last event, and
    room inside ``[min_size, max_size]``.  A load between the two
    thresholds resets both breach counters: the dead band keeps a noisy
    signal from sawtoothing the fleet."""

    def __init__(self, up: float = 0.8, down: float = 0.2,
                 hold: int = 2, cooldown_s: float = 10.0,
                 min_size: int = 1, max_size: int = 4,
                 clock=time.monotonic):
        if not down < up:
            raise ValueError(f"need down < up, got {down} >= {up}")
        if not 1 <= min_size <= max_size:
            raise ValueError(f"need 1 <= min_size <= max_size, got "
                             f"[{min_size}, {max_size}]")
        self.up = float(up)
        self.down = float(down)
        self.hold = int(hold)
        self.cooldown_s = float(cooldown_s)
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self._clock = clock
        self._above = 0
        self._below = 0
        self._last_event: float | None = None

    def decide(self, load: float, size: int) -> int:
        load = float(load)
        if load >= self.up:
            self._above += 1
            self._below = 0
        elif load <= self.down:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if (self._last_event is not None
                and self._clock() - self._last_event < self.cooldown_s):
            return 0
        if self._above >= self.hold and size < self.max_size:
            self._above = 0
            self._last_event = self._clock()
            return 1
        if self._below >= self.hold and size > self.min_size:
            self._below = 0
            self._last_event = self._clock()
            return -1
        return 0


class RoleGroup:
    """One role's supervised process group (module docstring).

    ``spawn_argv(port)`` builds a child's argv; every child inherits the
    environment (the shared ``THEANOMPI_TPU_SERVICE_KEY``, the monitor
    and collector settings).  ``probe(addr)`` says whether the replica at
    ``addr`` serves; by default one ``ping`` RPC."""

    def __init__(self, role: str, spawn_argv, initial: int = 1,
                 host: str = "127.0.0.1", max_restarts: int = 1,
                 ready_timeout_s: float = 180.0, probe=None):
        from theanompi_tpu_torch.parallel.service import _authkey

        _authkey(generate=True)  # ensure and export the shared key
        self.role = str(role)
        self.host = host
        self.spawn_argv = spawn_argv
        self.max_restarts = int(max_restarts)
        self.ready_timeout_s = float(ready_timeout_s)
        self._probe_fn = probe or self._rpc_probe
        self._lock = make_lock("frontdoor.RoleGroup._lock")
        self._stopping = threading.Event()
        self._procs: dict[int, subprocess.Popen] = {}  # guarded_by: self._lock
        self._restarts: dict[int, int] = {}            # guarded_by: self._lock
        try:
            self.grow_many(int(initial))
        except BaseException:
            self.stop()
            raise
        self._watcher = threading.Thread(
            target=self._watch, daemon=True,
            name=f"frontdoor-{self.role}-watcher")
        self._watcher.start()

    # -- addresses ------------------------------------------------------

    def addresses(self) -> list[str]:
        with self._lock:
            ports = sorted(self._procs)
        return [f"{self.host}:{p}" for p in ports]

    def __len__(self) -> int:
        with self._lock:
            return len(self._procs)

    # -- probing --------------------------------------------------------

    def _rpc_probe(self, addr: str) -> bool:
        from theanompi_tpu_torch.parallel.service import ServiceClient
        from theanompi_tpu_torch.resilience.retry import RetryPolicy

        c = None
        try:
            c = ServiceClient(addr, retry=RetryPolicy(
                max_attempts=1, name="frontdoor-probe"))
            return c.call("ping") == "pong"
        except Exception:
            return False
        finally:
            if c is not None:
                c.close()

    # -- lifecycle ------------------------------------------------------

    def grow(self) -> str:
        """Spawn one replica on a free port, wait until it serves, and
        return its address: the caller adds it to the router after this
        returns, so new traffic only lands on a warm replica."""
        return self.grow_many(1)[0]

    def grow_many(self, n: int) -> list[str]:
        """Spawn ``n`` replicas at once, then wait until each serves
        (port-only: JAX starts a group's replicas one after another); a
        replica joins supervision once it answers, and a failure stops
        every replica of this call that has not."""
        started = []
        for _ in range(n):
            port = _free_port()
            started.append((port, subprocess.Popen(
                self.spawn_argv(port), env=dict(os.environ))))
        addrs = []
        try:
            for port, proc in started:
                addrs.append(self._await_ready(port, proc))
        except BaseException:
            for port, proc in started[len(addrs):]:
                self._stop_proc(proc)
            raise
        return addrs

    def _await_ready(self, port: int, proc: subprocess.Popen) -> str:
        addr = f"{self.host}:{port}"
        deadline = time.monotonic() + self.ready_timeout_s
        while not self._probe_fn(addr):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"frontdoor {self.role} replica died during "
                    f"startup (rc={proc.returncode})")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"frontdoor {self.role} replica at {addr} never "
                    f"came up within {self.ready_timeout_s}s")
            time.sleep(0.3)
        with self._lock:
            self._procs[port] = proc
        return addr

    def release(self, addr: str) -> None:
        """Stop one DRAINED replica on purpose (scale-down): it leaves
        supervision first, so the watcher does not bring back what the
        autoscaler just removed."""
        port = int(str(addr).rpartition(":")[2])
        with self._lock:
            proc = self._procs.pop(port, None)
            self._restarts.pop(port, None)
        if proc is None:
            return
        self._stop_proc(proc)

    def kill(self, addr: str) -> None:
        """Kill one replica WITHOUT removing it from supervision (fault
        drills: the watcher relaunches it on its port within the restart
        budget)."""
        port = int(str(addr).rpartition(":")[2])
        with self._lock:
            proc = self._procs.get(port)
        if proc is not None:
            proc.kill()

    def _watch(self) -> None:
        while not self._stopping.wait(0.5):
            with self._lock:
                procs = dict(self._procs)
            for port, proc in procs.items():
                if proc.poll() is None or self._stopping.is_set():
                    continue
                with self._lock:
                    if self._procs.get(port) is not proc:
                        continue  # released or replaced concurrently
                    n = self._restarts.get(port, 0)
                    if n >= self.max_restarts:
                        continue  # budget spent: leave it dead
                    self._restarts[port] = n + 1
                    self._procs[port] = subprocess.Popen(
                        self.spawn_argv(port), env=dict(os.environ))
                print(f"[frontdoor] {self.role} replica on port {port} "
                      f"died (rc={proc.returncode}); relaunched "
                      f"({n + 1}/{self.max_restarts})",
                      file=sys.stderr, flush=True)
                monitor.inc("frontdoor/replica_restarts_total",
                            role=self.role)

    def restart_counts(self) -> dict:
        with self._lock:
            return dict(self._restarts)

    @staticmethod
    def _stop_proc(proc: subprocess.Popen) -> None:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)

    def stop(self) -> None:
        self._stopping.set()
        watcher = getattr(self, "_watcher", None)
        if watcher is not None and watcher.is_alive():
            watcher.join(timeout=5)
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            self._stop_proc(p)


class Autoscaler:
    """The loop: poll the signals, fold them to a load scalar, act.

    A role's load is the MAX over its replicas of:

    * queue depth: in-flight prefills / ``max_pending`` (prefill), or
      pending generate requests / 8 (decode);
    * page-pool occupancy: ``1 - free_pages / (free_pages + 8 *
      active)`` (decode);
    * overloads: any typed ``Overloaded`` shed since the last poll
      saturates the signal at 1.0;
    * inter-token p99 over ``slo_p99_ms`` (decode, when an SLO is set).

    The max, not the mean: one saturated replica is a reason to grow even
    when its siblings idle (the router round-robins, so a lasting skew
    means the fleet is short, not the balance)."""

    def __init__(self, router, groups: dict, controllers: dict,
                 poll_s: float = 1.0, slo_p99_ms: float | None = None,
                 drain_timeout_s: float = 30.0):
        self.router = router
        self.groups = dict(groups)
        self.controllers = dict(controllers)
        self.poll_s = float(poll_s)
        self.slo_p99_ms = slo_p99_ms
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = make_lock("frontdoor.Autoscaler._lock")
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self._clients: dict = {}        # guarded_by: self._lock
        self._last_overloaded: dict = {}  # guarded_by: self._lock
        #: executed scale events [(role, direction, addr)]
        self.events: list = []          # guarded_by: self._lock
        for role, group in self.groups.items():
            monitor.set_gauge("frontdoor/fleet_size", len(group),
                              role=role)

    # -- signal polling -------------------------------------------------

    def _stats(self, addr: str) -> dict | None:
        from theanompi_tpu_torch.parallel.service import ServiceClient
        from theanompi_tpu_torch.resilience.retry import RetryPolicy

        with self._lock:
            client = self._clients.get(addr)
        try:
            if client is None:
                client = ServiceClient(addr, retry=RetryPolicy(
                    max_attempts=1, name="frontdoor-scale-stats"))
                with self._lock:
                    self._clients[addr] = client
            return client.call("stats")
        except Exception:
            with self._lock:
                self._clients.pop(addr, None)
            if client is not None:
                try:
                    client.close()
                except Exception:
                    pass
            return None

    def _overload_delta(self, addr: str, count: int) -> int:
        with self._lock:
            prev = self._last_overloaded.get(addr, count)
            self._last_overloaded[addr] = count
        return max(0, count - prev)

    def _replica_load(self, addr: str, stats: dict) -> float:
        load = 0.0
        if stats.get("role") == "prefill":
            cap = max(1, int(stats.get("max_pending", 1)))
            load = max(load, float(stats.get("inflight", 0)) / cap)
            shed = int(stats.get("overloaded", 0))
        else:
            # a decode-mode server: fold its replicas' signals
            shed = int(stats.get("overloaded", 0))
            for rep in stats.get("replicas", []):
                pend = float(rep.get("pending", 0))
                load = max(load, pend / 8.0)
                free = rep.get("free_pages")
                active = float(rep.get("active", 0))
                if free is not None:
                    total = free + active * 8.0  # pages_per_seq bound
                    if total > 0:
                        load = max(load, 1.0 - free / total)
                p99 = (rep.get("intertoken_ms") or {}).get("p99")
                if self.slo_p99_ms and p99:
                    load = max(load, float(p99) / float(self.slo_p99_ms))
        if self._overload_delta(addr, shed) > 0:
            load = max(load, 1.0)
        return load

    def role_load(self, role: str) -> float:
        load = 0.0
        for addr in self.groups[role].addresses():
            stats = self._stats(addr)
            if stats is None:
                continue  # a dead or booting replica: supervision's job
            load = max(load, self._replica_load(addr, stats))
        monitor.set_gauge("frontdoor/role_load", load, role=role)
        return load

    # -- acting ---------------------------------------------------------

    def _scale_up(self, role: str) -> str:
        group = self.groups[role]
        addr = group.grow()
        self.router.add_backend(role, addr)
        with self._lock:
            self.events.append((role, "up", addr))
        monitor.inc("frontdoor/scale_events_total", role=role,
                    direction="up")
        monitor.set_gauge("frontdoor/fleet_size", len(group), role=role)
        print(f"[frontdoor] scale-up {role} -> {len(group)} "
              f"(added {addr})", flush=True)
        return addr

    def _scale_down(self, role: str) -> str | None:
        group = self.groups[role]
        addrs = group.addresses()
        if len(addrs) <= 1:
            return None
        addr = addrs[-1]  # the highest port drains first
        # drain FIRST: the router stops routing new streams to it, the
        # in-flight ones finish, and only a backend at zero streams dies
        self.router.remove_backend(role, addr)
        if role == "decode":
            # tell the replica to hand its LIVE streams back as pages:
            # each parked generate returns a MigratedStream the router
            # adopts onto a survivor, so the drain clears at the next
            # step boundary instead of after a whole stream.  Best
            # effort: if the RPC fails, in-flight streams finish where
            # they are
            try:
                from theanompi_tpu_torch.resilience.retry import RetryPolicy
                from theanompi_tpu_torch.serving.server import (
                    InferenceClient,
                )

                c = InferenceClient(addr, retry=RetryPolicy(
                    max_attempts=1, name="frontdoor-drain"))
                try:
                    c.drain_migrate()
                finally:
                    c.close()
            except Exception as e:
                print(f"[frontdoor] scale-down {role} {addr}: drain "
                      f"RPC failed ({type(e).__name__}: {e}); waiting "
                      "for in-flight streams to finish instead",
                      flush=True)
        deadline = time.monotonic() + self.drain_timeout_s
        while self.router.backend_streams(role, addr) > 0:
            if time.monotonic() > deadline:
                print(f"[frontdoor] scale-down {role} {addr}: drain "
                      f"timed out after {self.drain_timeout_s}s; "
                      "stopping it anyway", flush=True)
                break
            time.sleep(0.05)
        group.release(addr)
        with self._lock:
            self.events.append((role, "down", addr))
            stale = self._clients.pop(addr, None)
            self._last_overloaded.pop(addr, None)
        if stale is not None:
            stale.close()
        monitor.inc("frontdoor/scale_events_total", role=role,
                    direction="down")
        monitor.set_gauge("frontdoor/fleet_size", len(group), role=role)
        print(f"[frontdoor] scale-down {role} -> {len(group)} "
              f"(drained {addr})", flush=True)
        return addr

    def tick(self) -> None:
        """One poll, decide, act pass over every role."""
        for role, controller in self.controllers.items():
            decision = controller.decide(self.role_load(role),
                                         len(self.groups[role]))
            if decision > 0:
                self._scale_up(role)
            elif decision < 0:
                self._scale_down(role)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="frontdoor-autoscaler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stopping.wait(self.poll_s):
            try:
                self.tick()
            except Exception as e:
                # one bad poll (a replica mid-restart) must not end the
                # loop; the next tick reads the world again
                print(f"[frontdoor] autoscaler tick failed: "
                      f"{type(e).__name__}: {e}", flush=True)

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
