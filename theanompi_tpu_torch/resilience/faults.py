"""Deterministic fault injection (copy of ``theanompi_tpu/resilience/
faults.py``).

A fault plan is a JSON list of specs, each naming a ``site``, coordinate
matchers and an ``action``; this package wires these sites:

* ``worker_step``: one iteration of an async-rule worker (coords
  ``rule`` = ``easgd``/``asgd``/``gosgd``, ``worker``, ``step``: the
  worker's iterations since it (re)started);
* ``exchange``: one call of an in-process parameter store
  (``parallel/server.py``; coord ``kind`` = ``easgd``/``asgd``/``gosgd``);
* ``serve_step``: one replica batch execution (coords ``replica``,
  ``step``);
* ``checkpoint``: one epoch's manifest, just written on the
  checkpointer's background worker (coord ``epoch``); the ``truncate``
  action then halves the step directory's largest file, so the epoch
  fails verification at the next resume (utils/checkpoint.py).  A
  ``raise`` there is logged by the worker, never fatal;
* ``ingest_batch``: one batch pull served by an ingest reader (coords
  ``reader``, ``epoch``, ``index``; ``ingest/reader.py``);
* ``ingest_pull``: one pull request a trainer's ``RemoteBatchSource``
  sends (coords ``index``, ``rank``; ``ingest/client.py``); a ``raise``
  there fails the epoch's stream in the trainer;
* ``router_route``: one request the front-door router handles (coord
  ``op``; ``frontdoor/router.py``): ``raise`` rejects it with a typed
  err the client sees, ``delay`` adds router latency.  The prefill
  server's export leg fires ``page_migrate`` (coord ``side`` =
  ``export``), as the decode server's adopt and drain legs do.

    [{"site": "worker_step", "rule": "easgd", "worker": 1, "step": 3}]
    [{"site": "exchange", "kind": "asgd", "action": "delay",
      "delay_s": 0.2, "times": -1}]
    [{"site": "serve_step", "replica": 0, "step": 3, "action": "raise"}]
    [{"site": "checkpoint", "epoch": 1, "action": "truncate"}]

``action``: ``raise`` (default) raises :class:`FaultInjected`; ``delay``
sleeps ``delay_s`` (default 0.1) and proceeds; any other string is
returned to the call site.  ``nth`` (1-based) fires on the nth matching
event, ``times`` for that many consecutive events (-1 = forever).  Any
other key is a coordinate compared as a string.

Activation: ``THEANOMPI_TPU_FAULTS`` (inline JSON or a path) is read
once at import; tests use :func:`install` / :func:`clear`.  With no plan
installed :func:`fire` is one ``is None`` check.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any

from theanompi_tpu_torch import monitor

ENV_VAR = "THEANOMPI_TPU_FAULTS"

_CONTROL_KEYS = frozenset({"site", "action", "nth", "times", "delay_s"})


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action fault; handled like a real crash."""


class _Spec:
    def __init__(self, raw: dict):
        if not isinstance(raw, dict) or "site" not in raw:
            raise ValueError(f"fault spec needs a 'site' key: {raw!r}")
        self.site = str(raw["site"])
        self.action = str(raw.get("action", "raise"))
        self.nth = int(raw.get("nth", 1))
        self.times = int(raw.get("times", 1))
        self.delay_s = float(raw.get("delay_s", 0.1))
        self.coords = {k: str(v) for k, v in raw.items()
                       if k not in _CONTROL_KEYS}
        if self.nth < 1:
            raise ValueError(f"fault spec nth must be >= 1: {raw!r}")
        self._matched = 0

    def matches(self, site: str, coords: dict[str, Any]) -> bool:
        return site == self.site and all(
            k in coords and str(coords[k]) == want
            for k, want in self.coords.items())

    def should_fire(self) -> bool:
        self._matched += 1
        if self._matched < self.nth:
            return False
        return self.times < 0 or self._matched < self.nth + self.times


class FaultPlan:
    """A compiled, thread-safe fault plan."""

    def __init__(self, specs: list[dict]):
        self._specs = [_Spec(s) for s in specs]
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._specs)

    def fire(self, site: str, **coords) -> str | None:
        with self._lock:
            spec = next((s for s in self._specs
                         if s.matches(site, coords) and s.should_fire()),
                        None)
        if spec is None:
            return None
        monitor.inc("resilience/faults_injected_total", site=site,
                    action=spec.action)
        print(f"[resilience] FAULT {spec.action} at {site} {coords}",
              file=sys.stderr, flush=True)
        if spec.action == "raise":
            raise FaultInjected(f"injected fault at {site} {coords}")
        if spec.action == "delay":
            time.sleep(spec.delay_s)
        return spec.action


_plan: FaultPlan | None = None


def enabled() -> bool:
    return _plan is not None


def fire(site: str, **coords) -> str | None:
    plan = _plan
    if plan is None:
        return None
    return plan.fire(site, **coords)


def load(text_or_path: str) -> FaultPlan:
    text = text_or_path.strip()
    if not text.startswith(("[", "{")):
        with open(text_or_path) as f:
            text = f.read()
    specs = json.loads(text)
    return FaultPlan([specs] if isinstance(specs, dict) else specs)


def install(plan_or_specs: FaultPlan | list[dict] | str) -> FaultPlan:
    """Activate a plan (replacing any previous one); returns it."""
    global _plan
    if isinstance(plan_or_specs, FaultPlan):
        plan = plan_or_specs
    elif isinstance(plan_or_specs, str):
        plan = load(plan_or_specs)
    else:
        plan = FaultPlan(plan_or_specs)
    _plan = plan
    return plan


def clear() -> None:
    global _plan
    _plan = None


def install_from_env() -> FaultPlan | None:
    raw = os.environ.get(ENV_VAR)
    if not raw:
        clear()
        return None
    return install(raw)


install_from_env()
