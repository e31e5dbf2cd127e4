"""Rule API: the user-facing training-rule objects.

Counterpart of ``theanompi_tpu/rules/base.py``:

    rule = BSP()
    rule.init(device="cuda", modelfile="...", modelclass="...")
    rule.wait()

BSP: one process drives one card.  A multi-card run starts one process per
card with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in the environment; when ``WORLD_SIZE > 1``,
:meth:`Rule.init` joins the default process group (NCCL on ``cuda``,
gloo on ``cpu``) before the model is built.  The session runs on a
background thread; ``wait()`` joins it and re-raises its failure.  A
session that dies leaves a crash marker in the monitor run dir when
monitoring is on (``resilience.recovery.record_crash``).

The async rules (``rules/async_rules.py``) instead run one worker thread
per entry of a device list in this process, with no process group:
``init(devices=N | [device, ...], device=...)``, resolved by
:func:`resolve_devices`.
"""

from __future__ import annotations

import importlib
import os
import threading
import traceback
from typing import Any

import torch
import torch.distributed as dist

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel
from theanompi_tpu_torch.resilience import recovery


def resolve_model_class(modelfile: str, modelclass: str) -> type:
    """Import ``modelclass`` from module path ``modelfile``."""
    mod = importlib.import_module(modelfile)
    try:
        return getattr(mod, modelclass)
    except AttributeError as e:
        raise AttributeError(
            f"module {modelfile!r} has no class {modelclass!r}") from e


def init_distributed(device: torch.device) -> bool:
    """Join the default process group from the environment when
    ``WORLD_SIZE > 1`` and none exists; returns whether one exists."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def resolve_devices(devices=None, device: str | torch.device = "cuda",
                    global_mesh: bool = False) -> list[torch.device]:
    """The async rules' worker devices (JAX's ``resolve_devices``).

    ``devices`` is None (every card; one worker on the CPU), a count N
    (cards 0..N-1, or N CPU workers when ``device`` is ``"cpu"``), or a
    list of devices, device strings or card indices (``device`` then
    plays no part).  A list may name the same card more than once: each
    worker there launches on a stream of its own.  Asking for more cards
    than are visible raises.  Rules that place per-worker state
    (``global_mesh=False``) refuse to run inside a process group of more
    than one rank."""
    if (not global_mesh and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "async rules under multi-host launch need the DCN server "
            "transport (parallel/service); run them per-host, or use BSP "
            "for multi-host")
    if devices is None or isinstance(devices, int):
        kind = resolve_device(device).type
        n_cards = torch.cuda.device_count() if kind == "cuda" else None
        if devices is None:
            devices = n_cards or 1
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if n_cards is not None and devices > n_cards:
            raise ValueError(f"requested {devices} devices, have {n_cards}")
        return [torch.device(kind, i) if kind == "cuda"
                else torch.device("cpu") for i in range(devices)]
    out = []
    for d in devices:
        dev = resolve_device(torch.device("cuda", d) if isinstance(d, int)
                             else d)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            if dev.index >= torch.cuda.device_count():
                raise ValueError(f"device {dev} requested, have "
                                 f"{torch.cuda.device_count()} cards")
        out.append(dev)
    if not out:
        raise ValueError("devices is an empty list")
    return out


def rank_device(device: str | torch.device | None) -> torch.device:
    """``device`` for this process: ``cuda`` without an index means the
    card ``LOCAL_RANK`` names."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


class Rule:
    """Base: owns the session thread and its error."""

    name = "rule"
    #: True for rules that run one program over every rank of the
    #: process group (BSP); False for rules that place per-worker state
    #: on individual local devices (the async rules)
    uses_global_mesh = False

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.model: TorchModel | None = None
        self.result: dict[str, Any] = {}

    def init(self, device: str | torch.device | None = None,
             modelfile: str = "theanompi_tpu_torch.models.resnet50",
             modelclass: str = "ResNet50",
             config: ModelConfig | None = None, resume: bool = False,
             sync_type: str = "avg", **kwargs) -> "Rule":
        dev = rank_device(device)
        init_distributed(dev)
        self._start(dev, modelfile, modelclass, config, resume, sync_type,
                    **kwargs)
        return self

    def wait(self) -> dict[str, Any]:
        if self._thread is None:
            raise RuntimeError("call init() before wait()")
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self.result

    def _start(self, device, modelfile, modelclass, config, resume,
               sync_type, **kwargs):
        def run():
            try:
                rank = dist.get_rank() if dist.is_initialized() else 0
                with monitor.session(rank=rank):
                    try:
                        self._session(device, modelfile, modelclass,
                                      config, resume, sync_type, **kwargs)
                    except BaseException as e:
                        # postmortem: a crash marker with the resume hint,
                        # written while the monitor session is live
                        # (record_crash never raises)
                        recovery.record_crash(self.name, e, model=self.model)
                        raise
            except BaseException as e:  # propagated by wait()
                traceback.print_exc()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"{self.name}-session")
        self._thread.start()

    def _session(self, device, modelfile, modelclass, config, resume,
                 sync_type, **kwargs):
        raise NotImplementedError
