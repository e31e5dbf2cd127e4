"""Rule API: the user-facing training-rule objects.

Counterpart of ``theanompi_tpu/rules/base.py``:

    rule = BSP()
    rule.init(device="cuda", modelfile="...", modelclass="...")
    rule.wait()

One process drives one card.  A multi-card run starts one process per
card with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in the environment; when ``WORLD_SIZE > 1``,
:meth:`Rule.init` joins the default process group (NCCL on ``cuda``,
gloo on ``cpu``) before the model is built.  The session runs on a
background thread; ``wait()`` joins it and re-raises its failure.
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
                with monitor.session(name=f"rank{rank}"):
                    if device.type == "cuda":
                        torch.cuda.set_device(device)
                    self._session(device, modelfile, modelclass, config,
                                  resume, sync_type, **kwargs)
            except BaseException as e:  # propagated by wait()
                traceback.print_exc()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"{self.name}-session")
        self._thread.start()

    def _session(self, device, modelfile, modelclass, config, resume,
                 sync_type, **kwargs):
        raise NotImplementedError
