"""Model export: versioned, verified, eval-mode inference artifacts.

Counterpart of ``theanompi_tpu/serving/export.py`` with the same
directory contract, in a format this package reads without JAX (the JAX
package's exports are Orbax checkpoints):

    {export_dir}/{v}/state.pt        torch.save of a plain dict of tensors
    {export_dir}/manifest_{v}.json   per-file size + sha256
    {export_dir}/export_meta_{v}.json

written in that order.  The meta sidecar is the publish marker: a
version without one is half-published and never offered.  Versions are
immutable and strictly increasing; :func:`load_export` picks the newest
version that verifies and loads (``torch.load(weights_only=True)``), so
a corrupt newest version costs a fallback, never the server.  The meta
carries what is needed to rebuild the model around the tensors: the
model's module path and class, its ``ModelConfig`` and its net dims.

Only ``weight_dtype="f32"`` is written for now; quantized exports are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import torch
from torch import nn

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.models.layers import prepare_inference
from theanompi_tpu_torch.resilience.recovery import (
    manifest_path,
    verify_checkpoint,
    write_manifest,
)

WEIGHT_DTYPES = ("f32",)
STATE_FILE = "state.pt"
#: the only module tree an export's meta may name for rebuilding
_PACKAGE = "theanompi_tpu_torch."


class IncompatibleExport(RuntimeError):
    """A published export the live server must not hot-swap in: another
    model, sample shape, net dims or weight dtype."""


def meta_path(export_dir: str, version: int) -> str:
    return os.path.join(export_dir, f"export_meta_{int(version)}.json")


def export_incompatibility(live_meta: dict, new_meta: dict) -> str | None:
    """Why ``new_meta`` must NOT replace a server serving ``live_meta``;
    None when compatible."""
    for key in ("modelfile", "modelclass"):
        if live_meta.get(key) != new_meta.get(key):
            return (f"{key} changed "
                    f"{live_meta.get(key)!r} -> {new_meta.get(key)!r}")
    if list(live_meta.get("sample_shape") or []) != \
            list(new_meta.get("sample_shape") or []):
        return (f"sample_shape changed {live_meta.get('sample_shape')} -> "
                f"{new_meta.get('sample_shape')}")
    if (live_meta.get("net") or {}) != (new_meta.get("net") or {}):
        return (f"net dims changed {live_meta.get('net')} -> "
                f"{new_meta.get('net')}")
    live_wd = live_meta.get("weight_dtype") or "f32"
    new_wd = new_meta.get("weight_dtype") or "f32"
    if live_wd != new_wd:
        return (f"weight_dtype changed {live_wd!r} -> {new_wd!r} (restart "
                "the server to change it)")
    return None


def kept_versions(export_dir: str) -> list[int]:
    """Version directories on disk, ascending."""
    if not os.path.isdir(export_dir):
        return []
    return sorted(int(n) for n in os.listdir(export_dir)
                  if n.isdigit() and os.path.isdir(os.path.join(export_dir,
                                                                n)))


def _sample_dtype(model) -> str:
    dt = getattr(model.data, "sample_dtype", None)
    return str(dt) if dt is not None else str(model._input_dtype()).replace(
        "torch.", "")


def export_model(model, export_dir: str, version: int | None = None,
                 max_to_keep: int = 5, weight_dtype: str = "f32") -> int:
    """Write one export version of ``model`` (its module's state_dict,
    f32; under FSDP its parameters gathered, so every rank calls it);
    returns the version (default: ``model.current_epoch``).
    Re-exporting an existing version is refused."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r} is not ported yet "
                         f"(this package writes {WEIGHT_DTYPES})")
    version = int(model.current_epoch if version is None else version)
    if version in kept_versions(export_dir):
        raise ValueError(f"export version {version} already exists in "
                         f"{export_dir}; versions are immutable — export "
                         "the next one")
    step_dir = os.path.join(export_dir, str(version))
    os.makedirs(step_dir)
    with model.full_params():
        state = {k: v.detach().to("cpu", torch.float32).contiguous()
                 for k, v in model.module.state_dict().items()}
    torch.save(state, os.path.join(step_dir, STATE_FILE))
    write_manifest(export_dir, version, step_dir)
    meta = {
        "version": version,
        "name": model.name,
        "modelfile": type(model).__module__,
        "modelclass": type(model).__qualname__,
        "config": dataclasses.asdict(model.config),
        "sample_shape": list(model.data.sample_shape),
        "sample_dtype": _sample_dtype(model),
        "n_classes": getattr(model.data, "n_classes", None),
        "net": model._net_cfg,
        "weight_dtype": weight_dtype,
        "decode": False,
        "created": time.time(),
    }
    path = meta_path(export_dir, version)
    with open(f"{path}.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(f"{path}.tmp", path)
    for old in kept_versions(export_dir)[:-max_to_keep]:
        for p in (meta_path(export_dir, old), manifest_path(export_dir, old)):
            if os.path.exists(p):
                os.unlink(p)
        shutil.rmtree(os.path.join(export_dir, str(old)), ignore_errors=True)
    return version


def latest_export_version(export_dir: str) -> int | None:
    """Digest-free poll hint: the newest version whose manifest AND meta
    sidecar are both on disk (full verification happens at load)."""
    done = [v for v in kept_versions(export_dir)
            if os.path.exists(manifest_path(export_dir, v))
            and os.path.exists(meta_path(export_dir, v))]
    return done[-1] if done else None


@dataclasses.dataclass
class LoadedExport:
    version: int
    state: dict
    meta: dict


def _load_version(export_dir: str, v: int) -> LoadedExport:
    if not os.path.exists(meta_path(export_dir, v)):
        raise FileNotFoundError(f"export v{v} in {export_dir} has no meta "
                                "sidecar (not published)")
    ok, detail = verify_checkpoint(export_dir, v)
    if ok is False:
        monitor.inc("resilience/checkpoint_corrupt_total")
        raise ValueError(f"export v{v} in {export_dir} is corrupt ({detail})")
    state = torch.load(os.path.join(export_dir, str(v), STATE_FILE),
                       map_location="cpu", weights_only=True)
    with open(meta_path(export_dir, v)) as f:
        meta = json.load(f)
    return LoadedExport(v, state, meta)


def load_export(export_dir: str, version: int | None = None) -> LoadedExport:
    """Read-only verified load of ``version``, or of the newest version
    that is published, verifies and loads."""
    if version is not None:
        return _load_version(export_dir, int(version))
    for v in reversed(kept_versions(export_dir)):
        try:
            return _load_version(export_dir, v)
        except FileNotFoundError:
            continue
        except Exception as e:  # corrupt or unloadable: fall back
            print(f"[serving] export v{v} skipped ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)
    raise FileNotFoundError(f"no restorable export in {export_dir}")


def build_model_from_meta(meta: dict, device: str | torch.device = "cuda"):
    """Rebuild the exported model (class, config, net dims) on
    ``device``.  JSON turns ModelConfig's tuples into lists; they are
    re-tupled so the rebuilt config equals the exporter's."""
    from theanompi_tpu_torch.models.base import ModelConfig

    modelfile = meta["modelfile"]
    if not modelfile.startswith(_PACKAGE):
        raise ValueError(f"export names model module {modelfile!r}, "
                         f"outside {_PACKAGE[:-1]}")
    cls = getattr(importlib.import_module(modelfile), meta["modelclass"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in (meta.get("config") or {}).items() if k in fields}
    return cls(config=ModelConfig(**kw), device=device,
               **(meta.get("net") or {}))


class InferenceSession:
    """One eval-mode module over swappable weights.

    ``swap`` and ``infer`` synchronize by publishing one tuple attribute:
    ``infer`` reads ``(version, module)`` once, so an in-flight batch
    finishes on the module it started with while the next batch picks up
    the new one.  Each published module is built fresh from the model's
    ``build_module()``, loaded, moved to the model's device and prepared
    for inference (conv weights in compute dtype, BN affines folded)."""

    def __init__(self, model, state: dict | None = None, version: int = 0):
        self.model = model
        self.device = model.device
        self._transform = getattr(model.data, "device_transform", None)
        state = state if state is not None else model.module.state_dict()
        self._live = (int(version), self._place(state))
        self._swap_lock = threading.Lock()

    def _place(self, state: dict) -> nn.Module:
        module = self.model.build_module()
        module.load_state_dict(state)
        return prepare_inference(module.to(self.device))

    @property
    def version(self) -> int:
        return self._live[0]

    def infer(self, x) -> np.ndarray:
        """Logits (f32 numpy) for one batch of request rows."""
        _, module = self._live  # one-read snapshot
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            if self._transform is not None:
                # the dataset's eval transform: requests ship raw rows
                xt = self._transform(xt, None, train=False)
            logits = module(xt)
            return logits.float().cpu().numpy()

    def swap(self, version: int, state: dict) -> bool:
        """Publish new weights; refused (False) for an OLDER version than
        the live one, so a restart racing a hot reload cannot roll the
        replica back.  Same-version swaps are the restart itself."""
        with self._swap_lock:
            if int(version) < self._live[0]:
                return False
            self._live = (int(version), self._place(state))
            return True

    @classmethod
    def from_export(cls, export_dir: str, version: int | None = None,
                    device: str | torch.device = "cuda"
                    ) -> "InferenceSession":
        loaded = load_export(export_dir, version)
        model = build_model_from_meta(loaded.meta, device=device)
        return cls(model, state=loaded.state, version=loaded.version)
