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
model's module path and class, its ``ModelConfig``, its net dims, the
stored weight dtype and whether the export may serve the decode path
(``decode``, the model class's ``decode_capable``).

Quantized exports (``weight_dtype``): ``bf16`` stores every f32 tensor
of two or more dimensions as bfloat16 (rounded to nearest even with the
wire's numpy bit arithmetic, parallel/wire.py ``f32_to_bf16_bits``);
``int8`` stores it as ``{"int8_data": int8, "int8_scale": f32}`` with a
symmetric scale per output channel, the amax over every axis but the
one the flax leaf's LAST axis maps to (``quantize_axes``: axis 0 of a
``Dense``/``Conv`` weight, axis 1 of a transposed conv's, the last axis
of an embedding table, as the JAX package scales ``Embed`` along ``d``).
The leaves are bit-identical to the JAX package's ``quantize_tree`` of
the same weights, carried across by the bridge (models/bridge.py).
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
from theanompi_tpu_torch.parallel.wire import f32_to_bf16_bits
from theanompi_tpu_torch.resilience.recovery import (
    manifest_path,
    verify_checkpoint,
    write_manifest,
)

#: export weight storage dtypes: bf16 halves the bytes, int8 quarters
#: them with a per-output-channel scale
WEIGHT_DTYPES = ("f32", "bf16", "int8")
STATE_FILE = "state.pt"
#: the only module tree an export's meta may name for rebuilding
_PACKAGE = "theanompi_tpu_torch."


class IncompatibleExport(RuntimeError):
    """A published export the live server must not hot-swap in: another
    model, sample shape, net dims, weight dtype or decode capability."""


def meta_path(export_dir: str, version: int) -> str:
    return os.path.join(export_dir, f"export_meta_{int(version)}.json")


# ---------------------------------------------------------------------------
# Weight quantization (bf16 / int8 weight-only)
# ---------------------------------------------------------------------------

#: structural marker of one int8-quantized leaf
_INT8_KEYS = frozenset({"int8_data", "int8_scale"})
#: bridge layout -> the port axis that the flax leaf's last axis maps to
_OUT_AXIS = {"dense": 0, "conv": 0, "conv_t": 1, "same": -1}


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == _INT8_KEYS


def quantize_axes(module: nn.Module) -> dict[str, int]:
    """``{parameter name: output-channel axis}`` of ``module``, from the
    bridge's mapping of each parameter onto its flax leaf."""
    from theanompi_tpu_torch.models.bridge import _param_leaves

    return {port: _OUT_AXIS[layout]
            for port, _, layout in _param_leaves(module, False)}


def _bf16(a: np.ndarray) -> torch.Tensor:
    bits = f32_to_bf16_bits(np.ascontiguousarray(a, np.float32))
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def quantize_tree(state: dict, weight_dtype: str,
                  axes: dict[str, int] | None = None) -> dict:
    """Quantize a host ``state_dict`` for storage (export side).

    Weight-only: f32 tensors of two or more dimensions (kernels,
    embeddings); biases, norms and other 1-D state stay f32.  ``int8``
    needs ``axes`` (:func:`quantize_axes`) and a known axis for every
    such tensor: ``amax`` over the other axes, ``scale = (amax or 1) /
    127``, ``data = clip(rint(w / scale), -127, 127)``, as the JAX
    package in numpy."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, "
                         f"got {weight_dtype!r}")
    if weight_dtype == "f32":
        return state
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy() if t.dtype == torch.float32 else None
        if a is None or a.ndim < 2:
            out[name] = t
        elif weight_dtype == "bf16":
            out[name] = _bf16(a)
        else:
            if axes is None or name not in axes:
                raise ValueError(f"int8 export: no output-channel axis "
                                 f"known for {name} {tuple(a.shape)}")
            keep = axes[name] % a.ndim
            amax = np.max(np.abs(a), axis=tuple(
                i for i in range(a.ndim) if i != keep), keepdims=True)
            scale = (np.where(amax > 0, amax, 1.0) / 127.0).astype(
                np.float32)
            data = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
            out[name] = {"int8_data": torch.from_numpy(data),
                         "int8_scale": torch.from_numpy(scale)}
    return out


def dequantize_tree(tree, upcast_bf16: bool = False):
    """Collapse int8 nodes back to f32 tensors (``data * scale``, on the
    device the node lives on); ``upcast_bf16`` also widens bf16 tensors
    to f32 (the dequantize-on-load path)."""
    if is_quantized_leaf(tree):
        return tree["int8_data"].float() * tree["int8_scale"]
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, upcast_bf16) for k, v in tree.items()}
    if upcast_bf16 and isinstance(tree, torch.Tensor) \
            and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


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
    if bool(live_meta.get("decode")) != bool(new_meta.get("decode")):
        return ("decode capability changed "
                f"{bool(live_meta.get('decode'))} -> "
                f"{bool(new_meta.get('decode'))}")
    return None


def draft_incompatibility(target_meta: dict,
                          draft_meta: dict) -> str | None:
    """Why a draft export must NOT speculate for a live target; None
    when compatible.  The draft's dims are free; its decode capability,
    vocab and positional range (``max(2048, seq_len)``, which must cover
    the target's) must agree, because the target verifies draft
    tokens."""
    if not draft_meta.get("decode"):
        return "draft export is not decode-capable"
    t_net = target_meta.get("net") or {}
    d_net = draft_meta.get("net") or {}
    if t_net.get("vocab") != d_net.get("vocab"):
        return (f"draft vocab {d_net.get('vocab')} != target vocab "
                f"{t_net.get('vocab')}")
    t_max = max(2048, int(t_net.get("seq_len") or 0))
    d_max = max(2048, int(d_net.get("seq_len") or 0))
    if d_max < t_max:
        return (f"draft positional table {d_max} shorter than the "
                f"target's {t_max}")
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
    f32 then quantized to ``weight_dtype``; under FSDP its parameters
    gathered, so every rank calls it); returns the version (default:
    ``model.current_epoch``).  Re-exporting an existing version is
    refused."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, "
                         f"got {weight_dtype!r}")
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
        axes = (quantize_axes(model.module) if weight_dtype == "int8"
                else None)
    state = quantize_tree(state, weight_dtype, axes)
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
        "decode": bool(getattr(model, "decode_capable", False)),
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


def load_export(export_dir: str, version: int | None = None,
                dequantize: bool = True) -> LoadedExport:
    """Read-only verified load of ``version``, or of the newest version
    that is published, verifies and loads.  ``dequantize`` (default)
    collapses bf16/int8 weights back to f32; ``False`` keeps the stored
    leaves for dequantization inside each decode step."""
    if version is not None:
        return _finish(_load_version(export_dir, int(version)), dequantize)
    for v in reversed(kept_versions(export_dir)):
        try:
            return _finish(_load_version(export_dir, v), dequantize)
        except FileNotFoundError:
            continue
        except Exception as e:  # corrupt or unloadable: fall back
            print(f"[serving] export v{v} skipped ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)
    raise FileNotFoundError(f"no restorable export in {export_dir}")


def _finish(loaded: LoadedExport, dequantize: bool) -> LoadedExport:
    if dequantize:
        loaded.state = dequantize_tree(loaded.state, upcast_bf16=True)
    return loaded


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
