"""KV-page migration contract: the page manifest and the typed refusal.

Counterpart of ``theanompi_tpu/decode/migrate.py``.  A stream's pages
travel between replicas (a drained replica's live streams, or a prefill
done elsewhere) as its slice of the page pool, ``(n_layers,
pages_per_seq, page_size, n_heads, d_head)`` per pool in the ring layout
the prefill wrote, so adoption is one fixed-shape copy
(``DecodeSession.adopt_pages``).  The **page manifest** pins the
sender's pool geometry and the stream's position state (prompt, length,
the first token to emit); the receiver checks it and the arrays against
its own :class:`~theanompi_tpu_torch.decode.kvcache.CacheConfig` before
touching its pool, and any mismatch raises :class:`IncompatiblePages`,
a per-stream refusal that rides the wire's ``err`` prefix.  Model
version skew is tolerated; the manifest carries the sender's version
for observability only.

Page arrays are numpy arrays or CPU tensors: numpy has no bfloat16, so
the pages of a bf16 pool travel as ``torch.bfloat16`` tensors (the
wire's own rule for bf16 leaves, parallel/wire.py).
"""

from __future__ import annotations

import numpy as np
import torch

from theanompi_tpu_torch.decode.kvcache import CacheConfig

#: manifest fields that must equal the receiver's CacheConfig field of
#: the same name: the pool-geometry contract
GEOMETRY_FIELDS = ("n_layers", "n_heads", "d_head", "page_size",
                   "pages_per_seq", "dtype")


class IncompatiblePages(RuntimeError):
    """Migrated KV pages refused: the manifest or the page arrays do not
    fit the receiving replica's cache geometry.  A per-stream refusal,
    never a replica failure."""


def page_manifest(cfg: CacheConfig, prompt, length: int,
                  first_token: int, version: int = 0) -> dict:
    """The sender-side description of one prefilled stream's pages:
    the geometry, the whole prompt (the receiver's prefix-cache key),
    its length, the first token the receiver emits, and the sender's
    model version."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    return {
        "n_layers": int(cfg.n_layers),
        "n_heads": int(cfg.n_heads),
        "d_head": int(cfg.d_head),
        "page_size": int(cfg.page_size),
        "pages_per_seq": int(cfg.pages_per_seq),
        "dtype": str(cfg.dtype),
        "length": int(length),
        "prompt": [int(t) for t in prompt],
        "first_token": int(first_token),
        "version": int(version),
    }


def manifest_incompatibility(manifest: dict,
                             cfg: CacheConfig) -> str | None:
    """Why ``manifest`` cannot be adopted into a pool shaped by ``cfg``;
    None when compatible."""
    if not isinstance(manifest, dict):
        return f"manifest is {type(manifest).__name__}, not a dict"
    for f in (*GEOMETRY_FIELDS, "length", "prompt", "first_token"):
        if f not in manifest:
            return f"manifest missing field {f!r}"
    for f in GEOMETRY_FIELDS:
        want = getattr(cfg, f)
        got = manifest[f]
        if (str(got) if f == "dtype" else int(got)) != \
                (str(want) if f == "dtype" else int(want)):
            return (f"page geometry mismatch on {f}: sender {got!r} "
                    f"vs receiver {want!r}")
    length = int(manifest["length"])
    if length < 1:
        return f"manifest length {length} < 1"
    if len(manifest["prompt"]) != length:
        return (f"manifest prompt has {len(manifest['prompt'])} "
                f"tokens but length says {length}")
    return None


def dtype_name(arr) -> str:
    """A numpy array's or a tensor's dtype as the manifest names it."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return str(np.asarray(arr).dtype)


def pages_incompatibility(manifest: dict, k, v,
                          cfg: CacheConfig) -> str | None:
    """The manifest against ``cfg`` AND the page arrays against the
    shape and dtype the manifest promises (the arrays travel as
    separate frames, so a manifest can lie)."""
    reason = manifest_incompatibility(manifest, cfg)
    if reason is not None:
        return reason
    shape = (cfg.n_layers, cfg.pages_per_seq, cfg.page_size,
             cfg.n_heads, cfg.d_head)
    for name, arr in (("k", k), ("v", v)):
        if tuple(arr.shape) != shape:
            return (f"{name} pages shaped {tuple(arr.shape)}, "
                    f"receiver pool wants {shape}")
        if dtype_name(arr) != str(cfg.dtype):
            return (f"{name} pages dtype {dtype_name(arr)}, receiver "
                    f"pool wants {cfg.dtype}")
    return None
