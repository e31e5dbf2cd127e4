"""Fleet-wide prefix cache: the prefill fleet as cache authority.

Counterpart of ``theanompi_tpu/decode/fleetcache.py``.  A replica's
:class:`~theanompi_tpu_torch.decode.kvcache.PrefixCache` shares prefixes
only within its own pool; across a fleet the same system prompt would
still prefill once per replica.  One prefill replica (the AUTHORITY,
replica 0 of the prefill role group, ``frontdoor/fleet.py``) answers
three ops over the RPC substrate, and every other replica, prefill peers
and decode replicas alike, attaches a :class:`FleetCacheClient` to its
session (``DecodeSession.fleet``):

* ``cache_lookup(prompt)``: the longest page-aligned prefix the
  authority holds.  A hit increfs the entry's pages under a **lease**
  and ships their bytes as raw wire frames with a geometry manifest (the
  migration contract of ``decode/migrate.py`` minus stream state), so an
  eviction on the authority cannot free a page in flight: the lease's
  reference keeps it allocated until the reader decrefs.
* ``cache_decref(lease_id)``: drop the lease once the shipped bytes are
  adopted or discarded.  An unknown lease (foreign, already released)
  raises the typed :class:`LeaseError`, which rides the wire's ``err``
  prefix like ``Overloaded``.
* ``cache_register(manifest, pages)``: a replica that just prefilled a
  prompt cold offers its longest page-aligned proper prefix, so the next
  replica to see that prompt hits.  The authority checks the geometry
  (typed ``IncompatiblePages``) and adopts the bytes as cache content
  (``DecodeSession.adopt_prefix``).

Trust: the fleet shares one HMAC key (``THEANOMPI_TPU_SERVICE_KEY``), so
a registered prefix is as trusted as a migrated stream; the authority
still checks shape, dtype and geometry before its pool is touched, and
entries are keyed on the exact prompt bytes.

The client is best effort: a transport failure counts
``decode/fleet_cache_errors_total`` and reads as a local miss, so
admission never fails because the authority is down.

Page arrays are numpy arrays or CPU tensors (a bf16 pool's pages travel
as ``torch.bfloat16`` tensors: numpy has no bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.decode.migrate import (
    GEOMETRY_FIELDS,
    IncompatiblePages,
    dtype_name,
)
from theanompi_tpu_torch.parallel.service import ServiceClient, ServiceError


class LeaseError(RuntimeError):
    """Typed lease refusal: a decref of a lease the authority does not
    hold (a foreign id, a double decref, a lease that never existed).
    Rides the RPC ``err`` prefix and re-raises as itself on the client;
    the authority keeps serving."""


def prefix_manifest(cfg, prefix, version: int = 0) -> dict:
    """Geometry manifest for shipped PREFIX pages: the ``page_manifest``
    contract minus stream state (no length or first token: a prefix is
    cache content, not a live stream).  ``prefix`` is page-aligned; its
    pages travel beside it shaped ``(n_layers, n_tokens / page_size,
    page_size, n_heads, d_head)`` per pool."""
    prefix = np.asarray(prefix, np.int32).reshape(-1)
    return {
        "n_layers": int(cfg.n_layers),
        "n_heads": int(cfg.n_heads),
        "d_head": int(cfg.d_head),
        "page_size": int(cfg.page_size),
        "pages_per_seq": int(cfg.pages_per_seq),
        "dtype": str(cfg.dtype),
        "n_tokens": int(prefix.shape[0]),
        "prefix": [int(t) for t in prefix],
        "version": int(version),
    }


def prefix_incompatibility(manifest: dict, k, v, cfg) -> str | None:
    """Why shipped prefix pages cannot enter a pool shaped by ``cfg``;
    None when they can.  Used by the authority before ``cache_register``
    touches its pool and by the fetching replica before it adopts."""
    if not isinstance(manifest, dict):
        return f"manifest is {type(manifest).__name__}, not a dict"
    for f in (*GEOMETRY_FIELDS, "n_tokens", "prefix"):
        if f not in manifest:
            return f"prefix manifest missing field {f!r}"
    for f in GEOMETRY_FIELDS:
        want = getattr(cfg, f)
        got = manifest[f]
        if (str(got) if f == "dtype" else int(got)) != \
                (str(want) if f == "dtype" else int(want)):
            return (f"page geometry mismatch on {f}: sender {got!r} "
                    f"vs receiver {want!r}")
    n = int(manifest["n_tokens"])
    ps = int(cfg.page_size)
    if n < ps or n % ps:
        return (f"prefix of {n} tokens is not a whole number of "
                f"{ps}-token pages")
    q = n // ps
    if q > int(cfg.pages_per_seq):
        return (f"prefix spans {q} pages > pages_per_seq "
                f"{cfg.pages_per_seq}")
    if len(manifest["prefix"]) != n:
        return (f"prefix manifest carries {len(manifest['prefix'])} "
                f"tokens but n_tokens says {n}")
    shape = (cfg.n_layers, q, ps, cfg.n_heads, cfg.d_head)
    for name, arr in (("k", k), ("v", v)):
        if tuple(arr.shape) != shape:
            return (f"{name} prefix pages shaped {tuple(arr.shape)}, "
                    f"receiver wants {shape}")
        if dtype_name(arr) != str(cfg.dtype):
            return (f"{name} prefix pages dtype {dtype_name(arr)}, "
                    f"receiver pool wants {cfg.dtype}")
    return None


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


class FleetCacheClient(ServiceClient):
    """Wire client of the fleet cache authority.

    The low-level ops (:meth:`lookup`, :meth:`decref`,
    :meth:`register_prefix`) re-raise the typed refusals and let
    transport errors through.  :meth:`fetch` and :meth:`register` are
    what ``DecodeSession`` calls on its admission path: best effort,
    every failure counted and swallowed, so a down authority reads as a
    plain miss, never a failed admission."""

    #: typed errors that re-raise as themselves off the wire
    _TYPED = {LeaseError.__name__: LeaseError,
              IncompatiblePages.__name__: IncompatiblePages}

    def _call_typed(self, op: str, *args):
        try:
            return self.call(op, *args)
        except ServiceError as e:
            for name, cls in self._TYPED.items():
                if name in str(e):
                    raise cls(str(e)) from None
            raise

    # -- low-level ops --------------------------------------------------

    def lookup(self, prompt):
        """``(manifest, k, v, lease_id)`` on a hit (the lease holds a
        page reference until :meth:`decref`), None on a miss."""
        out = self._call_typed("cache_lookup",
                               np.asarray(prompt, np.int32))
        if out is None:
            return None
        manifest, pages, lease = out
        k, v = pages
        return manifest, k, v, lease

    def decref(self, lease_id: str) -> None:
        self._call_typed("cache_decref", str(lease_id))

    def register_prefix(self, manifest: dict, k, v) -> dict:
        from theanompi_tpu_torch.serving.server import wire_pages

        return self._call_typed("cache_register", manifest,
                                wire_pages(k, v))

    # -- the session's best-effort wrappers -----------------------------

    def fetch(self, session, prompt) -> bool:
        """On a local miss: ask the authority and adopt a hit's shipped
        pages into ``session``'s prefix cache.  True when an adoption
        happened (the caller looks up locally again).  The lease is
        released in ``finally``: adopted or not, the authority's page
        reference never outlives this call."""
        try:
            got = self.lookup(prompt)
        except Exception:
            monitor.inc("decode/fleet_cache_errors_total")
            return False
        if got is None:
            monitor.inc("decode/fleet_cache_misses_total")
            return False
        manifest, k, v, lease = got
        try:
            reason = prefix_incompatibility(manifest, k, v, session.cfg)
            if reason is not None:
                monitor.inc("decode/fleet_cache_errors_total")
                return False
            adopted = session.adopt_prefix(
                np.asarray(manifest["prefix"], np.int32), k, v)
            if adopted:
                monitor.inc("decode/fleet_cache_hits_total")
                monitor.inc("decode/fleet_cache_ship_bytes_total",
                            float(_nbytes(k) + _nbytes(v)))
            return adopted
        finally:
            try:
                self.decref(lease)
            except Exception:
                monitor.inc("decode/fleet_cache_errors_total")

    def register(self, session, prefix, pages) -> None:
        """Offer a just-prefilled page-aligned prefix (page ids in
        ``session``'s pool) to the authority.  Best effort: errors are
        counted, never raised."""
        try:
            k, v = session.export_page_ids(pages)
            manifest = prefix_manifest(session.cfg, prefix,
                                       version=session.version)
            self.register_prefix(manifest, k, v)
            monitor.inc("decode/fleet_cache_registers_total")
        except Exception:
            monitor.inc("decode/fleet_cache_errors_total")
