"""theanompi_tpu_torch.decode — autoregressive serving for the
transformer family.

Counterpart of ``theanompi_tpu/decode``:

* ``kvcache``   — paged/ring KV cache: one preallocated page pool per
  replica written in place, refcounted page tables (copy-on-write
  sharing and the cross-request ``PrefixCache``), ring eviction past
  the context window;
* ``model``     — cached-attention forward over the training
  ``TransformerLMNet``'s modules;
* ``migrate``   — the page manifest and the typed ``IncompatiblePages``;
* ``session``   — ``DecodeSession``: the prefill/decode/verify/propose/
  commit/extend/batched-prefill/copy/adopt program families on the
  bucket discipline;
* ``scheduler`` — ``ContinuousBatcher`` (admit and evict between decode
  steps) and ``DecodeReplica``, the restart-from-export wrapper the
  inference server pools;
* ``fleetcache`` — the fleet-wide prefix cache: ``FleetCacheClient``
  (``DecodeSession.fleet``), ``prefix_manifest``,
  ``prefix_incompatibility`` and the typed ``LeaseError``; a prefill
  replica of ``frontdoor/`` is the authority.

Wire surface: the inference server's ``generate`` and ``adopt`` ops
(``InferenceClient``), served by ``python -m
theanompi_tpu_torch.launcher SERVE --export-dir D --decode``, and the
front door's router (``--disaggregate``, ``frontdoor/``).
"""

from theanompi_tpu_torch.decode.kvcache import (
    CacheConfig,
    PagePool,
    PrefixCache,
)
from theanompi_tpu_torch.decode.migrate import (
    IncompatiblePages,
    page_manifest,
)
from theanompi_tpu_torch.decode.model import full_forward
from theanompi_tpu_torch.decode.scheduler import (
    ContinuousBatcher,
    DecodePolicy,
    DecodeReplica,
)
from theanompi_tpu_torch.decode.session import (
    DecodeSession,
    default_prefill_buckets,
)

__all__ = [
    "CacheConfig", "PagePool", "PrefixCache", "full_forward",
    "ContinuousBatcher", "DecodePolicy", "DecodeReplica",
    "DecodeSession", "IncompatiblePages", "default_prefill_buckets",
    "page_manifest",
]
