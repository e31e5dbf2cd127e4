"""theanompi_tpu_torch.ingest — the distributed ingest service
(counterpart of ``theanompi_tpu/ingest``).

A standalone reader fleet that feeds M trainers like one loader: N
reader processes own disjoint batch ranges of the shard tree and stream
assembled uint8 batches to trainers over raw wire-v2 frames; a
coordinator assigns ranges, drives shuffle-epoch boundaries, and
reassigns a dead reader's ranges mid-epoch; a trainer-side
:class:`RemoteBatchSource` plugs into ``DevicePrefetcher`` so the rules
switch on nothing but the launcher's ``--ingest`` flag.  The remote
stream is byte-identical to the in-process loader for the same seed,
and to the JAX package's readers: reader and trainer derive one epoch
permutation from (seed, epoch) with zero coordination.
"""

from theanompi_tpu_torch.ingest.client import (
    RemoteBatchSource,
    ingest_addresses,
)
from theanompi_tpu_torch.ingest.coordinator import IngestCoordinator
from theanompi_tpu_torch.ingest.fleet import IngestProcessGroup
from theanompi_tpu_torch.ingest.order import EpochOrder
from theanompi_tpu_torch.ingest.reader import IngestReader

__all__ = [
    "EpochOrder", "IngestCoordinator", "IngestProcessGroup",
    "IngestReader", "RemoteBatchSource", "ingest_addresses",
]
