"""Ingest wire protocol — op names + the pure range-assignment math
(copy of ``theanompi_tpu/ingest/protocol.py``).

Every ingest process (reader, coordinator, trainer client) speaks the
param-service transport (``parallel/service.py serve`` /
``ServiceClient``): HMAC handshake, negotiated wire v2 framing, typed
``err`` replies whose class-name prefix rides the wire (``Overloaded``
here, like ``SessionDisplaced`` there).  This module holds what the
three sides must agree on:

* **ops** — the request vocabulary (constants below);
* **plan math** — :func:`partition_batches` cuts an epoch's batch
  index space ``[0, n_batches)`` into contiguous per-reader ranges, a
  pure function of (n_batches, reader list) so every party derives
  the identical assignment from the same inputs;
* **addresses** — :func:`ingest_addresses` parses the launcher's
  ``--ingest`` / ``THEANOMPI_TPU_INGEST`` value.  TCP ``host:port``
  only: the port's ``parallel/rpc.py`` has no ``unix:/path``
  listeners, so a ``unix:`` address is refused by name
  (:func:`check_tcp_address`).

Correctness note: range assignment is an I/O-locality and read-ahead
hint, NOT a correctness boundary.  Every reader derives the same epoch
permutation from (seed, epoch) — ``ingest/order.py`` — so ANY reader
serves ANY batch index byte-identically; that is what makes mid-epoch
reassignment after a reader death trivially safe.
"""

from __future__ import annotations

import os
from typing import Sequence

#: probe: who am I talking to?  -> {"kind": "reader"|"coordinator", ...}
OP_INFO = "ingest_info"
#: reader: dataset identity -> dict (compared with the trainer's local
#: ``Dataset.ingest_signature()`` — a mismatch is a hard error)
OP_META = "ingest_meta"
#: reader: (epoch, rank, size, global_batch, index) -> RawArrays(x, y)
OP_BATCH = "ingest_batch"
#: reader: (epoch, rank, size, global_batch, lo, hi) -> "ok"; kicks the
#: background read-ahead of batches [lo, hi) (fadvise + page touch)
OP_ASSIGN = "ingest_assign"
#: coordinator: (epoch, rank, size, global_batch, n_batches) ->
#: {"version": int, "owners": [[lo, hi, addr], ...]}
OP_PLAN = "ingest_plan"
#: coordinator: (addr,) -> {"dead": bool, "version": int} — verify +
#: mark a reader the caller could not reach; bumps the plan version
OP_REPORT_DEAD = "ingest_report_dead"

ENV_VAR = "THEANOMPI_TPU_INGEST"

DEFAULT_COORDINATOR_PORT = 45950
DEFAULT_READER_BASE_PORT = 45951


def partition_batches(n_batches: int, readers: Sequence[str],
                      rotation: int = 0) -> list[tuple[int, int, str]]:
    """Contiguous equal split of ``[0, n_batches)`` over ``readers``:
    range ``i`` goes to reader ``(i + rotation) % len(readers)``.
    Early ranges take the remainder, so sizes differ by at most one.
    Deterministic in (n_batches, readers, rotation) — the coordinator
    and a coordinator-less client derive the same plan.

    ``rotation`` is the trainer's rank: an epoch stream is consumed in
    order, so with T trainers all starting at batch 0, un-rotated
    plans would have every trainer pulling from reader 0's range
    first, then reader 1's — the fleet serving one reader at a time.
    Rotating the reader order per rank spreads the CONCURRENT load
    across the whole fleet while keeping each (trainer, reader) range
    contiguous for read-ahead locality."""
    n, k = int(n_batches), len(readers)
    if n < 0:
        raise ValueError(f"n_batches must be >= 0, got {n}")
    if k < 1:
        raise ValueError("no readers to partition batches over")
    base, rem = divmod(n, k)
    owners: list[tuple[int, int, str]] = []
    lo = 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        owners.append((lo, hi, readers[(i + int(rotation)) % k]))
        lo = hi
    return owners


def owner_of(owners: Sequence[Sequence], index: int) -> str:
    """The reader address owning batch ``index`` under ``owners``
    (``partition_batches`` output, or its JSON round-trip)."""
    for lo, hi, addr in owners:
        if lo <= index < hi:
            return addr
    raise IndexError(f"batch {index} is outside every assigned range "
                     f"({[(lo, hi) for lo, hi, _ in owners]})")


def ingest_addresses(value: str | None = None) -> list[str] | None:
    """Parse ``--ingest`` / ``$THEANOMPI_TPU_INGEST``: one coordinator
    address, or a comma-separated static reader fleet.  None when
    unset (the in-process loader path)."""
    raw = value if value is not None else os.environ.get(ENV_VAR)
    if not raw:
        return None
    addrs = [a.strip() for a in raw.split(",") if a.strip()]
    if not addrs:
        raise ValueError(f"no addresses in ingest spec {raw!r}")
    for a in addrs:
        check_tcp_address(a)
        host, _, port = a.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"ingest address {a!r} is not host:port")
    return addrs


def check_tcp_address(addr: str) -> None:
    """Refuse a ``unix:/path`` address: the port's RPC substrate
    listens and dials on TCP only (JAX's ``rpc.unix_path`` is not
    ported)."""
    if str(addr).startswith("unix:"):
        raise ValueError(
            f"ingest address {addr!r}: unix: socket addresses are not "
            "supported by the PyTorch port (its parallel/rpc.py serves "
            "TCP host:port only); start the readers on a TCP port")
