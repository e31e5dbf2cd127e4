"""Lock construction seam for the threaded host plane.

Counterpart of ``theanompi_tpu/analysis/lockgraph.py``.  The JAX package
can swap in order-tracking locks; this package returns plain
``threading`` primitives for now, behind the same two names, so the
batcher and server keep their construction sites.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A ``threading.Lock`` (``name`` labels the construction site)."""
    return threading.Lock()


def make_condition(lock=None, name: str = "condition"):
    """``threading.Condition`` over ``lock``, or over a fresh lock."""
    return threading.Condition(lock if lock is not None else make_lock(name))
