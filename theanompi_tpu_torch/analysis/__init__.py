"""The port's correctness tooling (counterpart of
``theanompi_tpu/analysis``).

* **static** — the ``tmlint`` checker suite (pure stdlib ``ast``; no
  torch import): guarded-by (TM101), the record of why use-after-donate
  (TM201) has no PyTorch counterpart, host syncs reachable from a step
  (TM301, restated for PyTorch) and unguarded pickle decodes (TM302),
  and the catalog site coverage (TM401–TM404), gated on zero NEW
  findings against ``analysis/baseline.json``
  (``python theanompi_tpu_torch/tools/tmlint.py --gate``);
* **runtime** — ``lockgraph``: the lock construction seam.
"""

from theanompi_tpu_torch.analysis.common import (
    CHECK_IDS,
    Finding,
    load_baseline,
    split_by_baseline,
    write_baseline,
)
from theanompi_tpu_torch.analysis.lockgraph import make_condition, make_lock

__all__ = [
    "CHECK_IDS", "Finding", "load_baseline", "make_condition", "make_lock",
    "split_by_baseline", "write_baseline",
]
