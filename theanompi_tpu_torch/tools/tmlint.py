#!/usr/bin/env python
"""Run the port's static checker suite without importing torch.

Loads ``theanompi_tpu_torch.analysis`` without running the package
chain's imports: stub parent modules whose ``__path__`` points at the
real directories are installed first, so the checkers resolve from the
filesystem while no package ``__init__`` body runs.  The gate is pure
stdlib end to end; it runs on a box with no torch, no card and no JAX.

    python theanompi_tpu_torch/tools/tmlint.py --gate
"""

from __future__ import annotations

import os
import sys
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(_PKG))

for _name, _dir in (("theanompi_tpu_torch", _PKG),
                    ("theanompi_tpu_torch.analysis",
                     os.path.join(_PKG, "analysis"))):
    if _name not in sys.modules:
        _stub = types.ModuleType(_name)
        _stub.__path__ = [_dir]
        sys.modules[_name] = _stub

from theanompi_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
