"""Disaggregated serving's front door (counterpart of
``theanompi_tpu/frontdoor``).

Three roles over the shared RPC substrate: a PREFILL fleet running only
the prompt-phase programs (``frontdoor/prefill.py``), the decode-mode
servers adopting migrated KV pages (``decode/migrate.py`` and the
``adopt`` op), and a ROUTER (``frontdoor/router.py``) splitting each
client stream across them; plus an autoscaler
(``frontdoor/autoscale.py``) growing and shrinking each role without
dropping a stream, and ``frontdoor/fleet.py`` spawning it all.

The names below are imported on first use, so ``python -m
theanompi_tpu_torch.frontdoor.prefill`` (a fleet's child) runs its
module once.
"""

import importlib

#: public name -> the submodule defining it
_EXPORTS = {
    "Autoscaler": "autoscale",
    "DisaggregatedFleet": "fleet",
    "HysteresisController": "autoscale",
    "PrefillClient": "prefill",
    "PrefillServer": "prefill",
    "RoleGroup": "autoscale",
    "Router": "router",
    "RouterClient": "router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
