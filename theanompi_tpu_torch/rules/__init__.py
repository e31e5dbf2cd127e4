"""See the package docstring; module names follow ``theanompi_tpu``.

The rule classes: ``BSP`` (``rules/bsp.py``) and the async rules
``EASGD``, ``ASGD`` and ``GOSGD`` (``rules/async_rules.py``), imported
on first use."""

_RULES = {"BSP": "bsp", "EASGD": "async_rules", "ASGD": "async_rules",
          "GOSGD": "async_rules"}

__all__ = list(_RULES)


def __getattr__(name: str):
    if name in _RULES:
        import importlib

        return getattr(importlib.import_module(
            f"{__name__}.{_RULES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
