"""See the package docstring; module names follow ``theanompi_tpu``."""
