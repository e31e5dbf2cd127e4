"""The port's command-line tools (``python -m
theanompi_tpu_torch.tools.<name>``)."""
