"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100) cards.
Module names follow the JAX package so each module's counterpart is easy
to find.  The port imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``theanompi_tpu``.  Plain tensor code is PyTorch; every
Pallas TPU kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and checked
against a plain PyTorch version of the same function.

Ported so far (ROADMAP.md section A): ResNet-50 image-classification
serving (``serving.InferenceServer``); BSP training (``rules.bsp.BSP`` /
``run_bsp_session``, the launcher, one process per card,
``torch.distributed`` for the exchange) of the classifier zoo, the
TransformerLM and the WGAN, with every exchange mode, optimizer and
cadence, ``sync_bn``, ZeRO-1 and FSDP, checkpoints and resume; the
async rules ``EASGD``, ``ASGD`` and ``GOSGD`` in one process (one worker
thread per device entry, several may share a card); the model contract's
npz snapshots; shard preparation (``data.imagenet``,
``tools.prepare_imagenet``); the entry points of a dry run (``entry``), the
native host augment (``native``) and the static checker suite
(``analysis``, ``tools/tmlint.py``).  Entry points take ``device=`` and default
to ``"cuda"``.  The rule classes are exported here (imported on first
use): ``from theanompi_tpu_torch import EASGD``.
"""

__version__ = "0.1.0"

__all__ = ["BSP", "EASGD", "ASGD", "GOSGD"]


def __getattr__(name: str):
    if name in __all__:
        from theanompi_tpu_torch import rules

        return getattr(rules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
