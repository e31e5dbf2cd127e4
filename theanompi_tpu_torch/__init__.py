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
cadence, ``sync_bn``, checkpoints and resume; the model contract's npz
snapshots; shard preparation (``data.imagenet``,
``tools.prepare_imagenet``).  Entry points take ``device=`` and default
to ``"cuda"``.
"""

__version__ = "0.1.0"
