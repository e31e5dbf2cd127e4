"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100) cards.
Module names follow the JAX package so each module's counterpart is easy
to find.  The port imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``theanompi_tpu``.  Plain tensor code is PyTorch; every
Pallas TPU kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and checked
against a plain PyTorch version of the same function.

Ported so far: ResNet-50 image-classification serving
(``serving.InferenceServer`` over ``models.resnet50.ResNet50``), with
the fused BN epilogue and the stem max-pool as kernels.  Entry points
take ``device=`` and default to ``"cuda"``.
"""

__version__ = "0.1.0"
