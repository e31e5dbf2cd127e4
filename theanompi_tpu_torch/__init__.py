"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100) cards.
Module names follow the JAX package so each module's counterpart is easy
to find.  The port imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``theanompi_tpu``.  Plain tensor code is PyTorch; every
Pallas TPU kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and checked
against a plain PyTorch version of the same function.

Ported so far: ResNet-50 image-classification serving
(``serving.InferenceServer`` over ``models.resnet50.ResNet50``) and
ResNet-50 BSP training (``rules.bsp.BSP`` / ``run_bsp_session`` over
``TorchModel.train_iter``, one process per card, ``torch.distributed``
for the exchange), with the fused BN epilogue (forward and backward)
and the stem max-pool (value and argmax forward, gather backward) as
kernels.  Entry points take ``device=`` and default to ``"cuda"``.
"""

__version__ = "0.1.0"
