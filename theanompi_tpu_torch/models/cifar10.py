"""Cifar10 CNN: the smoke-test model (``BASELINE.json`` config 1,
single-worker BSP).

Counterpart of ``theanompi_tpu/models/cifar10.py``: a cuda-convnet-style
small CNN over NHWC input: three 5x5 convs (32, 32, 64) each with its
bias and a relu, a VALID 3x3/2 max pool then an LRN (n = 3, k = 1,
alpha = 5e-5) after the first, a VALID 3x3/2 average pool then the
same LRN after the second, an average pool after the third, then two
f32 dense layers (64, and the classes).  The LRNs run the K3a/K3b
kernels on the card (ops/lrn.py); the convolutions and matmuls are
``F.conv2d``/``F.linear`` and the bias and relu plain PyTorch, as the
JAX model leaves them to XLA.  Compute in ``dtype`` (f32 under the
recipe).  Module names follow the flax scopes (``Conv_0`` .. ``Conv_2``,
``Dense_0``, ``Dense_1``), so the weight bridge (models/bridge.py) is
mechanical.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch.data.cifar10 import Cifar10_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel


class Cifar10CNN(nn.Module):
    """The Cifar10 CNN over 32x32 NHWC input (f32 logits)."""

    def __init__(self, n_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((3, 32), (32, 32), (32, 64))):
            setattr(self, f"Conv_{i}", L.Conv(
                cin, cout, (5, 5), dtype=dtype, bias=True,
                kernel_init=L.he_normal(), bias_init=L.constant_init(0.0)))
        self.lrn = L.LRN(n=3, k=1.0, alpha=5e-5, beta=0.75)
        # 32 -> 15 (max pool) -> 7 -> 3 (average pools): 3*3*64
        self.Dense_0 = L.Dense(3 * 3 * 64, 64, kernel_init=L.he_normal(),
                               bias_init=L.constant_init(0.0))
        self.Dense_1 = L.Dense(64, n_classes,
                               kernel_init=L.gaussian_init(0.01),
                               bias_init=L.constant_init(0.0))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC ``x``; ``train`` must agree with the module's
        mode, ``rng`` is ignored (the net draws nothing)."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        x = x.to(self.dtype)
        x = self.lrn(L.max_pool(torch.relu(self.Conv_0(x)), 3, 2))
        x = self.lrn(L.avg_pool(torch.relu(self.Conv_1(x)), 3, 2))
        x = L.avg_pool(torch.relu(self.Conv_2(x)), 3, 2)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x).float()


class Cifar10_model(TorchModel):
    """Cifar10 trained (BSP) or served (``TorchModel``'s constructor:
    ``data`` passes a ready ``Cifar10_data`` instead of the one built
    from the config)."""

    name = "cifar10"
    #: 2 x MACs of the forward (10.8 M at 32x32), x3 fwd + bwd
    train_flops_per_sample = 6.46e7

    @classmethod
    def default_config(cls) -> ModelConfig:
        """The reference recipe: SGD momentum 0.9, wd 1e-4, LR 0.01
        stepped down at epochs 50 and 60, f32."""
        return ModelConfig(
            batch_size=128, n_epochs=70, learning_rate=0.01, momentum=0.9,
            weight_decay=1e-4, lr_schedule="step", lr_decay_epochs=(50, 60),
            lr_decay_factor=0.1, print_freq=40)

    def build_module(self) -> Cifar10CNN:
        return Cifar10CNN(n_classes=self.data.n_classes,
                          dtype=self._compute_dtype())

    def build_data(self) -> Cifar10_data:
        cfg = self.config
        return Cifar10_data(data_dir=cfg.data_dir, seed=cfg.seed,
                            augment_on_device=cfg.augment_on_device)

    def init_weights(self, module: Cifar10CNN, gen: torch.Generator) -> None:
        """The JAX recipe's inits: He-normal convs and first dense layer,
        N(0, 0.01^2) head, zero biases."""
        L.init_params(module, gen)
