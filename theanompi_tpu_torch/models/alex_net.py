"""AlexNet: the paper's main benchmark model (AlexNet-128 ImageNet BSP).

Counterpart of ``theanompi_tpu/models/alex_net.py``: the one-column
AlexNet over NHWC input with channel-grouped conv2/4/5, cross-channel LRN
after conv1 and conv2 (the K3a/K3b kernels on the card, ops/lrn.py),
overlapping 3x3/2 max pools, two dropout FC layers and a 1000-class
head; compute in ``dtype`` (bf16 under the recipe) on f32 master
weights, f32 logits.  Convolutions and matmuls are ``F.conv2d`` and
``F.linear``, as the JAX package leaves them to XLA.

The BN variant (``ModelConfig.batch_norm``) drops the conv biases and
runs each conv's epilogue as ``BatchNormAct(relu)`` (the K1a/K1c kernels
on the card, with the folded affine); the LRNs stay, as in JAX.

Module attribute names follow the flax scopes (``Conv_0`` .. ``Conv_4``,
``BatchNorm_0`` .. ``BatchNorm_4`` in the BN variant, ``Dense_0`` ..
``Dense_2``) so the weight bridge (models/bridge.py) is mechanical.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel

#: the JAX model's layers: (name, in, out, kernel, stride, padding,
#: groups, weight std, bias constant)
CONVS = (("Conv_0", 3, 96, 11, 4, "VALID", 1, 0.01, 0.0),
         ("Conv_1", 96, 256, 5, 1, "SAME", 2, 0.01, 0.1),
         ("Conv_2", 256, 384, 3, 1, "SAME", 1, 0.01, 0.0),
         ("Conv_3", 384, 384, 3, 1, "SAME", 2, 0.01, 0.1),
         ("Conv_4", 384, 256, 3, 1, "SAME", 2, 0.01, 0.1))


def flat_features(crop: int) -> int:
    """fc6's input width at a square ``crop``: conv1 11x11/4 VALID, then
    three VALID 3x3/2 pools (227 -> 55 -> 27 -> 13 -> 6: 6*6*256)."""
    hw = (crop - 11) // 4 + 1
    for _ in range(3):
        hw = (hw - 3) // 2 + 1
    if hw < 1:
        raise ValueError(f"crop {crop} too small for AlexNet")
    return hw * hw * 256


class AlexNetCNN(nn.Module):
    """One-column AlexNet with channel grouping (NHWC in, f32 logits);
    ``batch_norm`` selects the BN variant."""

    def __init__(self, n_classes: int = 1000, crop: int = 227,
                 dtype: torch.dtype = torch.float32,
                 batch_norm: bool = False, sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.batch_norm = batch_norm
        for i, (name, cin, cout, kern, stride, pad, groups, std,
                b) in enumerate(CONVS):
            setattr(self, name, L.Conv(
                cin, cout, (kern, kern), (stride, stride), padding=pad,
                dtype=dtype, groups=groups, bias=not batch_norm,
                kernel_init=L.gaussian_init(std),
                bias_init=L.constant_init(b)))
            if batch_norm:
                setattr(self, f"BatchNorm_{i}",
                        L.BatchNormAct(cout, dtype=dtype, act="relu",
                                       sync=sync_bn))
        self.lrn = L.LRN(n=5, k=2.0, alpha=1e-4, beta=0.75)
        self.Dense_0 = L.Dense(flat_features(crop), 4096, dtype,
                               L.gaussian_init(0.005), L.constant_init(0.1))
        self.Dense_1 = L.Dense(4096, 4096, dtype, L.gaussian_init(0.005),
                               L.constant_init(0.1))
        self.Dense_2 = L.Dense(4096, n_classes, dtype, L.gaussian_init(0.01),
                               L.constant_init(0.0))
        self.drop = L.Dropout(0.5)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Conv ``i`` and its epilogue: relu, or the BN variant's
        ``BatchNormAct(relu)``."""
        x = getattr(self, f"Conv_{i}")(x)
        if self.batch_norm:
            return getattr(self, f"BatchNorm_{i}")(x)
        return torch.relu(x)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC ``x``.  ``train`` must agree with the module's
        mode (the BN variant reads it); in train mode the two dropouts
        draw from ``rng``."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        x = x.to(self.dtype)
        x = L.max_pool(self.lrn(self._conv(0, x)), 3, 2)
        x = L.max_pool(self.lrn(self._conv(1, x)), 3, 2)
        x = self._conv(3, self._conv(2, x))
        x = L.max_pool(self._conv(4, x), 3, 2)
        # NHWC flattened in (H, W, C) order, as the JAX reshape
        x = x.reshape(x.shape[0], -1)
        x = self.drop(torch.relu(self.Dense_0(x)), train, rng)
        x = self.drop(torch.relu(self.Dense_1(x)), train, rng)
        return self.Dense_2(x).float()


class AlexNet(TorchModel):
    """AlexNet trained (BSP) or served; ``n_classes`` and ``crop`` (of
    the uint8 store images) are recorded as an export's net dims.
    ``data`` passes a ready ``ImageNet_data`` instead of the one built
    from the config."""

    name = "alexnet"
    #: 2 x MACs: ~0.7 GMAC forward at 227 (one column) x2, x3 fwd + bwd
    train_flops_per_sample = 4.2e9

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", n_classes: int = 1000,
                 crop: int = 227, data: ImageNet_data | None = None):
        self._net_cfg = {"n_classes": int(n_classes), "crop": int(crop)}
        super().__init__(config, device, data=data)

    @property
    def uses_batchnorm(self) -> bool:
        return self.config.batch_norm

    @classmethod
    def default_config(cls) -> ModelConfig:
        """The reference's batch-128 recipe: SGD momentum 0.9, wd 5e-4,
        LR 0.01 stepped down at epochs 20, 40 and 60."""
        return ModelConfig(
            batch_size=128, n_epochs=70, learning_rate=0.01, momentum=0.9,
            weight_decay=5e-4, lr_schedule="step",
            lr_decay_epochs=(20, 40, 60), lr_decay_factor=0.1,
            compute_dtype="bfloat16", track_top5=True, print_freq=40)

    def build_module(self) -> AlexNetCNN:
        return AlexNetCNN(n_classes=self.data.n_classes,
                          crop=self._net_cfg["crop"],
                          dtype=self._compute_dtype(),
                          batch_norm=self.config.batch_norm,
                          sync_bn=self.config.sync_bn)

    def build_data(self) -> ImageNet_data:
        cfg = self.config
        return ImageNet_data(data_dir=cfg.data_dir, crop=self._net_cfg["crop"],
                             seed=cfg.seed,
                             augment_on_device=cfg.augment_on_device,
                             n_classes=self._net_cfg["n_classes"])

    def init_weights(self, module: AlexNetCNN, gen: torch.Generator) -> None:
        """The JAX recipe's Gaussian weights and constant biases (BN:
        scale 1, bias 0)."""
        L.init_params(module, gen)


# reference-style alias
AlexNet_model = AlexNet
