"""VGG16 (``BASELINE.json`` config 3, "VGG16 / GoogLeNet ImageNet, BSP
data-parallel").

Counterpart of ``theanompi_tpu/models/vgg16.py``: configuration D, 3x3
SAME convs in blocks of 2, 2, 3, 3, 3 (64 .. 512 channels), each block
ending in a VALID 2x2/2 max pool, then fc6/fc7 (4096, relu, dropout 0.5)
and the head; compute in ``dtype`` (bf16 under the recipe) on f32 master
weights, f32 logits.  Every conv is bias-free and its epilogue runs
through the fused BN kernels: :class:`~theanompi_tpu_torch.models.layers.
BiasAct` (K1a forward, K1c backward, unit scale) or, in the BN variant
(``ModelConfig.batch_norm``), ``BatchNormAct(relu)`` (the same kernels
with the folded affine).  Pools, convolutions and matmuls are plain
PyTorch, as the JAX model leaves them to XLA.

Module names follow the flax scopes of the JAX model built with
``bn_act_impl='pallas'`` (``Conv_i``, ``BiasAct_i`` or ``BatchNorm_i``,
``Dense_0`` .. ``Dense_2``); the bridge (models/bridge.py) also takes the
``'xla'`` tree, whose conv biases live in ``Conv_i``.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel

#: configuration D: (n_convs, features) per block
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGGCNN(nn.Module):
    """VGG over square NHWC ``crop`` input (f32 logits)."""

    def __init__(self, blocks=VGG16_BLOCKS, n_classes: int = 1000,
                 crop: int = 224, dtype: torch.dtype = torch.float32,
                 batch_norm: bool = False, sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.blocks = tuple(tuple(b) for b in blocks)
        self.layers: list[tuple[str, str]] = []   # (conv, epilogue) names
        cin, hw = 3, crop
        for n_convs, features in self.blocks:
            for _ in range(n_convs):
                i = len(self.layers)
                kind, epi = L.conv_epilogue(features, dtype, batch_norm,
                                            L.constant_init(0.0), sync_bn)
                setattr(self, f"Conv_{i}", L.Conv(
                    cin, features, (3, 3), dtype=dtype,
                    kernel_init=L.he_normal()))
                setattr(self, f"{kind}_{i}", epi)
                self.layers.append((f"Conv_{i}", f"{kind}_{i}"))
                cin = features
            hw //= 2
        if hw < 1:
            raise ValueError(f"crop {crop} too small for {len(self.blocks)} "
                             "pooled blocks")
        self.Dense_0 = L.Dense(hw * hw * cin, 4096, dtype,
                               L.gaussian_init(0.005), L.constant_init(0.1))
        self.Dense_1 = L.Dense(4096, 4096, dtype, L.gaussian_init(0.005),
                               L.constant_init(0.1))
        self.Dense_2 = L.Dense(4096, n_classes, dtype, L.gaussian_init(0.01),
                               L.constant_init(0.0))
        self.drop = L.Dropout(0.5)

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
        layers = iter(self.layers)
        for n_convs, _ in self.blocks:
            for _ in range(n_convs):
                conv, epi = next(layers)
                x = getattr(self, epi)(getattr(self, conv)(x))
            x = L.max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)   # (H, W, C) order, as JAX's
        x = self.drop(torch.relu(self.Dense_0(x)), train, rng)
        x = self.drop(torch.relu(self.Dense_1(x)), train, rng)
        return self.Dense_2(x).float()


class VGG16(TorchModel):
    """VGG16 trained (BSP) or served; ``n_classes`` and ``crop`` (of the
    uint8 store images) are recorded as an export's net dims.  ``data``
    passes a ready ``ImageNet_data`` instead of the one built from the
    config."""

    name = "vgg16"
    #: 2 x MACs: ~15.5 GMAC forward at 224 x2, x3 fwd + bwd
    train_flops_per_sample = 93.0e9
    #: (n_convs, features) per block; the zoo's VGG19 overrides it
    blocks = VGG16_BLOCKS

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", n_classes: int = 1000,
                 crop: int = 224, data: ImageNet_data | None = None):
        self._net_cfg = {"n_classes": int(n_classes), "crop": int(crop)}
        super().__init__(config, device, data=data)

    @property
    def uses_batchnorm(self) -> bool:
        return self.config.batch_norm

    @classmethod
    def default_config(cls) -> ModelConfig:
        """The JAX recipe: batch 64, SGD momentum 0.9, wd 5e-4, LR 0.01
        stepped down at epochs 25, 50 and 65, bf16."""
        return ModelConfig(
            batch_size=64, n_epochs=70, learning_rate=0.01, momentum=0.9,
            weight_decay=5e-4, lr_schedule="step",
            lr_decay_epochs=(25, 50, 65), lr_decay_factor=0.1,
            compute_dtype="bfloat16", track_top5=True, print_freq=40)

    def build_module(self) -> VGGCNN:
        return VGGCNN(blocks=self.blocks, n_classes=self.data.n_classes,
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

    def init_weights(self, module: VGGCNN, gen: torch.Generator) -> None:
        """The JAX recipe: He-normal convs, zero conv biases, Gaussian
        dense layers with the recipe's bias constants (BN: scale 1, bias
        0)."""
        L.init_params(module, gen)


# reference-style alias
VGG16_model = VGG16
