"""GoogLeNet (Inception v1; ``BASELINE.json`` config 3, "VGG16 /
GoogLeNet ImageNet, BSP data-parallel").

Counterpart of ``theanompi_tpu/models/googlenet.py``: the stem (7x7/2
conv, 3x3/2 SAME max pool, LRN, 1x1 and 3x3 convs, LRN, pool), nine
inception modules (1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | 3x3/1 SAME max pool
-> 1x1, concatenated on channels) with SAME pools after 3b and 4e, two
auxiliary heads off 4a and 4d in training (5x5/3 average pool, 1x1
conv, fc 1024, dropout 0.7, fc; weight 0.3 each), then global average
pooling, dropout 0.4 and the head; compute in ``dtype`` (bf16 under the
recipe) on f32 master weights, f32 logits.

Every conv is bias-free and its epilogue runs through the fused BN
kernels: :class:`~theanompi_tpu_torch.models.layers.BiasAct` (K1a
forward and K1c backward at unit scale: 59 of each per training step,
57 forwards per eval batch) or, in the BN variant
(``ModelConfig.batch_norm``), ``BatchNormAct(relu)``.  The stem's two
LRNs run K3a/K3b (ops/lrn.py).  Pools, convolutions and matmuls are
plain PyTorch, as the JAX model leaves them to XLA.  In training the
module returns ``(main, (aux1, 0.3), (aux2, 0.3))``, which
``TorchModel.loss_fn`` weighs; in eval the main logits alone (the aux
towers do not run).

Module names follow the flax scopes of the JAX model built with
``bn_act_impl='pallas'`` (``ConvRelu_i``, ``Inception_i``, ``aux1``,
``aux2``, ``Dense_0``; inside them ``Conv_0`` and ``BiasAct_0`` or
``BatchNorm_0``); the bridge (models/bridge.py) also takes the
``'xla'`` tree, whose conv biases live in ``Conv_0``.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel

#: the paper's inception widths (b1, b3r, b3, b5r, b5, bp): 3a, 3b,
#: 4a .. 4e, 5a, 5b
INCEPTIONS = ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
              (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
              (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
              (256, 160, 320, 32, 128, 128), (256, 160, 320, 32, 128, 128),
              (384, 192, 384, 48, 128, 128))
#: the inceptions the aux heads read (4a, 4d) and those followed by a
#: 3x3/2 SAME max pool (3b, 4e)
AUX_AFTER = {2: "aux1", 5: "aux2"}
POOL_AFTER = (1, 6)


class ConvRelu(nn.Module):
    """Bias-free conv (Xavier-uniform) and its relu epilogue:
    ``BiasAct_0`` (bias 0.2) or, with ``batch_norm``, ``BatchNorm_0``."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int] = (1, 1),
                 strides: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32,
                 batch_norm: bool = False, sync_bn: bool = False):
        super().__init__()
        self.Conv_0 = L.Conv(in_features, features, kernel, strides,
                             dtype=dtype, kernel_init=L.xavier_uniform())
        kind, epi = L.conv_epilogue(features, dtype, batch_norm,
                                    L.constant_init(0.2), sync_bn)
        self.epilogue = f"{kind}_0"
        setattr(self, self.epilogue, epi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.epilogue)(self.Conv_0(x))


class Inception(nn.Module):
    """1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | pool -> 1x1, concatenated on
    channels (``ConvRelu_0`` .. ``ConvRelu_5`` in that order)."""

    def __init__(self, in_features: int, b1: int, b3r: int, b3: int,
                 b5r: int, b5: int, bp: int,
                 dtype: torch.dtype = torch.float32,
                 batch_norm: bool = False, sync_bn: bool = False):
        super().__init__()
        specs = ((in_features, b1, 1), (in_features, b3r, 1), (b3r, b3, 3),
                 (in_features, b5r, 1), (b5r, b5, 5), (in_features, bp, 1))
        for i, (cin, cout, k) in enumerate(specs):
            setattr(self, f"ConvRelu_{i}",
                    ConvRelu(cin, cout, (k, k), dtype=dtype,
                             batch_norm=batch_norm, sync_bn=sync_bn))
        self.features = b1 + b3 + b5 + bp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.ConvRelu_0(x)
        p3 = self.ConvRelu_2(self.ConvRelu_1(x))
        p5 = self.ConvRelu_4(self.ConvRelu_3(x))
        pp = self.ConvRelu_5(L.max_pool(x, 3, 1, "SAME"))
        return torch.cat([p1, p3, p5, pp], dim=-1)


class AuxHead(nn.Module):
    """Auxiliary classifier: 5x5/3 VALID average pool, 1x1 conv (128),
    fc 1024 + relu, dropout 0.7, fc (f32 logits)."""

    def __init__(self, in_features: int, hw: int, n_classes: int,
                 dtype: torch.dtype = torch.float32,
                 batch_norm: bool = False, sync_bn: bool = False):
        super().__init__()
        pooled = (hw - 5) // 3 + 1
        if pooled < 1:
            raise ValueError(f"aux head needs >= 5x5 input, got {hw}x{hw}")
        self.ConvRelu_0 = ConvRelu(in_features, 128, dtype=dtype,
                                   batch_norm=batch_norm, sync_bn=sync_bn)
        self.Dense_0 = L.Dense(pooled * pooled * 128, 1024, dtype,
                               L.gaussian_init(0.01), L.constant_init(0.1))
        self.Dense_1 = L.Dense(1024, n_classes, dtype, L.gaussian_init(0.01),
                               L.constant_init(0.0))
        self.drop = L.Dropout(0.7)

    def forward(self, x: torch.Tensor, train: bool,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.ConvRelu_0(L.avg_pool(x, 5, 3))
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(self.drop(x, train, rng)).float()


def widths(width_mult: float) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(stem widths, inception widths) at ``width_mult``: each width
    ``max(8, round(n * width_mult))``, as the JAX model's ``w``."""
    def w(n: int) -> int:
        return max(8, round(n * width_mult))

    return ((w(64), w(64), w(192)),
            tuple(tuple(w(n) for n in spec) for spec in INCEPTIONS))


class GoogLeNetCNN(nn.Module):
    """GoogLeNet over square NHWC ``crop`` input (module docstring)."""

    def __init__(self, n_classes: int = 1000, crop: int = 224,
                 aux_weight: float = 0.3, dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0, batch_norm: bool = False,
                 sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.aux_weight = aux_weight
        stem, incs = widths(width_mult)
        kw = dict(dtype=dtype, batch_norm=batch_norm, sync_bn=sync_bn)
        self.ConvRelu_0 = ConvRelu(3, stem[0], (7, 7), (2, 2), **kw)
        self.ConvRelu_1 = ConvRelu(stem[0], stem[1], **kw)
        self.ConvRelu_2 = ConvRelu(stem[1], stem[2], (3, 3), **kw)
        self.lrn = L.LRN(n=5, k=2.0, alpha=1e-4, beta=0.75)
        hw = -(-crop // 8)       # the 7x7/2 conv and two SAME pools
        cin = stem[2]
        for i, spec in enumerate(incs):
            inc = Inception(cin, *spec, **kw)
            setattr(self, f"Inception_{i}", inc)
            cin = inc.features
            if i in AUX_AFTER:
                setattr(self, AUX_AFTER[i],
                        AuxHead(cin, hw, n_classes, **kw))
            if i in POOL_AFTER:
                hw = -(-hw // 2)
        self.Dense_0 = L.Dense(cin, n_classes, dtype, L.xavier_uniform(),
                               L.constant_init(0.0))
        self.drop = L.Dropout(0.4)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None):
        """Main logits of NHWC ``x`` in eval; ``(main, (aux1, w), (aux2,
        w))`` in train, where the dropouts draw from ``rng``.  ``train``
        must agree with the module's mode."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        x = x.to(self.dtype)
        x = self.lrn(L.max_pool(self.ConvRelu_0(x), 3, 2, "SAME"))
        x = self.lrn(self.ConvRelu_2(self.ConvRelu_1(x)))
        x = L.max_pool(x, 3, 2, "SAME")
        aux = []
        for i in range(len(INCEPTIONS)):
            x = getattr(self, f"Inception_{i}")(x)
            if train and i in AUX_AFTER:
                aux.append((getattr(self, AUX_AFTER[i])(x, train, rng),
                            self.aux_weight))
            if i in POOL_AFTER:
                x = L.max_pool(x, 3, 2, "SAME")
        x = self.drop(L.global_avg_pool(x), train, rng)
        main = self.Dense_0(x).float()
        return (main, *aux) if train else main


class GoogLeNet(TorchModel):
    """GoogLeNet trained (BSP) or served; ``n_classes``, ``crop`` (of the
    uint8 store images) and ``width_mult`` (the channel multiplier, 1.0
    the paper's widths; every width a multiple of 8 on the card, the
    fused kernels' bf16 rule) are recorded as an export's net dims.
    ``data`` passes a ready ``ImageNet_data`` instead of the one built
    from the config."""

    name = "googlenet"
    #: 2 x MACs: ~1.5 GMAC forward at 224 x2, x3 fwd + bwd
    train_flops_per_sample = 9.0e9

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", n_classes: int = 1000,
                 crop: int = 224, width_mult: float = 1.0,
                 data: ImageNet_data | None = None):
        self._net_cfg = {"n_classes": int(n_classes), "crop": int(crop),
                         "width_mult": float(width_mult)}
        super().__init__(config, device, data=data)

    @property
    def uses_batchnorm(self) -> bool:
        return self.config.batch_norm

    @classmethod
    def default_config(cls) -> ModelConfig:
        """The JAX recipe: batch 64, SGD momentum 0.9, wd 2e-4, LR 0.01
        on a poly schedule of power 0.5, bf16."""
        return ModelConfig(
            batch_size=64, n_epochs=70, learning_rate=0.01, momentum=0.9,
            weight_decay=2e-4, lr_schedule="poly", lr_poly_power=0.5,
            compute_dtype="bfloat16", track_top5=True, print_freq=40)

    def build_module(self) -> GoogLeNetCNN:
        net = self._net_cfg
        return GoogLeNetCNN(n_classes=self.data.n_classes, crop=net["crop"],
                            dtype=self._compute_dtype(),
                            width_mult=net["width_mult"],
                            batch_norm=self.config.batch_norm,
                            sync_bn=self.config.sync_bn)

    def build_data(self) -> ImageNet_data:
        cfg = self.config
        return ImageNet_data(data_dir=cfg.data_dir, crop=self._net_cfg["crop"],
                             seed=cfg.seed,
                             augment_on_device=cfg.augment_on_device,
                             n_classes=self._net_cfg["n_classes"])

    def init_weights(self, module: GoogLeNetCNN,
                     gen: torch.Generator) -> None:
        """The JAX recipe: Xavier-uniform convs and head, conv biases
        0.2, Gaussian aux dense layers (BN: scale 1, bias 0)."""
        L.init_params(module, gen)


# reference-style alias
GoogLeNet_model = GoogLeNet
