"""ResNet-50.

Counterpart of ``theanompi_tpu/models/resnet50.py``: bottleneck ResNet
over NHWC input, compute in ``dtype`` (bf16 under the ResNet-50 recipe)
with f32 master weights, an f32 head and f32 logits.  Every BN runs
through the fused epilogue kernels (53 launches per ResNet-50 forward,
and as many backward launches in training) and the stem pool through
the max-pool kernels (one forward launch, and one backward in
training); the convolutions are ``F.conv2d``, as the JAX package leaves
them to XLA.

Module attribute names follow the flax scopes so the weight bridge
(models/bridge.py) is mechanical: ``stem_conv``, ``stem_bn``,
``blocks[i]`` = ``BottleneckBlock_{i}`` with ``proj_conv``/``proj_bn``
(flax ``proj_conv``/``BatchNorm_0``) and ``conv{j}``/``bn{j}`` (flax
``Conv_{j}``/``BatchNorm_{j or j+1}``), and ``head`` = ``Dense_0``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel
from theanompi_tpu_torch.ops.maxpool import maxpool_stem


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, projection shortcut on a stride or
    width change.  The exit BN adds the shortcut inside its kernel and
    applies the relu: ``relu(bn(y) + shortcut)`` in one stream."""

    def __init__(self, in_features: int, features: int,
                 strides: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32, sync_bn: bool = False):
        super().__init__()
        out = features * 4
        bn = dict(dtype=dtype, sync=sync_bn)
        self.proj_conv = self.proj_bn = None
        if in_features != out or tuple(strides) != (1, 1):
            self.proj_conv = L.Conv(in_features, out, (1, 1), strides,
                                    dtype=dtype)
            self.proj_bn = L.BatchNormAct(out, **bn)
        self.conv0 = L.Conv(in_features, features, (1, 1), dtype=dtype)
        self.bn0 = L.BatchNormAct(features, act="relu", **bn)
        self.conv1 = L.Conv(features, features, (3, 3), strides, dtype=dtype)
        self.bn1 = L.BatchNormAct(features, act="relu", **bn)
        self.conv2 = L.Conv(features, out, (1, 1), dtype=dtype)
        self.bn2 = L.BatchNormAct(out, act="relu", **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x))
        y = self.bn0(self.conv0(x))
        y = self.bn1(self.conv1(y))
        return self.bn2(self.conv2(y), residual=residual)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channels in (row offset,
    col offset, channel) order, as the JAX ``space_to_depth``."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * c)


class ResNet(nn.Module):
    """Generic bottleneck ResNet (50 = (3, 4, 6, 3)) over NHWC input;
    ``sync_bn`` gives every BN the statistics of the global batch."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, n_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, stem: str = "conv7",
                 sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stem = stem
        if stem == "s2d":
            self.stem_conv = L.Conv(12, width, (4, 4), (1, 1),
                                    padding=((2, 1), (2, 1)), dtype=dtype)
        elif stem == "conv7":
            self.stem_conv = L.Conv(3, width, (7, 7), (2, 2),
                                    padding=((3, 3), (3, 3)), dtype=dtype)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.stem_bn = L.BatchNormAct(width, dtype=dtype, sync=sync_bn)
        blocks = []
        in_f = width
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                feats = width * 2 ** stage
                blocks.append(BottleneckBlock(in_f, feats, strides, dtype,
                                              sync_bn))
                in_f = feats * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = L.Dense(in_f, n_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NHWC ``x``.  ``train`` is the JAX ``train`` flag and
        must agree with the module's mode (``.train()``/``.eval()``),
        which the BNs read.  ``rng`` is ignored: ResNet draws nothing."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        x = x.to(self.dtype)
        if self.stem == "s2d":
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError("stem='s2d' needs even spatial dims, got "
                                 f"{tuple(x.shape)}")
            x = space_to_depth(x, 2)
        x = self.stem_bn(self.stem_conv(x))
        # relu after the pool, as in the JAX model: max commutes with
        # relu and the relu then runs on the 4x smaller tensor
        x = torch.relu(maxpool_stem(x))
        for blk in self.blocks:
            x = blk(x)
        return self.head(L.global_avg_pool(x)).float()


class ResNet50(TorchModel):
    """ResNet-50, served or trained (BSP): full width by default;
    ``stage_sizes`` (default: the class's, as the JAX zoo's deeper
    ResNets set it), ``width``, ``n_classes`` and ``crop`` (the crop of
    the uint8 store images) are recorded as an export's net dims.
    ``data`` passes a ready ``ImageNet_data`` (e.g. a smaller synthetic
    pool) instead of the one built from the config."""

    name = "resnet50"
    uses_batchnorm = True
    #: blocks per stage; the zoo's ResNet-101/152 override it
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    #: 2 x MACs of the forward at 224 (8.2 GFLOP), x3 for fwd + bwd
    train_flops_per_sample = 24.6e9

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda",
                 stage_sizes: Sequence[int] | None = None, width: int = 64,
                 n_classes: int = 1000, crop: int = 224,
                 data: ImageNet_data | None = None):
        if stage_sizes is None:
            stage_sizes = self.stage_sizes
        self._net_cfg = {"stage_sizes": [int(s) for s in stage_sizes],
                         "width": int(width), "n_classes": int(n_classes),
                         "crop": int(crop)}
        super().__init__(config, device, data=data)

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig(
            batch_size=128, n_epochs=90, learning_rate=0.05, momentum=0.9,
            weight_decay=1e-4, lr_schedule="step",
            lr_decay_epochs=(30, 60, 80), lr_decay_factor=0.1,
            lr_scale_with_workers="linear", compute_dtype="bfloat16",
            track_top5=True, print_freq=20)

    def build_module(self) -> ResNet:
        net = self._net_cfg
        return ResNet(stage_sizes=net["stage_sizes"], width=net["width"],
                      n_classes=self.data.n_classes,
                      dtype=self._compute_dtype(),
                      stem=self.config.resnet_stem,
                      sync_bn=self.config.sync_bn)

    def build_data(self) -> ImageNet_data:
        cfg = self.config
        return ImageNet_data(data_dir=cfg.data_dir, crop=self._net_cfg["crop"],
                             seed=cfg.seed,
                             augment_on_device=cfg.augment_on_device,
                             n_classes=self._net_cfg["n_classes"])

    @torch.no_grad()
    def init_weights(self, module: ResNet, gen: torch.Generator) -> None:
        """The JAX recipe: He-normal convs, Xavier-uniform head, BN
        scale 1 / bias 0 / mean 0 / var 1, and every exit BN's scale 0."""
        for m in module.modules():
            if isinstance(m, L.Conv):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            elif isinstance(m, L.Dense):
                fan_out, fan_in = m.weight.shape
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-lim, lim, generator=gen)
                m.bias.zero_()
        for blk in module.blocks:
            blk.bn2.scale.zero_()


# reference-style alias, as the JAX package exposes
ResNet50_model = ResNet50
