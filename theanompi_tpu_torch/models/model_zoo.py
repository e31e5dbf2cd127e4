"""The zoo's variants of the first-class models.

Counterpart of ``theanompi_tpu/models/model_zoo.py``: thin
reconfigurations that keep the whole model contract, so the launcher and
every rule drive them like any zoo member: VGG19 (configuration E),
ResNet-101 and ResNet-152 (deeper bottleneck stages; through the
launcher ``-c ResNet101`` needs no extra flag), and ``resnet50_large``,
the large-batch recipe over ResNet-50 (LARS, linear warmup then cosine
decay, label smoothing 0.1, the space-to-depth stem, the LR scaled with
the square root of the worker count).
"""

from __future__ import annotations

from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.models.vgg16 import VGG16

#: configuration E: (n_convs, features) per block, 16 convs + 3 FC
VGG19_BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


class VGG19(VGG16):
    name = "vgg19"
    blocks = VGG19_BLOCKS
    train_flops_per_sample = 117.6e9  # 2 x MACs: 19.6 GMAC fwd @224, x3


class ResNet101(ResNet50):
    name = "resnet101"
    stage_sizes = (3, 4, 23, 3)
    train_flops_per_sample = 46.8e9   # 2 x MACs: 7.8 GMAC fwd @224, x3


class ResNet152(ResNet101):
    name = "resnet152"
    stage_sizes = (3, 8, 36, 3)
    train_flops_per_sample = 69.0e9   # 2 x MACs: 11.5 GMAC fwd @224, x3


class ResNet50_LargeBatch(ResNet50):
    """ResNet-50 under the large-batch recipe: LARS (trust coefficient
    0.001) with momentum 0.9, 5 warmup epochs then cosine decay over 90,
    label smoothing 0.1, bf16, the space-to-depth stem, per-card batch
    128 and a master LR of 0.7 scaled by the square root of the worker
    count (the JAX ``default_config``)."""

    name = "resnet50_large"

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig(
            batch_size=128, learning_rate=0.7, lr_scale_with_workers="sqrt",
            n_epochs=90, optimizer="lars", momentum=0.9, weight_decay=1e-4,
            lr_schedule="cosine", warmup_epochs=5, label_smoothing=0.1,
            compute_dtype="bfloat16", resnet_stem="s2d", track_top5=True,
            print_freq=20)
