"""Model config and the minimal model wrapper the serving path needs.

``ModelConfig`` is a field-for-field copy of the JAX package's
(``theanompi_tpu/models/base.py``), so an export's ``config`` sidecar
round-trips between the two.  Most fields steer training, which this
package does not run yet; serving reads ``compute_dtype``,
``resnet_stem`` and ``seed``.

:class:`TorchModel` holds what a served model is: its ``nn.Module``
(eval mode), its data spec, its device and its compute dtype.  Weights
are drawn from ``config.seed`` with a ``torch.Generator`` on the CPU and
then moved to the device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from theanompi_tpu_torch._device import resolve_device


@dataclasses.dataclass
class ModelConfig:
    """Copy of ``theanompi_tpu.models.base.ModelConfig`` (same fields,
    same defaults); see the JAX package for each field's meaning."""

    batch_size: int = 128
    n_epochs: int = 70
    learning_rate: float = 0.01
    optimizer: str = "sgd"
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    rmsprop_decay: float = 0.9
    lars_trust_coefficient: float = 0.001
    lr_schedule: str = "step"
    lr_decay_epochs: tuple = (40, 60)
    lr_decay_factor: float = 0.1
    lr_poly_power: float = 1.0
    warmup_epochs: int = 0
    label_smoothing: float = 0.0
    lr_scale_with_workers: str | None = None
    exchange_strategy: str = "psum"
    exchange_what: str = "grads"
    exchange_dtype: str = "f32"
    exchange_error_feedback: bool = False
    exchange_buckets: int = 1
    #: 'bfloat16' runs convs and the BN epilogue in bf16
    compute_dtype: str = "float32"
    augment_on_device: bool = True
    #: 'conv7' (7x7/stride-2 stem) or 's2d' (space-to-depth + 4x4 conv)
    resnet_stem: str = "conv7"
    #: JAX-only knobs: the port always runs its kernels on the card
    pool_impl: str = "xla"
    bn_act_impl: str = "xla"
    donate_batch: bool = True
    sync_bn: bool = False
    batch_norm: bool = False
    remat: bool = False
    steps_per_call: int = 1
    grad_accum_steps: int = 1
    zero_sharding: bool = False
    fsdp_sharding: bool = False
    seed: int = 42
    data_dir: str | None = None
    snapshot_dir: str = "./snapshots"
    print_freq: int = 40
    track_top5: bool = False


class TorchModel:
    """A model: module + data spec + device + compute dtype.

    Subclasses define ``build_module()`` (an ``nn.Module`` taking NHWC
    input), ``build_data()`` and ``init_weights(generator)``, and may set
    ``_net_cfg`` (constructor dims beyond ``ModelConfig``, recorded in
    the export's ``net`` sidecar field) before calling this
    constructor."""

    name = "model"
    _net_cfg: dict | None = None

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config or self.default_config()
        self.current_epoch = 0
        self.data = self.build_data()
        module = self.build_module()
        self.init_weights(module,
                          torch.Generator().manual_seed(self.config.seed))
        self.module = module.to(self.device).eval()

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig()

    def build_module(self) -> nn.Module:
        raise NotImplementedError

    def build_data(self):
        raise NotImplementedError

    def init_weights(self, module: nn.Module, gen: torch.Generator) -> None:
        raise NotImplementedError

    def _input_dtype(self) -> torch.dtype:
        return torch.float32

    def _compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.config.compute_dtype == "bfloat16"
                else torch.float32)
