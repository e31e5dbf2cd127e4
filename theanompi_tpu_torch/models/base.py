"""Model config and the model contract: serving and BSP training.

``ModelConfig`` is a field-for-field copy of the JAX package's
(``theanompi_tpu/models/base.py``), so an export's ``config`` sidecar
round-trips between the two.

:class:`TorchModel` is the counterpart of the JAX ``TpuModel``: its
``nn.Module`` (f32 master weights, drawn from ``config.seed`` with a
``torch.Generator`` on the CPU, then moved to the device; eval mode
until training starts), its dataset, its device and compute dtype, and
the reference contract the rules drive: ``compile_iter_fns``,
``begin_epoch``, ``train_iter``, ``val_iter``/``val_epoch``,
``adjust_hyperp`` and ``cleanup``.  One process trains on one card;
the rank and worker count come from ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Iterator

import torch
from torch import nn

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch._device import resolve_device
from theanompi_tpu_torch.data.prefetch import DevicePrefetcher
from theanompi_tpu_torch.models.layers import (
    error_rate,
    softmax_cross_entropy,
    topk_error,
)
from theanompi_tpu_torch.parallel.bsp import (
    TrainState,
    make_bsp_eval_step,
    make_bsp_train_step,
)
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.utils.helper_funcs import (
    build_optimizer,
    scale_lr,
    set_learning_rate,
)
from theanompi_tpu_torch.utils.recorder import Recorder


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
    """A model: module + dataset + device + compute dtype, and the
    training contract (module docstring).

    Subclasses define ``build_module()`` (an ``nn.Module`` taking NHWC
    input and a ``train`` flag), ``build_data()`` and
    ``init_weights(module, generator)``, and may set ``_net_cfg``
    (constructor dims beyond ``ModelConfig``, recorded in an export's
    ``net`` sidecar field) before calling this constructor.  ``data``
    passes a ready dataset instead of ``build_data()``'s."""

    name = "model"
    _net_cfg: dict | None = None
    #: True for networks with BatchNorm (enables the small-batch warning)
    uses_batchnorm: bool = False
    #: trained FLOPs per sample (forward + backward), for the recorder
    train_flops_per_sample: float | None = None
    #: most un-synced validation batches in flight
    VAL_SYNC_WINDOW = 8

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", data=None):
        self.device = resolve_device(device)
        self.config = config or self.default_config()
        dist = torch.distributed
        initialized = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if initialized else 0
        self.n_workers = dist.get_world_size() if initialized else 1
        self.batch_size = self.config.batch_size
        self.global_batch = self.batch_size * self.n_workers
        self.n_epochs = self.config.n_epochs
        self.current_epoch = 0
        self.current_info: dict = {}
        self.data = data if data is not None else self.build_data()
        base_lr = self.config.learning_rate
        if self.config.lr_scale_with_workers:
            base_lr = scale_lr(base_lr, self.n_workers,
                               self.config.lr_scale_with_workers)
        self._base_lr = base_lr
        module = self.build_module()
        self.init_weights(module,
                          torch.Generator().manual_seed(self.config.seed))
        self.module = module.to(self.device).eval()
        self.state: TrainState | None = None
        self.train_step = None
        self.eval_step = None
        self._rng: torch.Generator | None = None
        self._train_prefetcher: DevicePrefetcher | None = None
        self._train_iter: Iterator | None = None
        self._pending: list[tuple[int, dict]] = []

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

    # -- optimizer / loss ----------------------------------------------------

    def _optimizer_kwargs(self) -> dict:
        cfg = self.config
        return {"optimizer": cfg.optimizer, "momentum": cfg.momentum,
                "nesterov": cfg.nesterov, "weight_decay": cfg.weight_decay}

    def _ensure_state(self) -> TrainState:
        """The training state, made at first use: a model that only
        serves never builds an optimizer."""
        if self.state is None:
            self.state = TrainState(self.module, build_optimizer(
                self.module.parameters(), self._base_lr,
                **self._optimizer_kwargs()))
        return self.state

    def loss_fn(self, module: nn.Module, batch, rng):
        """Softmax CE (with the config's label smoothing) + top-1 error;
        the dataset's ``device_transform`` crops, mirrors and normalizes
        raw uint8 batches on the device first."""
        x, y = batch
        transform = getattr(self.data, "device_transform", None)
        if transform is not None:
            x = transform(x, rng, train=True)
        logits = module(x, train=True)
        loss = softmax_cross_entropy(logits, y, self.config.label_smoothing)
        logits = logits.detach()
        metrics = {"loss": loss.detach(), "error": error_rate(logits, y)}
        if self.config.track_top5:
            metrics["top5_error"] = topk_error(logits, y, 5)
        return loss, metrics

    def eval_fn(self, module: nn.Module, batch) -> dict:
        x, y = batch
        transform = getattr(self.data, "device_transform", None)
        if transform is not None:
            x = transform(x, None, train=False)  # center crop, no mirror
        logits = module(x, train=False)
        metrics = {"loss": softmax_cross_entropy(logits, y),
                   "error": error_rate(logits, y)}
        if self.config.track_top5:
            metrics["top5_error"] = topk_error(logits, y, 5)
        return metrics

    # -- reference contract --------------------------------------------------

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        """Build the BSP train and eval steps (``sync_type`` 'avg'
        averages the exchanged gradients, 'cdd' sums them) and put the
        module in train mode.  Raises on the configuration knobs the
        port has not taken over yet."""
        cfg = self.config
        unported = {"steps_per_call": (cfg.steps_per_call > 1, 9),
                    "grad_accum_steps": (cfg.grad_accum_steps > 1, 9),
                    "zero_sharding": (cfg.zero_sharding, 13),
                    "fsdp_sharding": (cfg.fsdp_sharding, 13),
                    "sync_bn": (cfg.sync_bn, 13)}
        for knob, (on, item) in unported.items():
            if on:
                raise NotImplementedError(
                    f"ModelConfig.{knob} is not ported yet (ROADMAP.md "
                    f"section A, item {item})")
        if self.uses_batchnorm and self.batch_size < 16:
            warnings.warn(
                f"{type(self).__name__}: per-rank batch {self.batch_size} "
                "gives BatchNorm running statistics too noisy to serve "
                "eval; raise batch_size", stacklevel=2)
        exchanger = BSP_Exchanger(
            strategy=cfg.exchange_strategy, avg=(sync_type != "cdd"),
            exchange_what=cfg.exchange_what,
            exchange_dtype=(None if cfg.exchange_dtype == "f32"
                            else cfg.exchange_dtype),
            error_feedback=cfg.exchange_error_feedback,
            exchange_buckets=cfg.exchange_buckets)
        self._ensure_state()
        self.train_step = make_bsp_train_step(self.loss_fn, exchanger)
        self.eval_step = make_bsp_eval_step(self.eval_fn)
        self.module.train()

    def _epoch_rng(self, epoch: int) -> torch.Generator:
        """The augment stream of ``epoch`` on this rank: a generator on
        the device seeded from (seed, epoch, rank), so a run replays
        the same draws epoch by epoch."""
        seed = ((self.config.seed + 1) * 1_000_003 + 7919 * epoch
                + 104729 * self.rank)
        return torch.Generator(device=self.device).manual_seed(seed)

    def begin_epoch(self, epoch: int) -> int:
        """Start the epoch's prefetched train stream (this rank's block
        of every global batch); returns the number of iterations."""
        self.cleanup_iter()
        self.current_epoch = epoch
        self._rng = self._epoch_rng(epoch)
        if self.n_workers > 1:
            host_iter = self.data.host_train_batches(
                epoch, self.global_batch, self.rank, self.n_workers)
        else:
            host_iter = self.data.train_batches(epoch, self.global_batch)
        n_iters = self.data.n_train_batches_for(epoch, self.global_batch)
        self._train_prefetcher = DevicePrefetcher(host_iter, self.device)
        self._train_iter = iter(self._train_prefetcher)
        return n_iters

    def train_iter(self, count: int, recorder: Recorder) -> int:
        """One training step; returns the iterations it covered (1)."""
        if self.train_step is None:
            raise RuntimeError("call compile_iter_fns() first")
        recorder.start()
        batch = next(self._train_iter)
        recorder.end("wait")  # time blocked on the loader
        recorder.start()
        metrics = self.train_step(self.state, batch, self._rng)
        recorder.end("calc")  # enqueue; device time lands on the flush
        self._pending.append((count, metrics))
        window = recorder.print_freq if recorder.print_freq > 0 else 50
        if len(self._pending) >= window:
            self._flush_metrics(recorder)
            recorder.print_train_info(count)
        return 1

    def _flush_metrics(self, recorder: Recorder) -> None:
        """Bring the pending steps' metrics to the host in ONE copy
        (which waits for the card: charged to 'calc')."""
        if not self._pending:
            return
        recorder.start()
        host = torch.stack([torch.stack([m["loss"], m["error"]])
                            for _, m in self._pending]).cpu().numpy()
        for loss, err in host:
            recorder.train_metrics(float(loss), float(err),
                                   self.global_batch)
        recorder.end("calc")
        self._pending.clear()
        self.current_info = {
            "epoch": self.current_epoch,
            "loss": (recorder.train_losses[-1] if recorder.train_losses
                     else None)}

    def val_iter(self, count: int, recorder: Recorder,
                 batch=None) -> dict:
        """One eval step; the metrics stay on the device."""
        recorder.start()
        metrics = self.eval_step(self.state, batch)
        recorder.end("calc")
        return metrics

    def val_epoch(self, recorder: Recorder) -> dict[str, float]:
        """A full validation pass; returns the averaged metrics.  Syncs
        once per ``VAL_SYNC_WINDOW`` batches and copies the metrics to
        the host once at the end."""
        pending: list[dict] = []
        if self.n_workers > 1:
            host_iter = self.data.host_val_batches(
                self.global_batch, self.rank, self.n_workers)
        else:
            host_iter = self.data.val_batches(self.global_batch)
        with DevicePrefetcher(host_iter, self.device) as pf:
            for n, batch in enumerate(pf):
                pending.append(self.val_iter(n, recorder, batch))
                monitor.progress(phase="validate", step=n)
                if (n + 1) % self.VAL_SYNC_WINDOW == 0:
                    recorder.start()
                    recorder.end("calc", block_on=pending[-1])
        if not pending:
            return {}
        recorder.start()
        names = sorted(pending[0])
        host = torch.stack([torch.stack([m[k] for k in names])
                            for m in pending]).cpu().numpy()
        recorder.end("calc")
        return {k: float(v) for k, v in zip(names, host.mean(0))}

    def adjust_hyperp(self, epoch: int) -> float:
        """Per-epoch LR schedule: step, constant, poly or cosine, after
        an optional linear warmup."""
        cfg = self.config
        if cfg.warmup_epochs and epoch < cfg.warmup_epochs:
            lr = self._base_lr * (epoch + 1) / cfg.warmup_epochs
        elif cfg.lr_schedule == "constant":
            lr = self._base_lr
        elif cfg.lr_schedule == "step":
            k = sum(1 for e in cfg.lr_decay_epochs if epoch >= e)
            lr = self._base_lr * (cfg.lr_decay_factor ** k)
        elif cfg.lr_schedule in ("poly", "cosine"):
            span = max(cfg.n_epochs - cfg.warmup_epochs, 1)
            frac = min((epoch - cfg.warmup_epochs) / span, 1.0)
            if cfg.lr_schedule == "poly":
                lr = self._base_lr * (1.0 - frac) ** cfg.lr_poly_power
            else:
                lr = self._base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        else:
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        set_learning_rate(self._ensure_state().optimizer, lr)
        return lr

    def cleanup_iter(self) -> None:
        if self._train_prefetcher is not None:
            self._train_prefetcher.close()
            self._train_prefetcher = None
            self._train_iter = None

    def cleanup(self) -> None:
        self.cleanup_iter()
