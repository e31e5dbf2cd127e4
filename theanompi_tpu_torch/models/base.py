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
``adjust_hyperp`` and ``cleanup``, the checkpoint hooks
``checkpoint_payload`` / ``adopt_restored_state``, the npz parameter
snapshots (``params``, ``save``, ``load``: the JAX package's files, flax
names and layouts through models/bridge.py), ``compile_grad_fn`` and
``optimizer_hyperparams``.  Every exchange mode, optimizer and cadence of
the JAX BSP step is taken (``steps_per_call``: k steps per
``train_iter``; ``grad_accum_steps``: one update from ``a``
microbatches), and ``sync_bn``, apart from ZeRO and FSDP.
``begin_epoch``'s random stream and the data streams are pure functions
of (seed, epoch, rank), so a run resumed at an epoch boundary replays
the unbroken one.
One process trains on one card; the rank and worker count come from
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import math
import os
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
    grad_and_metrics,
    init_exchange_residual,
    make_bsp_accum_step,
    make_bsp_eval_step,
    make_bsp_multi_step,
    make_bsp_train_step,
)
from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger,
    zero_missing_grads,
)
from theanompi_tpu_torch.utils.helper_funcs import (
    build_optimizer,
    load_params_npz,
    save_params_npz,
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


def names_in_order(module: nn.Module) -> list[str]:
    """The module's parameter names, in ``parameters()`` order."""
    return [n for n, _ in module.named_parameters()]


def gather_rows(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's copy of each tensor, stacked ``(n_ranks, *shape)``,
    with one all-gather over a flat buffer (one row without a process
    group).  Every rank must call it together."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat)
        out = out.view(n, flat.numel())
    else:
        out = flat[None]
    rows, at = [], 0
    for t in tensors:
        rows.append(out[:, at:at + t.numel()].reshape((-1,) + t.shape))
        at += t.numel()
    return rows


class TorchModel:
    """A model: module + dataset + device + compute dtype, and the
    training contract (module docstring).

    Subclasses define ``build_module()`` (an ``nn.Module`` taking NHWC
    input, a ``train`` flag and the step's ``rng``), ``build_data()`` and
    ``init_weights(module, generator)``, and may set ``_net_cfg``
    (constructor dims beyond ``ModelConfig``, recorded in an export's
    ``net`` sidecar field) before calling this constructor.  ``data``
    passes a ready dataset instead of ``build_data()``'s."""

    name = "model"
    _net_cfg: dict | None = None
    #: True for networks with BatchNorm (enables the small-batch warning);
    #: the zoo members with a BN variant make it a property that follows
    #: ``config.batch_norm``
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
        self.exchanger: BSP_Exchanger | None = None
        self.train_step_multi = None
        self.train_step_accum = None
        #: batches the last :meth:`val_epoch` ran
        self.val_batches_run = 0

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
                "nesterov": cfg.nesterov, "weight_decay": cfg.weight_decay,
                "beta1": cfg.adam_beta1, "beta2": cfg.adam_beta2,
                "eps": cfg.adam_eps, "rmsprop_decay": cfg.rmsprop_decay,
                "lars_trust_coefficient": cfg.lars_trust_coefficient}

    def optimizer_hyperparams(self) -> dict:
        """The optimizer as plain values: ``learning_rate`` (the base LR,
        worker-scaled) and ``build_optimizer``'s keyword arguments (the
        JAX ``optimizer_hyperparams``)."""
        return {"learning_rate": self._base_lr, **self._optimizer_kwargs()}

    def _ensure_state(self) -> TrainState:
        """The training state, made at first use: a model that only
        serves never builds an optimizer."""
        if self.state is None:
            self.state = TrainState(
                self.module, build_optimizer(self.module.parameters(),
                                             self._base_lr,
                                             **self._optimizer_kwargs()),
                exchange_residual=self._init_residual())
        return self.state

    def _init_residual(self) -> list[torch.Tensor] | None:
        """The error-feedback residual of the bf16 gradient exchange
        (``ModelConfig.exchange_error_feedback``): zeros, one f32 tensor
        per parameter on this rank's device; ``None`` when off."""
        cfg = self.config
        if not cfg.exchange_error_feedback:
            return None
        if cfg.exchange_dtype != "bf16":
            raise ValueError("exchange_error_feedback compensates bf16 "
                             "quantization; set exchange_dtype='bf16'")
        return init_exchange_residual(self.module)

    # -- checkpoint payload --------------------------------------------------

    def checkpoint_payload(self, epoch: int | None = None) -> dict:
        """The training state as the canonical checkpoint payload (the
        JAX package's names): ``params`` and ``model_state`` (the
        module's parameters and its other state-dict entries, the BN
        running statistics, by name), ``opt_state`` (the optimizer's
        state dict), ``step`` and, when given, ``epoch``.  With error
        feedback also ``exchange_residual``: per parameter name, every
        rank's residual stacked ``(n_ranks, *shape)`` (JAX's layout),
        gathered from the ranks, so every rank must call this together.
        The other tensors are the live ones: ``Checkpointer.save`` copies
        them."""
        state = self._ensure_state()
        tensors = state.module.state_dict()
        names = {n for n, _ in state.module.named_parameters()}
        payload = {
            "params": {k: v for k, v in tensors.items() if k in names},
            "model_state": {k: v for k, v in tensors.items()
                            if k not in names},
            "opt_state": state.optimizer.state_dict(),
            "step": state.step}
        if state.exchange_residual is not None:
            payload["exchange_residual"] = dict(zip(
                names_in_order(state.module),
                gather_rows(state.exchange_residual)))
        if epoch is not None:
            payload["epoch"] = int(epoch)
        return payload

    def adopt_restored_state(self, payload: dict) -> TrainState:
        """Load a checkpoint payload (:meth:`checkpoint_payload`'s form,
        tensors anywhere) into the module and the optimizer on this
        rank's device, in place: the optimizer keeps its parameters.  Each
        rank takes its own row of a saved error-feedback residual."""
        state = self._ensure_state()
        saved = payload.get("exchange_residual")
        if (saved is None) != (state.exchange_residual is None):
            raise ValueError(
                "checkpoint and config disagree on error feedback: the "
                "payload " + ("lacks" if saved is None else "holds")
                + " an exchange_residual and exchange_error_feedback is "
                + str(self.config.exchange_error_feedback))
        state.module.load_state_dict({**payload["params"],
                                      **payload["model_state"]})
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        if saved is not None:
            for name, r in zip(names_in_order(state.module),
                               state.exchange_residual):
                rows = saved[name]
                if rows.shape != (self.n_workers,) + tuple(r.shape):
                    raise ValueError(
                        f"exchange_residual[{name!r}] has shape "
                        f"{tuple(rows.shape)}; this run needs "
                        f"{(self.n_workers,) + tuple(r.shape)}")
                r.copy_(rows[self.rank])
        return state

    # -- npz parameter snapshots ---------------------------------------------

    @property
    def params(self) -> dict:
        """The parameters as the JAX model's flax ``params`` tree: nested
        dicts of f32 numpy arrays, flax names and layouts (models/bridge.py;
        a BN-free zoo member's conv biases where ``config.bn_act_impl``
        puts them)."""
        from theanompi_tpu_torch.models.bridge import flax_params

        return flax_params(self.module,
                           fused=self.config.bn_act_impl == "pallas")

    def save(self, path: str | None = None) -> str:
        """Write :attr:`params` as the JAX package's npz snapshot (default
        ``<snapshot_dir>/<name>_params.npz``); returns the path."""
        path = path or os.path.join(self.config.snapshot_dir,
                                    f"{self.name}_params.npz")
        save_params_npz(path, self.params)
        return path

    def load(self, path: str) -> None:
        """Replace the parameters in place from an npz snapshot of either
        package (shapes checked, cast to f32): the BN running statistics
        and the optimizer state stay as they are, as JAX's
        ``state.replace(params=...)`` leaves them."""
        self._load_params(self.module,
                          load_params_npz(path, self.params))

    @staticmethod
    def _load_params(module: nn.Module, params: dict) -> None:
        """Copy a flax ``params`` tree into ``module``'s parameters."""
        from theanompi_tpu_torch.models.bridge import module_params_from_flax

        tensors = module_params_from_flax(module, params)
        res = module.load_state_dict(tensors, strict=False)
        names = {n for n, _ in module.named_parameters()}
        if res.unexpected_keys or names & set(res.missing_keys):
            raise KeyError(f"snapshot does not cover the parameters: "
                           f"{res.unexpected_keys or res.missing_keys}")

    def compile_grad_fn(self):
        """``fn(state, batch, rng) -> (grads, new_model_state, metrics)``:
        one train-mode forward and backward with no update (the JAX
        ``compile_grad_fn`` for parameter-server rules).  ``grads`` and
        ``new_model_state`` map parameter and buffer names to new tensors;
        the live state is left as it was (its running statistics and
        gradients restored, the module's mode too)."""
        loss_fn = self.loss_fn

        def gstep(state, batch, rng):
            module = state.module
            params = list(module.parameters())
            buffers = dict(module.named_buffers())
            saved = {n: b.clone() for n, b in buffers.items()}
            grads_before = [p.grad for p in params]
            was_training = module.training
            for p in params:
                p.grad = None
            module.train()
            try:
                metrics = grad_and_metrics(loss_fn, module, batch, rng)
                zero_missing_grads(params)
                grads = {n: p.grad for n, p in module.named_parameters()}
                new_ms = {n: b.clone() for n, b in buffers.items()}
            finally:
                with torch.no_grad():
                    for n, b in buffers.items():
                        b.copy_(saved[n])
                for p, g in zip(params, grads_before):
                    p.grad = g
                module.train(was_training)
            return grads, new_ms, metrics

        return gstep

    def loss_fn(self, module: nn.Module, batch, rng):
        """Softmax CE (with the config's label smoothing) + top-1 error;
        the dataset's ``device_transform`` crops, mirrors and normalizes
        raw uint8 batches on the device first.  ``rng`` (the epoch's
        generator, :meth:`_epoch_rng`) feeds the augment draws and then
        the module's own (dropout masks), so a run replays both.  A
        module with auxiliary heads (GoogLeNet) returns ``(main, (aux,
        weight), ...)`` in training: the loss is ``CE(main) + sum(weight
        * CE(aux))``, each smoothed, and the metrics are ``main``'s."""
        x, y = batch
        transform = getattr(self.data, "device_transform", None)
        if transform is not None:
            x = transform(x, rng, train=True)
        logits = module(x, train=True, rng=rng)
        smooth = self.config.label_smoothing
        if isinstance(logits, tuple):
            logits, *aux = logits
            loss = softmax_cross_entropy(logits, y, smooth)
            for aux_logits, weight in aux:
                loss = loss + weight * softmax_cross_entropy(aux_logits, y,
                                                             smooth)
        else:
            loss = softmax_cross_entropy(logits, y, smooth)
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
        if isinstance(logits, tuple):
            logits = logits[0]
        metrics = {"loss": softmax_cross_entropy(logits, y),
                   "error": error_rate(logits, y)}
        if self.config.track_top5:
            metrics["top5_error"] = topk_error(logits, y, 5)
        return metrics

    # -- reference contract --------------------------------------------------

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        """Build the BSP train and eval steps (``sync_type`` 'avg'
        averages the exchanged gradients, 'cdd' sums them), the stacked
        cadence's step when one is set, and put the module in train mode.
        ``sync_bn`` was threaded into the BNs when the module was built;
        with it off, a per-rank batch under 16 on a BN network warns (JAX's
        rule).  Raises on the knobs the port has not taken over yet (ZeRO,
        FSDP), and on ``sync_bn`` with FSDP, as JAX does."""
        cfg = self.config
        if cfg.fsdp_sharding and cfg.sync_bn:
            raise ValueError(
                "sync_bn needs a shard_map step with a named 'data' "
                "axis; the FSDP step is GSPMD-jitted with no named "
                "axes — use per-shard BN (sync_bn=False) with FSDP")
        for knob in ("zero_sharding", "fsdp_sharding"):
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"ModelConfig.{knob} is not ported yet (ROADMAP.md "
                    "section A, item 13)")
        if cfg.steps_per_call > 1 and cfg.grad_accum_steps > 1:
            raise ValueError(
                "steps_per_call and grad_accum_steps are both stacked-"
                "batch cadences; combining them by nesting is not "
                "supported — set one of them to 1")
        if self.uses_batchnorm and not cfg.sync_bn and self.batch_size < 16:
            warnings.warn(
                f"{type(self).__name__}: per-rank batch {self.batch_size} "
                "with sync_bn=False gives BatchNorm running statistics "
                "too noisy to serve eval; set ModelConfig.sync_bn=True "
                "(cross-rank statistics) or raise batch_size",
                stacklevel=2)
        exchanger = BSP_Exchanger(
            strategy=cfg.exchange_strategy, avg=(sync_type != "cdd"),
            exchange_what=cfg.exchange_what,
            exchange_dtype=(None if cfg.exchange_dtype == "f32"
                            else cfg.exchange_dtype),
            error_feedback=cfg.exchange_error_feedback,
            exchange_buckets=cfg.exchange_buckets)
        self._ensure_state()
        self.exchanger = exchanger
        self.train_step = make_bsp_train_step(self.loss_fn, exchanger)
        self.train_step_multi = (
            make_bsp_multi_step(self.loss_fn, exchanger)
            if cfg.steps_per_call > 1 else None)
        self.train_step_accum = (
            make_bsp_accum_step(self.loss_fn, exchanger)
            if cfg.grad_accum_steps > 1 else None)
        self.eval_step = make_bsp_eval_step(self.eval_fn)
        self.module.train()

    def _epoch_rng(self, epoch: int) -> torch.Generator:
        """The random stream of ``epoch`` on this rank (augment draws,
        then dropout masks): a generator on the device seeded from
        (seed, epoch, rank), so a run replays the same draws epoch by
        epoch."""
        seed = ((self.config.seed + 1) * 1_000_003 + 7919 * epoch
                + 104729 * self.rank)
        return torch.Generator(device=self.device).manual_seed(seed)

    def begin_epoch(self, epoch: int) -> int:
        """Start the epoch's prefetched train stream (this rank's block
        of every global batch); returns the number of iterations,
        rounded down to a multiple of the stacked cadence
        (``max(steps_per_call, grad_accum_steps)``); an epoch shorter
        than one stack raises."""
        self.cleanup_iter()
        self.current_epoch = epoch
        self._rng = self._epoch_rng(epoch)
        if self.n_workers > 1:
            host_iter = self.data.host_train_batches(
                epoch, self.global_batch, self.rank, self.n_workers)
        else:
            host_iter = self.data.train_batches(epoch, self.global_batch)
        n_iters = self.data.n_train_batches_for(epoch, self.global_batch)
        stack = max(self.config.steps_per_call,
                    self.config.grad_accum_steps)
        if stack > 1:
            n_iters -= n_iters % stack
            if n_iters == 0:
                raise ValueError(
                    f"the epoch has fewer iterations than the stacked "
                    f"cadence ({stack} = max(steps_per_call, "
                    f"grad_accum_steps)) — every epoch would train "
                    f"NOTHING; shrink the stack or grow the dataset/"
                    f"batch ratio")
        self._train_prefetcher = DevicePrefetcher(host_iter, self.device)
        self._train_iter = iter(self._train_prefetcher)
        return n_iters

    def train_iter(self, count: int, recorder: Recorder) -> int:
        """One training dispatch; returns the iterations it covered
        (``steps_per_call`` k steps on k batches, ``grad_accum_steps`` one
        update from that many microbatches, else 1)."""
        if self.train_step is None:
            raise RuntimeError("call compile_iter_fns() first")
        # the cadences exclude each other: at most one of k, a exceeds 1
        k, a = self.config.steps_per_call, self.config.grad_accum_steps
        consumed = max(k, a)
        recorder.start()
        batches = [next(self._train_iter) for _ in range(consumed)]
        recorder.end("wait")  # time blocked on the loader
        recorder.start()
        if k > 1:
            metrics = self.train_step_multi(self.state, batches, self._rng)
        elif a > 1:
            metrics = self.train_step_accum(self.state, batches, self._rng)
        else:
            metrics = self.train_step(self.state, batches[0], self._rng)
        recorder.end("calc")  # enqueue; device time lands on the flush
        self._pending.append((count, metrics))
        window = recorder.print_freq if recorder.print_freq > 0 else 50
        if len(self._pending) * consumed >= window:
            self._flush_metrics(recorder)
            recorder.print_train_info(count)
        return consumed

    def _flush_metrics(self, recorder: Recorder) -> None:
        """Bring the pending steps' metrics to the host in ONE copy
        (which waits for the card: charged to 'calc').  A steps_per_call
        entry holds one metric per sub-step, each recorded over the
        global batch; an accumulated entry covers ``grad_accum_steps``
        global batches of images."""
        if not self._pending:
            return
        recorder.start()
        host = torch.cat([torch.stack([m["loss"].reshape(-1),
                                       m["error"].reshape(-1)], 1)
                          for _, m in self._pending]).cpu().numpy()
        per_row = self.global_batch * self.config.grad_accum_steps
        for loss, err in host:
            recorder.train_metrics(float(loss), float(err), per_row)
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
        self.val_batches_run = len(pending)
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
