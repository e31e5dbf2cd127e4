"""Wasserstein GAN: a DCGAN-shaped generator and critic trained with the
WGAN recipe (RMSprop, ``n_critic`` critic updates per generator update,
the critic's weights clipped to ``[-c, c]``).

Counterpart of ``theanompi_tpu/models/wasserstein_gan.py``.  JAX runs the
whole round as one jitted SPMD program; here each rank runs it eagerly on
its block of the global batch:

1. the rank's ``n_critic * b`` real rows are split into ``n_critic``
   slices of ``b``; for each slice the critic loss ``mean f(G(z)) -
   mean f(x)`` is differentiated with respect to the critic alone, the
   gradients are exchanged (``BSP_Exchanger(strategy, avg=(sync_type !=
   'cdd'), exchange_what='grads', exchange_dtype)``), the critic's
   RMSprop steps and its weights are clipped;
2. one generator step: ``-mean f(G(z))`` differentiated with respect to
   the generator, exchanged, RMSprop;
3. the metrics ``{"loss": -(last critic loss), "error": generator
   loss}`` (the Wasserstein estimate and the generator loss) are
   averaged over the ranks.

The two optimizers are the port's ``RMSprop`` at ``optax.rmsprop(lr)``'s
defaults (decay 0.9, eps 1e-8, no momentum, no weight decay), whatever
the config's ``rmsprop_decay``, as JAX builds them.  The noise ``z`` is
drawn from the epoch's generator on the card (``n_critic`` draws of ``(b,
latent_dim)``, then one), distinct per rank; JAX draws it from its step
key, so the two packages' draws differ, and the round takes explicit
noise (``noise=``) where they must agree.  ``module`` is an
``nn.ModuleDict`` of ``generator`` and ``critic``, whose flax-named
parameters are JAX's ``{"generator": ..., "critic": ...}`` tree (the npz
``save``/``load`` and ``params``).  The checkpoint payload carries JAX's
``WGANState`` field names: ``step``, ``gen_params``, ``gen_opt``,
``critic_params``, ``critic_opt``.

As in JAX the round refuses gradient accumulation, ZeRO, FSDP, error
feedback and exchange buckets, and ignores ``exchange_what`` (it always
exchanges gradients) and ``sync_bn`` (no BN).  ``steps_per_call > 1``
raises: JAX builds no stacked WGAN step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from theanompi_tpu_torch.data.cifar10 import Cifar10_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel
from theanompi_tpu_torch.parallel.bsp import mean_metrics
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.utils.helper_funcs import RMSprop
from theanompi_tpu_torch.utils.recorder import Recorder

#: the N(0, std^2) init of every weight of both networks
INIT_STD = 0.02


class Generator(nn.Module):
    """z -> 32x32x3 image in [-1, 1]: a dense layer to 4x4x(2 width),
    relu, then three 4x4/2 SAME transposed convs (4 -> 8 -> 16 -> 32,
    relu between), tanh; computed in ``dtype``, f32 out."""

    def __init__(self, width: int = 128, latent_dim: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width = width
        self.dtype = dtype
        init = L.gaussian_init(INIT_STD)
        self.Dense_0 = L.Dense(latent_dim, 4 * 4 * width * 2, dtype, init,
                               L.constant_init(0.0))
        for i, (cin, cout) in enumerate(((width * 2, width * 2),
                                         (width * 2, width), (width, 3))):
            setattr(self, f"ConvTranspose_{i}", L.ConvTranspose(
                cin, cout, (4, 4), (2, 2), "SAME", dtype, kernel_init=init,
                bias_init=L.constant_init(0.0)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Dense_0(z.to(self.dtype)))
        x = x.reshape(x.shape[0], 4, 4, self.width * 2)
        x = torch.relu(self.ConvTranspose_0(x))
        x = torch.relu(self.ConvTranspose_1(x))
        return torch.tanh(self.ConvTranspose_2(x)).float()


class Critic(nn.Module):
    """32x32x3 image -> scalar score (no sigmoid): three 4x4/2 SAME convs
    (width/2, width, 2 width; leaky relu 0.2), flattened in (H, W, C)
    order, a dense layer to one; computed in ``dtype``, f32 out."""

    def __init__(self, width: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        init = L.gaussian_init(INIT_STD)
        cin = 3
        for i, w in enumerate((width // 2, width, width * 2)):
            setattr(self, f"Conv_{i}", L.Conv(
                cin, w, (4, 4), (2, 2), "SAME", dtype, bias=True,
                kernel_init=init, bias_init=L.constant_init(0.0)))
            cin = w
        self.Dense_0 = L.Dense(4 * 4 * cin, 1, dtype, init,
                               L.constant_init(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"Conv_{i}")(x), 0.2)
        return self.Dense_0(x.reshape(x.shape[0], -1)).float()[:, 0]


class WGANCifar_data(Cifar10_data):
    """CIFAR images scaled to the generator's tanh range [-1, 1]:
    ``((px / 255) - 0.5) / 0.5``, augmented on the host (JAX's
    ``WGANCifar_data``)."""

    mean = (0.5, 0.5, 0.5)
    std = (0.5, 0.5, 0.5)


@torch.no_grad()
def clip_params(module: nn.Module, c: float) -> None:
    """The WGAN weight clip, in place: every parameter into ``[-c, c]``."""
    for p in module.parameters():
        p.clamp_(-c, c)


@dataclasses.dataclass
class WGANState:
    """What a round updates: both networks (``module["generator"]``,
    ``module["critic"]``), their optimizers and the round count (JAX's
    ``WGANState``)."""

    module: nn.ModuleDict
    gen_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    step: int = 0


class Wasserstein_GAN(TorchModel):
    """WGAN over CIFAR-shaped images, BSP data parallel (module
    docstring).  Both networks are built at ``2 * width`` (128 by
    default, JAX's); ``data`` passes a ready dataset instead of
    ``WGANCifar_data``."""

    name = "wgan"
    latent_dim = 100
    n_critic = 5
    clip_c = 0.01

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", data=None,
                 width: int = 64):
        self._net_cfg = {"width": int(width)}
        super().__init__(config, device, data=data)
        # each round takes a fresh real slice per critic update
        self.global_batch = self.batch_size * self.n_workers * self.n_critic
        self._val_rng: torch.Generator | None = None

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig(batch_size=64, n_epochs=50, learning_rate=5e-5,
                           momentum=0.0, weight_decay=0.0,
                           lr_schedule="constant", print_freq=20)

    def build_module(self) -> nn.ModuleDict:
        width, dtype = 2 * self._net_cfg["width"], self._compute_dtype()
        return nn.ModuleDict({
            "generator": Generator(width, self.latent_dim, dtype),
            "critic": Critic(width, dtype)})

    def build_data(self) -> WGANCifar_data:
        return WGANCifar_data(data_dir=self.config.data_dir,
                              seed=self.config.seed)

    def init_weights(self, module: nn.ModuleDict,
                     gen: torch.Generator) -> None:
        """N(0, 0.02^2) weights, zero biases, the critic clipped."""
        L.init_params(module, gen)
        clip_params(module["critic"], self.clip_c)

    def _ensure_state(self) -> WGANState:
        if self.state is None:
            self.state = WGANState(
                self.module,
                RMSprop(self.module["generator"].parameters(), self._base_lr),
                RMSprop(self.module["critic"].parameters(), self._base_lr))
        return self.state

    # -- the round -----------------------------------------------------------

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        cfg, kind = self.config, "WGAN round step"
        if cfg.steps_per_call > 1:
            raise ValueError(f"steps_per_call>1 is not implemented for the "
                             f"{kind}")
        if cfg.grad_accum_steps > 1:
            raise ValueError(f"grad_accum_steps>1 is not implemented for "
                             f"the {kind}")
        for knob, on in (("zero_sharding", cfg.zero_sharding),
                         ("fsdp_sharding", cfg.fsdp_sharding),
                         ("exchange_error_feedback",
                          cfg.exchange_error_feedback),
                         ("exchange_buckets", cfg.exchange_buckets != 1)):
            if on:
                raise ValueError(f"{knob} is not implemented for the {kind}")
        self.exchanger = BSP_Exchanger(
            strategy=cfg.exchange_strategy, avg=(sync_type != "cdd"),
            exchange_what="grads",
            exchange_dtype=(None if cfg.exchange_dtype == "f32"
                            else cfg.exchange_dtype))
        self._ensure_state()
        self.train_step = self.round
        self.eval_step = self.evaluate
        self.module.train()

    def _update(self, opt: torch.optim.Optimizer, params: list,
                loss: torch.Tensor) -> None:
        """Gradients of ``loss`` with respect to ``params`` alone,
        exchanged, then one step of ``opt``."""
        grads = list(torch.autograd.grad(loss, params))
        self.exchanger.exchange(grads)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None

    def round(self, state: WGANState, batch, rng: torch.Generator | None,
              noise: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> dict:
        """One WGAN round on this rank's rows (module docstring).
        ``noise``: ``(z of the critic updates (n_critic, b, latent_dim),
        z of the generator update (b, latent_dim))`` instead of draws
        from ``rng``."""
        gen, critic = state.module["generator"], state.module["critic"]
        x_real = batch[0]
        n = self.n_critic
        b = x_real.shape[0] // n
        slices = x_real[:b * n].reshape((n, b) + tuple(x_real.shape[1:]))
        if noise is None:
            z = torch.randn((n + 1, b, self.latent_dim), generator=rng,
                            device=x_real.device)
            noise = (z[:n], z[n])
        z_critic, z_gen = noise
        c_params, g_params = list(critic.parameters()), list(
            gen.parameters())
        for i in range(n):
            with torch.no_grad():
                x_fake = gen(z_critic[i])
            c_loss = critic(x_fake).mean() - critic(slices[i]).mean()
            self._update(state.critic_opt, c_params, c_loss)
            clip_params(critic, self.clip_c)
        g_loss = -critic(gen(z_gen)).mean()
        self._update(state.gen_opt, g_params, g_loss)
        state.step += 1
        return mean_metrics({"loss": -c_loss.detach(),
                             "error": g_loss.detach()})

    @torch.no_grad()
    def evaluate(self, state: WGANState, batch,
                 rng: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> dict:
        """The Wasserstein estimate ``mean f(x) - mean f(G(z))`` on this
        rank's rows, ``z`` one draw per row (or ``noise``), averaged over
        the ranks; ``error`` is 0 (JAX's eval step)."""
        gen, critic = state.module["generator"], state.module["critic"]
        x_real = batch[0]
        z = noise if noise is not None else torch.randn(
            (x_real.shape[0], self.latent_dim), generator=rng,
            device=x_real.device)
        w = critic(x_real).mean() - critic(gen(z)).mean()
        return mean_metrics({"loss": w, "error": torch.zeros_like(w)})

    def val_epoch(self, recorder: Recorder) -> dict[str, float]:
        """A validation pass whose noise comes from a generator of its
        own, seeded from (seed, epoch, rank)."""
        seed = ((self.config.seed + 1) * 1_000_003 + 7919 * self.current_epoch
                + 104729 * self.rank + 31337)
        self._val_rng = torch.Generator(device=self.device).manual_seed(seed)
        return super().val_epoch(recorder)

    def val_iter(self, count: int, recorder: Recorder, batch=None) -> dict:
        recorder.start()
        metrics = self.eval_step(self.state, batch, self._val_rng)
        recorder.end("calc")
        return metrics

    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` generator samples (N, 32, 32, 3) from ``z`` drawn on the
        CPU from ``seed``."""
        z = torch.randn((n, self.latent_dim),
                        generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return self.module["generator"](z.to(self.device)).cpu().numpy()

    def adjust_hyperp(self, epoch: int) -> float:
        return self._base_lr  # constant RMSprop LR (the WGAN recipe)

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_payload(self, epoch: int | None = None) -> dict:
        """JAX's ``WGANState`` fields: ``step``, ``gen_params``,
        ``gen_opt``, ``critic_params``, ``critic_opt`` (each network's
        parameters by name, each optimizer's state dict), and ``epoch``
        when given.  The tensors are the live ones."""
        state = self._ensure_state()
        payload = {"step": state.step}
        for net, opt in (("gen", state.gen_opt),
                         ("critic", state.critic_opt)):
            module = state.module["generator" if net == "gen" else net]
            payload[f"{net}_params"] = dict(module.state_dict())
            payload[f"{net}_opt"] = opt.state_dict()
        if epoch is not None:
            payload["epoch"] = int(epoch)
        return payload

    def adopt_restored_state(self, payload: dict) -> WGANState:
        """Load :meth:`checkpoint_payload`'s form into both networks and
        optimizers, in place."""
        state = self._ensure_state()
        for net, opt in (("gen", state.gen_opt),
                         ("critic", state.critic_opt)):
            module = state.module["generator" if net == "gen" else net]
            module.load_state_dict(payload[f"{net}_params"])
            opt.load_state_dict(payload[f"{net}_opt"])
        state.step = int(payload["step"])
        return state
