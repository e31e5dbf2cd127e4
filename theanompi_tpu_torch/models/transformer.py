"""Causal transformer LM trained BSP under plain data parallelism.

Counterpart of ``theanompi_tpu/models/transformer.py`` (``Block``,
``TransformerLMNet``, ``TransformerLM``).  Each block is pre-LN:
LayerNorm, three bias-free projections q/k/v to (B, T, H, D), causal
attention through the fused K4a/K4b kernels (ops/attention.py), a
bias-free output projection added to the residual, then LayerNorm, an
MLP of width 4*d_model with tanh-GELU, added to the residual.  The token
embedding plus the f32 positional slice is summed in f32 and cast to the
compute dtype, so the residual stream is bf16 under the recipe; the
logits come back in f32.  Master weights are f32; every layer computes in
the compute dtype, as its flax counterpart with ``dtype=...``.

Module attribute names follow the flax scopes (``Embed_0``, ``pos_emb``,
``Block_i/{LayerNorm_0, q_proj, ...}``, ``LayerNorm_0``, ``Dense_0``), so
the weight bridge (models/bridge.py) is mechanical.

On one card, or any pure data-parallel group, the JAX model resolves its
``seq`` axis to None and every block calls ``fused_attention`` directly:
that is the path ported here.  Sequence parallelism (ring, all-gather and
Ulysses attention), the tensor-, pipeline- and expert-parallel variants
and ``remat`` raise: they are ROADMAP.md section A, item 18.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_tpu_torch.data.lm import SeqLM_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel
from theanompi_tpu_torch.ops.attention import fused_attention

#: parameters applied as gathers or adds, not per-token matmuls: the
#: standard 6N count leaves them out, as the JAX ``_NON_MATMUL_KEYS``
_NON_MATMUL_NAMES = ("embedding", "pos_emb")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md section A, item 18)")


def _lm_train_flops(module: nn.Module, n_layers: int, seq_len: int,
                    d_model: int) -> float:
    """Trained FLOPs per sample (one sequence), as the JAX
    ``_lm_train_flops``: 6 per trained token per matmul-applied parameter
    (embedding and positional tables excluded) plus the attention term
    12 * n_layers * L^2 * d."""
    active = sum(p.numel() for name, p in module.named_parameters()
                 if name.rsplit(".", 1)[-1] not in _NON_MATMUL_NAMES)
    return float(6 * active * seq_len
                 + 12 * n_layers * seq_len * seq_len * d_model)


def sequence_attention(*args, **kwargs):
    """Ring, all-gather and Ulysses attention over a ``seq`` axis."""
    raise _not_ported("sequence_attention (sequence parallelism)")


class Block(nn.Module):
    """Pre-LN transformer block (module docstring); causal attention over
    the whole local sequence."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"n_heads {n_heads} must divide d_model "
                             f"{d_model}")
        self.d_model, self.n_heads = d_model, n_heads
        self.LayerNorm_0 = L.LayerNorm(d_model, dtype)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, L.Dense(d_model, d_model, dtype,
                                        L.xavier_uniform(), use_bias=False))
        self.LayerNorm_1 = L.LayerNorm(d_model, dtype)
        self.mlp_up = L.Dense(d_model, 4 * d_model, dtype, L.he_normal(),
                              L.constant_init(0.0))
        self.mlp_down = L.Dense(4 * d_model, d_model, dtype,
                                L.xavier_uniform(), L.constant_init(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        shape = (b, t, self.n_heads, self.d_model // self.n_heads)
        h = self.LayerNorm_0(x)
        q = self.q_proj(h).reshape(shape)
        k = self.k_proj(h).reshape(shape)
        v = self.v_proj(h).reshape(shape)
        o = fused_attention(q, k, v, causal=True).reshape(b, t, self.d_model)
        x = x + self.o_proj(o)
        h = L.gelu(self.mlp_up(self.LayerNorm_1(x)))
        return x + self.mlp_down(h)


class TransformerLMNet(nn.Module):
    """Token ids (B, T) -> f32 logits (B, T, vocab).  The positional
    table holds ``max(2048, seq_len)`` rows, as the JAX model's
    ``max_len``."""

    def __init__(self, vocab: int = 256, n_layers: int = 2,
                 d_model: int = 128, n_heads: int = 4, seq_len: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.max_len = max_len = max(2048, seq_len)
        self.Embed_0 = L.Embed(vocab, d_model)
        self.pos_emb = nn.Parameter(torch.empty(max_len, d_model))
        self.blocks = nn.ModuleList(Block(d_model, n_heads, dtype)
                                    for _ in range(n_layers))
        self.LayerNorm_0 = L.LayerNorm(d_model, dtype)
        self.Dense_0 = L.Dense(d_model, vocab, dtype, L.xavier_uniform(),
                               L.constant_init(0.0))

    def forward(self, tokens: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits of ``tokens``; ``train`` must agree with the module's
        mode (the net has no dropout, so ``rng`` is unused)."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence of {t} tokens exceeds max_len "
                             f"{self.max_len}")
        x = self.Embed_0(tokens) + self.pos_emb[:t][None]
        x = x.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.Dense_0(self.LayerNorm_0(x)).float()


class TransformerLM(TorchModel):
    """The LM trained (BSP) on a pure data-parallel group; reference model
    contract.  ``data`` passes a ready ``SeqLM_data`` instead of the one
    built from the dims and the config's seed."""

    name = "transformer_lm"

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig(batch_size=16, n_epochs=5, learning_rate=0.1,
                           momentum=0.9, weight_decay=0.0,
                           lr_schedule="constant", print_freq=20)

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", vocab: int = 256,
                 seq_len: int = 128, n_layers: int = 2, d_model: int = 128,
                 n_heads: int = 4, data: SeqLM_data | None = None,
                 shard_rank: int = 0, shard_size: int = 1):
        if (config or self.default_config()).remat:
            raise _not_ported("ModelConfig.remat")
        self._net_cfg = dict(vocab=int(vocab), seq_len=int(seq_len),
                             n_layers=int(n_layers), d_model=int(d_model),
                             n_heads=int(n_heads))
        super().__init__(config, device, data=data, shard_rank=shard_rank,
                         shard_size=shard_size)
        self.train_flops_per_sample = _lm_train_flops(
            self.module, n_layers, seq_len, d_model)

    def _input_dtype(self) -> torch.dtype:
        return torch.int32

    def build_data(self) -> SeqLM_data:
        c = self._net_cfg
        return SeqLM_data(vocab=c["vocab"], seq_len=c["seq_len"],
                          seed=self.config.seed)

    def build_module(self) -> TransformerLMNet:
        return TransformerLMNet(**self._net_cfg, dtype=self._compute_dtype())

    def init_weights(self, module: TransformerLMNet,
                     gen: torch.Generator) -> None:
        """flax's inits: N(0, 0.02^2) token and positional tables, xavier
        projections, he-normal (truncated) MLP up, zero biases, unit
        LayerNorm scales."""
        L.init_params(module, gen)
        with torch.no_grad():
            module.pos_emb.normal_(0.0, 0.02, generator=gen)

    def _logits_and_targets(self, module, batch, train: bool):
        tokens, targets = batch
        logits = module(tokens, train=train)
        v = logits.shape[-1]
        return logits.reshape(-1, v), targets.reshape(-1)

    def loss_fn(self, module: nn.Module, batch, rng):
        """Mean token CE over the flattened (B*T, V) logits (with the
        config's label smoothing) and the top-1 token error."""
        logits, targets = self._logits_and_targets(module, batch, True)
        loss = L.softmax_cross_entropy(logits, targets,
                                       self.config.label_smoothing)
        return loss, {"loss": loss.detach(),
                      "error": L.error_rate(logits.detach(), targets)}

    def eval_fn(self, module: nn.Module, batch) -> dict:
        logits, targets = self._logits_and_targets(module, batch, False)
        return {"loss": L.softmax_cross_entropy(logits, targets),
                "error": L.error_rate(logits, targets)}


class _Unported(TransformerLM):
    """A parallel variant of the JAX package that needs more than a pure
    data-parallel group."""

    def __init__(self, *args, **kwargs):
        raise _not_ported(type(self).__name__)


class TransformerLM_TP(_Unported):
    """Tensor-parallel LM (heads over a ``model`` axis)."""


class TransformerLM_PP(_Unported):
    """Pipeline-parallel LM (blocks over a ``pipe`` axis)."""


class TransformerLM_MoE(_Unported):
    """Mixture-of-experts LM (experts over an ``expert`` axis)."""
