"""The causal transformer LM family, over the five-axis mesh.

Counterpart of ``theanompi_tpu/models/transformer.py``.  Each block is
pre-LN: LayerNorm, three bias-free projections q/k/v to (B, T, H, D),
causal attention, a bias-free output projection added to the residual,
then LayerNorm, an MLP of width 4*d_model with tanh-GELU, added to the
residual.  The token embedding plus the f32 positional slice is summed
in f32 and cast to the compute dtype, so the residual stream is bf16
under the recipe; the logits come back in f32.  Master weights are f32;
every layer computes in the compute dtype, as its flax counterpart with
``dtype=...``.  Attention is the fused K4a/K4b kernels
(ops/attention.py) on every path but ring attention.

Module attribute names follow the flax scopes (``Embed_0``, ``pos_emb``,
``Block_i/{LayerNorm_0, q_proj, ...}``, ``LayerNorm_0``, ``Dense_0``), so
the weight bridge (models/bridge.py) is mechanical.

The variants (a ``mesh`` of parallel/mesh.py places them; without one,
or with every axis of degree 1, each runs on its rank alone):

* :class:`TransformerLM`: batch ``("data", "seq")``.  A ``seq`` axis
  above 1 cuts time: the positional slice is offset by ``seq.index *
  T_local`` and attention is :func:`~theanompi_tpu_torch.parallel.
  sequence.sequence_attention` (``sp_strategy``: ring, all-gather or
  Ulysses); a ``seq`` axis of 1 resolves to the fused local path
  (``_resolved_seq_axis``).  ``ModelConfig.remat`` checkpoints each
  block (``use_reentrant=False``), under the non-remat names.
* :class:`TransformerLM_TP`: batch ``("data",)``, heads and the MLP
  hidden width over ``model`` (parallel/tensor.py), K4 on the rank's
  ``H/tp`` heads.
* :class:`TransformerLM_PP`: the blocks over ``pipe`` (each stage owns
  ``n_layers/pipe`` of them), a GPipe schedule over ``n_microbatches``
  (parallel/pipeline.py); ``pos_emb`` is ``(seq_len, d)``.
* :class:`TransformerLM_MoE`: batch ``(("data", "expert"),)``, every
  FFN a top-1 switch over ``n_experts`` experts cut over ``expert``
  (parallel/expert.py), attention in :class:`AttnBlock`.

The TP, PP and MoE models keep only their shards: their checkpoint
payload, ``params`` and ``load`` gather and cut the whole tree over the
sharding group (:class:`_ShardedLM`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from theanompi_tpu_torch.data.lm import SeqLM_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig, TorchModel
from theanompi_tpu_torch.ops.attention import fused_attention
from theanompi_tpu_torch.parallel.bsp import TrainState, mean_metrics
from theanompi_tpu_torch.parallel.exchanger import (
    BSP_Exchanger,
    zero_missing_grads,
)
from theanompi_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    gather_named,
    local_named,
)
from theanompi_tpu_torch.parallel.sequence import sequence_attention
from theanompi_tpu_torch.parallel.tensor import (
    copy_to_model,
    reduce_from_model,
    transformer_tp_specs,
)

#: parameters applied as gathers or adds, not per-token matmuls: the
#: standard 6N count leaves them out, as the JAX ``_NON_MATMUL_KEYS``
_NON_MATMUL_NAMES = ("embedding", "pos_emb")


def _lm_train_flops(sizes, n_layers: int, seq_len: int, d_model: int,
                    expert_names=(), n_experts: int = 1) -> float:
    """Trained FLOPs per sample (one sequence), as the JAX
    ``_lm_train_flops``: 6 per trained token per matmul-applied parameter
    (embedding and positional tables excluded; a parameter of
    ``expert_names`` counts 1/``n_experts``, top-1 routing) plus the
    attention term 12 * n_layers * L^2 * d.  ``sizes``: a module, or
    ``{name: whole element count}``."""
    if isinstance(sizes, nn.Module):
        sizes = {n: p.numel() for n, p in sizes.named_parameters()}
    active = sum(k // (n_experts if name in expert_names else 1)
                 for name, k in sizes.items()
                 if name.rsplit(".", 1)[-1] not in _NON_MATMUL_NAMES)
    return float(6 * active * seq_len
                 + 12 * n_layers * seq_len * seq_len * d_model)


def _refuse(model: TorchModel, model_kind: str, steps: str | None,
            state_kind: str | None = None) -> None:
    """JAX's refusals for a family with its own step: its
    ``_reject_grad_accum(model_kind)`` and
    ``_reject_zero_sharding(state_kind or model_kind)`` texts, and
    ``steps_per_call`` where the family has no stacked step."""
    cfg = model.config
    if cfg.grad_accum_steps > 1:
        raise ValueError(f"grad_accum_steps>1 is not implemented for the "
                         f"{model_kind}")
    state_kind = state_kind or model_kind
    for knob in ("zero_sharding", "fsdp_sharding"):
        if getattr(cfg, knob):
            raise ValueError(f"{knob} is not implemented for the "
                             f"{state_kind}")
    if cfg.exchange_error_feedback:
        raise ValueError(f"exchange_error_feedback is not implemented "
                         f"for the {state_kind}")
    if cfg.exchange_buckets != 1:
        raise ValueError(f"exchange_buckets is not implemented for the "
                         f"{state_kind}")
    if steps is not None and cfg.steps_per_call > 1:
        raise ValueError(f"steps_per_call>1 is not implemented for the "
                         f"{steps} path")


class Block(nn.Module):
    """Pre-LN transformer block (module docstring).  With ``tp`` (the
    ``model`` axis' ``AxisGroup``) the rank holds its column block of
    q/k/v_proj and mlp_up and its row block of o_proj and mlp_down
    (parallel/tensor.py); ``forward(x, seq)`` cuts time over ``seq`` when
    given."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32, tp=None,
                 sp_strategy: str = "ring"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"n_heads {n_heads} must divide d_model "
                             f"{d_model}")
        n = 1 if tp is None else tp.size
        self.d_model, self.n_heads = d_model, n_heads
        self.tp, self.sp_strategy = tp, sp_strategy
        self.heads = n_heads // n
        d_local, ff_local = d_model // n, 4 * d_model // n
        self.LayerNorm_0 = L.LayerNorm(d_model, dtype)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, L.Dense(d_model, d_local, dtype,
                                        L.xavier_uniform(), use_bias=False))
        self.o_proj = L.Dense(d_local, d_model, dtype, L.xavier_uniform(),
                              use_bias=False)
        self.LayerNorm_1 = L.LayerNorm(d_model, dtype)
        self.mlp_up = L.Dense(d_model, ff_local, dtype, L.he_normal(),
                              L.constant_init(0.0))
        self.mlp_down = L.Dense(ff_local, d_model, dtype,
                                L.xavier_uniform(), L.constant_init(0.0))

    def forward(self, x: torch.Tensor, seq=None) -> torch.Tensor:
        b, t, _ = x.shape
        d_head = self.d_model // self.n_heads
        shape = (b, t, self.heads, d_head)
        tp = self.tp
        h = self.LayerNorm_0(x)
        if tp is not None:
            h = copy_to_model(h, tp)
        q = self.q_proj(h).reshape(shape)
        k = self.k_proj(h).reshape(shape)
        v = self.v_proj(h).reshape(shape)
        if seq is not None:
            o = sequence_attention(q, k, v, seq, causal=True,
                                   strategy=self.sp_strategy)
        else:
            o = fused_attention(q, k, v, causal=True)
        o = o.reshape(b, t, self.heads * d_head)
        if tp is None:
            x = x + self.o_proj(o)
            h = L.gelu(self.mlp_up(self.LayerNorm_1(x)))
            return x + self.mlp_down(h)
        x = x + reduce_from_model(self.o_proj(o), tp)
        h = L.gelu(self.mlp_up(copy_to_model(self.LayerNorm_1(x), tp)))
        down = self.mlp_down
        part = F.linear(h.to(down.dtype), down.weight.to(down.dtype))
        # the row-parallel bias is whole: added once, after the reduce
        return x + (reduce_from_model(part, tp) + down.bias.to(down.dtype))


class TransformerLMNet(nn.Module):
    """Token ids (B, T_local) -> f32 logits (B, T_local, vocab).  The
    positional table holds ``max(2048, seq_len)`` rows, as the JAX
    model's ``max_len``; ``forward(..., seq=...)`` offsets it by the
    rank's time block."""

    def __init__(self, vocab: int = 256, n_layers: int = 2,
                 d_model: int = 128, n_heads: int = 4, seq_len: int = 128,
                 dtype: torch.dtype = torch.float32,
                 sp_strategy: str = "ring", remat: bool = False, tp=None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.max_len = max_len = max(2048, seq_len)
        self.Embed_0 = L.Embed(vocab, d_model)
        self.pos_emb = nn.Parameter(torch.empty(max_len, d_model))
        self.blocks = nn.ModuleList(Block(d_model, n_heads, dtype, tp,
                                          sp_strategy)
                                    for _ in range(n_layers))
        self.LayerNorm_0 = L.LayerNorm(d_model, dtype)
        self.Dense_0 = L.Dense(d_model, vocab, dtype, L.xavier_uniform(),
                               L.constant_init(0.0))

    def forward(self, tokens: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None,
                seq=None) -> torch.Tensor:
        """Logits of ``tokens`` (this rank's time block under ``seq``);
        ``train`` must agree with the module's mode (the net has no
        dropout, so ``rng`` is unused)."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} "
                             "mode; call .train() or .eval() first")
        t = tokens.shape[1]
        offset = 0 if seq is None else seq.index * t
        if offset + t > self.max_len:
            raise ValueError(f"sequence of {offset + t} tokens exceeds "
                             f"max_len {self.max_len}")
        x = self.Embed_0(tokens) + self.pos_emb[offset:offset + t][None]
        x = x.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpoint(block, x, seq, use_reentrant=False) if remat
                 else block(x, seq))
        return self.Dense_0(self.LayerNorm_0(x)).float()


class TransformerLM(TorchModel):
    """The LM trained BSP over a (data x seq) mesh; reference model
    contract.  ``data`` passes a ready ``SeqLM_data`` instead of the one
    built from the dims and the config's seed."""

    name = "transformer_lm"
    sp_strategy = "ring"
    batch_partition = (AXIS_DATA, AXIS_SEQ)
    #: the axis time is cut over (None: whole sequences; TP sets None)
    seq_axis: str | None = AXIS_SEQ
    #: exports of this family may serve the decode path (decode/); the
    #: JAX package's flag, set on the same class
    decode_capable = True

    @classmethod
    def default_config(cls) -> ModelConfig:
        return ModelConfig(batch_size=16, n_epochs=5, learning_rate=0.1,
                           momentum=0.9, weight_decay=0.0,
                           lr_schedule="constant", print_freq=20)

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", vocab: int = 256,
                 seq_len: int = 128, n_layers: int = 2, d_model: int = 128,
                 n_heads: int = 4, data: SeqLM_data | None = None,
                 shard_rank: int = 0, shard_size: int = 1, mesh=None):
        self._net_cfg = dict(vocab=int(vocab), seq_len=int(seq_len),
                             n_layers=int(n_layers), d_model=int(d_model),
                             n_heads=int(n_heads))
        super().__init__(config, device, data=data, shard_rank=shard_rank,
                         shard_size=shard_size, mesh=mesh)
        self.train_flops_per_sample = _lm_train_flops(
            self._whole_sizes(), n_layers, seq_len, d_model)

    def _whole_sizes(self) -> dict:
        return {n: p.numel() for n, p in self.module.named_parameters()}

    def _input_dtype(self) -> torch.dtype:
        return torch.int32

    def _resolved_seq_axis(self):
        """The ``seq`` ``AxisGroup`` time is cut over, or None: a seq
        axis of one rank takes the fused local path (JAX's routing fix:
        ring attention over one block is the same math)."""
        if self.seq_axis is None or self.mesh is None:
            return None
        seq = self.mesh.axis(self.seq_axis)
        return None if seq.trivial else seq

    def _tp(self):
        return None

    def build_data(self) -> SeqLM_data:
        c = self._net_cfg
        return SeqLM_data(vocab=c["vocab"], seq_len=c["seq_len"],
                          seed=self.config.seed)

    def build_module(self) -> TransformerLMNet:
        return TransformerLMNet(**self._net_cfg, dtype=self._compute_dtype(),
                                sp_strategy=self.sp_strategy,
                                remat=self.config.remat, tp=self._tp())

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
        logits = module(tokens, train=train, seq=self._resolved_seq_axis())
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


class _ShardedLM:
    """The whole-tree views of a model that keeps only its shards: the
    placement of each parameter over the sharding group
    (``_placement(module)``: ``{name: (AxisGroup, dim or None)}``,
    mesh.py ``gather_named``), the whole names in order
    (``_whole_names()``), and the family's flax bridge.  Every rank calls
    these together.  The weights are drawn whole from the seed (the
    unsharded model's) and each rank keeps its shards."""

    def whole_state_dict(self) -> dict:
        """The whole model's parameters, gathered from every shard."""
        return gather_named(dict(self.module.named_parameters()),
                            self._placement(self.module),
                            self._whole_names())

    def load_whole_state_dict(self, whole: dict, module=None) -> None:
        """This rank's shards of ``whole`` into ``module`` (default: the
        model's)."""
        module = self.module if module is None else module
        names = [n for n, _ in module.named_parameters()]
        mine = local_named(whole, self._placement(module), names)
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(mine[n].to(p.device, p.dtype))

    @property
    def params(self) -> dict:
        from theanompi_tpu_torch.models.bridge import flax_from_state_dict

        return flax_from_state_dict(self.bridge_family,
                                    self.whole_state_dict())

    def load(self, path: str) -> None:
        from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree
        from theanompi_tpu_torch.utils.helper_funcs import load_params_npz

        tree = load_params_npz(path, self.params)
        self.load_whole_state_dict(state_dict_from_flax_tree(
            self.bridge_family, tree))

    def checkpoint_payload(self, epoch: int | None = None) -> dict:
        """The whole parameters by name, and the optimizer state of every
        rank of the sharding group (``opt_state['shards']``, by its index
        there): a resume takes its own, so it needs the same degrees."""
        state = self._ensure_state()
        axis = self.mesh_axis_of_shards()
        sd = state.optimizer.state_dict()
        if axis is None or axis.trivial:
            shards = [sd]
        else:
            cpu = {"state": {i: {k: v.detach().cpu() if torch.is_tensor(v)
                                 else v for k, v in per.items()}
                             for i, per in sd["state"].items()},
                   "param_groups": sd["param_groups"]}
            shards = [None] * axis.size
            dist.all_gather_object(shards, cpu, group=axis.group)
        payload = {"params": self.whole_state_dict(), "model_state": {},
                   "opt_state": {"shards": shards}, "step": state.step}
        if epoch is not None:
            payload["epoch"] = int(epoch)
        return payload

    def adopt_restored_state(self, payload: dict) -> TrainState:
        state = self._ensure_state()
        if payload.get("exchange_residual") is not None:
            raise ValueError("checkpoint holds an exchange_residual; this "
                             "model has no error feedback")
        self.load_whole_state_dict(payload["params"])
        shards = payload["opt_state"]["shards"]
        axis = self.mesh_axis_of_shards()
        n = 1 if axis is None else axis.size
        if len(shards) != n:
            raise ValueError(f"checkpoint holds {len(shards)} optimizer "
                             f"shards; this run's sharding group has {n}")
        state.optimizer.load_state_dict(
            shards[0 if axis is None else axis.index])
        state.step = int(payload["step"])
        return state


class TransformerLM_TP(_ShardedLM, TransformerLM):
    """Tensor-parallel LM over a (data x model) mesh: Megatron's column
    and row blocks with hand-written collectives (parallel/tensor.py).
    Attention runs on whole sequences (``seq_axis=None``), the rank's
    ``H/tp`` heads; the optimizer is built from the sharded parameters."""

    name = "transformer_lm_tp"
    batch_partition = (AXIS_DATA,)
    seq_axis = None
    bridge_family = "lm"

    def _tp(self):
        if self.mesh is None:
            return None
        tp = self.mesh.axis(AXIS_MODEL)
        c = self._net_cfg
        d_ff = 4 * c["d_model"]
        if c["n_heads"] % tp.size or d_ff % tp.size:
            raise ValueError(
                f"tensor parallelism {tp.size} must divide n_heads="
                f"{c['n_heads']} and d_ff={d_ff}: otherwise heads/hidden "
                "straddle shards and GSPMD silently inserts per-block "
                "reshards instead of the Megatron pattern")
        return tp

    def mesh_axis_of_shards(self):
        return None if self.mesh is None else self.mesh.axis(AXIS_MODEL)

    def init_weights(self, module, gen) -> None:
        whole = TransformerLMNet(**self._net_cfg)
        super().init_weights(whole, gen)
        self.load_whole_state_dict(whole.state_dict(), module)

    def _placement(self, module) -> dict:
        tp = self.mesh_axis_of_shards()
        return {n: (tp, d) for n, d in transformer_tp_specs(
            [n for n, _ in module.named_parameters()]).items()
            if d is not None}

    def _whole_names(self):
        return [n for n, _ in self.module.named_parameters()]

    def _whole_sizes(self) -> dict:
        tp = self.mesh_axis_of_shards()
        n = 1 if tp is None else tp.size
        specs = transformer_tp_specs(
            [k for k, _ in self.module.named_parameters()])
        return {k: p.numel() * (n if specs[k] is not None else 1)
                for k, p in self.module.named_parameters()}

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        """The BSP step over the ``data`` group (parallel/tensor.py's
        docstring: 'avg' and 'cdd' are JAX's ``grad_scale``), with JAX's
        refusals."""
        _refuse(self, "GSPMD tensor-parallel step", None,
                "GSPMD tensor-parallel step (its optimizer state is "
                "already sharded like the params)")
        super().compile_iter_fns(sync_type)


# -- the pipeline-parallel LM ----------------------------------------------


class PipelineLMNet(nn.Module):
    """One pipeline stage's view of the LM: the embedding, a ``(seq_len,
    d)`` positional table, this stage's blocks (``blocks.<layer>``, by
    the global layer index), the final norm ``ln_f`` and the head, the
    names of JAX's PP tree (``embed``, ``pos_emb``, stacked ``blocks``,
    ``ln_f``, ``head``).  Every stage holds the embedding and the head;
    only stage 0 and the last use them."""

    def __init__(self, vocab: int, layers, d_model: int, n_heads: int,
                 seq_len: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed = L.Embed(vocab, d_model)
        self.pos_emb = nn.Parameter(torch.empty(seq_len, d_model))
        self.blocks = nn.ModuleDict({str(i): Block(d_model, n_heads, dtype)
                                     for i in layers})
        self.ln_f = L.LayerNorm(d_model, dtype)
        self.head = L.Dense(d_model, vocab, dtype, L.xavier_uniform(),
                            L.constant_init(0.0))

    def inject(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens) + self.pos_emb[:tokens.shape[1]][None]
        return x.to(self.dtype)

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks.values():
            x = block(x)
        return x

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.head(self.ln_f(h)).float()


def _init_lm_tree(module, gen, pos_std: float = 0.02) -> None:
    L.init_params(module, gen)
    with torch.no_grad():
        module.pos_emb.normal_(0.0, pos_std, generator=gen)


class TransformerLM_PP(_ShardedLM, TorchModel):
    """Pipeline-parallel LM over a (data x pipe) mesh (GPipe, module
    docstring).  Each stage owns ``n_layers / pipe`` consecutive blocks;
    the embedding and head are replicated, their gradients summed over
    ``pipe``.  The weights are drawn whole from the seed and each stage
    keeps its blocks."""

    name = "transformer_lm_pp"
    batch_partition = (AXIS_DATA,)
    bridge_family = "pp"

    @classmethod
    def default_config(cls) -> ModelConfig:
        return TransformerLM.default_config()

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", vocab: int = 256,
                 seq_len: int = 128, n_layers: int = 4, d_model: int = 128,
                 n_heads: int = 4, n_microbatches: int = 4,
                 data: SeqLM_data | None = None, shard_rank: int = 0,
                 shard_size: int = 1, mesh=None):
        self._net_cfg = dict(vocab=int(vocab), seq_len=int(seq_len),
                             n_layers=int(n_layers), d_model=int(d_model),
                             n_heads=int(n_heads))
        self.n_microbatches = int(n_microbatches)
        self._pipe = None if mesh is None else mesh.axis(AXIS_PIPE)
        n_stages = 1 if self._pipe is None else self._pipe.size
        if n_layers % n_stages != 0:
            raise ValueError(f"n_layers={n_layers} not divisible by "
                             f"pipe={n_stages} stages")
        super().__init__(config, device, data=data, shard_rank=shard_rank,
                         shard_size=shard_size, mesh=mesh)
        if self.batch_size % self.n_microbatches != 0:
            raise ValueError(
                f"per-data-shard batch {self.batch_size} not divisible by "
                f"{self.n_microbatches} microbatches")
        self.train_flops_per_sample = _lm_train_flops(
            self._whole_sizes(), n_layers, seq_len, d_model)

    def _layers(self) -> range:
        n = self._net_cfg["n_layers"]
        s, k = ((0, 1) if self._pipe is None
                else (self._pipe.index, self._pipe.size))
        per = n // k
        return range(s * per, (s + 1) * per)

    def _input_dtype(self) -> torch.dtype:
        return torch.int32

    def build_data(self) -> SeqLM_data:
        c = self._net_cfg
        return SeqLM_data(vocab=c["vocab"], seq_len=c["seq_len"],
                          seed=self.config.seed)

    def _net(self, layers) -> PipelineLMNet:
        c = self._net_cfg
        return PipelineLMNet(c["vocab"], layers, c["d_model"], c["n_heads"],
                             c["seq_len"], self._compute_dtype())

    def build_module(self) -> PipelineLMNet:
        return self._net(self._layers())

    def init_weights(self, module, gen) -> None:
        whole = self._net(range(self._net_cfg["n_layers"]))
        _init_lm_tree(whole, gen)
        self.load_whole_state_dict(whole.state_dict(), module)

    def mesh_axis_of_shards(self):
        return self._pipe

    def _placement(self, module) -> dict:
        return {n: (self._pipe, None) for n, _ in module.named_parameters()
                if n.startswith("blocks.")}

    def _whole_names(self):
        return list(self._whole_sizes())

    def _whole_sizes(self) -> dict:
        """The whole net's parameter sizes by name, in its order, read
        off this stage's tree: its first block stands for every layer."""
        first = f"blocks.{self._layers()[0]}."
        own = [(n, p.numel()) for n, p in self.module.named_parameters()]
        block = [(n[len(first):], k) for n, k in own if n.startswith(first)]
        sizes = {}
        for n, k in own:
            if not n.startswith("blocks."):
                sizes[n] = k
            elif n == first + block[0][0]:
                for i in range(self._net_cfg["n_layers"]):
                    sizes.update((f"blocks.{i}.{b}", bk) for b, bk in block)
        return sizes

    def _act_shape(self, tokens) -> tuple:
        return (tokens.shape[0] // self.n_microbatches, tokens.shape[1],
                self._net_cfg["d_model"])

    def _head_loss(self, module, smooth: float):
        def head_loss(h, targets):
            logits = module.logits(h)
            v = logits.shape[-1]
            logits, targets = logits.reshape(-1, v), targets.reshape(-1)
            return (L.softmax_cross_entropy(logits, targets, smooth),
                    L.error_rate(logits.detach(), targets))
        return head_loss

    def loss_fn(self, module, batch, rng):
        """The GPipe forward and backward of this stage (gradients land in
        ``.grad``); returns the masked metrics (module docstring)."""
        from theanompi_tpu_torch.parallel.pipeline import (
            gpipe_forward_backward,
        )

        tokens, targets = batch
        return gpipe_forward_backward(
            module.inject, module.stage,
            self._head_loss(module, self.config.label_smoothing), tokens,
            targets, self._pipe, self.n_microbatches,
            self._act_shape(tokens), self._compute_dtype())

    def eval_fn(self, module, batch) -> dict:
        from theanompi_tpu_torch.parallel.pipeline import gpipe_forward

        tokens, targets = batch

        def head_metrics(h, targets):
            logits = module.logits(h)
            v = logits.shape[-1]
            logits, targets = logits.reshape(-1, v), targets.reshape(-1)
            return {"loss": L.softmax_cross_entropy(logits, targets),
                    "error": L.error_rate(logits, targets)}

        out = gpipe_forward(module.inject, module.stage, head_metrics,
                            tokens, targets, self._pipe, self.n_microbatches,
                            self._act_shape(tokens), self._compute_dtype())
        if out is None:
            z = torch.zeros((), device=tokens.device)
            out = {"loss": z, "error": z.clone()}
        return out

    def _masked_mean(self, metrics: dict) -> dict:
        """Metrics real on the last stage: summed over ``pipe``, then
        averaged over ``data``."""
        from theanompi_tpu_torch.parallel.pipeline import sum_over_pipe

        names = sorted(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(())
                               for k in names])
        sum_over_pipe([stacked], self._pipe)
        return mean_metrics(dict(zip(names, stacked.unbind())),
                            self._data_group())

    def _data_group(self):
        return None if self.mesh is None else self.mesh.axis(AXIS_DATA).group

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        from theanompi_tpu_torch.parallel.pipeline import sum_over_pipe

        _refuse(self, "pipeline/expert step", "pipeline-parallel")
        state = self._ensure_state()
        exchanger = BSP_Exchanger(avg=(sync_type != "cdd"),
                                  group=self._data_group())
        self.exchanger = exchanger
        module = state.module
        replicated = [p for n, p in module.named_parameters()
                      if not n.startswith("blocks.")]

        def step(state: TrainState, batch, rng) -> dict:
            state.optimizer.zero_grad(set_to_none=True)
            metrics = self.loss_fn(module, batch, rng)
            with torch.no_grad():
                zero_missing_grads(module.parameters())
                sum_over_pipe([p.grad for p in replicated], self._pipe)
                exchanger.exchange([p.grad for p in module.parameters()])
            state.optimizer.step()
            state.step += 1
            return self._masked_mean(metrics)

        def eval_step(state: TrainState, batch) -> dict:
            return self._masked_mean(self.eval_fn(module, batch))

        self.train_step, self.eval_step = step, eval_step
        self.train_step_multi = self.train_step_accum = None
        module.train()


# -- the mixture-of-experts LM ---------------------------------------------


class AttnBlock(nn.Module):
    """Pre-LN attention sublayer (LN + q/k/v/o + residual), the attention
    half of :class:`Block`, through K4."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.LayerNorm_0 = L.LayerNorm(d_model, dtype)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, L.Dense(d_model, d_model, dtype,
                                        L.xavier_uniform(), use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        shape = (b, t, self.n_heads, self.d_model // self.n_heads)
        h = self.LayerNorm_0(x)
        o = fused_attention(self.q_proj(h).reshape(shape),
                            self.k_proj(h).reshape(shape),
                            self.v_proj(h).reshape(shape), causal=True)
        return x + self.o_proj(o.reshape(b, t, self.d_model))


class ExpertStack(nn.Module):
    """The FFNs of ``n`` experts stacked on a leading axis, in JAX's
    layout: ``up_kernel`` (n, d, ff), ``up_bias`` (n, ff), ``down_kernel``
    (n, ff, d), ``down_bias`` (n, d), f32."""

    def __init__(self, n: int, d: int, ff: int):
        super().__init__()
        self.up_kernel = nn.Parameter(torch.empty(n, d, ff))
        self.up_bias = nn.Parameter(torch.zeros(n, ff))
        self.down_kernel = nn.Parameter(torch.empty(n, ff, d))
        self.down_bias = nn.Parameter(torch.zeros(n, d))


class MoELMNet(nn.Module):
    """The switch-MoE LM with the names of JAX's MoE tree: ``embed``,
    ``pos_emb`` (seq_len, d), per layer ``attn.<i>``, ``moe_ln.<i>``,
    ``router.<i>`` (d, E) and ``experts.<i>`` (this rank's E/ep experts),
    then ``ln_f`` and ``head``."""

    def __init__(self, vocab: int, n_layers: int, d_model: int,
                 n_heads: int, seq_len: int, n_experts: int,
                 dtype: torch.dtype = torch.float32,
                 capacity_factor: float = 1.25, ep=None):
        super().__init__()
        self.dtype, self.capacity_factor, self.ep = dtype, capacity_factor, ep
        d, n_local = d_model, n_experts // (1 if ep is None else ep.size)
        self.embed = L.Embed(vocab, d)
        self.pos_emb = nn.Parameter(torch.empty(seq_len, d))
        self.attn = nn.ModuleList(AttnBlock(d, n_heads, dtype)
                                  for _ in range(n_layers))
        self.moe_ln = nn.ModuleList(L.LayerNorm(d, dtype)
                                    for _ in range(n_layers))
        self.router = nn.ParameterList(
            nn.Parameter(torch.empty(d, n_experts)) for _ in range(n_layers))
        self.experts = nn.ModuleList(ExpertStack(n_local, d, 4 * d)
                                     for _ in range(n_layers))
        self.ln_f = L.LayerNorm(d, dtype)
        self.head = L.Dense(d, vocab, dtype, L.xavier_uniform(),
                            L.constant_init(0.0))

    def forward(self, tokens: torch.Tensor):
        """(f32 logits, summed aux loss)."""
        from theanompi_tpu_torch.parallel.expert import moe_ffn

        b, t = tokens.shape
        x = (self.embed(tokens) + self.pos_emb[:t][None]).to(self.dtype)
        aux_total = torch.zeros((), device=tokens.device)
        for attn, ln, router, experts in zip(self.attn, self.moe_ln,
                                             self.router, self.experts):
            x = attn(x)
            h = ln(x)
            out, aux = moe_ffn(h.reshape(b * t, -1), router,
                               dict(experts.named_parameters()),
                               self.capacity_factor, self.ep)
            x = x + out.reshape(x.shape)
            aux_total = aux_total + aux
        return self.head(self.ln_f(x)).float(), aux_total


class TransformerLM_MoE(_ShardedLM, TorchModel):
    """Switch-MoE LM over a (data x expert) mesh: the batch rides BOTH
    axes (the expert axis is data parallelism outside the MoE layers),
    so the workers, the global batch and the worker-scaled LR count
    ``data x ep``.  The loss is ``ce + aux_weight * aux / n_layers``."""

    name = "transformer_lm_moe"
    batch_partition = ((AXIS_DATA, AXIS_EXPERT),)
    bridge_family = "moe"

    @classmethod
    def default_config(cls) -> ModelConfig:
        return TransformerLM.default_config()

    def __init__(self, config: ModelConfig | None = None,
                 device: str | torch.device = "cuda", vocab: int = 256,
                 seq_len: int = 128, n_layers: int = 2, d_model: int = 128,
                 n_heads: int = 4, n_experts: int = 8,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01,
                 data: SeqLM_data | None = None, shard_rank: int = 0,
                 shard_size: int = 1, mesh=None):
        from theanompi_tpu_torch.utils.helper_funcs import scale_lr

        self._net_cfg = dict(vocab=int(vocab), seq_len=int(seq_len),
                             n_layers=int(n_layers), d_model=int(d_model),
                             n_heads=int(n_heads))
        self.n_experts = int(n_experts)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self._ep = None if mesh is None else mesh.axis(AXIS_EXPERT)
        ep = 1 if self._ep is None else self._ep.size
        if n_experts % ep != 0:
            raise ValueError(f"n_experts={n_experts} not divisible by "
                             f"expert-parallel degree {ep}")
        super().__init__(config, device, data=data, shard_rank=shard_rank,
                         shard_size=shard_size, mesh=mesh)
        # tokens ride BOTH axes: the workers, the global batch and the
        # worker-scaled LR count data x ep
        if mesh is not None:
            self.n_workers = mesh.shape[AXIS_DATA] * ep
        self.global_batch = self.batch_size * self.n_workers
        if self.config.lr_scale_with_workers:
            self._base_lr = scale_lr(self.config.learning_rate,
                                     self.n_workers,
                                     self.config.lr_scale_with_workers)
        whole = self._whole_sizes()
        self.train_flops_per_sample = _lm_train_flops(
            whole, n_layers, seq_len, d_model,
            expert_names={n for n in whole if n.startswith("experts.")},
            n_experts=n_experts)

    def _input_dtype(self) -> torch.dtype:
        return torch.int32

    def build_data(self) -> SeqLM_data:
        c = self._net_cfg
        return SeqLM_data(vocab=c["vocab"], seq_len=c["seq_len"],
                          seed=self.config.seed)

    def _net(self, ep) -> MoELMNet:
        c = self._net_cfg
        return MoELMNet(c["vocab"], c["n_layers"], c["d_model"],
                        c["n_heads"], c["seq_len"], self.n_experts,
                        self._compute_dtype(), self.capacity_factor, ep)

    def build_module(self) -> MoELMNet:
        return self._net(self._ep)

    def init_weights(self, module, gen) -> None:
        """JAX's draws: the attention and head as flax's layers, N(0,
        0.02^2) tables and routers, experts' up kernels he-normal
        (untruncated, std sqrt(2/d)) and down kernels xavier-uniform, zero
        biases; drawn whole, each rank keeps its experts."""
        whole = self._net(None)
        _init_lm_tree(whole, gen)
        d = self._net_cfg["d_model"]
        ff = 4 * d
        with torch.no_grad():
            for r in whole.router:
                r.normal_(0.0, 0.02, generator=gen)
            for e in whole.experts:
                e.up_kernel.normal_(0.0, math.sqrt(2.0 / d), generator=gen)
                a = math.sqrt(6.0 / (ff + d))
                e.down_kernel.uniform_(-a, a, generator=gen)
        self.load_whole_state_dict(whole.state_dict(), module)

    def _placement(self, module) -> dict:
        return {n: (self._ep, 0) for n, _ in module.named_parameters()
                if n.startswith("experts.")}

    def mesh_axis_of_shards(self):
        return self._ep

    def _whole_names(self):
        return [n for n, _ in self.module.named_parameters()]

    def _whole_sizes(self) -> dict:
        ep = 1 if self._ep is None else self._ep.size
        return {n: p.numel() * (ep if n.startswith("experts.") else 1)
                for n, p in self.module.named_parameters()}

    def _forward(self, module, tokens):
        logits, aux = module(tokens)
        return logits.reshape(-1, logits.shape[-1]), aux

    def loss_fn(self, module, batch, rng):
        tokens, targets = batch
        logits, aux = self._forward(module, tokens)
        targets = targets.reshape(-1)
        ce = L.softmax_cross_entropy(logits, targets,
                                     self.config.label_smoothing)
        loss = ce + self.aux_weight * aux / self._net_cfg["n_layers"]
        return loss, {"loss": ce.detach(),
                      "error": L.error_rate(logits.detach(), targets),
                      "aux": aux.detach()}

    def eval_fn(self, module, batch) -> dict:
        tokens, targets = batch
        logits, _ = self._forward(module, tokens)
        targets = targets.reshape(-1)
        return {"loss": L.softmax_cross_entropy(logits, targets),
                "error": L.error_rate(logits, targets)}

    def compile_iter_fns(self, sync_type: str = "avg") -> None:
        from theanompi_tpu_torch.parallel.bsp import (
            grad_and_metrics,
            make_bsp_eval_step,
        )
        from theanompi_tpu_torch.parallel.expert import sync_moe_grads

        _refuse(self, "pipeline/expert step", "expert-parallel")
        state = self._ensure_state()
        module = state.module
        # without a mesh every rank is a data rank: both sets are WORLD
        data = both = None
        if self.mesh is not None:
            data = self.mesh.axis(AXIS_DATA).group
            both = self.mesh.axis((AXIS_DATA, AXIS_EXPERT)).group
        divide = self.n_workers if sync_type != "cdd" else None
        experts = [p for n, p in module.named_parameters()
                   if n.startswith("experts.")]
        others = [p for n, p in module.named_parameters()
                  if not n.startswith("experts.")]

        def step(state: TrainState, batch, rng) -> dict:
            state.optimizer.zero_grad(set_to_none=True)
            metrics = grad_and_metrics(self.loss_fn, module, batch, rng)
            with torch.no_grad():
                zero_missing_grads(module.parameters())
                sync_moe_grads([p.grad for p in experts],
                               [p.grad for p in others], data, both, divide)
            state.optimizer.step()
            state.step += 1
            return mean_metrics(metrics, both)

        self.exchanger = None
        self.train_step = step
        self.train_step_multi = self.train_step_accum = None
        self.eval_step = make_bsp_eval_step(self.eval_fn, both)
        module.train()
