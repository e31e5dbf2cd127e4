"""Layer library for the port's model zoo.

Counterpart of ``theanompi_tpu/models/layers.py``.  Activations are NHWC
at every public boundary, as in the JAX package.  A convolution runs
``F.conv2d`` on the channels-last view of its NHWC input with a
channels-last weight, so its output permutes back to a contiguous NHWC
tensor without a copy, and the fused BN epilogue (ops/fused_bn.py) and
the LRN kernels (ops/lrn.py) read that ``(N*H*W, C)`` view in place.
:class:`ConvTranspose` is flax's ``nn.ConvTranspose`` (the WGAN
generator) on ``F.conv_transpose2d``.  With ``sync`` a
:class:`BatchNormAct` takes its batch statistics over every rank
(``ModelConfig.sync_bn``).  Pooling (VALID, or flax's SAME) is
``F.max_pool2d``/``F.avg_pool2d`` on the same view, as the JAX package
leaves it to XLA's ``reduce_window``; the max-pool kernels serve
ResNet's stem alone.
:class:`BiasAct` is the BN-free zoo's conv epilogue through the fused
BN kernels at unit scale.  The transformer's layers (:class:`LayerNorm`,
:class:`Embed`, :func:`gelu`, bias-free :class:`Dense`) follow flax's
defaults, which differ from PyTorch's.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from theanompi_tpu_torch.ops.fused_bn import scale_bias_act
from theanompi_tpu_torch.ops.lrn import lrn

#: ``init(tensor, generator)`` fills a parameter in place
Init = Callable[[torch.Tensor, torch.Generator], None]


# -- reference-era initializers (gaussian std + constant bias) --


def gaussian_init(std: float = 0.01) -> Init:
    """N(0, std^2), drawn from the given generator."""
    def init(t: torch.Tensor, gen: torch.Generator) -> None:
        t.normal_(0.0, std, generator=gen)
    return init


def constant_init(v: float = 0.0) -> Init:
    def init(t: torch.Tensor, gen: torch.Generator) -> None:
        t.fill_(v)
    return init


def _fans(t: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of an (out, in) dense or (out, in, kh, kw) conv
    weight, as flax counts them (the receptive field multiplies both)."""
    receptive = t[0, 0].numel()
    return t.shape[1] * receptive, t.shape[0] * receptive


def xavier_uniform() -> Init:
    """flax's ``xavier_uniform``: U(-a, a), a = sqrt(6 / (fan_in +
    fan_out)), for a dense or conv weight."""
    def init(t: torch.Tensor, gen: torch.Generator) -> None:
        fan_in, fan_out = _fans(t)
        a = math.sqrt(6.0 / (fan_in + fan_out))
        t.uniform_(-a, a, generator=gen)
    return init


def he_normal() -> Init:
    """flax's ``he_normal``: a normal of variance 2 / fan_in TRUNCATED at
    two standard deviations (the std rescaled by 1/0.8796 so the
    truncated draw keeps that variance), for a dense or conv weight."""
    def init(t: torch.Tensor, gen: torch.Generator) -> None:
        std = math.sqrt(2.0 / _fans(t)[0]) / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
    return init


def init_params(module: nn.Module, gen: torch.Generator) -> None:
    """Apply every :class:`Conv`/:class:`ConvTranspose`/:class:`Dense`/
    :class:`BiasAct`/:class:`Embed` layer's own inits, in module order
    (layers built without inits are left as they are)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, ConvTranspose, Dense)):
                for init, t in ((m.kernel_init, m.weight),
                                (m.bias_init, m.bias)):
                    if init is not None and t is not None:
                        init(t, gen)
            elif isinstance(m, BiasAct) and m.bias_init is not None:
                m.bias_init(m.bias, gen)
            elif isinstance(m, Embed):
                m.embedding.normal_(0.0, EMBED_STD, generator=gen)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: the output is
    ``ceil(size/stride)`` and the odd pixel of the total pad goes to the
    END, so a stride-2 3x3 conv on an even input pads (0, 1) where
    PyTorch's ``padding=1`` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def to_nhwc(y: torch.Tensor) -> torch.Tensor:
    """NCHW result of a conv -> contiguous NHWC (free when the conv
    wrote channels-last, a copy otherwise)."""
    return y.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """Convolution over NHWC input; ``padding`` is ``"SAME"``, ``"VALID"``
    or explicit ``((top, bottom), (left, right))`` pads.  The weight is
    OIHW ``(out, in/groups, kh, kw)`` (flax's HWIO grouped kernel
    transposed; ``groups`` splits the input and output channels in
    contiguous blocks, as XLA's ``feature_group_count``), cast to
    ``dtype`` at use (flax's ``nn.Conv(dtype=...)`` promotion), as is
    the optional bias."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding="SAME", dtype: torch.dtype = torch.float32,
                 groups: int = 1, bias: bool = False,
                 kernel_init: Init | None = None,
                 bias_init: Init | None = None):
        super().__init__()
        if in_features % groups or features % groups:
            raise ValueError(f"groups={groups} must divide in_features "
                             f"{in_features} and features {features}")
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.groups = groups
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def pads(self, h: int, w: int):
        if self.padding == "SAME":
            return (same_pads(h, self.kernel[0], self.strides[0]),
                    same_pads(w, self.kernel[1], self.strides[1]))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        (pt, pb), (pl, pr) = self.pads(x.shape[1], x.shape[2])
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
            padding = (0, 0)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.strides,
                     padding=padding, groups=self.groups)
        return to_nhwc(y)


def conv_transpose_pads(kernel: int, stride: int,
                        padding: str) -> tuple[int, int]:
    """lax's ``conv_transpose`` pads ``(pad_a, pad_b)`` of one spatial
    dim: the stride-dilated input is padded so and correlated with the
    kernel.  ``"SAME"``: ``pad_len = k + s - 2``, ``pad_a = k - 1`` when
    ``s > k - 1``, else ``ceil(pad_len / 2)``; ``"VALID"``: ``pad_len =
    k + s - 2 + max(k - s, 0)``, ``pad_a = k - 1``."""
    if padding == "SAME":
        pad_len = kernel + stride - 2
        pad_a = (kernel - 1 if stride > kernel - 1
                 else -(-pad_len // 2))
    elif padding == "VALID":
        pad_len = kernel + stride - 2 + max(kernel - stride, 0)
        pad_a = kernel - 1
    else:
        raise ValueError(f"ConvTranspose padding {padding!r} (want "
                         "'SAME'|'VALID')")
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) over NHWC
    input, computed in ``dtype``, with a bias by default.  flax correlates
    the stride-dilated, padded input with its ``(kh, kw, in, out)`` kernel
    as it is; ``F.conv_transpose2d`` correlates with its ``(in, out, kh,
    kw)`` weight flipped in space, so the weight stored here is flax's
    kernel flipped on (kh, kw) and permuted (the bridge does both).  The
    lax pads (:func:`conv_transpose_pads`) become ``padding = k - 1 -
    pad_a`` on both sides and ``output_padding = pad_b - pad_a`` at the
    end; where ``pad_b`` is one less than ``pad_a`` (``"SAME"`` at odd
    ``k + s``) the last row and column are cut instead, which is exact.
    Padding other than ``"SAME"``/``"VALID"`` raises."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding: str = "SAME", dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, kernel_init: Init | None = None,
                 bias_init: Init | None = None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        pads = [conv_transpose_pads(k, s, padding)
                for k, s in zip(self.kernel, self.strides)]
        self.padding = tuple(k - 1 - a for k, (a, _) in zip(self.kernel,
                                                             pads))
        self.output_padding = tuple(max(b - a, 0) for a, b in pads)
        self.cuts = tuple(min(b - a, 0) for a, b in pads)
        self.weight = nn.Parameter(
            torch.empty(in_features, features, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b,
                               stride=self.strides, padding=self.padding,
                               output_padding=self.output_padding)
        ch, cw = self.cuts
        return to_nhwc(y[:, :, :y.shape[2] + ch, :y.shape[3] + cw])


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a tensor over the ranks of the default process group
    (one all-reduce, then a division by the world size: JAX's
    ``lax.pmean``); its backward is the same mean of the cotangent, what
    JAX's ``shard_map`` step differentiates ``pmean`` to.  Without a
    process group the world is this process alone."""

    @staticmethod
    def _mean(t: torch.Tensor) -> torch.Tensor:
        t = t.clone(memory_format=torch.contiguous_format)
        if not dist.is_initialized():
            return t
        dist.all_reduce(t)
        return t / dist.get_world_size()

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return _MeanOverRanks._mean(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _MeanOverRanks._mean(g)


class BatchNormAct(nn.Module):
    """BatchNorm with its fused epilogue.

    Variables as in the JAX package: params ``scale``/``bias``, running
    stats ``mean``/``var``.  The affine is folded as the JAX Pallas
    branch folds it, in f32: ``scale_eff = scale * rsqrt(var + eps)``,
    ``bias_eff = bias - mean * scale_eff``; then ONE kernel computes
    ``act(x * scale_eff + bias_eff [+ residual])`` and writes ``dtype``
    (the model's compute dtype, as the JAX models pass it).

    In eval mode mean/var are the running statistics.  In train mode
    they are the batch statistics of ``x.float()`` over every axis but
    the last, with flax's fast variance ``max(0, E[x^2] - E[x]^2)``; the
    running statistics move ``ra = momentum * ra + (1 - momentum) *
    stat`` (biased variance, outside autograd), and the gradient reaches
    ``x`` through the statistics by autograd, as JAX differentiates them.
    With ``sync`` (``ModelConfig.sync_bn``) the stacked ``[mean, E[x^2]]``
    (2 x C, f32) is averaged over the ranks of the default process group
    in one collective before the variance is formed, forward and backward
    (:class:`_MeanOverRanks`), so every rank normalizes by the global
    batch's statistics and moves its running statistics from them.
    Entering train mode drops an affine folded by
    :func:`prepare_inference`."""

    def __init__(self, features: int, dtype: torch.dtype,
                 act: str | None = None, epsilon: float = 1e-5,
                 momentum: float = 0.9, sync: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.act = act
        self.sync = sync
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self._folded: tuple[torch.Tensor, torch.Tensor] | None = None

    def fold(self, mean: torch.Tensor | None = None,
             var: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded affine for ``mean``/``var`` (default: the running
        statistics)."""
        mean = self.mean if mean is None else mean
        var = self.var if var is None else var
        scale = self.scale.float()
        scale_eff = scale * torch.rsqrt(var.float() + self.epsilon)
        bias_eff = self.bias.float() - mean.float() * scale_eff
        return scale_eff, bias_eff

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = None  # new variables invalidate the folded affine
        super()._load_from_state_dict(*args, **kwargs)

    def train(self, mode: bool = True):
        if mode:
            self._folded = None  # batch statistics replace the fold
        return super().train(mode)

    def batch_stats(self, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 batch mean and (biased, fast) variance over all but the
        last axis of ``x``; moves the running statistics."""
        xf = x.float()
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(axes)
        mean2 = (xf * xf).mean(axes)
        if self.sync:
            mean, mean2 = _MeanOverRanks.apply(
                torch.stack([mean, mean2])).unbind()
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            scale_eff, bias_eff = self.fold(*self.batch_stats(x))
        elif self._folded is not None:
            scale_eff, bias_eff = self._folded
        else:
            scale_eff, bias_eff = self.fold()
        return scale_bias_act(x, scale_eff, bias_eff, residual=residual,
                              act=self.act, out_dtype=self.dtype)


class BiasAct(nn.Module):
    """Per-channel bias + activation, the conv epilogue of the BN-free
    zoo members (VGG, GoogLeNet): the JAX ``BiasAct``'s fused route,
    ``scale_bias_act(x, 1, bias)`` (K1a forward and K1c backward on the
    card): f32 math, ``x``'s dtype out.  The bias is an f32 parameter;
    the unit scale is a constant kept per device, outside the module's
    state and the autograd graph, so the ``sum(g * x)`` K1c computes for
    it reaches no parameter.  (JAX's ``'xla'`` route adds a bf16 bias in
    bf16 instead: the two agree bit for bit in f32 and within bf16
    rounding in bf16.)"""

    def __init__(self, features: int, bias_init: Init | None = None,
                 act: str | None = "relu"):
        super().__init__()
        self.act = act
        self.bias_init = bias_init
        self.bias = nn.Parameter(torch.zeros(features))
        self._ones: torch.Tensor | None = None

    def ones(self) -> torch.Tensor:
        """The unit scale on the bias's device."""
        if self._ones is None or self._ones.device != self.bias.device:
            self._ones = torch.ones_like(self.bias, requires_grad=False)
        return self._ones

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return scale_bias_act(x, self.ones(), self.bias, act=self.act,
                              out_dtype=x.dtype)


def conv_epilogue(features: int, dtype: torch.dtype, batch_norm: bool,
                  bias_init: Init | None = None,
                  sync_bn: bool = False) -> tuple[str, nn.Module]:
    """The epilogue after a bias-free conv of a zoo member, with the flax
    scope prefix it takes: ``("BatchNorm", BatchNormAct(relu))`` for the
    BN variants (``ModelConfig.batch_norm``; the JAX ``layers.BatchNorm``
    with ``act='relu'``, which nests its variables one scope deeper;
    ``sync_bn`` its cross-rank statistics), else ``("BiasAct",
    BiasAct(relu))``."""
    if batch_norm:
        return "BatchNorm", BatchNormAct(features, dtype=dtype, act="relu",
                                         sync=sync_bn)
    return "BiasAct", BiasAct(features, bias_init=bias_init, act="relu")


class Dense(nn.Module):
    """Fully connected layer computed in ``dtype``: f32 by default (the
    JAX ``L.Dense`` default, which the ResNet head keeps under bf16
    compute); AlexNet's and the transformer's layers pass the compute
    dtype, as their JAX models do.  ``use_bias=False`` drops the bias
    (the attention projections)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 kernel_init: Init | None = None,
                 bias_init: Init | None = None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        None if self.bias is None
                        else self.bias.to(self.dtype))


#: flax's LayerNorm epsilon (PyTorch's default is 1e-5)
LN_EPSILON = 1e-6


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=...)`` over the last axis: epsilon
    :data:`LN_EPSILON`, the statistics of ``x`` in f32 with the fast
    variance ``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in f32, the result in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + LN_EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


#: the std of :class:`Embed`'s N(0, std^2) init (the JAX TransformerLM's)
EMBED_STD = 0.02


class Embed(nn.Module):
    """flax's ``nn.Embed``: an f32 (num, features) table, drawn by
    :func:`init_params` from N(0, :data:`EMBED_STD`^2); the lookup of
    integer ids (int32 or int64) returns f32."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation (``F.gelu``'s default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _pool_input(x: torch.Tensor, window: int, stride: int, padding: str,
                value: float) -> tuple[torch.Tensor, tuple[int, int]]:
    """NCHW view of NHWC ``x`` and the symmetric pads left for the pool,
    for ``padding`` ``"VALID"`` or ``"SAME"`` (flax's pads,
    :func:`same_pads`): symmetric pads go to the pool, which pads max
    with -inf and counts avg's zeros as flax does; asymmetric ones are
    written by ``F.pad`` with ``value``, as :class:`Conv` does."""
    if padding == "VALID":
        return x.permute(0, 3, 1, 2), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding {padding!r} (want 'VALID'|'SAME')")
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], window, stride),
                          same_pads(x.shape[2], window, stride))
    if pt == pb and pl == pr:
        return x.permute(0, 3, 1, 2), (pt, pl)
    x = F.pad(x, (0, 0, pl, pr, pt, pb), value=value)
    return x.permute(0, 3, 1, 2), (0, 0)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` over NHWC ``x``: ``"VALID"`` windows (output
    ``(H - window) // stride + 1``) or ``"SAME"`` (output ``ceil(H /
    stride)``, padded with -inf, an odd pad at the end)."""
    xp, pads = _pool_input(x, window, stride, padding, float("-inf"))
    return to_nhwc(F.max_pool2d(xp, window, stride, pads))


def avg_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.avg_pool`` over NHWC ``x``, ``"VALID"`` or ``"SAME"``
    (zero pads counted in the mean: flax's ``count_include_pad``)."""
    xp, pads = _pool_input(x, window, stride, padding, 0.0)
    return to_nhwc(F.avg_pool2d(xp, window, stride, pads,
                                count_include_pad=True))


class LRN(nn.Module):
    """Cross-channel local response normalization (ops/lrn.py)."""

    def __init__(self, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75):
        super().__init__()
        self.n, self.k, self.alpha, self.beta = n, k, alpha, beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrn(x, self.n, self.k, self.alpha, self.beta)


class Dropout(nn.Module):
    """flax's dropout: in train mode ``where(mask, x / keep, 0)`` with
    ``mask`` true at rate ``keep = 1 - rate``, drawn from the step's
    ``torch.Generator`` (so a run replays its masks); the identity in
    eval mode."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool,
                rng: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout in train mode needs a torch.Generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W of NHWC ``x`` (keeps x's dtype, as jnp.mean)."""
    return x.mean(dim=(1, 2))


# -- loss / metric heads ------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over the batch, labels integer class ids; with
    ``label_smoothing=eps`` the target is ``(1-eps)*onehot + eps/K``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None]).mean()
    if label_smoothing:
        eps = label_smoothing
        return (1.0 - eps) * nll - eps * logp.mean()
    return nll


def error_rate(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 error."""
    return (logits.argmax(-1) != labels).float().mean()


def topk_error(logits: torch.Tensor, labels: torch.Tensor,
               k: int = 5) -> torch.Tensor:
    """Top-k error; ``k`` is clamped to the class count."""
    k = min(k, logits.shape[-1])
    topk = logits.topk(k, dim=-1).indices
    return 1.0 - (topk == labels[:, None]).any(-1).float().mean()


@torch.no_grad()
def prepare_inference(module: nn.Module) -> nn.Module:
    """Convert a loaded eval module once for serving: conv weights to
    their compute dtype in channels-last (so ``Conv.forward``'s cast is
    a no-op) and every BN affine folded ahead of time.  Call again after
    loading new weights.  Never on a module that trains: it replaces the
    f32 master weights with compute-dtype copies."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.weight.data = m.weight.data.to(
                m.dtype, memory_format=torch.channels_last)
        elif isinstance(m, BatchNormAct):
            m._folded = m.fold()
    return module.eval()
