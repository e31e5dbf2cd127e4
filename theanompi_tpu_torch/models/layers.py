"""Layer library for the port's model zoo.

Counterpart of ``theanompi_tpu/models/layers.py``.  Activations are NHWC
at every public boundary, as in the JAX package.  A convolution runs
``F.conv2d`` on the channels-last view of its NHWC input with a
channels-last weight, so its output permutes back to a contiguous NHWC
tensor without a copy, and the fused BN epilogue (ops/fused_bn.py) reads
that ``(N*H*W, C)`` view in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from theanompi_tpu_torch.ops.fused_bn import scale_bias_act


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
    """Bias-free convolution over NHWC input; ``padding`` is ``"SAME"``
    or explicit ``((top, bottom), (left, right))`` pads.  The weight is
    OIHW, cast to ``dtype`` at use (flax's ``nn.Conv(dtype=...)``
    promotion)."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding="SAME", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, *self.kernel))

    def pads(self, h: int, w: int):
        if self.padding == "SAME":
            return (same_pads(h, self.kernel[0], self.strides[0]),
                    same_pads(w, self.kernel[1], self.strides[1]))
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
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=padding)
        return to_nhwc(y)


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
    Entering train mode drops an affine folded by
    :func:`prepare_inference`."""

    def __init__(self, features: int, dtype: torch.dtype,
                 act: str | None = None, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.act = act
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


class Dense(nn.Module):
    """Fully connected layer, computed in f32 (the JAX ``L.Dense``
    default, which the ResNet head keeps under bf16 compute)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


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
