"""The ResNet stem max-pool: 3x3 window, stride 2, pad 1, NHWC.

Counterpart of ``theanompi_tpu/ops/maxpool.py`` and
``theanompi_tpu/ops/maxpool_pallas.py``.  Three hand-written kernels in
``csrc/maxpool.cu``, each beside the plain PyTorch version it is checked
against (a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises):

* K2a :func:`maxpool3x3s2` (plain :func:`maxpool3x3s2_plain`), the value
  forward: -inf padding, taps in row-major window order, a tap taken
  when ``v > best or isnan(v)`` so NaN propagates.
* K2b :func:`maxpool3x3s2_argmax` (plain
  :func:`maxpool3x3s2_argmax_plain`), the same max plus the int8 argmax
  tap 0-8, by the Pallas training rules: the tap starts at 4, the first
  maximum in row-major order wins, and the first NaN claims the window
  and sticks.
* K2c :func:`maxpool3x3s2_bwd` (plain :func:`maxpool3x3s2_bwd_plain`),
  the gather backward: each input pixel sums, in g's dtype, the g of the
  windows whose saved tap points at it.

:func:`maxpool_stem` runs K2b and K2c under autograd (grad enabled and
``x.requires_grad``) and K2a otherwise.  Odd H or W is refused, as in the
Pallas path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from theanompi_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

K_POOL = _kernels.Kernel(
    "maxpool3x3s2", "maxpool", "tm_maxpool3x3s2",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
K_POOL_ARGMAX = _kernels.Kernel("maxpool3x3s2_argmax", "maxpool",
                                "tm_maxpool3x3s2_argmax", _TRAIN_ARGTYPES)
K_POOL_BWD = _kernels.Kernel("maxpool3x3s2_bwd", "maxpool",
                             "tm_maxpool3x3s2_bwd", _TRAIN_ARGTYPES)


def _check(x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"maxpool3x3s2 expects NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            "maxpool3x3s2 (stride 2, pad 1) needs even H and W, got "
            f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"maxpool3x3s2 needs a contiguous NHWC tensor "
                         f"(got strides {x.stride()})")
    return b, h, w, c


def maxpool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: nine strided taps of a -inf padded tensor."""
    b, h, w, c = x.shape
    best = torch.full((b, h // 2, w // 2, c), float("-inf"), dtype=x.dtype,
                      device=x.device)
    for _, v in _taps(x):
        best = torch.where((v > best) | torch.isnan(v), v, best)
    return best


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2/pad-1 max pool over contiguous NHWC ``x`` with even
    H and W."""
    b, h, w, c = _check(x)
    if _kernels.on_cpu(x):
        return maxpool3x3s2_plain(x)
    y = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _check_kernel(x, "maxpool3x3s2")
    K_POOL(x.device, x.data_ptr(), y.data_ptr(), b, h, w, c,
           _DTYPE_CODES[x.dtype])
    return y


def _check_kernel(t: torch.Tensor, name: str) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32|bfloat16, got "
                        f"{t.dtype}")
    vec = 16 // t.element_size()
    if t.shape[-1] % vec or t.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs C % {vec} == 0 and a "
                         f"16-byte aligned tensor, got C={t.shape[-1]}")


def _taps(x: torch.Tensor):
    """The nine (dy, dx) taps of every 3x3/2/1 window of ``x``, as
    strided views of the -inf padded tensor, in row-major order."""
    _, h, w, _ = x.shape
    oh, ow = h // 2, w // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    for t in range(9):
        dy, dx = divmod(t, 3)
        yield t, xp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2, :]


def maxpool3x3s2_argmax_plain(x: torch.Tensor):
    """The plain K2b: ``(y, idx)`` with ``idx`` the int8 winning tap."""
    b, h, w, c = x.shape
    best = torch.full((b, h // 2, w // 2, c), float("-inf"), dtype=x.dtype,
                      device=x.device)
    bidx = torch.full(best.shape, 4, dtype=torch.int8, device=x.device)
    for t, v in _taps(x):
        take = ((v > best) | torch.isnan(v)) & ~torch.isnan(best)
        best = torch.where(take, v, best)
        bidx = torch.where(take, torch.full((), t, dtype=torch.int8,
                                            device=x.device), bidx)
    return best, bidx


def maxpool3x3s2_argmax(x: torch.Tensor):
    """K2b over contiguous NHWC ``x`` with even H and W: the pooled
    ``y`` and the int8 argmax tap of each output."""
    b, h, w, c = _check(x)
    if _kernels.on_cpu(x):
        return maxpool3x3s2_argmax_plain(x)
    y = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(y.shape, dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y, idx
    _check_kernel(x, "maxpool3x3s2_argmax")
    K_POOL_ARGMAX(x.device, x.data_ptr(), y.data_ptr(), idx.data_ptr(), b, h,
                  w, c, _DTYPE_CODES[x.dtype])
    return y, idx


def maxpool3x3s2_bwd_plain(g: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """The plain K2c, as the Pallas ``_bwd_kernel`` computes it: input
    pixels fall into four (row, column) parity classes; each class plane
    adds, in g's dtype from zero, ``where(idx == tap, g, 0)`` over the
    taps that reach it (dy ascending, then dx), and the four planes
    interleave into ``dx``."""
    b, oh, ow, c = g.shape
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    ip = F.pad(idx.to(torch.int16), (0, 0, 1, 1, 1, 1), value=-1)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    def plane(pi, pj):
        acc = torch.zeros((b, oh, ow, c), dtype=g.dtype, device=g.device)
        for dy in range(3):
            if (pi + 1 - dy) % 2:
                continue
            o = (pi + 1 - dy) // 2
            for dx in range(3):
                if (pj + 1 - dx) % 2:
                    continue
                p = (pj + 1 - dx) // 2
                gs = gp[:, o + 1:o + 1 + oh, p + 1:p + 1 + ow]
                is_ = ip[:, o + 1:o + 1 + oh, p + 1:p + 1 + ow]
                acc = acc + torch.where(is_ == dy * 3 + dx, gs, zero)
        return acc

    top = torch.stack([plane(0, 0), plane(0, 1)], dim=3)
    bot = torch.stack([plane(1, 0), plane(1, 1)], dim=3)
    return torch.stack([top.reshape(b, oh, 2 * ow, c),
                        bot.reshape(b, oh, 2 * ow, c)],
                       dim=2).reshape(b, 2 * oh, 2 * ow, c)


def maxpool3x3s2_bwd(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2c: ``dx`` of shape ``(N, 2*OH, 2*OW, C)`` in g's dtype from the
    pooled gradient ``g`` and the int8 taps of :func:`maxpool3x3s2_argmax`
    (both contiguous ``(N, OH, OW, C)``)."""
    if idx.shape != g.shape or idx.dtype != torch.int8:
        raise ValueError(f"idx must be int8 of g's shape {tuple(g.shape)}, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("maxpool3x3s2_bwd needs contiguous g and idx")
    if _kernels.on_cpu(g):
        return maxpool3x3s2_bwd_plain(g, idx)
    b, oh, ow, c = g.shape
    dx = torch.empty((b, 2 * oh, 2 * ow, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    _check_kernel(g, "maxpool3x3s2_bwd")
    if idx.device != g.device or idx.data_ptr() % 16:
        raise ValueError("maxpool3x3s2_bwd kernel needs idx 16-byte aligned "
                         "on g's device")
    K_POOL_BWD(g.device, g.data_ptr(), idx.data_ptr(), dx.data_ptr(), b, oh,
               ow, c, _DTYPE_CODES[g.dtype])
    return dx


class MaxPool3x3s2(torch.autograd.Function):
    """The stem pool under autograd: K2b forward saving the int8 taps,
    K2c gather backward.  An incoming gradient that is not contiguous
    is copied first."""

    @staticmethod
    def forward(ctx, x):
        y, idx = maxpool3x3s2_argmax(x)
        ctx.save_for_backward(idx)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return maxpool3x3s2_bwd(g.contiguous(), idx)


def maxpool_stem(x: torch.Tensor) -> torch.Tensor:
    """The ResNet stem pool.  Unlike the JAX front end there is no
    compiler path to choose: under autograd it is K2b with the K2c
    backward, otherwise K2a; odd spatial sizes are refused."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool3x3s2.apply(x)
    return maxpool3x3s2(x)
