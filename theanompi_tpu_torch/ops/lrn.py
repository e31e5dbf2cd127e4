"""Cross-channel local response normalization (AlexNet, GoogLeNet), NHWC.

Counterpart of ``theanompi_tpu/ops/lrn.py`` and
``theanompi_tpu/ops/lrn_pallas.py``::

    y = x * (k + a * W(x^2)) ** -beta,   a = alpha / n (or alpha)

W is the zero-padded window sum over the channel axis (:func:`window_sum`,
the JAX package's convention: ``lo = (n-1)//2`` channels below, the rest
above; ``adjoint=True`` swaps the two, the transpose the backward needs).

Two hand-written kernels in ``csrc/lrn.cu``, each beside the plain
PyTorch version it is checked against (a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, never falls back):

* K3a :func:`lrn_fwd` (plain :func:`lrn_plain`);
* K3b :func:`lrn_bwd` (plain :func:`lrn_bwd_plain`), the analytic VJP of
  the Pallas kernel, in its order:
  ``s_mb1 = s**(-beta-1)``, ``dx = g*s_mb1*s - 2*a*beta * x * W^T(g*x*s_mb1)``.

Both compute in f32 and round to x's dtype once.  The Pallas kernel
computes in the input's dtype, so in bf16 the two differ by about one
bf16 ulp (tests/test_torch_lrn.py states the tolerance).  The kernels
reproduce their plain versions bit for bit on the card as long as
PyTorch's ``pow`` takes its general ``powf`` path for ``-beta`` and
``-beta-1`` (it has special cases for exponents such as -0.5, -1, -2).

:func:`lrn` is the dispatch: under autograd (grad enabled and
``x.requires_grad``) :class:`LRN` runs K3a, saves ``x`` (as the Pallas
``custom_vjp`` does) and runs K3b in its backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from theanompi_tpu_torch.ops import _kernels

#: widest C the kernels take (one row per tile of ``csrc/lrn.cu``)
MAX_CHANNELS = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# x, y; rows, c, n; k, a, -beta; dtype; stream
K_FWD = _kernels.Kernel(
    "lrn", "lrn", "tm_lrn_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_int, ctypes.c_void_p])
# x, g, dx; rows, c, n; k, a, -beta-1, 2*a*beta; dtype; stream
K_BWD = _kernels.Kernel(
    "lrn_bwd", "lrn", "tm_lrn_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_float, ctypes.c_float,
                             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def window_sum(v: torch.Tensor, n: int, adjoint: bool = False
               ) -> torch.Tensor:
    """Zero-padded sum over a window of ``n`` channels (last axis): the
    shifted copies ``d = 0 .. n-1`` added left to right, as the JAX
    ``window_sum``."""
    lo = (n - 1) // 2
    hi = n - 1 - lo
    if adjoint:
        lo, hi = hi, lo
    c = v.shape[-1]
    padded = F.pad(v, (lo, hi))
    win = padded[..., 0:c]
    for d in range(1, n):
        win = win + padded[..., d:d + c]
    return win


def _coeff(n: int, alpha: float, alpha_scaled_by_n: bool) -> float:
    return alpha / n if alpha_scaled_by_n else alpha


def lrn_plain(x: torch.Tensor, n: int = 5, k: float = 2.0,
              alpha: float = 1e-4, beta: float = 0.75,
              alpha_scaled_by_n: bool = True) -> torch.Tensor:
    """The plain forward: f32 math, one rounding per op, cast to x's
    dtype."""
    a = _coeff(n, alpha, alpha_scaled_by_n)
    xf = x.float()
    s = k + a * window_sum(xf * xf, n)
    return (xf * s ** (-beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, n: int = 5,
                  k: float = 2.0, alpha: float = 1e-4, beta: float = 0.75,
                  alpha_scaled_by_n: bool = True) -> torch.Tensor:
    """The plain backward (the Pallas kernel's analytic VJP): f32 math,
    one rounding per op, ``dx`` in x's dtype."""
    a = _coeff(n, alpha, alpha_scaled_by_n)
    xf, gf = x.float(), g.float()
    s = k + a * window_sum(xf * xf, n)
    s_mb1 = s ** (-beta - 1.0)
    dx = gf * s_mb1 * s - (2.0 * a * beta) * xf * window_sum(
        gf * xf * s_mb1, n, adjoint=True)
    return dx.to(x.dtype)


def tile_geometry(c: int, n: int) -> dict[str, int]:
    """The tile the kernels take for ``C = c`` and window ``n``, as
    ``csrc/lrn.cu`` computes it (``geometry``, read from the built
    library, so only where it builds): ``rows`` per tile, ``stride``
    floats per row of a shared plane, ``pad`` zero columns on each side
    of a row, and K3a's and K3b's shared memory per block in bytes
    (``fwd_smem_bytes``, ``bwd_smem_bytes``)."""
    fn = _kernels.load("lrn").tm_lrn_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    if fn(c, n, out) != 0:
        raise ValueError(f"no LRN tile for C={c}, n={n}")
    return dict(zip(("rows", "stride", "pad", "fwd_smem_bytes",
                     "bwd_smem_bytes"), out))


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What the kernels take; anything else raises."""
    x = tensors[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32|bfloat16, got "
                        f"{x.dtype}")
    for t in tensors[1:]:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} kernel takes every tensor in x's dtype "
                            f"{x.dtype} on {x.device}, got {t.dtype} on "
                            f"{t.device}")
    if not 1 <= x.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"{name} kernel takes 1 <= C <= {MAX_CHANNELS}, "
                         f"got C={x.shape[-1]}")


def _check_layout(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous channel-last tensors "
                             f"(got strides {t.stride()})")


def lrn_fwd(x: torch.Tensor, n: int = 5, k: float = 2.0,
            alpha: float = 1e-4, beta: float = 0.75,
            alpha_scaled_by_n: bool = True) -> torch.Tensor:
    """The forward over the contiguous ``(rows, C)`` view of ``x``: K3a
    on a CUDA tensor, :func:`lrn_plain` on a CPU tensor."""
    _check_layout("lrn", x)
    if _kernels.on_cpu(x):
        return lrn_plain(x, n, k, alpha, beta, alpha_scaled_by_n)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _check_cuda("lrn", x)
    c = x.shape[-1]
    K_FWD(x.device, x.data_ptr(), y.data_ptr(), x.numel() // c, c, n, k,
          _coeff(n, alpha, alpha_scaled_by_n), -beta, _DTYPE_CODES[x.dtype])
    return y


def lrn_bwd(x: torch.Tensor, g: torch.Tensor, n: int = 5, k: float = 2.0,
            alpha: float = 1e-4, beta: float = 0.75,
            alpha_scaled_by_n: bool = True) -> torch.Tensor:
    """The backward ``dx`` for the saved input ``x`` and the incoming
    gradient ``g`` (x's shape): K3b on a CUDA tensor,
    :func:`lrn_bwd_plain` on a CPU tensor."""
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    _check_layout("lrn_bwd", x, g)
    if _kernels.on_cpu(x):
        return lrn_bwd_plain(x, g, n, k, alpha, beta, alpha_scaled_by_n)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    _check_cuda("lrn_bwd", x, g)
    c = x.shape[-1]
    a = _coeff(n, alpha, alpha_scaled_by_n)
    K_BWD(x.device, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
          x.numel() // c, c, n, k, a, -beta - 1.0, 2.0 * a * beta,
          _DTYPE_CODES[x.dtype])
    return dx


class LRN(torch.autograd.Function):
    """LRN under autograd: K3a forward saving ``x``, K3b backward."""

    @staticmethod
    def forward(ctx, x, n, k, alpha, beta, alpha_scaled_by_n):
        ctx.save_for_backward(x)
        ctx.args = (n, k, alpha, beta, alpha_scaled_by_n)
        return lrn_fwd(x, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_bwd(x, g.contiguous(), *ctx.args),
                None, None, None, None, None)


def lrn(x: torch.Tensor, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
        beta: float = 0.75, *, alpha_scaled_by_n: bool = True
        ) -> torch.Tensor:
    """Cross-channel LRN of contiguous NHWC ``x`` (module docstring);
    differentiable through :class:`LRN`."""
    if x.ndim != 4:
        raise ValueError(f"lrn expects NHWC, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return LRN.apply(x, n, k, alpha, beta, alpha_scaled_by_n)
    return lrn_fwd(x, n, k, alpha, beta, alpha_scaled_by_n)
