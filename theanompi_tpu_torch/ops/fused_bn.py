"""The fused BN epilogue ``act(x * scale + bias [+ residual])``.

Counterpart of ``theanompi_tpu/ops/fused_bn.py`` (forward only; the
backward comes with training).  On a CUDA tensor :func:`scale_bias_act`
launches the hand-written kernel ``csrc/fused_bn.cu`` (one stream over
the flattened ``(N*H*W, C)`` view, f32 math, cast to ``out_dtype``);
on a CPU tensor it runs :func:`scale_bias_act_plain`, the plain PyTorch
version the kernel is checked against.  Nothing picks the plain version
for a CUDA tensor: a kernel that cannot build or launch raises.

Two kernels, one per launch count, share the entry point: K1a
(``scale_bias_act``, no residual) and K1b (``scale_bias_act_res``, the
bottleneck-exit form with the shortcut added inside the stream).
"""

from __future__ import annotations

import ctypes

import torch

from theanompi_tpu_torch.ops import _kernels

#: widest C the kernel stages in the default 48 KB of shared memory
MAX_CHANNELS = 6144
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]

K_FWD = _kernels.Kernel("scale_bias_act", "fused_bn", "tm_scale_bias_act",
                        _ARGTYPES)
K_FWD_RES = _kernels.Kernel("scale_bias_act_res", "fused_bn",
                            "tm_scale_bias_act", _ARGTYPES)


def scale_bias_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor,
                         residual: torch.Tensor | None = None,
                         act: str | None = "relu",
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """The plain PyTorch version: f32 math, one rounding per op, cast
    to ``out_dtype`` (default ``x.dtype``)."""
    z = x.float() * scale.float() + bias.float()
    if residual is not None:
        z = z + residual.float()
    if act == "relu":
        z = torch.relu(z)
    return z.to(out_dtype or x.dtype)


def scale_bias_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None = None,
                   act: str | None = "relu",
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(x * scale + bias [+ residual])`` over channel-last ``x``.

    ``scale``/``bias`` are ``(C,)`` vectors (the folded BN affine);
    ``residual`` matches ``x``.  Inputs must be contiguous: the kernel
    reads the ``(N*H*W, C)`` row-major view and no copy is made here."""
    if act not in (None, "relu"):
        raise ValueError(f"unknown act {act!r} (want None|'relu')")
    c = x.shape[-1]
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"scale/bias must be ({c},) channel vectors, got "
            f"{tuple(scale.shape)}/{tuple(bias.shape)} for x "
            f"{tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} != x "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"scale_bias_act needs a contiguous {name} "
                             f"(got strides {t.stride()})")
    out_dtype = out_dtype or x.dtype
    if _kernels.on_cpu(x):
        return scale_bias_act_plain(x, scale, bias, residual, act, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    _check_cuda(x, scale, bias, residual, out_dtype)
    kernel = K_FWD if residual is None else K_FWD_RES
    kernel(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           None if residual is None else residual.data_ptr(), y.data_ptr(),
           x.numel() // c, c, _DTYPE_CODES[x.dtype], int(act == "relu"))
    return y


def _check_cuda(x, scale, bias, residual, out_dtype) -> None:
    """What the kernel takes; anything else raises."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"scale_bias_act kernel takes float32|bfloat16, "
                        f"got {x.dtype}")
    if out_dtype != x.dtype:
        raise TypeError(f"scale_bias_act kernel writes x's dtype {x.dtype}, "
                        f"asked for {out_dtype}")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"residual dtype {residual.dtype} != x {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if residual is not None and residual.device != x.device:
        raise ValueError(f"residual on {residual.device}, x on {x.device}")
    c = x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec or c > MAX_CHANNELS:
        raise ValueError(f"scale_bias_act kernel needs C % {vec} == 0 and "
                         f"C <= {MAX_CHANNELS} for {x.dtype}, got C={c}")
    for t in (x, residual):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("scale_bias_act kernel needs 16-byte aligned "
                             "tensors")
