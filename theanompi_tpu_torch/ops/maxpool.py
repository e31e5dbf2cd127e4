"""The ResNet stem max-pool: 3x3 window, stride 2, pad 1, NHWC.

Counterpart of ``theanompi_tpu/ops/maxpool.py`` and the value forward of
``theanompi_tpu/ops/maxpool_pallas.py`` (the argmax forward and the
gather backward come with training).  On a CUDA tensor
:func:`maxpool3x3s2` launches the hand-written kernel
``csrc/maxpool.cu`` (K2a); on a CPU tensor it runs
:func:`maxpool3x3s2_plain`, the plain version the kernel is checked
against.  Both follow the Pallas kernel: -inf padding, taps in row-major
window order, a tap taken when ``v > best or isnan(v)`` so NaN
propagates.  Odd H or W is refused, as in the Pallas path.
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
    _, h, w, _ = x.shape
    oh, ow = h // 2, w // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    best = torch.full((x.shape[0], oh, ow, x.shape[3]), float("-inf"),
                      dtype=x.dtype, device=x.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        v = xp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2, :]
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
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"maxpool3x3s2 kernel takes float32|bfloat16, got "
                        f"{x.dtype}")
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        raise ValueError(f"maxpool3x3s2 kernel needs C % {vec} == 0 and a "
                         f"16-byte aligned tensor, got C={c}")
    K_POOL(x.device, x.data_ptr(), y.data_ptr(), b, h, w, c,
           _DTYPE_CODES[x.dtype])
    return y


def maxpool_stem(x: torch.Tensor) -> torch.Tensor:
    """The ResNet stem pool.  Unlike the JAX front end there is no
    compiler path to choose: it is always :func:`maxpool3x3s2`, so odd
    spatial sizes are refused."""
    return maxpool3x3s2(x)
