"""The fused BN epilogue ``act(x * scale + bias [+ residual])`` and its
backward.

Counterpart of ``theanompi_tpu/ops/fused_bn.py``.  On a CUDA tensor
:func:`scale_bias_act` launches the hand-written kernels of
``csrc/fused_bn.cu`` (one stream over the flattened ``(N*H*W, C)`` view,
f32 math, cast to ``out_dtype``); on a CPU tensor it runs the plain
PyTorch versions the kernels are checked against.  Nothing picks a plain
version for a CUDA tensor: a kernel that cannot build or launch raises.

Four kernels, each with its own launch count: K1a (``scale_bias_act``,
no residual) and K1b (``scale_bias_act_res``, the bottleneck-exit form
with the shortcut added inside the stream) share the forward entry
point; K1c (``scale_bias_act_bwd``) and K1d (``scale_bias_act_res_bwd``)
share the backward one.  When autograd records the call (grad enabled
and an input that requires grad), :class:`ScaleBiasAct` runs the forward
kernel, saves ``x``, ``scale``, ``bias`` and the residual, and its
backward runs the backward kernel: the relu mask is recomputed from
``x``, and ``dx``, ``dres`` and the per-channel ``ds``/``db`` come out of
one stream.  Otherwise the forward runs alone.
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
# x, scale, bias, res, g, dx, dres, part, tickets, ds, db; rows, c,
# part_floats, n_tickets, dtype, relu; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
K_BWD = _kernels.Kernel("scale_bias_act_bwd", "fused_bn",
                        "tm_scale_bias_act_bwd", _BWD_ARGTYPES)
K_BWD_RES = _kernels.Kernel("scale_bias_act_res_bwd", "fused_bn",
                            "tm_scale_bias_act_bwd", _BWD_ARGTYPES)

#: copies :class:`ScaleBiasAct` made of a non-contiguous incoming
#: gradient (the kernels read the row-major ``(rows, C)`` view)
grad_copies = _kernels.Counter()


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


def scale_bias_act_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, g: torch.Tensor,
                             relu: bool = True):
    """The plain backward without a residual: ``(dx, ds, db)``.  f32
    math, one rounding per op; ``dx`` in x's dtype, ``ds``/``db`` f32
    sums over the rows of the ``(rows, C)`` view."""
    dx, _, ds, db = _bwd_plain(x, scale, bias, None, g, relu)
    return dx, ds, db


def scale_bias_act_res_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor, residual: torch.Tensor,
                                 g: torch.Tensor, relu: bool = True):
    """The plain backward with a residual: ``(dx, dres, ds, db)``;
    ``dres`` in the residual's dtype, the rest as
    :func:`scale_bias_act_bwd_plain`."""
    return _bwd_plain(x, scale, bias, residual, g, relu)


def _bwd_plain(x, scale, bias, residual, g, relu):
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    gf = g.reshape(-1, c).float()
    s = scale.float()
    if relu:
        z = xf * s + bias.float()
        if residual is not None:
            z = z + residual.reshape(-1, c).float()
        gf = torch.where(z > 0, gf, torch.zeros((), dtype=gf.dtype,
                                                device=gf.device))
    dx = (gf * s).to(x.dtype).reshape(x.shape)
    dres = (None if residual is None
            else gf.to(residual.dtype).reshape(residual.shape))
    return dx, dres, (gf * xf).sum(0), gf.sum(0)


#: threads of a backward block, rows a thread loads before it computes,
#: the largest cluster, the clusters of that size an H100 SXM holds at
#: once, and the most threads that share a float4 of the last cluster's
#: sum (``csrc/fused_bn.cu`` ``kBwd*``)
BWD_THREADS, BWD_UNROLL, BWD_MAX_CLUSTER, BWD_MAX_CLUSTERS = 256, 4, 8, 30
BWD_FINAL_SPLIT = 16
_BWD_GEOMETRY_KEYS = ("lanes", "groups", "chunks", "tile_rows", "tiles",
                      "cluster", "clusters", "row_blocks", "scratch_floats",
                      "tickets", "smem", "slice", "final_split")


def bwd_geometry_plain(rows: int, c: int, dtype: torch.dtype) -> dict:
    """The grid of K1c/K1d at ``(rows, c)`` in ``dtype``, computed as
    ``csrc/fused_bn.cu`` ``bwd_geometry`` computes it.  A block of
    ``BWD_THREADS`` threads is ``lanes`` 16-byte channel vectors by
    ``groups`` rows, ``chunks`` blocks along C; a row tile is
    ``tile_rows`` = groups x ``BWD_UNROLL`` rows and there are ``tiles``
    of them, which ``row_blocks`` blocks walk grid-stride (block b takes
    tiles b, b + row_blocks, ...; thread (grp, lane) rows grp, grp +
    groups, ... of each).  The row blocks form ``clusters`` clusters of
    ``cluster`` blocks a chunk: one cluster of the next power of two
    blocks with up to 8 tiles, else clusters of 8.  The scratch is ``scratch_floats`` f32:
    (chunks, clusters, 2, lanes x N) partial rows, N values a vector;
    ``tickets`` int32, one a chunk and cluster rank (both 0 with one
    cluster a chunk, which writes ds/db itself); ``smem`` bytes of
    shared memory a block (its [2][groups][lanes x N] partials).  Block
    rank p of a cluster adds float4s [p x slice, (p + 1) x slice) of the
    cluster's (ds, db) row, and in the last cluster ``final_split``
    threads share each of those float4s (thread j adds cluster rows j,
    j + final_split, ... in order, then the partials are added pairwise,
    final_split / 2 apart, then / 4, ... 1)."""
    n = 16 // torch.empty((), dtype=dtype).element_size()
    cv = c // n
    lanes = min(cv, BWD_THREADS)
    groups, chunks = BWD_THREADS // lanes, -(-cv // lanes)
    tile_rows = groups * BWD_UNROLL
    tiles = -(-rows // tile_rows)
    cap = max(BWD_MAX_CLUSTER, BWD_MAX_CLUSTERS * BWD_MAX_CLUSTER // chunks
              // BWD_MAX_CLUSTER * BWD_MAX_CLUSTER)
    want = min(tiles, cap)
    cluster = 1      # the next power of two >= want, up to 8
    while cluster < min(BWD_MAX_CLUSTER, want):
        cluster *= 2
    clusters = -(-want // cluster)
    width = lanes * n
    many = clusters > 1      # one cluster a chunk writes ds/db itself
    slice_ = -(-(width // 2) // cluster)
    split = 1
    while (many and split * 2 <= BWD_FINAL_SPLIT
           and split * 2 * slice_ <= BWD_THREADS):
        split *= 2
    return dict(zip(_BWD_GEOMETRY_KEYS, (
        lanes, groups, chunks, tile_rows, tiles, cluster, clusters,
        cluster * clusters, many * chunks * clusters * 2 * width,
        many * chunks * cluster, 2 * groups * width * 4, slice_, split)))


def bwd_geometry(rows: int, c: int, dtype: torch.dtype) -> dict:
    """:func:`bwd_geometry_plain` as the built library computes it
    (``tm_scale_bias_act_bwd_geometry``; so only where it builds)."""
    fn = _kernels.load("fused_bn").tm_scale_bias_act_bwd_geometry
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_BWD_GEOMETRY_KEYS))()
    if fn(rows, c, _DTYPE_CODES[dtype], out) != 0:
        raise ValueError(f"no backward grid for {dtype} (rows, C) = "
                         f"{(rows, c)}")
    return dict(zip(_BWD_GEOMETRY_KEYS, out))


def scale_bias_act_bwd(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, g: torch.Tensor,
                       residual: torch.Tensor | None = None,
                       relu: bool = True):
    """The backward of :func:`scale_bias_act`: ``(dx, dres, ds, db)``
    (``dres`` None without a residual).  On a CUDA tensor it launches
    K1c or K1d; on a CPU tensor it runs the plain version.  All tensors
    must be contiguous and ``g`` must have x's shape (the kernels also
    x's dtype)."""
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    for name, t in (("x", x), ("g", g), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"scale_bias_act_bwd needs a contiguous {name}")
    if _kernels.on_cpu(x):
        return _bwd_plain(x, scale, bias, residual, g, relu)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x)
    dres = None if residual is None else torch.empty_like(residual)
    ds = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dres, ds.zero_(), db.zero_()
    _check_cuda(x, scale, bias, residual, x.dtype)
    if g.dtype != x.dtype:
        raise TypeError(f"scale_bias_act_bwd kernel takes g in x's dtype "
                        f"{x.dtype}, got {g.dtype}")
    if g.device != x.device or g.data_ptr() % 16:
        raise ValueError("scale_bias_act_bwd kernel needs g 16-byte aligned "
                         "on x's device")
    geo = bwd_geometry_plain(rows, c, x.dtype)
    part = torch.empty(geo["scratch_floats"], dtype=torch.float32,
                       device=x.device)
    tickets = torch.empty(geo["tickets"], dtype=torch.int32, device=x.device)
    kernel = K_BWD if residual is None else K_BWD_RES
    kernel(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           None if residual is None else residual.data_ptr(), g.data_ptr(),
           dx.data_ptr(), None if dres is None else dres.data_ptr(),
           part.data_ptr(), tickets.data_ptr(), ds.data_ptr(), db.data_ptr(),
           rows, c, geo["scratch_floats"], geo["tickets"],
           _DTYPE_CODES[x.dtype], int(relu))
    return dx, dres, ds, db


class ScaleBiasAct(torch.autograd.Function):
    """``act(x * scale + bias [+ residual])`` under autograd: the forward
    kernel (K1a/K1b) saves its inputs, the backward kernel (K1c/K1d)
    recomputes the relu mask from them.  An incoming gradient that is
    not contiguous is copied first (and counted in
    :data:`grad_copies`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act, out_dtype):
        ctx.relu = act == "relu"
        ctx.save_for_backward(x, scale, bias, residual)
        return _forward(x, scale, bias, residual, act, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, residual = ctx.saved_tensors
        if not g.is_contiguous():
            grad_copies.add()
            g = g.contiguous()
        dx, dres, ds, db = scale_bias_act_bwd(x, scale, bias, g, residual,
                                              ctx.relu)
        return (dx, ds.to(scale.dtype), db.to(bias.dtype), dres, None, None)


def scale_bias_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None = None,
                   act: str | None = "relu",
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(x * scale + bias [+ residual])`` over channel-last ``x``.

    ``scale``/``bias`` are ``(C,)`` vectors (the folded BN affine);
    ``residual`` matches ``x``.  Inputs must be contiguous: the kernel
    reads the ``(N*H*W, C)`` row-major view and no copy is made here.
    Differentiable: when autograd records the call the backward runs
    :func:`scale_bias_act_bwd`."""
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, bias, residual)):
        return ScaleBiasAct.apply(x, scale, bias, residual, act, out_dtype)
    return _forward(x, scale, bias, residual, act, out_dtype)


def _forward(x, scale, bias, residual, act, out_dtype):
    if _kernels.on_cpu(x):
        return scale_bias_act_plain(x, scale, bias, residual, act, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    _check_cuda(x, scale, bias, residual, out_dtype)
    c = x.shape[-1]
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
