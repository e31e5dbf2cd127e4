"""Fused softmax attention: the transformer family's hot op.

Counterpart of ``theanompi_tpu/ops/attention.py``.  Layout (B, T, H, D)
at every public function, as in the JAX package; optional global
positions ``q_pos`` (Tq,) and ``k_pos`` (Tk,) drive the causal mask
(``q_pos >= k_pos``; default: local aranges), and a masked score is the
finite ``_MASK_NEG`` so no softmax accumulator meets ``inf - inf``.

Hand-written kernels in ``csrc/attention.cu``, each beside the plain
PyTorch version it is checked against (a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, never falls back):

* K4a :func:`attention_fwd` (plain :func:`attention_fwd_plain`, the
  Pallas ``_kernel``): f32 scores, f32 softmax, ``p`` rounded to v's
  dtype before the PV product, ``l`` summed from the unrounded ``p``, and
  the per-row ``lse = m + log l`` as (B*H, Tq) f32;
* K4b :func:`attention_bwd` (plain :func:`attention_bwd_plain`, the
  Pallas ``_bwd_kernel``): ``p = exp(s - lse)`` renormalized by its row
  sum (which gives a fully masked row its uniform 1/Tk), then ``dv``,
  ``dq``, ``dk`` in f32.  Two kernels, both counted: a row pass
  (``attention_bwd_dq``: dq and each row's ``1/sum p`` and
  ``sum(dp p)/sum p``) and a column pass (``attention_bwd_dkdv``).

Two routes in the kernels, by dtype alone: bfloat16 (the models' training
dtype) runs on the tensor cores (``mma.sync`` bf16 products with f32
sums, the backward's f32 ``p`` and ``ds`` fed as a bf16 pair hi + lo,
``cp.async`` copies into a two-stage ring) and skips the (query tile, key
tile) pairs that :func:`skipped_tiles` names, where every p is exactly 0;
float32 runs on the CUDA cores in f32 and visits every tile (the tensor
cores have no exact f32 route).  A failed build or launch raises; no
route falls back to another.

The kernel's online softmax rounds ``p`` after a different subtraction
than the plain version's ``exp(s - m_final)``, and both sum in their own
order, so the two agree within stated tolerances, not bit for bit
(tests/test_torch_attention.py, chip_smoke.py).

:func:`fused_attention` is the dispatch the model calls: under autograd
:class:`FusedAttention` runs K4a, saves q, k, v, the positions and
``lse`` (the JAX ``custom_vjp``'s residuals) and runs K4b in its
backward.  There is no routing by shape: every CUDA shape goes to the
kernels, and a head dim above :data:`MAX_HEAD_DIM` raises.
"""

from __future__ import annotations

import ctypes

import torch

from theanompi_tpu_torch.ops import _kernels

#: large-negative mask value, finite (see the module docstring)
_MASK_NEG = -1e30
#: widest head dim the kernels take (shared memory holds tiles of 64 rows
#: padded to 32, 64 or 128 columns)
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k, v, q_pos, k_pos, o, lse; b, tq, tk, h, d; scale; causal, dtype;
# stream
K_FWD = _kernels.Kernel(
    "attention", "attention", "tm_attention_fwd",
    [_P] * 7 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])
# q, k, v, q_pos, k_pos, g, lse, dq, rd; dims; scale; causal, dtype; stream
K_BWD_DQ = _kernels.Kernel(
    "attention_bwd_dq", "attention", "tm_attention_bwd_dq",
    [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])
# q, k, v, q_pos, k_pos, g, lse, rd, dk, dv; dims; scale; causal, dtype;
# stream
K_BWD_DKDV = _kernels.Kernel(
    "attention_bwd_dkdv", "attention", "tm_attention_bwd_dkdv",
    [_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])


def block_scores(q: torch.Tensor, k: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """q (B,Tq,H,D) x k (B,Tk,H,D) -> (B,H,Tq,Tk) scores in f32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    return q_pos[:, None] >= k_pos[None, :]          # (Tq, Tk)


#: query rows and keys of the tiles the bf16 kernels skip or visit
TILE = 64


def _tile_range(pos: torch.Tensor, tile: int):
    """Per tile of ``tile`` positions: (min, max)."""
    n = -(-pos.numel() // tile)
    pad = n * tile - pos.numel()
    big = torch.iinfo(torch.int64).max
    lo = torch.cat([pos, pos.new_full((pad,), big)]).view(n, tile)
    hi = torch.cat([pos, pos.new_full((pad,), -big)]).view(n, tile)
    return lo.amin(1), hi.amax(1)


def skipped_tiles(q_pos, k_pos, causal: bool, tile_q: int = TILE,
                  tile_k: int = TILE) -> torch.Tensor:
    """The plain mirror of the bf16 kernels' skip rule: a boolean
    (ceil(Tq / tile_q), ceil(Tk / tile_k)) grid, True where the kernels
    skip the (query tile, key tile) pair.  A pair is skipped only when
    every key of the tile is masked for every query of the tile (its
    least k_pos is above the query tile's largest q_pos) and every query
    of the tile sees some key (its least q_pos is at least the least
    k_pos of all keys): every score of the pair is then ``_MASK_NEG``
    against a real row maximum or lse, so every p there is exactly 0.
    Positions may be in any order.  Nothing is skipped unless causal.
    Tests and ``chip_smoke.py`` use it; the kernels compute it
    themselves."""
    q_pos = torch.as_tensor(q_pos).flatten().long().cpu()
    k_pos = torch.as_tensor(k_pos).flatten().long().cpu()
    nq, nk = -(-q_pos.numel() // tile_q), -(-k_pos.numel() // tile_k)
    if not causal:
        return torch.zeros((nq, nk), dtype=torch.bool)
    q_lo, q_hi = _tile_range(q_pos, tile_q)
    k_lo, _ = _tile_range(k_pos, tile_k)
    return (k_lo[None, :] > q_hi[:, None]) & (q_lo >= k_pos.min())[:, None]


def _masked_scores(q, k, q_pos, k_pos, scale, causal):
    s = block_scores(q, k, scale)
    if causal:
        s = s.masked_fill(~causal_mask(q_pos, k_pos), _MASK_NEG)
    return s


def attention_fwd_plain(q, k, v, q_pos, k_pos, scale: float, causal: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``(o, lse)`` with o (B,Tq,H,D) in q's dtype and
    lse (B*H, Tq) f32, in the Pallas ``_kernel``'s arithmetic."""
    b, tq, h, _ = q.shape
    s = _masked_scores(q, k, q_pos, k_pos, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)                       # (B,H,Tq,1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, tq)
    return o, lse


def attention_bwd_plain(q, k, v, q_pos, k_pos, lse, g, scale: float,
                        causal: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward ``(dq, dk, dv)`` from the forward's ``lse`` and
    the incoming gradient ``g`` (q's shape), in the Pallas
    ``_bwd_kernel``'s arithmetic: all f32, rounded to the inputs'
    dtypes once."""
    b, tq, h, _ = q.shape
    s = _masked_scores(q, k, q_pos, k_pos, scale, causal)
    p = torch.exp(s - lse.reshape(b, h, tq, 1))
    p = p / p.sum(-1, keepdim=True)
    gf, vf = g.float(), v.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each |x| (f32 tensor)."""
    a = x.float().abs()
    _, e = torch.frexp(a)
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return torch.where(a > 0, ulp, torch.zeros_like(a))


def tolerance_excess(name: str, got: torch.Tensor, want: torch.Tensor,
                     fwd_inputs: tuple | None = None) -> float:
    """How far a kernel's output ``got`` lies from its plain version's
    ``want``, as the largest ``|got - want| / limit`` (at most 1 passes).
    ``name`` is ``o``, ``lse``, ``dq``, ``dk`` or ``dv``; a bfloat16
    ``o`` also needs the forward's ``fwd_inputs``, ``(q, k, v, q_pos,
    k_pos, scale, causal)``.  The limits, and why:

    * float32 ``o``, ``dq``, ``dk``, ``dv``: 2e-5 of the output's largest
      magnitude (both sum over up to Tk terms, in different orders);
    * ``lse``: 1e-5 of ``max(|lse|, 1)`` per row, and exactly ``want``
      (``_MASK_NEG``: ``log Tk`` is below its f32 ulp) on a row that sees
      no key;
    * bfloat16 ``o``, per element: 2 bf16 ulps of its row's largest
      |want| (o is rounded once on each side) plus ``2^-7 sum(p |v|) /
      l``: the online softmax rounds each p to bf16 after subtracting a
      running max, the plain version after subtracting the final one,
      each within 2^-8 of p.  A row that sees no key has p = 1 exactly
      and no such term, and is held to the mean of v over the keys;
    * bfloat16 ``dq``, ``dk``, ``dv``: 1e-4 of the largest magnitude
      plus one bf16 ulp of each element (the f32 sums agree to about
      1e-6 and may round to neighbouring bf16 values)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    if name == "lse":
        limit = torch.where(want > _MASK_NEG / 2,
                            1e-5 * want.abs().clamp_min(1.0), 0.0)
    elif name == "o" and bf16:
        q, k, v, q_pos, k_pos, scale, causal = fwd_inputs
        s = _masked_scores(q, k, q_pos, k_pos, scale, causal)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        vf = v.float()
        spread = torch.einsum("bhqk,bkhd->bqhd", p, vf.abs())
        spread = spread / l.permute(0, 2, 1, 3)
        sees = (m > _MASK_NEG / 2).permute(0, 2, 1, 3)  # (B,Tq,H,1)
        want = torch.where(sees, want, vf.mean(1, keepdim=True))
        row_top = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        limit = 2 * bf16_ulp(row_top) + torch.where(sees, 2 ** -7 * spread,
                                                    0.0)
    elif name in ("o", "dq", "dk", "dv"):
        top = max(float(want.abs().max()), 1e-30)
        limit = (1e-4 * top + bf16_ulp(want) if bf16
                 else torch.full_like(want, 2e-5 * top))
    else:
        raise ValueError(f"unknown output {name!r}")
    err = (got - want).abs()
    excess = torch.where(limit > 0, err / limit.clamp_min(1e-38),
                         torch.where(err > 0, torch.inf, 0.0))
    return float(torch.where(excess.isnan(), torch.inf, excess).max())


def _positions(pos, t: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(t, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device)
    if pos.shape != (t,):
        raise ValueError(f"positions of shape {tuple(pos.shape)} for a "
                         f"length-{t} axis")
    return pos.to(torch.int32).contiguous()


def _check(name: str, q, k, v, *more) -> None:
    """Shapes, and (on the card) what the kernels take; anything else
    raises."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name} takes (B, T, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (
            b, h, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Tk, H, D) for q "
                         f"{tuple(q.shape)}")
    for t in (q, k, v, *more):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous (B, T, H, D) "
                             f"tensors (got strides {t.stride()})")
    if _kernels.on_cpu(q):
        return
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32|bfloat16, got "
                        f"{q.dtype}")
    for t in (k, v, *more):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} kernel takes every tensor in q's dtype "
                            f"{q.dtype} on {q.device}, got {t.dtype} on "
                            f"{t.device}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head dims 1 <= D <= "
                         f"{MAX_HEAD_DIM}, got D={d}")


def attention_fwd(q, k, v, q_pos=None, k_pos=None, scale: float | None = None,
                  causal: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: K4a on CUDA tensors, :func:`attention_fwd_plain` on
    CPU tensors."""
    _check("attention", q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else float(scale)
    q_pos = _positions(q_pos, tq, q.device)
    k_pos = _positions(k_pos, tk, q.device)
    if _kernels.on_cpu(q):
        return attention_fwd_plain(q, k, v, q_pos, k_pos, scale, causal)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    K_FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          q_pos.data_ptr(), k_pos.data_ptr(), o.data_ptr(), lse.data_ptr(),
          b, tq, tk, h, d, scale, int(causal), _DTYPE_CODES[q.dtype])
    return o, lse


def attention_bwd(q, k, v, q_pos, k_pos, lse, g, scale: float | None = None,
                  causal: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for the incoming gradient ``g`` (q's shape) and
    the forward's ``lse`` (B*H, Tq): the K4b row and column passes on
    CUDA tensors, :func:`attention_bwd_plain` on CPU tensors."""
    _check("attention_bwd", q, k, v, g)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must match q "
                         f"{tuple(q.shape)}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if lse.shape != (b * h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b * h}, {tq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = d ** -0.5 if scale is None else float(scale)
    q_pos = _positions(q_pos, tq, q.device)
    k_pos = _positions(k_pos, tk, q.device)
    if _kernels.on_cpu(q):
        return attention_bwd_plain(q, k, v, q_pos, k_pos, lse, g, scale,
                                   causal)
    lse = lse.contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rd = torch.empty((b * h, tq, 2), dtype=torch.float32, device=q.device)
    dims = (b, tq, tk, h, d, scale, int(causal), _DTYPE_CODES[q.dtype])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), g.data_ptr(), lse.data_ptr())
    K_BWD_DQ(q.device, *ptrs, dq.data_ptr(), rd.data_ptr(), *dims)
    K_BWD_DKDV(q.device, *ptrs, rd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               *dims)
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Attention under autograd: K4a forward saving q, k, v, the
    positions and ``lse``; K4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, causal):
        o, lse = attention_fwd(q, k, v, q_pos, k_pos, scale, causal)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, lse)
        ctx.args = (scale, causal)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, k_pos, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, q_pos, k_pos, lse,
                                   g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def fused_attention(q, k, v, q_pos=None, k_pos=None, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention.  q: (B, Tq, H, D); k, v: (B, Tk, H, D);
    optional global positions (Tq,)/(Tk,) for the causal mask (default:
    local aranges).  Returns (B, Tq, H, D) in q's dtype; differentiable in
    q, k and v through :class:`FusedAttention`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    q_pos = _positions(q_pos, q.shape[1], q.device)
    k_pos = _positions(k_pos, k.shape[1], q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, q_pos, k_pos, scale, causal)
    return attention_fwd(q, k, v, q_pos, k_pos, scale, causal)[0]
