"""Sequence/context parallelism: ring, all-gather and Ulysses attention.

Counterpart of ``theanompi_tpu/parallel/sequence.py``.  The TIME
dimension is cut over the mesh's ``seq`` axis: rank ``i`` of the seq
group holds global positions ``[i*T_local, (i+1)*T_local)``.  Every
strategy takes and returns the local shard (B, T_local, H, D) and is
differentiable; ``seq`` is the seq axis' ``AxisGroup``
(parallel/mesh.py).  JAX gets each collective's backward by
differentiating ``ppermute``, ``all_gather`` and ``all_to_all``; here
each collective is a ``torch.autograd.Function`` whose backward is the
transposed collective:

* :func:`ring_attention` (plain PyTorch, as JAX composes it from
  ``_block_scores``): blockwise attention with the online softmax in
  f32 and the finite ``_MASK_NEG``; K/V rotate one hop around the seq
  group per block (:class:`_RingShift`, ``batch_isend_irecv`` so neither
  direction blocks the other; its backward sends the cotangent the
  other way).  Step 0 is the rank's own block (``src = idx - step``):
  with a finite mask value a row whose FIRST block is fully masked
  would otherwise add ``exp(0)`` terms before its running max is real.
* :func:`allgather_attention`: K/V all-gathered over the group
  (:class:`_AllGatherTime`; backward: the sum over the ranks of the
  full cotangent, then this rank's slice, as an ``all_to_all_single``
  and a local sum in rank order), then the fused K4 kernels
  (ops/attention.py) with global positions ``q_pos = idx*T_local +
  arange`` and ``k_pos = arange(n*T_local)``: ``Tq != Tk``, and the
  bf16 kernels' tile skip plans from the offset positions.
* :func:`ulysses_attention`: an ``all_to_all_single`` from (time-cut,
  all heads) to (all time, head-cut) (:class:`_Ulysses`, whose backward
  is the inverse all-to-all), K4 on the local heads over the whole
  sequence, then the inverse.  Needs ``H % n == 0``.

A seq group of one rank issues no collective: ring attention is one
block, the other two call K4 on the local tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from theanompi_tpu_torch.ops.attention import (
    _MASK_NEG,
    block_scores as _block_scores,
    causal_mask as _causal_mask,
    fused_attention,
)


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain single-device attention (the correctness oracle): f32
    scores, softmax, ``p`` cast to v's dtype for the PV product."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _block_scores(q, k, scale)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = _causal_mask(torch.arange(tq, device=q.device),
                            torch.arange(tk, device=q.device))
        s = s.masked_fill(~mask[None, None], _MASK_NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


class _RingShift(torch.autograd.Function):
    """Send K and V (stacked, one message) to the next rank of the ring
    and take the previous rank's; the backward sends the cotangents to
    the previous rank and takes the next one's."""

    @staticmethod
    def forward(ctx, k, v, seq):
        ctx.seq = seq
        out = _shift(torch.stack([k, v]), seq, +1)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, gk, gv):
        g = _shift(_stack_grads(gk, gv), ctx.seq, -1)
        return g[0], g[1], None


def _stack_grads(*grads) -> torch.Tensor:
    """One tensor of the cotangents of a multi-output collective (an
    unused output's is zero), so its transpose is ONE collective: ranks
    whose autograd engines ran two independent collectives in different
    orders would pair them wrongly."""
    like = next(g for g in grads if g is not None)
    return torch.stack([torch.zeros_like(like) if g is None else g
                        for g in grads])


def _shift(x: torch.Tensor, seq, hop: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, seq.peer(seq.index + hop)),
           dist.P2POp(dist.irecv, out, seq.peer(seq.index - hop))]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_attention(q, k, v, seq=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Blockwise ring attention over the ``seq`` group (module
    docstring): the local time shard in, the local shard out, in q's
    dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n = 1 if seq is None else seq.size
    idx = 0 if seq is None else seq.index
    b, t_local, h, d = q.shape
    ar = torch.arange(t_local, device=q.device)
    q_pos = idx * t_local + ar
    m = torch.full((b, h, t_local), _MASK_NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                      device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        # after ``step`` hops this rank holds the block of ring
        # neighbour idx - step (step 0: its own)
        src = (idx - step) % n
        s = _block_scores(q, k_blk, scale)            # (B,H,Tq,Tk)
        if causal:
            keep = _causal_mask(q_pos, src * t_local + ar)
            s = s.masked_fill(~keep[None, None], _MASK_NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if step + 1 < n:
            k_blk, v_blk = _RingShift.apply(k_blk, v_blk, seq)
    out = acc / l[..., None]                          # (B,H,Tq,D)
    return out.transpose(1, 2).to(q.dtype)            # (B,Tq,H,D)


def _all_to_all(x: torch.Tensor, seq) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` (n, ...) over the group: row j goes
    to rank j, row i of the result came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=seq.group)
    return out


class _AllGatherTime(torch.autograd.Function):
    """K and V (B, T_local, ...) -> (B, n*T_local, ...) in rank order, one
    all-gather; the backward sums the full cotangents over the ranks and
    keeps this rank's time block, one all-to-all."""

    @staticmethod
    def forward(ctx, k, v, seq):
        ctx.seq = seq
        n = seq.size
        x = torch.stack([k, v])                       # (2, B, T, ...)
        out = x.new_empty((n * 2,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=seq.group)
        out = out.view((n,) + tuple(x.shape))         # (n, 2, B, T, ...)
        full = out.permute(1, 2, 0, *range(3, out.dim())).reshape(
            (2, k.shape[0], n * k.shape[1]) + tuple(k.shape[2:]))
        return full[0], full[1]

    @staticmethod
    def backward(ctx, gk, gv):
        n = ctx.seq.size
        g = _stack_grads(gk, gv)                      # (2, B, nT, ...)
        b, t = g.shape[1], g.shape[2] // n
        blocks = g.reshape((2, b, n, t) + tuple(g.shape[3:])).movedim(2, 0)
        g = _all_to_all(blocks, ctx.seq).sum(0)       # (2, B, T, ...)
        return g[0], g[1], None


def allgather_attention(q, k, v, seq=None, causal: bool = False,
                        scale: Optional[float] = None):
    """K/V all-gathered over the seq group, the local Q shard attends
    through K4 with global positions (module docstring)."""
    if seq is None or seq.trivial:
        return fused_attention(q, k, v, causal=causal, scale=scale)
    n, t_local = seq.size, q.shape[1]
    k_full, v_full = _AllGatherTime.apply(k, v, seq)
    if not causal:
        return fused_attention(q, k_full, v_full, causal=False, scale=scale)
    q_pos = seq.index * t_local + torch.arange(t_local, device=q.device)
    k_pos = torch.arange(n * t_local, device=q.device)
    return fused_attention(q, k_full, v_full, q_pos=q_pos, k_pos=k_pos,
                           causal=True, scale=scale)


def _to_headshard(x: torch.Tensor, seq) -> torch.Tensor:
    """(S, B, T/n, H, D) -> (S, B, T, H/n, D) for S stacked tensors, one
    all-to-all: head block j to rank j, the time blocks received
    concatenated in rank order."""
    n = seq.size
    s, b, t, h, d = x.shape
    blocks = x.reshape(s, b, t, n, h // n, d).permute(3, 0, 1, 2, 4, 5)
    recv = _all_to_all(blocks, seq)             # (n, S, B, T/n, H/n, D)
    return recv.permute(1, 2, 0, 3, 4, 5).reshape(s, b, n * t, h // n, d)


def _to_timeshard(x: torch.Tensor, seq) -> torch.Tensor:
    """(S, B, T, H/n, D) -> (S, B, T/n, H, D): the inverse of
    :func:`_to_headshard`."""
    n = seq.size
    s, b, t, hl, d = x.shape
    blocks = x.reshape(s, b, n, t // n, hl, d).permute(2, 0, 1, 3, 4, 5)
    recv = _all_to_all(blocks, seq)             # (n, S, B, T/n, H/n, D)
    return recv.permute(1, 2, 3, 0, 4, 5).reshape(s, b, t // n, n * hl, d)


class _Ulysses(torch.autograd.Function):
    """The Ulysses layout swap of S stacked tensors (q, k and v together:
    one collective each way); ``to_heads`` picks the direction, the
    backward runs the other one."""

    @staticmethod
    def forward(ctx, x, seq, to_heads: bool):
        ctx.seq, ctx.to_heads = seq, to_heads
        return (_to_headshard if to_heads else _to_timeshard)(x, seq)

    @staticmethod
    def backward(ctx, g):
        back = _to_timeshard if ctx.to_heads else _to_headshard
        return back(g.contiguous(), ctx.seq), None, None


def ulysses_attention(q, k, v, seq=None, causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all head/time reshard around K4 on the local heads (the
    DeepSpeed-Ulysses layout): (B, T/n, H, D) -> (B, T, H/n, D) ->
    attend -> back.  Requires H % n == 0."""
    n = 1 if seq is None else seq.size
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by seq "
                         f"axis ({n})")
    if n == 1:
        return fused_attention(q, k, v, causal=causal, scale=scale)
    qh, kh, vh = _Ulysses.apply(torch.stack([q, k, v]), seq, True).unbind()
    out = fused_attention(qh, kh, vh, causal=causal, scale=scale)
    return _Ulysses.apply(out[None], seq, False)[0]


STRATEGIES = {
    "ring": ring_attention,
    "allgather": allgather_attention,
    "ulysses": ulysses_attention,
}


def sequence_attention(q, k, v, seq=None, causal: bool = False,
                       scale: Optional[float] = None,
                       strategy: str = "ring"):
    """Dispatch on the SP strategy name (JAX's string-keyed seam)."""
    try:
        fn = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"unknown sequence-parallel strategy {strategy!r}; "
            f"available: {sorted(STRATEGIES)}") from None
    return fn(q, k, v, seq=seq, causal=causal, scale=scale)
