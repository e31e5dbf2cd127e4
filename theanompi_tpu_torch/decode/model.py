"""Cached-attention forward over the training transformer's modules.

Counterpart of ``theanompi_tpu/decode/model.py``.  The decode path
shares weights with models/transformer.py's :class:`~theanompi_tpu_torch.
models.transformer.TransformerLMNet`: every function here takes the net
and calls ITS submodules (``Embed_0``, ``pos_emb``, each block's
``LayerNorm_0``/``q_proj``/.../``mlp_down``, the final ``LayerNorm_0``
and ``Dense_0``), so the layers' numerics are the training net's.  Only
the attention is composed here, as in the JAX package (which runs no
Pallas kernel on this path): f32 scores (``block_scores``), the finite
mask value ``-1e30``, the token's own score column concatenated after
the ring's, one softmax, and two einsums.

* :func:`full_forward` — logits and per-layer K/V of a (B, T) prompt,
  with an optional sliding-window causal mask (``window``, the KV ring's
  capacity): without one it is the training eval path; with one, the
  oracle for decode past an eviction boundary.
* :func:`decode_block` / :func:`chunk_block` / :func:`embed_tokens` /
  :func:`final_logits` — what the session's one-token and chunk steps
  compose around the paged gather (decode/session.py).
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.models import layers as L

#: finite mask value (the JAX package's ``ops/attention._MASK_NEG``):
#: exp(-1e30 - m) underflows to exactly 0 once a real score is seen
MASK_NEG = -1e30


def block_scores(q: torch.Tensor, k: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """q (B, Tq, H, D) x k (B, Tk, H, D) -> f32 scores (B, H, Tq, Tk):
    the operands widened to f32, so the products and the sum are f32 as
    JAX's ``preferred_element_type=float32``."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def embed_tokens(net, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Token embedding plus the positional rows at arbitrary absolute
    ``positions``; f32 (the caller casts to the compute dtype, as the
    training net does)."""
    return net.Embed_0(tokens) + net.pos_emb[positions]


def final_logits(net, x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + LM head -> f32 logits."""
    return net.Dense_0(net.LayerNorm_0(x)).float()


def _qkv(block, x: torch.Tensor, n_heads: int):
    b, t, d = x.shape
    shape = (b, t, n_heads, d // n_heads)
    h = block.LayerNorm_0(x)
    return (block.q_proj(h).reshape(shape), block.k_proj(h).reshape(shape),
            block.v_proj(h).reshape(shape))


def _finish(block, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    x = x + block.o_proj(o)
    h = L.gelu(block.mlp_up(block.LayerNorm_1(x)))
    return x + block.mlp_down(h)


def _block_full(block, x: torch.Tensor, n_heads: int,
                window: int | None):
    """One pre-LN block over a full (B, T, D) sequence; returns the
    block output and its K/V (B, T, H, Dh)."""
    b, t, d = x.shape
    q, k, v = _qkv(block, x, n_heads)
    s = block_scores(q, k, (d // n_heads) ** -0.5)
    qi = torch.arange(t, device=x.device)[:, None]
    kj = torch.arange(t, device=x.device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask = mask & (qi - kj < window)
    s = torch.where(mask[None, None], s, MASK_NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return _finish(block, x, o.reshape(b, t, d)), k, v


def full_forward(net, tokens: torch.Tensor, window: int | None = None):
    """Whole-prompt forward: (B, T) tokens -> (f32 logits (B, T, V),
    [k_l], [v_l]) with per-layer K/V (B, T, H, Dh).  ``window`` bounds
    each query's attention to the last ``window`` positions: the ring's
    eviction as a mask, the oracle decode must match past the
    boundary."""
    t = tokens.shape[1]
    pos = torch.arange(t, device=tokens.device)
    x = embed_tokens(net, tokens, pos).to(net.dtype)
    ks, vs = [], []
    for block in net.blocks:
        x, k, v = _block_full(block, x, block.n_heads, window)
        ks.append(k)
        vs.append(v)
    return final_logits(net, x), ks, vs


def chunk_block(block, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, ring_mask: torch.Tensor,
                window: int | None = None):
    """One block for a CHUNK of C new tokens per sequence against the
    ring (the speculative verify step, the prefix-hit extend and the
    batched prefill).  ``x``: (S, C, D), token ``i`` at position
    ``length + i``; ``k_cache``/``v_cache``: (S, W, H, Dh) gathered
    ring (pre-write); ``ring_mask``: (S, C, W).  Each chunk token
    attends the masked ring plus the chunk's earlier tokens and itself
    (causal, window-limited when ``window`` is given).  Returns (x_out
    (S, C, D), k_new (S, C, H, Dh), v_new)."""
    s_, c, d = x.shape
    q, k_new, v_new = _qkv(block, x, block.n_heads)
    scale = (d // block.n_heads) ** -0.5
    sc = block_scores(q, k_cache, scale)                # (S, H, C, W)
    sc = torch.where(ring_mask[:, None], sc, MASK_NEG)
    self_sc = block_scores(q, k_new, scale)             # (S, H, C, C)
    ci = torch.arange(c, device=x.device)
    cmask = ci[None, :] <= ci[:, None]
    if window is not None:
        cmask = cmask & (ci[:, None] - ci[None, :] < window)
    self_sc = torch.where(cmask[None, None], self_sc, MASK_NEG)
    p = torch.softmax(torch.cat([sc, self_sc], dim=-1), dim=-1)
    w = k_cache.shape[1]
    o_cache = torch.einsum("bhqk,bkhd->bqhd",
                           p[..., :w].to(v_cache.dtype), v_cache)
    o_self = torch.einsum("bhqk,bkhd->bqhd",
                          p[..., w:].to(v_new.dtype), v_new)
    o = (o_cache + o_self).reshape(s_, c, d)
    return _finish(block, x, o), k_new, v_new


def decode_block(block, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, mask: torch.Tensor):
    """One block for ONE new token per sequence against the ring.
    ``x``: (S, 1, D); ``k_cache``/``v_cache``: (S, W, H, Dh) gathered
    ring (pre-write); ``mask``: (S, W) (the slot this token overwrites
    is already excluded).  The token attends the masked ring plus
    itself, its K/V appended as a W+1'th key.  Returns (x_out (S, 1,
    D), k_new (S, H, Dh), v_new)."""
    s_, _, d = x.shape
    q, k_new, v_new = _qkv(block, x, block.n_heads)
    scale = (d // block.n_heads) ** -0.5
    sc = block_scores(q, k_cache, scale)                # (S, H, 1, W)
    sc = torch.where(mask[:, None, None, :], sc, MASK_NEG)
    self_sc = block_scores(q, k_new, scale)             # (S, H, 1, 1)
    p = torch.softmax(torch.cat([sc, self_sc], dim=-1), dim=-1)
    o_cache = torch.einsum("bhqk,bkhd->bqhd",
                           p[..., :-1].to(v_cache.dtype), v_cache)
    o_self = p[..., -1:].permute(0, 3, 1, 2).to(v_new.dtype) * v_new
    o = (o_cache + o_self).reshape(s_, 1, d)
    return _finish(block, x, o), k_new[:, 0], v_new[:, 0]
