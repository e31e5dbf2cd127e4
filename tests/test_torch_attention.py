"""The port's attention (ops/attention.py) on the CPU against the JAX
package's Pallas kernels, run in interpret mode as tests/test_ops.py runs
them.

The same numpy inputs (drawn from a seed) go to both.  On the CPU the
port's wrappers take their plain versions, which repeat the Pallas
kernels' arithmetic.  Tolerances, and why:

* float32: both sum the scores, the softmax and the products over the
  same terms in different orders: ``1e-5`` of each output's largest
  magnitude (o and the gradients alike).
* ``lse``, both dtypes: 1e-5 of ``max(|lse|, 1)`` per row, and exact
  on a row that sees no key (``attention.tolerance_excess``).
* bfloat16: the outputs are rounded to bf16 once, and an f32 difference
  of a few ulps can round to the neighbouring bf16 value: the limits of
  ``attention.tolerance_excess`` (o per element within 2 bf16 ulps of
  its row's largest magnitude plus 2^-7 of its row's ``sum(p |v|) / l``;
  dq, dk, dv within 1e-4 of their largest magnitude plus one bf16 ulp of
  each element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theanompi_tpu.ops.attention as JA
from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.ops import attention as A

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def inputs(b, tq, tk, h, d, dtype, seed=0):
    """q, k, v, g as numpy f32 arrays (rounded to bf16 first for a bf16
    case, so both packages see the same values)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for t in (tq, tk, tk, tq)]
    if dtype == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def to_jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def to_torch(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][2])


def check(name, got, want, dtype, fwd_inputs=None):
    """``got`` (torch) against ``want`` (jax) under the module
    docstring's limits; ``fwd_inputs`` as ``A.tolerance_excess`` takes
    them, for a bf16 o."""
    want_t = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    if dtype == "float32" and name != "lse":
        assert_close(got.float().numpy(), want_t.numpy(), rtol=0,
                     floor=1e-5, msg=name)
    else:
        excess = A.tolerance_excess(name, got, want_t.to(got.dtype),
                                    fwd_inputs)
        assert excess <= 1.0, (name, excess)


def jax_fwd(q, k, v, q_pos, k_pos, causal, dtype):
    scale = q.shape[-1] ** -0.5
    return JA._pallas_attention(
        to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype),
        jnp.asarray(q_pos), jnp.asarray(k_pos), scale, causal,
        interpret=True)


CASES = [
    # b, tq, tk, h, d, causal, q_offset
    (2, 16, 16, 2, 8, True, 0),
    (2, 16, 16, 2, 8, False, 0),
    (1, 8, 24, 2, 8, True, 16),      # global positions: a later shard
    (1, 12, 24, 3, 16, True, -5),    # 5 rows see no key at all
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,q_off", CASES)
def test_forward_matches_pallas_interpret(dtype, b, tq, tk, h, d, causal,
                                         q_off):
    q, k, v, _ = inputs(b, tq, tk, h, d, dtype)
    q_pos, k_pos = q_off + np.arange(tq), np.arange(tk)
    jo, jlse = jax_fwd(q, k, v, q_pos, k_pos, causal, dtype)
    fwd_inputs = (to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
                  torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                  d ** -0.5, causal)
    o, lse = A.attention_fwd(*fwd_inputs[:5], causal=causal)
    assert o.dtype == DTYPES[dtype][2] and o.shape == (b, tq, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, tq)
    check("o", o, jo, dtype, fwd_inputs)
    check("lse", lse, jnp.reshape(jlse, (b * h, tq)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,q_off", CASES)
def test_backward_matches_pallas_interpret(dtype, b, tq, tk, h, d, causal,
                                          q_off):
    """The plain K4b from the JAX forward's own lse, against the Pallas
    ``_bwd_kernel`` on the same inputs."""
    q, k, v, g = inputs(b, tq, tk, h, d, dtype, seed=1)
    q_pos, k_pos = q_off + np.arange(tq), np.arange(tk)
    _, jlse = jax_fwd(q, k, v, q_pos, k_pos, causal, dtype)
    want = JA._pallas_attention_bwd(
        to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype),
        jnp.asarray(q_pos), jnp.asarray(k_pos), jlse, to_jax(g, dtype),
        d ** -0.5, causal, interpret=True)
    got = A.attention_bwd(
        to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        torch.from_numpy(np.asarray(jlse).reshape(b * h, tq)),
        to_torch(g, dtype), causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == DTYPES[dtype][2]
        check(name, a, w, dtype)


def test_fully_masked_rows_get_the_uniform_distribution():
    """A row that sees no key attends uniformly (the finite -1e30 mask),
    forward and backward: its o is the mean of v, its lse -1e30, and its
    g reaches every key's dv with weight 1/Tk."""
    b, tq, tk, h, d = 1, 6, 10, 2, 4
    q, k, v, g = inputs(b, tq, tk, h, d, "float32", seed=2)
    g[:, 3:] = 0.0                     # only the masked rows 0-2 pull
    q_pos, k_pos = np.arange(tq) - 3, np.arange(tk)   # rows 0-2: none
    tq_, tk_, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = A.attention_fwd(tq_, tk_, tv, torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), causal=True)
    np.testing.assert_allclose(o[:, :3].numpy(),
                               np.broadcast_to(v.mean(1, keepdims=True),
                                               (b, 3, h, d)), rtol=1e-5,
                               atol=1e-6)
    assert (lse.reshape(b, h, tq)[..., :3] == -1e30).all()
    _, _, dv = A.attention_bwd(tq_, tk_, tv, torch.from_numpy(q_pos),
                               torch.from_numpy(k_pos), lse, tg, causal=True)
    want = np.broadcast_to(g[:, :3].sum(1, keepdims=True) / tk, dv.shape)
    np.testing.assert_allclose(dv.numpy(), want, rtol=1e-5, atol=1e-6)
    _, jlse = jax_fwd(q, k, v, q_pos, k_pos, True, "float32")
    jdv = JA._pallas_attention_bwd(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), jlse,
        jnp.asarray(g), d ** -0.5, True, interpret=True)[2]
    assert_close(dv.numpy(), np.asarray(jdv), rtol=0, floor=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,qblock", [(16, 256), (20, 8), (24, 8)])
def test_fused_attention_vjp_matches_jax(monkeypatch, dtype, causal, t,
                                        qblock):
    """``fused_attention`` under autograd against the JAX ``custom_vjp``
    (``impl='pallas'``) under ``jax.vjp``.  With a q-block of 8, T=24
    loops three exact blocks in the Pallas backward and T=20 is ragged,
    where the JAX backward takes its composed-XLA ``_xla_bwd``; the port
    has one backward for every T."""
    monkeypatch.setattr(JA, "_Q_BLOCK", qblock)
    b, h, d = 2, 2, 8
    q, k, v, g = inputs(b, t, t, h, d, dtype, seed=3)
    jo, vjp = jax.vjp(lambda q_, k_, v_: JA.fused_attention(
        q_, k_, v_, causal=causal, impl="pallas"),
        *(to_jax(a, dtype) for a in (q, k, v)))
    jgrads = vjp(to_jax(g, dtype))
    tq_, tk_, tv = (to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    o = A.fused_attention(tq_, tk_, tv, causal=causal)
    o.backward(to_torch(g, dtype))
    pos = torch.arange(t)
    check("o", o.detach(), jo, dtype,
          (tq_.detach(), tk_.detach(), tv.detach(), pos, pos, d ** -0.5,
           causal))
    for name, t_, w in zip(("dq", "dk", "dv"), (tq_, tk_, tv), jgrads):
        check(name, t_.grad, w, dtype)


def test_autograd_function_runs_the_plain_backward():
    """On CPU tensors the Function's backward is the plain K4b on the
    forward's lse; no kernel is launched."""
    q, k, v, g = (torch.from_numpy(a) for a in inputs(2, 12, 12, 2, 8,
                                                       "float32", seed=4))
    before = _kernels.launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    A.fused_attention(*leaves, causal=True).backward(g)
    pos = torch.arange(12, dtype=torch.int32)
    _, lse = A.attention_fwd_plain(q, k, v, pos, pos, 8 ** -0.5, True)
    want = A.attention_bwd_plain(q, k, v, pos, pos, lse, g, 8 ** -0.5, True)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    assert _kernels.launch_counts() == before
    # without autograd the forward alone runs
    with torch.no_grad():
        out = A.fused_attention(q, k, v, causal=True)
    assert torch.equal(out, A.attention_fwd_plain(q, k, v, pos, pos,
                                                  8 ** -0.5, True)[0])


def test_bf16_limits_catch_a_late_row_fault():
    """The bf16 limits of ``A.tolerance_excess`` are per row: the plain o
    passes against itself, but a fault of 0.008 max|v| in the PV part of
    the last row (where |o| is small: about 3 times that row's limit), or
    a row that sees no key given a moved lse or a non-uniform o, goes
    over."""
    q, k, v, _ = (to_torch(a, "bfloat16")
                  for a in inputs(1, 64, 64, 2, 16, "bfloat16", seed=6))
    q_pos, k_pos = torch.arange(64) - 4, torch.arange(64)   # rows 0-3: none
    fwd_inputs = (q, k, v, q_pos, k_pos, 0.25, True)
    o, lse = A.attention_fwd_plain(*fwd_inputs)
    # rows 0-3 are held to the f32 mean of v: o rounds it by half an ulp
    assert A.tolerance_excess("o", o, o, fwd_inputs) <= 0.25
    assert A.tolerance_excess("lse", lse, lse) == 0.0
    late = o.float().clone()
    late[0, -1, 0] += 0.008 * v.float().abs().max()
    assert A.tolerance_excess("o", late.bfloat16(), o, fwd_inputs) > 1.0
    masked = o.float().clone()
    masked[0, 0, 0, 0] += 0.1
    assert A.tolerance_excess("o", masked.bfloat16(), o, fwd_inputs) > 1.0
    moved = lse.clone()
    moved[0, 0] = -0.99e30
    assert A.tolerance_excess("lse", moved, lse) == float("inf")


def _skip_positions(kind):
    """(q_pos, k_pos, causal) of a skip-rule case, 48 keys."""
    rng = np.random.default_rng(7)
    t = np.arange(48)
    return {"arange": (t, t, True),
            "later shard": (t[:24] + 16, t, True),
            "rows see no key": (t[:40] - 12, t, True),
            "shuffled": (rng.permutation(48), rng.permutation(48), True),
            "duplicates": (t // 3, t // 3, True),
            "shuffled duplicates": (rng.permutation(48) // 5,
                                    rng.permutation(48) // 5, True),
            "non-causal": (t, t, False)}[kind]


@pytest.mark.parametrize("kind,some", [
    ("arange", True), ("later shard", True), ("rows see no key", True),
    ("shuffled", False), ("duplicates", True), ("shuffled duplicates", False),
    ("non-causal", False)])
def test_skipped_tiles_hold_only_exact_zeros(kind, some):
    """Every pair that ``A.skipped_tiles`` (the bf16 kernels' skip rule)
    skips holds p exactly 0 in ``attention_fwd_plain``'s softmax and in
    ``attention_bwd_plain``'s renormalized p, and no query tile holding a
    row that sees no key skips anything (such a row averages every
    key).  Tiles of 8 over 48 keys."""
    q_pos, k_pos, causal = (torch.from_numpy(np.asarray(a)) if
                            isinstance(a, np.ndarray) else a
                            for a in _skip_positions(kind))
    tq, tk, tile = len(q_pos), len(k_pos), 8
    q, k, v, _ = (torch.from_numpy(a)
                  for a in inputs(2, tq, tk, 2, 4, "float32", seed=8))
    grid = A.skipped_tiles(q_pos, k_pos, causal, tile, tile)
    assert grid.shape == (-(-tq // tile), -(-tk // tile))
    assert bool(grid.any()) == some, grid
    skip = grid.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    skip = skip[:tq, :tk]
    s = A._masked_scores(q, k, q_pos, k_pos, 0.5, causal)
    p_fwd = torch.exp(s - s.amax(-1, keepdim=True))
    _, lse = A.attention_fwd_plain(q, k, v, q_pos, k_pos, 0.5, causal)
    p_bwd = torch.exp(s - lse.reshape(2, 2, tq, 1))
    p_bwd = p_bwd / p_bwd.sum(-1, keepdim=True)
    for p in (p_fwd, p_bwd):
        assert (p[:, :, skip] == 0).all()
    if causal:
        sees_none = ~(q_pos[:, None] >= k_pos[None, :]).any(1)
        rows_tile = torch.arange(tq) // tile
        for i in rows_tile[sees_none].unique():
            assert not grid[i].any()
        if sees_none.any():
            assert (p_bwd[:, :, sees_none] == 1 / tk).all()


def test_skipped_tiles_count_the_causal_half():
    """At T = 1024 in tiles of 64 (the LM slice), a causal arange visits
    136 of the 256 tile pairs per (b, h): the diagonal and below."""
    t = torch.arange(1024, dtype=torch.int32)
    grid = A.skipped_tiles(t, t, True)
    assert grid.shape == (16, 16) and int((~grid).sum()) == 136
    assert torch.equal(grid, torch.ones(16, 16, dtype=torch.bool).triu(1))
    assert not A.skipped_tiles(t, t, False).any()


def test_scale_and_block_helpers_match_jax():
    q, k, _, _ = inputs(1, 5, 7, 2, 4, "float32", seed=5)
    want = JA.block_scores(jnp.asarray(q), jnp.asarray(k), 0.3)
    assert_close(A.block_scores(torch.from_numpy(q), torch.from_numpy(k),
                                0.3).numpy(), np.asarray(want), rtol=1e-6,
                 floor=1e-6)
    qp, kp = np.arange(5) + 2, np.arange(7)
    np.testing.assert_array_equal(
        A.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp)).numpy(),
        np.asarray(JA.causal_mask(jnp.asarray(qp), jnp.asarray(kp))))
    assert A._MASK_NEG == JA._MASK_NEG


def test_refusals():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match=r"\(B, T, H, D\)"):
        A.fused_attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="k .* and v"):
        A.fused_attention(x, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 2, 4, 8).transpose(1, 2)
        A.fused_attention(y, y, y)
    with pytest.raises(ValueError, match="positions"):
        A.fused_attention(x, x, x, q_pos=torch.arange(5), causal=True)
    with pytest.raises(ValueError, match="lse"):
        A.attention_bwd(x, x, x, None, None, torch.zeros(3, 4), x)
