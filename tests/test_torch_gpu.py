"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``gpu``: without a card every test here skips (the check
is made inside the ``cuda`` fixture, never at import).  On a machine
with a card (``--noconftest``: ``tests/conftest.py`` imports JAX, which a
machine set up for the port need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

import chip_smoke
from theanompi_tpu_torch.ops import _kernels, attention, fused_bn, lrn, maxpool

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
def test_scale_bias_act_kernel_matches_plain(cuda, dtype, residual, act):
    gen = torch.Generator(device=cuda).manual_seed(0)
    rows, c = 1037, 64      # a ragged row count
    x = torch.randn(rows, c, generator=gen, device=cuda).to(dtype)
    res = (torch.randn(rows, c, generator=gen, device=cuda).to(dtype)
           if residual else None)
    scale = torch.rand(c, generator=gen, device=cuda) + 0.5
    bias = torch.randn(c, generator=gen, device=cuda)
    kernel = fused_bn.K_FWD_RES if residual else fused_bn.K_FWD
    before = kernel.launches
    y = fused_bn.scale_bias_act(x, scale, bias, res, act)
    want = fused_bn.scale_bias_act_plain(x, scale, bias, res, act)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    # one rounding per op in both: bit-exact
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 16, 12, 32, generator=gen, device=cuda).to(dtype)
    x[0, 0:2, 0:2, :] = float("-inf")
    x[1, 3, 5, :4] = float("nan")
    before = maxpool.K_POOL.launches
    y = maxpool.maxpool3x3s2(x)
    want = maxpool.maxpool3x3s2_plain(x)
    torch.cuda.synchronize()
    assert maxpool.K_POOL.launches == before + 1
    torch.testing.assert_close(y, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isneginf(y[0, 0, 0]).all()


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16)  # C % 8 != 0
    with pytest.raises(ValueError, match="C % 8"):
        fused_bn.scale_bias_act(x, torch.ones(12, device=cuda),
                                torch.zeros(12, device=cuda))
    assert set(_kernels.build()) == set(_kernels.SOURCES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rows,c", [(1037, 64), (50, 2048), (3, 6144)])
def test_scale_bias_act_bwd_kernel_matches_plain(cuda, dtype, residual, relu,
                                                 rows, c):
    """dx and dres are elementwise and rounded once: bit-exact.  ds/db
    sum in another order than the plain version: within 1e-5 of the
    sum of magnitudes."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, g = (torch.randn(rows, c, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    res = (torch.randn(rows, c, generator=gen, device=cuda).to(dtype)
           if residual else None)
    scale = torch.rand(c, generator=gen, device=cuda) + 0.5
    bias = torch.randn(c, generator=gen, device=cuda)
    kernel = fused_bn.K_BWD_RES if residual else fused_bn.K_BWD
    before = kernel.launches
    dx, dres, ds, db = fused_bn.scale_bias_act_bwd(x, scale, bias, g, res,
                                                   relu)
    want = fused_bn._bwd_plain(x, scale, bias, res, g, relu)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(dx, want[0])
    if residual:
        assert torch.equal(dres, want[1])
    gm = g.float()
    if relu:
        z = x.float() * scale + bias + (res.float() if residual else 0)
        gm = torch.where(z > 0, gm, 0)
    assert ((ds - want[2]).abs()
            <= 1e-5 * (gm * x.float()).abs().sum(0)).all()
    assert ((db - want[3]).abs() <= 1e-5 * gm.abs().sum(0)).all()


def test_scale_bias_act_autograd_runs_the_backward_kernel(cuda):
    x = torch.randn(2, 6, 6, 64, device=cuda).bfloat16().requires_grad_()
    scale = (torch.rand(64, device=cuda) + 0.5).requires_grad_()
    bias = torch.randn(64, device=cuda).requires_grad_()
    before = fused_bn.K_BWD.launches
    fused_bn.scale_bias_act(x, scale, bias).float().sum().backward()
    torch.cuda.synchronize()
    assert fused_bn.K_BWD.launches == before + 1
    assert x.grad.dtype == torch.bfloat16 and scale.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 14, 14, 64), (3, 7, 7, 528)])
def test_bias_act_runs_k1a_and_k1c_at_unit_scale(cuda, dtype, shape):
    """The BN-free zoo's conv epilogue (``layers.BiasAct``): K1a forward
    and K1c backward with the constant unit scale, bit-exact against the
    plain versions (dx too; db within 1e-5 of the sum of |g|), and the
    scale receives no gradient."""
    from theanompi_tpu_torch.models.layers import BiasAct

    gen = torch.Generator(device=cuda).manual_seed(3)
    layer = BiasAct(shape[-1]).to(cuda)
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.5, generator=gen)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    xr = x.clone().requires_grad_()
    before = (fused_bn.K_FWD.launches, fused_bn.K_BWD.launches)
    y = layer(xr)
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_bn.K_FWD.launches, fused_bn.K_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    ones = layer.ones()
    assert ones.device == x.device and ones.grad is None
    assert torch.equal(y, fused_bn.scale_bias_act_plain(x, ones, layer.bias))
    dx, _, _, db = fused_bn._bwd_plain(x, ones, layer.bias.detach(), None,
                                        g, True)
    assert torch.equal(xr.grad, dx)
    z = x.float() + layer.bias.detach()
    gm = torch.where(z > 0, g.float(), 0).reshape(-1, shape[-1])
    assert ((layer.bias.grad - db).abs() <= 1e-5 * gm.abs().sum(0)).all()


@pytest.mark.parametrize("shape,n,k,alpha,dtype", [
    ((64, 56, 56, 64), 5, 2.0, 1e-4, torch.bfloat16),    # GoogLeNet stem
    ((64, 56, 56, 192), 5, 2.0, 1e-4, torch.bfloat16),
    ((128, 15, 15, 32), 3, 1.0, 5e-5, torch.float32),    # Cifar10
    ((128, 7, 7, 32), 3, 1.0, 5e-5, torch.float32)])
def test_lrn_kernels_match_plain_at_the_zoo_shapes(cuda, shape, n, k, alpha,
                                                   dtype):
    """K3a/K3b at GoogLeNet's batch-64 and Cifar10's batch-128 shapes,
    with each model's n, k and alpha: 0 ulp from the plain versions."""
    x, g = _lrn_inputs(cuda, shape, dtype)
    y = lrn.lrn_fwd(x, n, k, alpha)
    dx = lrn.lrn_bwd(x, g, n, k, alpha)
    assert torch.equal(y, lrn.lrn_plain(x, n, k, alpha))
    assert torch.equal(dx, lrn.lrn_bwd_plain(x, g, n, k, alpha))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", chip_smoke.K2_EDGE_SHAPES)
def test_maxpool_argmax_and_bwd_kernels_match_plain(cuda, dtype, shape):
    """K2b/K2c at the edges of their tiles (``chip_smoke.K2_EDGE_SHAPES``)
    with an all-(-inf) window, two NaNs in one window, ties, and quads
    whose bf16 (f32) sum depends on the order: y's bits (NaNs too), idx
    and dx equal the plain versions', each quad's pixel is the plain
    order's 0, and each kernel launched once."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, g, quads = chip_smoke.k2_edge_case(torch, shape, dtype, gen)
    before = (maxpool.K_POOL_ARGMAX.launches, maxpool.K_POOL_BWD.launches)
    y, idx = maxpool.maxpool3x3s2_argmax(x)
    dx = maxpool.maxpool3x3s2_bwd(g, idx)
    torch.cuda.synchronize()
    assert (maxpool.K_POOL_ARGMAX.launches, maxpool.K_POOL_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
    want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
    assert torch.isnan(want_y).sum() == 2
    assert torch.equal(_bits(y), _bits(want_y))
    assert torch.equal(idx, want_idx)
    assert torch.equal(dx, want_dx)
    assert (idx[0, 0, 0] == 4).all() and torch.isneginf(y[0, 0, 0]).all()
    for iy, ix in quads:
        assert not dx[0, iy, ix].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_train_geometry_matches_its_mirror(cuda, dtype):
    """The tiles ``csrc/maxpool.cu`` computes are those of the Python
    mirror that the CPU tests check for coverage."""
    lanes = 16 // torch.empty((), dtype=dtype).element_size()
    for _, h, w, c in chip_smoke.K2_EDGE_SHAPES + [(128, 112, 112, 64)]:
        for bwd in (False, True):
            assert maxpool.train_geometry(bwd, dtype, h, w, c or lanes) == (
                maxpool.train_geometry_plain(bwd, dtype, h, w, c or lanes))


def test_training_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 8, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        maxpool.maxpool3x3s2_argmax(x)
    g = torch.zeros(2, 4, 4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32|bfloat16"):
        maxpool.maxpool3x3s2_bwd(g, torch.zeros(g.shape, dtype=torch.int8,
                                                device=cuda))
    x = torch.zeros(4, 16, device=cuda)
    with pytest.raises(TypeError, match="x's dtype"):
        fused_bn.scale_bias_act_bwd(x, torch.ones(16, device=cuda),
                                    torch.zeros(16, device=cuda),
                                    x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fused_bn.scale_bias_act_bwd(x, torch.ones(16, device=cuda),
                                    torch.zeros(16, device=cuda),
                                    torch.zeros(16, 4, device=cuda).t())
    xa = torch.zeros(4 * 16 + 1, device=cuda)[1:].view(4, 16)  # misaligned
    with pytest.raises(ValueError, match="16-byte"):
        fused_bn.scale_bias_act_bwd(xa, torch.ones(16, device=cuda),
                                    torch.zeros(16, device=cuda),
                                    torch.zeros(4, 16, device=cuda))


def test_prefetcher_stages_batches_on_the_unindexed_card(cuda):
    import numpy as np

    from theanompi_tpu_torch.data.prefetch import DevicePrefetcher

    host = [(np.full((4, 3), i, np.uint8), np.arange(4) + i)
            for i in range(5)]
    with DevicePrefetcher(iter(host), cuda) as pf:
        got = [tuple(t.cpu().numpy() for t in b) for b in pf]
    assert len(got) == len(host)
    for (x, y), (gx, gy) in zip(host, got):
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy, y)


def _lrn_inputs(cuda, shape, dtype, offset=0):
    """x ~ N(0, 20^2) (so a*W(x^2) is live) and g ~ N(0, 1); ``offset``
    elements into a fresh buffer (an offset that breaks 16-byte
    alignment sends the kernels down their scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    n = 1
    for d in shape:
        n *= d
    x = torch.randn(n + offset, generator=gen, device=cuda) * 20
    g = torch.randn(n + offset, generator=gen, device=cuda)
    return (x.to(dtype)[offset:].view(shape),
            g.to(dtype)[offset:].view(shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n,offset", [
    ((128, 55, 55, 96), 5, 0), ((128, 27, 27, 256), 5, 0),
    ((2, 9, 7, 32), 3, 0), ((3, 11, 13, 96), 4, 0),
    ((1, 33, 33, 96), 5, 0),        # 1089 rows: a ragged last tile
    ((2, 5, 7, 33), 5, 0),          # C not a multiple of the vector
    ((2, 5, 7, 32), 5, 1),          # misaligned: the scalar path
    ((2, 5, 7, 96), 5, 8),          # 16-byte aligned, not at the start
    ((2, 3, 1, 1), 1, 0), ((2, 3, 1, 1), 2, 0),   # C 1: n > 2C + 1
    ((1, 2, 3, 7), 7, 0), ((1, 2, 3, 7), 9, 0), ((2, 3, 5, 7), 31, 0),
    ((1, 3, 2, 9), 2, 0), ((1, 3, 2, 9), 9, 0),
    ((1, 1, 3, 4096), 1, 0), ((1, 1, 3, 4096), 5, 0),
    ((1, 1, 3, 4096), 7, 0), ((1, 1, 2, 4096), 2, 0),
    ((1, 1, 1, 96), 5, 0),          # one row
    # ("tile", C, d): the kernels' rows per tile for (C, n), plus d
    (("tile", 96, -1), 5, 0), (("tile", 96, 1), 5, 0),
    (("tile", 256, -1), 5, 0), (("tile", 256, 1), 5, 0),
    (("tile", 33, 1), 4, 0), (("tile", 96, 1), 3, 8)])
def test_lrn_kernels_match_plain(cuda, dtype, shape, n, offset):
    """K3a/K3b against their plain versions: the same f32 operations in
    the same order, rounded once, so bit-exact."""
    if shape[0] == "tile":
        _, c, d = shape
        shape = (1, 1, lrn.tile_geometry(c, n)["rows"] + d, c)
    x, g = _lrn_inputs(cuda, shape, dtype, offset)
    before = (lrn.K_FWD.launches, lrn.K_BWD.launches)
    y = lrn.lrn_fwd(x, n)
    dx = lrn.lrn_bwd(x, g, n)
    want_y, want_dx = lrn.lrn_plain(x, n), lrn.lrn_bwd_plain(x, g, n)
    torch.cuda.synchronize()
    assert (lrn.K_FWD.launches, lrn.K_BWD.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert y.dtype == dx.dtype == dtype
    assert torch.equal(y, want_y)
    assert torch.equal(dx, want_dx)


def test_lrn_tile_geometry_fits_every_c(cuda):
    """For every C the kernels take and windows from 1 tap to far wider
    than the row: a tile's rows fit the block's 256 x 16 element slots,
    its planes fit a block's 232 448 bytes of shared memory, and
    each row's zero columns cover the window cut to C."""
    for c in range(1, lrn.MAX_CHANNELS + 1):
        for n in {1, 2, 5, 9, 2 * c + 1, 2 * c + 2, 10 ** 6}:
            geo = lrn.tile_geometry(c, n)
            reach = min(max((n - 1) // 2, n - 1 - (n - 1) // 2), c)
            assert 1 <= geo["rows"] and geo["rows"] * c <= 4096, (c, n, geo)
            assert geo["bwd_smem_bytes"] <= 232448, (c, n, geo)
            assert geo["pad"] >= reach and geo["pad"] % 4 == 0, (c, n, geo)
            assert geo["stride"] >= c + 2 * geo["pad"], (c, n, geo)
            plane = 4 * geo["rows"] * geo["stride"]
            assert (geo["fwd_smem_bytes"], geo["bwd_smem_bytes"]) == (
                2 * plane, 3 * plane), (c, n, geo)


def test_lrn_autograd_runs_both_kernels(cuda):
    x, g = _lrn_inputs(cuda, (2, 6, 6, 96), torch.bfloat16)
    x.requires_grad_()
    before = (lrn.K_FWD.launches, lrn.K_BWD.launches)
    lrn.lrn(x).backward(g)
    torch.cuda.synchronize()
    assert (lrn.K_FWD.launches, lrn.K_BWD.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.equal(x.grad, lrn.lrn_bwd_plain(x.detach(), g))


def test_lrn_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32|bfloat16"):
        lrn.lrn(torch.zeros(1, 2, 2, 8, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="C <= 4096"):
        lrn.lrn(torch.zeros(1, 1, 2, 4097, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn(torch.zeros(1, 2, 8, 4, device=cuda).transpose(2, 3))
    x = torch.zeros(1, 2, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        lrn.lrn_bwd(x, x.bfloat16())


def _attention_inputs(cuda, b, tq, tk, h, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    g = torch.randn(b, tq, h, d, generator=gen, device=cuda).to(dtype)
    return q, k, v, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,q_off", [
    (2, 256, 256, 3, 64, True, 0),
    (2, 256, 256, 3, 64, False, 0),
    (1, 100, 200, 2, 32, True, 100),     # global positions, Tq != Tk
    (1, 96, 160, 2, 64, True, -40),      # 40 rows see no key at all
    (2, 77, 77, 2, 64, True, 0),         # ragged T
    (1, 130, 70, 2, 48, True, 10),       # D padded to 64, ragged both
    (1, 64, 64, 2, 128, True, 0),
    (1, 33, 33, 3, 16, False, 0),
    (2, 256, 256, 2, 64, True, None),    # shuffled positions
    (1, 160, 256, 2, 64, True, -40),     # a tile straddles the no-key border
    (1, 65, 130, 2, 64, True, 0),        # ragged Tk = 130, Tq = 65
    (1, 128, 128, 2, 40, True, 0),       # D = 40, padded
    (1, 70, 90, 2, 20, True, 5),         # D % 8 != 0: plain loads
    (1, 64, 66000, 1, 16, True, 65950)])  # over 1024 key tiles: chunks
def test_attention_kernels_match_plain(cuda, dtype, b, tq, tk, h, d, causal,
                                       q_off):
    """K4a and both K4b passes against their plain versions, within the
    limits of ``attention.tolerance_excess`` (stated there).  ``q_off``
    None: both position vectors are random permutations, so the bf16
    kernels' tile skipping cannot assume sorted positions."""
    q, k, v, g = _attention_inputs(cuda, b, tq, tk, h, d, dtype)
    if q_off is None:
        gen = torch.Generator().manual_seed(3)
        q_pos = torch.randperm(tq, generator=gen).to(cuda)
        k_pos = torch.randperm(tk, generator=gen).to(cuda)
    else:
        q_pos = torch.arange(tq, device=cuda) + q_off
        k_pos = torch.arange(tk, device=cuda)
    ks = (attention.K_FWD, attention.K_BWD_DQ, attention.K_BWD_DKDV)
    before = [kk.launches for kk in ks]
    o, lse = attention.attention_fwd(q, k, v, q_pos, k_pos, causal=causal)
    grads = attention.attention_bwd(q, k, v, q_pos, k_pos, lse, g,
                                    causal=causal)
    scale = d ** -0.5
    want_o, want_lse = attention.attention_fwd_plain(
        q, k, v, q_pos.int(), k_pos.int(), scale, causal)
    want = attention.attention_bwd_plain(q, k, v, q_pos.int(), k_pos.int(),
                                         lse, g, scale, causal)
    torch.cuda.synchronize()
    assert [kk.launches for kk in ks] == [n + 1 for n in before]
    assert o.dtype == dtype and lse.shape == (b * h, tq)
    assert all(t.dtype == dtype for t in grads)
    fwd_inputs = (q, k, v, q_pos, k_pos, scale, causal)
    excess = {"o": attention.tolerance_excess("o", o, want_o, fwd_inputs),
              "lse": attention.tolerance_excess("lse", lse, want_lse)}
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        excess[name] = attention.tolerance_excess(name, got, w)
    assert max(excess.values()) <= 1.0, excess
    if q_off is not None and q_off < 0:
        # a row that sees no key averages v uniformly
        torch.testing.assert_close(o[:, 0].float(),
                                   v.float().mean(1), rtol=0, atol=2e-2)


def test_attention_bf16_backward_is_deterministic(cuda):
    """No atomics: two bf16 backward calls at the LM slice's causal shape
    (batch 2) give bit-identical dq, dk and dv."""
    q, k, v, g = _attention_inputs(cuda, 2, 1024, 1024, 12, 64,
                                   torch.bfloat16, seed=5)
    _, lse = attention.attention_fwd(q, k, v, causal=True)
    first = attention.attention_bwd(q, k, v, None, None, lse, g, causal=True)
    second = attention.attention_bwd(q, k, v, None, None, lse, g,
                                     causal=True)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_attention_autograd_runs_all_three_kernels(cuda):
    q, k, v, g = _attention_inputs(cuda, 2, 128, 128, 2, 64, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ks = (attention.K_FWD, attention.K_BWD_DQ, attention.K_BWD_DKDV)
    before = [kk.launches for kk in ks]
    attention.fused_attention(q, k, v, causal=True).backward(g)
    torch.cuda.synchronize()
    assert [kk.launches for kk in ks] == [n + 1 for n in before]
    _, lse = attention.attention_fwd_plain(
        q.detach(), k.detach(), v.detach(),
        torch.arange(128, device=cuda), torch.arange(128, device=cuda),
        64 ** -0.5, True)
    want = attention.attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), torch.arange(128, device=cuda),
        torch.arange(128, device=cuda), lse, g, 64 ** -0.5, True)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert attention.tolerance_excess(name, t.grad, w) <= 1.0, name


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 1, 8, device=cuda)
    with pytest.raises(TypeError, match="float32|bfloat16"):
        attention.fused_attention(x.half(), x.half(), x.half())
    big = torch.zeros(1, 4, 1, 160, device=cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        attention.fused_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 2, 4, 8, device=cuda).transpose(1, 2)
        attention.fused_attention(y, y, y)
    with pytest.raises(TypeError, match="dtype"):
        attention.fused_attention(x, x.bfloat16(), x)


def test_checkpoint_snapshot_is_taken_before_save_returns(cuda, tmp_path):
    """The async contract on the card: ``save`` copies every tensor off
    the card before it returns, so kernels queued right after it (the
    next step's in-place update) never reach the file."""
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    n = 1 << 22
    w = torch.arange(n, dtype=torch.float32, device=cuda)
    b = torch.ones(n, dtype=torch.bfloat16, device=cuda)
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"params": {"w": w, "b": b}, "step": 1})
    w.add_(1.0)
    b.mul_(3.0)
    ck.save(1, {"params": {"w": w, "b": b}, "step": 2})
    w.add_(1.0)
    ck.close()
    first, second = ck.restore(0), ck.restore(1)
    want = torch.arange(n, dtype=torch.float32)
    assert torch.equal(first["params"]["w"], want)
    assert torch.equal(first["params"]["b"], torch.ones(n).bfloat16())
    assert torch.equal(second["params"]["w"], want + 1)
    assert torch.equal(second["params"]["b"], torch.full((n,), 3.0).bfloat16())


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A trained ResNet's payload restored with ``map_location='cuda:0'``
    lands on the card, and a fresh model that adopts it holds the saved
    state bit for bit (its digest equals the one taken at save)."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.utils.checkpoint import (
        Checkpointer,
        state_digest,
    )

    def model():
        data = ImageNet_data(crop=64, seed=0, synthetic_n=16,
                             synthetic_pool=4, synthetic_store=72)
        m = ResNet50(device="cuda", stage_sizes=(1, 1, 1, 1), crop=64,
                     data=data)
        m.compile_iter_fns()
        return m

    trained = model()
    x, y = next(iter(trained.data.train_batches(0, 8)))
    trained.train_step(trained.state, (torch.from_numpy(x).to(cuda),
                                       torch.from_numpy(y).to(cuda)),
                       trained._epoch_rng(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(0, trained.checkpoint_payload(0))
    payload = ck.restore(0, map_location="cuda:0")
    assert ck.saved_digest(0) == state_digest(trained.checkpoint_payload())
    ck.close()
    assert all(t.device == torch.device("cuda", 0)
               for t in payload["params"].values())
    fresh = model()
    fresh.adopt_restored_state(payload)
    assert next(iter(fresh.state.optimizer.state.values()))[
        "momentum_buffer"].device.type == "cuda"
    assert state_digest(fresh.checkpoint_payload()) == ck.saved_digest(0)
