"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``gpu``: without a card every test here skips (the check
is made inside the ``cuda`` fixture, never at import).  On a machine
with a card (``--noconftest``: ``tests/conftest.py`` imports JAX, which a
machine set up for the port need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from theanompi_tpu_torch.ops import _kernels, fused_bn, maxpool

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
def test_maxpool_argmax_and_bwd_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 16, 12, 32, generator=gen, device=cuda).to(dtype)
    x[0, 0:2, 0:2, :] = float("-inf")          # all-(-inf) window
    x[1, 3, 5, :4] = float("nan")
    x[1, 4, 4, :4] = float("nan")               # a second NaN, same window
    x[2, 6:9, 6:9, :] = 1.0                     # ties
    before = (maxpool.K_POOL_ARGMAX.launches, maxpool.K_POOL_BWD.launches)
    y, idx = maxpool.maxpool3x3s2_argmax(x)
    want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
    g = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
    dx = maxpool.maxpool3x3s2_bwd(g, idx)
    want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
    torch.cuda.synchronize()
    assert (maxpool.K_POOL_ARGMAX.launches, maxpool.K_POOL_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(idx, want_idx)
    assert torch.equal(dx, want_dx)
    assert (idx[0, 0, 0] == 4).all()


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
