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
