"""The port's fused BN epilogue (theanompi_tpu_torch/ops/fused_bn.py) on
the CPU against the JAX package's ``scale_bias_act``: the Pallas kernel
in interpret mode and the plain XLA path.  The same numpy inputs go to
both.

Tolerances: both compute x*s+b (+res) in f32 and cast once, but XLA
may contract the multiply-add into an FMA on the CPU, which moves a
result by up to one f32 ulp of the product: ``atol=1e-6`` on O(1)
operands.  f32 ``rtol=1e-6`` (a few ulp); bf16 ``rtol=2**-7`` (one bf16
ulp, where that f32 difference tips the final rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops.fused_bn import scale_bias_act as jax_sba
from theanompi_tpu_torch.ops import _kernels, fused_bn

# 128 channels: JAX tiles 1024 (f32) / 2048 (bf16) rows, so 4133 rows
# leave a ragged last block in both dtypes
ROWS, C = 4133, 128


def _inputs(seed: int, rows: int = ROWS, c: int = C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c)).astype(np.float32)
    res = rng.standard_normal((rows, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return x, res, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
def test_matches_jax_pallas_and_xla(dtype, residual, act):
    seed = 4 * (dtype == "bfloat16") + 2 * residual + (act == "relu")
    x, res, scale, bias = _inputs(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jres = jnp.asarray(x, jdt), jnp.asarray(res, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tres = torch.from_numpy(res).to(tdt) if residual else None
    got = fused_bn.scale_bias_act(tx, torch.from_numpy(scale),
                                  torch.from_numpy(bias), tres, act)
    assert got.dtype == tdt and got.shape == (ROWS, C)
    rtol = 2**-7 if dtype == "bfloat16" else 1e-6
    for impl in ("pallas", "xla"):
        want = jax_sba(jx, jnp.asarray(scale), jnp.asarray(bias),
                       residual=jres if residual else None, act=act,
                       impl=impl)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-6, err_msg=impl)


def test_zero_size_input():
    x = torch.zeros((0, C))
    y = fused_bn.scale_bias_act(x, torch.ones(C), torch.zeros(C))
    want = jax_sba(jnp.zeros((0, C)), jnp.ones(C), jnp.zeros(C),
                   impl="pallas")
    assert tuple(y.shape) == want.shape == (0, C)


def test_nhwc_input_and_out_dtype():
    """A 4-D activation is read as its (N*H*W, C) view; out_dtype casts
    (the flax canonicalize_dtype result of BatchNormAct)."""
    x, res, scale, bias = _inputs(seed=3, rows=2 * 5 * 6, c=16)
    x4 = x.reshape(2, 5, 6, 16)
    got = fused_bn.scale_bias_act(
        torch.from_numpy(x4).bfloat16(), torch.from_numpy(scale),
        torch.from_numpy(bias), act="relu", out_dtype=torch.float32)
    want = jax_sba(jnp.asarray(x4, jnp.bfloat16), jnp.asarray(scale),
                   jnp.asarray(bias), act="relu", impl="pallas",
                   out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rejects_bad_arguments():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="unknown act"):
        fused_bn.scale_bias_act(x, torch.ones(8), torch.zeros(8), act="gelu")
    with pytest.raises(ValueError, match="channel vectors"):
        fused_bn.scale_bias_act(x, torch.ones(4), torch.zeros(8))
    with pytest.raises(ValueError, match="residual"):
        fused_bn.scale_bias_act(x, torch.ones(8), torch.zeros(8),
                                residual=torch.zeros((4, 4)))


def test_non_contiguous_input_raises():
    x = torch.zeros((8, 16))[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_bn.scale_bias_act(x, torch.ones(8), torch.zeros(8))
    res = torch.zeros((16, 8)).t()   # (8, 16), column-major
    with pytest.raises(ValueError, match="contiguous"):
        fused_bn.scale_bias_act(torch.zeros((8, 16)), torch.ones(16),
                                torch.zeros(16), residual=res)


def test_device_tensor_without_library_raises(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel or raises: with no nvcc
    and nothing built, the wrapper raises instead of taking the plain
    version, and counts no launch."""
    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    before = _kernels.launch_counts()
    x = torch.zeros((16, 64))
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        fused_bn.scale_bias_act(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(_kernels.KernelBuildError):
        fused_bn.scale_bias_act(x, torch.ones(64), torch.zeros(64),
                                residual=torch.zeros((16, 64)))
    assert _kernels.launch_counts() == before
