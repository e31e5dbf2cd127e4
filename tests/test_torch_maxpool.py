"""The port's stem max-pool (theanompi_tpu_torch/ops/maxpool.py) on the
CPU against the JAX package's Pallas ``maxpool3x3s2`` (interpret mode).
A max selects one of its inputs, so the two must agree exactly: values,
NaN positions and -inf windows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from theanompi_tpu.ops.maxpool_pallas import maxpool3x3s2 as jax_pool
from theanompi_tpu_torch.ops import maxpool


def _both(x: np.ndarray, dtype: str):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jax_pool(jnp.asarray(x, jdt)), np.float32)
    got = maxpool.maxpool_stem(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    return got.float().numpy(), want


def _assert_exact(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)   # NaN == NaN here


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tie_free_exact(dtype):
    rng = np.random.default_rng(0)
    # a permutation: no two inputs equal, so no tie to break
    x = rng.permutation(2 * 12 * 10 * 16).reshape(2, 12, 10, 16)
    x = (x / 64.0).astype(np.float32)
    got, want = _both(x, dtype)
    _assert_exact(got, want)
    if dtype == "float32":
        # and the plain version is a true 3x3/2/1 max pool
        ref = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
        np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_propagates(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    x[0, 3, 4, 2] = np.nan
    x[1, 0, 0, :] = np.nan
    x[1, 6, 7, 5] = np.nan
    got, want = _both(x, dtype)
    assert np.isnan(want).sum() >= 4
    _assert_exact(got, want)


def test_all_neg_inf_window():
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 8)).astype(
        np.float32)
    x[0, 0:2, 0:2, :] = -np.inf     # the whole window of output (0, 0)
    x[0, 4, 4, 3] = -np.inf
    got, want = _both(x, "float32")
    assert np.isneginf(want[0, 0, 0]).all()
    _assert_exact(got, want)


@pytest.mark.parametrize("shape", [(1, 7, 8, 8), (1, 8, 9, 8)])
def test_odd_spatial_size_raises(shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="even H and W"):
        jax_pool(jnp.asarray(x))
    with pytest.raises(ValueError, match="even H and W"):
        maxpool.maxpool_stem(torch.from_numpy(x))


def test_non_contiguous_raises():
    x = torch.zeros((1, 8, 8, 16))[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        maxpool.maxpool3x3s2(x)


def test_device_tensor_without_library_raises(monkeypatch, tmp_path):
    """Off the CPU the pool launches its kernel or raises; it never
    takes the plain version."""
    from theanompi_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        maxpool.maxpool3x3s2(torch.zeros((1, 8, 8, 16)))
    assert maxpool.K_POOL.launches == 0
