"""The port's stem max-pool (theanompi_tpu_torch/ops/maxpool.py) on the
CPU against the JAX package's Pallas ``maxpool3x3s2`` (interpret mode).
A max selects one of its inputs, so the two must agree exactly: values,
NaN positions and -inf windows.  Under autograd both save the argmax tap
and the backward gathers g by it, adding in g's dtype in the same order
(the class planes of the Pallas ``_bwd_kernel``), so the gradients must
agree exactly too, in f32 and in bf16.
"""

import jax
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
    with pytest.raises(ValueError, match="even H and W"):
        jax.vjp(jax_pool, jnp.asarray(x))
    with pytest.raises(ValueError, match="even H and W"):
        maxpool.maxpool_stem(torch.from_numpy(x).requires_grad_())


def _vjp_both(x: np.ndarray, g: np.ndarray, dtype: str):
    """(port y, port dx, JAX y, JAX dx) under autograd / jax.vjp."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y, vjp = jax.vjp(jax_pool, jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = maxpool.maxpool_stem(tx)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tx.grad.dtype == tdt
    return (ty.detach().float().numpy(), tx.grad.float().numpy(),
            np.asarray(y, np.float32), np.asarray(dx, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_argmax_forward_and_gather_backward_tie_free(dtype):
    rng = np.random.default_rng(4)
    x = rng.permutation(2 * 12 * 10 * 16).reshape(2, 12, 10, 16)
    x = (x / 64.0).astype(np.float32)
    g = rng.standard_normal((2, 6, 5, 16)).astype(np.float32)
    y, dx, want_y, want_dx = _vjp_both(x, g, dtype)
    _assert_exact(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)
    # the argmax forward is the value forward, and its taps are 0..8
    tx = torch.from_numpy(x)
    y2, idx = maxpool.maxpool3x3s2_argmax(tx)
    assert torch.equal(y2, maxpool.maxpool3x3s2(tx))
    assert idx.dtype == torch.int8 and 0 <= idx.min() and idx.max() <= 8


def test_gather_backward_conserves_mass_with_ties():
    """Ties route each window's gradient to one pixel (the first in
    row-major order): the gradient sums agree, window by window."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 3, (2, 8, 8, 8)).astype(np.float32)   # many ties
    g = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    y, dx, want_y, want_dx = _vjp_both(x, g, "float32")
    _assert_exact(y, want_y)
    np.testing.assert_allclose(dx.sum((1, 2)), g.sum((1, 2)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(dx, want_dx)   # same first-max rule


def test_gather_backward_nan_and_all_neg_inf_windows():
    """The first NaN of a window claims it and sticks; an all-(-inf)
    window routes its gradient to its centre pixel."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    x[0, 0:2, 0:2, :] = -np.inf           # window (0, 0): centre is (0, 0)
    x[0, 3, 4, 2] = np.nan
    x[0, 4, 4, 2] = np.nan                # same window, later tap
    g = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    y, dx, want_y, want_dx = _vjp_both(x, g, "float32")
    _assert_exact(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)
    np.testing.assert_array_equal(dx[0, 0, 0], g[0, 0, 0])
    _, idx = maxpool.maxpool3x3s2_argmax(torch.from_numpy(x))
    assert (idx[0, 0, 0] == 4).all()
    assert idx[0, 2, 2, 2] == 1         # (3, 4) is tap (0, 1) of (2, 2)


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
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        maxpool.maxpool_stem(torch.zeros((1, 8, 8, 16), requires_grad=True))
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        maxpool.maxpool3x3s2_bwd(torch.zeros((1, 4, 4, 16)),
                                 torch.zeros((1, 4, 4, 16), dtype=torch.int8))
    assert maxpool.K_POOL.launches == 0
    assert maxpool.K_POOL_ARGMAX.launches == maxpool.K_POOL_BWD.launches == 0
