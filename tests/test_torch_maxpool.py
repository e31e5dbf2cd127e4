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

import chip_smoke
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


def test_order_sensitive_bf16_gather_matches_pallas():
    """An odd/odd input pixel that wins all four of its windows sums four
    g terms whose bf16 result depends on the order.  The plain K2c adds
    them in the Pallas class plane's order, window (oy + 1, ox + 1)
    first, as the Pallas ``_mp_bwd`` does in interpret mode: bit for
    bit, and 0 here, where the opposite order gives 2^-7."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 10, 10, 8)).astype(np.float32)
    g = rng.standard_normal((1, 5, 5, 8)).astype(np.float32)
    # g of windows (oy, ox), (oy, ox + 1), (oy + 1, ox), (oy + 1, ox + 1)
    terms = (-1.0, 2.0 ** -8, 2.0 ** -8, 1.0)
    for iy, ix in ((1, 1), (7, 7)):
        oy, ox = iy // 2, ix // 2
        x[0, iy, ix] = 100.0
        (g[0, oy, ox], g[0, oy, ox + 1], g[0, oy + 1, ox],
         g[0, oy + 1, ox + 1]) = terms
    y, dx, want_y, want_dx = _vjp_both(x, g, "bfloat16")
    _assert_exact(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)
    assert not dx[0, 1, 1].any() and not dx[0, 7, 7].any()
    # the pin has teeth: in the opposite order the same terms give 2^-7
    acc = torch.zeros((), dtype=torch.bfloat16)
    for v in terms:
        acc = acc + torch.tensor(v, dtype=torch.bfloat16)
    assert float(acc) == 2.0 ** -7


def _tiles(geo: dict, n: int, oh: int, ow: int, cv: int):
    """Each block's tile (image, first output row, column and channel
    vector, and extent), as the kernels' ``tile_of`` reads it from
    blockIdx.x."""
    for i in range(n * geo["strips"] * geo["col_tiles"] * geo["vec_tiles"]):
        c0 = i % geo["vec_tiles"] * geo["vecs"]
        i //= geo["vec_tiles"]
        ox0 = i % geo["col_tiles"] * geo["cols"]
        i //= geo["col_tiles"]
        oy0 = i % geo["strips"] * geo["rows"]
        yield (i // geo["strips"], oy0, ox0, c0, min(geo["rows"], oh - oy0),
               min(geo["cols"], ow - ox0), min(geo["vecs"], cv - c0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape",
                         chip_smoke.K2_EDGE_SHAPES + [(2, 112, 112, 64)])
def test_train_tiles_cover_every_pixel_once(shape, dtype):
    """The blocks and threads of K2b and K2c walked over the Python
    mirror of their tiles (the card test holds ``csrc/maxpool.cu``'s
    geometry to it): K2b writes every output cell, and K2c every input
    pixel, from exactly one (block, thread); every tap or window a thread
    reads lies in what its block staged; every stage fits the block's
    shared memory."""
    lanes = 16 // torch.empty((), dtype=dtype).element_size()
    n, h, w, c = shape
    c = c or lanes
    oh, ow, cv = h // 2, w // 2, c // lanes

    def threads_work(cols, vecs):
        # (column, channel vector) of each position p of a tile; thread t
        # takes positions t, t + threads, ..., so each position one thread
        p = np.arange(cols * vecs)
        return p // vecs, p % vecs

    geo = maxpool.train_geometry_plain(False, dtype, h, w, c)
    assert geo["smem"] == ((2 * geo["rows"] + 1) * (2 * geo["cols"] + 1)
                           * geo["vecs"] * 16) <= maxpool.TILE_BYTES
    written = np.zeros((n, oh, ow, cv), np.int64)
    for b, oy0, ox0, c0, rows, cols, vecs in _tiles(geo, n, oh, ow, cv):
        ox, ch = threads_work(cols, vecs)
        # staged: input rows 2*oy0 - 1 .. 2*(oy0 + rows) - 1 and columns
        # 2*ox0 - 1 .. 2*(ox0 + cols) - 1, on the image but for the -1s
        assert 2 * (oy0 + rows) - 1 <= h - 1 and 2 * (ox0 + cols) - 1 <= w - 1
        for r in range(rows):
            np.add.at(written, (b, oy0 + r, ox0 + ox, c0 + ch), 1)
            for d in range(3):
                iy, ix = 2 * (oy0 + r) - 1 + d, 2 * (ox0 + ox) - 1 + d
                assert 2 * oy0 - 1 <= iy <= 2 * (oy0 + rows) - 1
                assert ((2 * ox0 - 1 <= ix) & (ix <= 2 * (ox0 + cols) - 1)
                        ).all()
    assert (written == 1).all()

    geo = maxpool.train_geometry_plain(True, dtype, h, w, c)
    assert geo["smem"] == ((geo["rows"] + 1) * (geo["cols"] + 1)
                           * geo["vecs"] * (16 + lanes)) <= maxpool.TILE_BYTES
    written = np.zeros((n, h, w, cv), np.int64)
    read = np.zeros((n, oh, ow, cv), np.int64)
    for b, oy0, ox0, c0, rows, cols, vecs in _tiles(geo, n, oh, ow, cv):
        ox, ch = threads_work(cols, vecs)
        for r in range(rows):
            oy = oy0 + r
            for pi in (0, 1):
                for pj in (0, 1):
                    np.add.at(written, (b, 2 * oy + pi,
                                        2 * (ox0 + ox) + pj, c0 + ch), 1)
            # windows (oy, ox) .. (oy + 1, ox + 1): staged output rows
            # oy0 .. oy0 + rows and columns ox0 .. ox0 + cols; those off
            # the image are the staged zero-g, tap -1 halo
            for a in (0, 1):
                wx = ox0 + ox + a
                assert (wx <= ox0 + cols).all() and oy + 1 <= oy0 + rows
                for wy in (oy, oy + 1)[:oh - oy]:
                    on = wx < ow
                    np.add.at(read, (b, wy, wx[on], c0 + ch[on]), 1)
    assert (written == 1).all()
    assert (read >= 1).all()


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
