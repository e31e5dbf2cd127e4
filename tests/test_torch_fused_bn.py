"""The port's fused BN epilogue (theanompi_tpu_torch/ops/fused_bn.py) on
the CPU against the JAX package's ``scale_bias_act``: the Pallas kernel
in interpret mode and the plain XLA path.  The same numpy inputs go to
both.

Tolerances: both compute x*s+b (+res) in f32 and cast once, but XLA
may contract the multiply-add into an FMA on the CPU, which moves a
result by up to one f32 ulp of the product: ``atol=1e-6`` on O(1)
operands.  f32 ``rtol=1e-6`` (a few ulp); bf16 ``rtol=2**-7`` (one bf16
ulp, where that f32 difference tips the final rounding).

Backward: ``dx = g*s`` and ``dres = g`` are one rounding of the same
product in both, so the same tolerances hold.  ``ds``/``db`` are f32
sums over thousands of rows taken in different orders (Pallas per row
tile, XLA and PyTorch their own): within ``1e-5`` of the sum of
magnitudes ``sum|g*x|`` (``sum|g|``) of each channel.  The Pallas
backward's ``ds`` is read only at a row count its tiles divide: at a
ragged count its ``_bwd_kernel`` multiplies the masked ``g`` by the
unmasked ``x`` of the padded tail rows (``fused_bn.py:90-92``), and in
interpret mode those out-of-bounds rows read as NaN, so ``0 * NaN``
makes its ``ds`` NaN there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops.fused_bn import scale_bias_act as jax_sba
from _fused_bn_order import emulate_bwd_sums
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


@pytest.mark.parametrize("rows", [ROWS, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
def test_backward_matches_jax_grad(dtype, residual, act, rows):
    """dx, dres, ds, db of the port's plain backward, called directly
    and through autograd, against ``jax.vjp`` of JAX's scale_bias_act
    (Pallas interpret mode and XLA), at a ragged row count (4133) and
    one the Pallas tiles divide (4096)."""
    seed = 10 + 4 * (dtype == "bfloat16") + 2 * residual + (act == "relu")
    x, res, scale, bias = _inputs(seed, rows=rows)
    g = np.random.default_rng(seed + 100).standard_normal(x.shape).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    tres = torch.from_numpy(res).to(tdt) if residual else None
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    relu = act == "relu"
    if residual:
        direct = fused_bn.scale_bias_act_res_bwd_plain(tx, ts, tb, tres, tg,
                                                       relu)
    else:
        dx_, ds_, db_ = fused_bn.scale_bias_act_bwd_plain(tx, ts, tb, tg,
                                                          relu)
        direct = (dx_, None, ds_, db_)
    # through autograd (ScaleBiasAct) on leaf copies of the same inputs
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (tx, ts, tb, tres)]
    fused_bn.scale_bias_act(*leaves, act=act).backward(tg)
    via_autograd = (leaves[0].grad, None if tres is None else leaves[3].grad,
                    leaves[1].grad, leaves[2].grad)

    gm = g.astype(jdt).astype(np.float32)
    if relu:
        z = (x.astype(jdt).astype(np.float32) * scale + bias
             + (res.astype(jdt).astype(np.float32) if residual else 0))
        gm = np.where(z > 0, gm, 0)
    xf = x.astype(jdt).astype(np.float32)
    ds_tol = 1e-5 * np.abs(gm * xf).sum(0)
    db_tol = 1e-5 * np.abs(gm).sum(0)
    rtol = 2**-7 if dtype == "bfloat16" else 1e-6
    for impl in ("pallas", "xla"):
        primals = [jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)]
        if residual:
            primals.append(jnp.asarray(res, jdt))

        def f(*a):
            return jax_sba(a[0], a[1], a[2], residual=a[3] if residual
                           else None, act=act, impl=impl)

        _, vjp = jax.vjp(f, *primals)
        want = vjp(jnp.asarray(g, jdt))
        for got in (direct, via_autograd):
            dx, dres, ds, db = got
            assert dx.dtype == tdt and ds.dtype == torch.float32
            np.testing.assert_allclose(dx.float().numpy(),
                                       np.asarray(want[0], np.float32),
                                       rtol=rtol, atol=1e-6, err_msg=impl)
            if residual:
                assert dres.dtype == tdt
                np.testing.assert_allclose(dres.float().numpy(),
                                           np.asarray(want[3], np.float32),
                                           rtol=rtol, atol=1e-6,
                                           err_msg=impl)
            if impl == "pallas" and rows % 1024:
                continue    # the reference's ragged-tail ds (docstring)
            assert (np.abs(ds.numpy() - np.asarray(want[1])) <= ds_tol).all()
            assert (np.abs(db.numpy() - np.asarray(want[2])) <= db_tol).all()


def test_backward_zero_size_input():
    x = torch.zeros((0, C), requires_grad=True)
    s = torch.ones(C, requires_grad=True)
    b = torch.zeros(C, requires_grad=True)
    fused_bn.scale_bias_act(x, s, b).sum().backward()
    _, vjp = jax.vjp(lambda s_, b_: jax_sba(jnp.zeros((0, C)), s_, b_,
                                            impl="pallas"),
                     jnp.ones(C), jnp.zeros(C))
    ds, db = vjp(jnp.zeros((0, C)))
    assert x.grad.shape == (0, C)
    np.testing.assert_array_equal(s.grad.numpy(), np.asarray(ds))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(db))


def test_backward_copies_a_non_contiguous_gradient_and_counts_it():
    x, _, scale, bias = _inputs(seed=9, rows=6 * 8, c=16)
    tx = torch.from_numpy(x).reshape(6, 8, 16).requires_grad_()
    y = fused_bn.scale_bias_act(tx, torch.from_numpy(scale),
                                torch.from_numpy(bias))
    before = fused_bn.grad_copies.value
    # the transpose's backward hands over a transposed gradient
    (y.transpose(1, 2) * torch.randn(6, 16, 8)).sum().backward()
    assert fused_bn.grad_copies.value == before + 1
    assert tx.grad.is_contiguous()


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
    x = torch.zeros((16, 64), requires_grad=True)
    with pytest.raises(_kernels.KernelBuildError):
        fused_bn.scale_bias_act_bwd(x.detach(), torch.ones(64),
                                    torch.zeros(64), torch.zeros((16, 64)))
    assert _kernels.launch_counts() == before


# -- the grid and reduction order of the K1c/K1d kernel ----------------------

#: (rows, C, residual?) of the backward: every K1c/K1d of a batch-128
#: ResNet-50 step (bf16, chip_smoke.py phase 5), a few of GoogLeNet's
#: batch-64 BiasAct shapes (phase 18 (d)), a ragged f32 case, and 3 row
#: tiles of a wide C (a 1x1 last stage at batch 10-12: one cluster of 4)
BWD_SHAPES = [
    *[(r, c, False, torch.bfloat16) for r, c in (
        (6272, 512), (6272, 2048), (25088, 256), (25088, 512),
        (25088, 1024), (100352, 128), (100352, 256), (100352, 512),
        (401408, 64), (401408, 128), (401408, 256), (1605632, 64))],
    *[(r, c, True, torch.bfloat16) for r, c in (
        (6272, 2048), (25088, 1024), (100352, 512), (401408, 256))],
    *[(r, c, False, torch.bfloat16) for r, c in (
        (50176, 16), (12544, 144), (802816, 64))],
    (3007, 64, True, torch.float32),
    (10, 2048, False, torch.bfloat16), (12, 1536, True, torch.bfloat16),
]
_SHAPE_IDS = [f"{r}x{c}{'-res' if res else ''}-{str(dt)[6:]}"
              for r, c, res, dt in BWD_SHAPES]


def _vec_width(dtype):
    return 16 // torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("rows,c,residual,dtype", BWD_SHAPES, ids=_SHAPE_IDS)
def test_bwd_grid_covers_every_vector_once(rows, c, residual, dtype):
    """The blocks and threads of K1c/K1d walked over the Python mirror of
    their grid (the card test holds ``csrc/fused_bn.cu``'s geometry to
    it): every (row, 16-byte channel vector) is taken by exactly one
    (block, thread); the grid is one wave of whole clusters; every float4
    of the (ds, db) row is added by exactly one thread of the cluster's
    blocks and, in the last cluster, by the threads that share it; the
    block's partials fit its shared memory and every cluster's partial
    row fits the scratch."""
    n = _vec_width(dtype)
    cv = c // n
    geo = fused_bn.bwd_geometry_plain(rows, c, dtype)
    lanes, groups, chunks = geo["lanes"], geo["groups"], geo["chunks"]
    assert lanes * groups <= fused_bn.BWD_THREADS
    assert geo["tile_rows"] == groups * fused_bn.BWD_UNROLL
    assert geo["tiles"] * geo["tile_rows"] >= rows > (
        geo["tiles"] - 1) * geo["tile_rows"]
    # whole clusters of a portable size, at most one block a tile beyond
    # rounding up to a cluster, and one wave on the card
    cluster, clusters = geo["cluster"], geo["clusters"]
    assert cluster in (1, 2, 4, 8) and geo["row_blocks"] == cluster * clusters
    assert geo["row_blocks"] < geo["tiles"] + cluster
    assert clusters == 1 or cluster == fused_bn.BWD_MAX_CLUSTER
    assert geo["row_blocks"] * chunks <= (fused_bn.BWD_MAX_CLUSTERS
                                         * fused_bn.BWD_MAX_CLUSTER)

    # rows: block b takes tiles b, b + row_blocks, ...; thread group grp
    # rows grp + u * groups of each (u < BWD_UNROLL); rows past the end
    # are masked
    taken = np.zeros(rows, np.int64)
    for b in range(geo["row_blocks"]):
        t = np.arange(b, geo["tiles"], geo["row_blocks"])
        r = (t[:, None, None] * geo["tile_rows"]
             + np.arange(fused_bn.BWD_UNROLL)[None, :, None] * groups
             + np.arange(groups)[None, None, :]).ravel()
        np.add.at(taken, r[r < rows], 1)
    assert (taken == 1).all()
    # channel vectors: chunk k's lane l takes vector k * lanes + l
    vec = (np.arange(chunks)[:, None] * lanes + np.arange(lanes)).ravel()
    assert np.array_equal(np.sort(vec[vec < cv]), np.arange(cv))

    width = lanes * n
    # the partials fit the default 48 KB a block, two blocks an SM
    assert geo["smem"] == 2 * groups * width * 4 <= 48 * 1024
    # a block's slice of the cluster's (ds, db) row; in the last
    # cluster, final_split threads a float4 of it, each loading at most
    # 16 cluster rows (kBwdFinalLoads) at once
    assert geo["slice"] * cluster >= width // 2
    assert geo["final_split"] * geo["slice"] <= fused_bn.BWD_THREADS
    assert geo["final_split"] * 16 >= clusters
    _assert_sum_threads_cover_the_row(geo, n)
    if clusters == 1:        # the cluster writes ds/db itself
        assert geo["scratch_floats"] == geo["tickets"] == 0
    else:
        # the float after the last one a cluster writes: row (chunk,
        # cluster), quad 2 * width / 4 - 1
        end = ((chunks - 1) * clusters + clusters - 1) * 2 * width + 2 * width
        assert end == geo["scratch_floats"]
        assert geo["tickets"] == chunks * cluster


def _assert_sum_threads_cover_the_row(geo, n):
    """The threads of the kernel's cluster and last-cluster sums, walked
    as ``csrc/fused_bn.cu`` deals them: block rank p takes float4s e0 +
    tid, e0 + tid + BWD_THREADS, ... < e1 of its slice [e0, e1) of the
    (ds, db) row; in the last cluster thread tid takes float4 e0 + tid %
    slice as part tid // slice (parts below final_split only).  Each
    float4 of the row is added once by a cluster thread and, with more
    than one cluster, by all final_split parts."""
    quads = geo["lanes"] * n // 2
    slice_, split = geo["slice"], geo["final_split"]
    cluster_adds = np.zeros(quads, np.int64)
    final_parts = np.zeros((quads, split), np.int64)
    tid = np.arange(fused_bn.BWD_THREADS)
    for p in range(geo["cluster"]):
        e0, e1 = p * slice_, min((p + 1) * slice_, quads)
        np.add.at(cluster_adds, np.arange(e0, e1, 1), 1)
        e, j = e0 + tid % slice_, tid // slice_
        on = (j < split) & (e < e1)
        np.add.at(final_parts, (e[on], j[on]), 1)
    assert (cluster_adds == 1).all()
    if geo["clusters"] > 1:
        assert (final_parts == 1).all()
        assert geo["clusters"] <= split * 16      # kBwdFinalLoads


def test_bwd_geometry_holds_its_rules_at_every_small_grid():
    """The rules of :func:`bwd_geometry_plain` (the kernel refuses a
    geometry that breaks them) at every row tile count up to 40 and at a
    few row counts in the full grid, for every C the kernel takes in
    both dtypes: clusters of 8 wherever a chunk has more than one, and the
    last cluster's threads over every float4 of the (ds, db) row."""
    for dtype in (torch.bfloat16, torch.float32):
        n = _vec_width(dtype)
        for c in range(n, 6144 + 1, n):
            tile_rows = fused_bn.bwd_geometry_plain(1, c, dtype)["tile_rows"]
            for tiles in (*range(1, 41), 239, 240, 241, 10**4):
                rows = tiles * tile_rows - (tiles > 1)
                geo = fused_bn.bwd_geometry_plain(rows, c, dtype)
                assert geo["tiles"] == tiles
                assert (geo["clusters"] == 1
                        or geo["cluster"] == fused_bn.BWD_MAX_CLUSTER)
                assert geo["clusters"] <= fused_bn.BWD_MAX_CLUSTERS
                if geo["clusters"] > 1:
                    assert geo["final_split"] * geo["slice"] <= (
                        fused_bn.BWD_THREADS)
                    assert geo["clusters"] <= geo["final_split"] * 16
                assert geo["slice"] * geo["cluster"] >= geo["lanes"] * n // 2


@pytest.mark.parametrize("rows,c,residual,dtype", BWD_SHAPES, ids=_SHAPE_IDS)
def test_bwd_reduction_order_meets_the_plain_sums(rows, c, residual, dtype):
    """The kernel's order of adds (:func:`emulate_bwd_sums`, all f32) on
    seeded bf16 (or f32) inputs under the relu mask: ds and db within the
    card check's 1e-5 of sum|g'x| and sum|g'| of the plain backward's."""
    rng = np.random.default_rng(rows + c + residual)

    def draw():      # uniform in [-1, 1): cheaper to draw than normals
        a = rng.random((rows, c), dtype=np.float32)
        return torch.from_numpy(2 * a - 1).to(dtype)

    x, g = draw(), draw()
    r = draw() if residual else None
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    _, _, ds, db = fused_bn._bwd_plain(x, scale, bias, r, g, True)
    xf = x.float()
    z = xf * scale + bias
    if residual:
        z += r.float()
    gm = torch.where(z > 0, g.float(), 0)
    del z, g, r
    got_s, got_b = emulate_bwd_sums(
        gm.numpy(), xf.numpy(), fused_bn.bwd_geometry_plain(rows, c, dtype))
    assert np.isfinite(got_s).all() and np.isfinite(got_b).all()
    tol_s = 1e-5 * (gm * xf).abs().sum(0, dtype=torch.float64)
    tol_b = 1e-5 * gm.abs().sum(0, dtype=torch.float64)
    assert (np.abs(got_s - ds.numpy()) <= tol_s.numpy()).all()
    assert (np.abs(got_b - db.numpy()) <= tol_b.numpy()).all()
