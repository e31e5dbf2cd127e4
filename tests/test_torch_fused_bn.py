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
