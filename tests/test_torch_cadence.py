"""The stacked cadences of the port's BSP step (``steps_per_call``,
``grad_accum_steps``) against the JAX package's (tests/test_multi_step.py
and tests/test_grad_accum.py there).

* ``steps_per_call = k`` over an epoch equals k single calls bit for bit
  (parameters, BN statistics, momentum, the recorded losses): the port
  runs the same single step k times on the same generator.
* Accumulation of 4 microbatches of 16 on a linear regression equals
  JAX's ``make_bsp_accum_step`` and the one-batch-of-64 step, at JAX's
  own tolerance for that pin (``rtol=1e-6``, ``atol=1e-7``).  The
  two-rank ResNet pin against JAX's accumulation step is in
  test_torch_bsp_dist.py.
* The model plumbing as JAX's: the epoch cut to a multiple of the stack,
  an epoch shorter than the stack refused, ``train_iter`` returning the
  iterations it covered, the recorder's losses and image counts, the
  two cadences refusing each other, accumulation refusing 'params', and
  error feedback refusing the f32 wire, with JAX's error texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel.bsp import TrainState as JaxState
from theanompi_tpu.parallel.bsp import make_bsp_accum_step as jax_accum
from theanompi_tpu.parallel.mesh import data_mesh, shard_batch
from theanompi_tpu.utils.helper_funcs import build_sgd_optimizer
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.parallel.bsp import (
    TrainState,
    make_bsp_accum_step,
    make_bsp_train_step,
)
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.utils.helper_funcs import build_optimizer
from theanompi_tpu_torch.utils.recorder import Recorder

TINY = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=10)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(tmp_path, n_images=128, **cfg):
    config = ModelConfig(**{**dict(batch_size=16, n_epochs=1,
                                   learning_rate=0.05, print_freq=0,
                                   snapshot_dir=str(tmp_path)), **cfg})
    data = ImageNet_data(crop=32, seed=0, synthetic_n=n_images,
                         synthetic_pool=8, synthetic_store=36, n_classes=10)
    return ResNet50(config=config, device="cpu", **TINY, crop=32, data=data)


def _epoch(model, rec=None):
    """One training epoch through the reference contract; returns the
    iterations, the dispatches' covered counts and the recorder."""
    rec = rec or Recorder(print_freq=0)
    model.compile_iter_fns()
    n_iters = model.begin_epoch(0)
    it, covered = 0, []
    while it < n_iters:
        covered.append(model.train_iter(it, rec))
        it += covered[-1]
    model._flush_metrics(rec)
    model.cleanup()
    return n_iters, covered, rec


@pytest.mark.parametrize("k", [2, 4])
def test_steps_per_call_equals_single_calls(tmp_path, k):
    single = _model(tmp_path)
    n1, _, rec1 = _epoch(single)
    multi = _model(tmp_path, steps_per_call=k)
    nk, covered, reck = _epoch(multi)
    assert n1 == nk == 8 and covered == [k] * (8 // k)
    assert single.state.step == multi.state.step == 8
    got, want = multi.module.state_dict(), single.module.state_dict()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for p, q in zip(multi.module.parameters(), single.module.parameters()):
        assert torch.equal(multi.state.optimizer.state[p]["momentum_buffer"],
                           single.state.optimizer.state[q]["momentum_buffer"])
    # every sub-step recorded, each over the global batch
    assert reck.train_losses == rec1.train_losses
    assert len(reck.train_losses) == 8
    assert reck.n_images == rec1.n_images == 8 * multi.global_batch


def _linreg():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = (x @ np.arange(4.0, 8.0)).astype(np.float32)
    return x, y


class _LinReg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4, dtype=torch.float32))


def _torch_linreg_loss(module, batch, rng):
    x, y = batch
    loss = torch.mean((x @ module.w - y) ** 2)
    return loss, {"error": loss.detach()}


def test_accum_matches_jax_and_the_big_batch():
    """4 microbatches of 16 -> one update, against JAX's accumulation
    step (a 1-device mesh) and the port's step on the batch of 64."""
    x, y = _linreg()

    def jax_loss(params, model_state, batch, rng):
        xb, yb = batch
        loss = jnp.mean((xb @ params["w"] - yb) ** 2)
        return loss, (model_state, {"loss": loss, "error": loss})

    mesh = data_mesh(1, jax.devices()[:1])
    tx = build_sgd_optimizer(0.05, momentum=0.9)
    state = JaxState.create({"w": jnp.arange(4, dtype=jnp.float32)}, tx)
    from jax.sharding import PartitionSpec as P

    stacked = shard_batch((x.reshape(4, 16, 4), y.reshape(4, 16)), mesh,
                          spec=P(None, "data"))
    s_jax, m_jax = jax_accum(jax_loss, tx, mesh, donate=False)(
        state, stacked, jax.random.key(3))

    def run(step, batch):
        module = _LinReg()
        st = TrainState(module, build_optimizer(module.parameters(), 0.05,
                                                "sgd", momentum=0.9))
        metrics = step(st, batch, None)
        return module.w.detach().numpy(), metrics, st.step

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    w_acc, m_acc, steps = run(make_bsp_accum_step(_torch_linreg_loss),
                              [(xt[i:i + 16], yt[i:i + 16])
                               for i in range(0, 64, 16)])
    w_big, m_big, _ = run(make_bsp_train_step(_torch_linreg_loss), (xt, yt))
    assert steps == 1                                   # ONE update
    np.testing.assert_allclose(w_acc, np.asarray(s_jax.params["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w_acc, w_big, rtol=1e-6, atol=1e-7)
    assert float(m_acc["loss"]) == pytest.approx(float(m_jax["loss"]),
                                                 rel=1e-6)
    assert float(m_acc["loss"]) == pytest.approx(float(m_big["loss"]),
                                                 rel=1e-6)


def test_accum_model_plumbing_counts_and_trains(tmp_path):
    """As JAX's ``test_model_plumbing_counts_and_trains``: one update per
    ``a`` iterations, ``train_iter`` returns ``a``, and the recorder sees
    every image though each metric is a mean over ``a`` microbatches."""
    model = _model(tmp_path, grad_accum_steps=4)
    n_iters, covered, rec = _epoch(model)
    assert n_iters == 8 and covered == [4, 4]
    assert model.state.step == n_iters // 4
    assert rec.n_images == n_iters * model.global_batch
    assert len(rec.train_losses) == n_iters // 4
    assert np.isfinite(rec.train_losses).all()


@pytest.mark.parametrize("cfg", [dict(steps_per_call=4),
                                 dict(grad_accum_steps=4)])
def test_epoch_rounds_down_to_the_stack(tmp_path, cfg):
    """6 batches an epoch under a stack of 4: 4 iterations (JAX cuts
    ``n_iters -= n_iters % stack``)."""
    model = _model(tmp_path, n_images=96, **cfg)
    model.compile_iter_fns()
    assert model.begin_epoch(0) == 4
    model.cleanup()


@pytest.mark.parametrize("cfg", [dict(steps_per_call=8),
                                 dict(grad_accum_steps=8)])
def test_epoch_shorter_than_the_stack_raises(tmp_path, cfg):
    model = _model(tmp_path, n_images=96, **cfg)
    model.compile_iter_fns()
    with pytest.raises(ValueError, match="fewer iterations than the "
                                         "stacked cadence"):
        model.begin_epoch(0)
    model.cleanup()


def test_both_cadences_rejected(tmp_path):
    model = _model(tmp_path, steps_per_call=2, grad_accum_steps=2)
    with pytest.raises(ValueError, match="stacked-batch cadences"):
        model.compile_iter_fns()


def test_accum_rejects_param_averaging(tmp_path):
    with pytest.raises(ValueError, match="exchange_what='grads'"):
        make_bsp_accum_step(_torch_linreg_loss,
                            BSP_Exchanger(exchange_what="params"))
    model = _model(tmp_path, grad_accum_steps=2, exchange_what="params")
    with pytest.raises(ValueError, match="exchange_what='grads'"):
        model.compile_iter_fns()


def test_error_feedback_needs_the_bf16_wire(tmp_path):
    """JAX's ``_init_residual`` text; and the residual it builds: zeros,
    f32, one per parameter."""
    model = _model(tmp_path, exchange_error_feedback=True,
                   exchange_strategy="nccl16")
    with pytest.raises(ValueError, match="set exchange_dtype='bf16'"):
        model.compile_iter_fns()
    model = _model(tmp_path, exchange_error_feedback=True,
                   exchange_dtype="bf16")
    model.compile_iter_fns()
    res = model.state.exchange_residual
    params = list(model.module.parameters())
    assert len(res) == len(params)
    assert all(r.dtype == torch.float32 and r.shape == p.shape
               and not r.any() for r, p in zip(res, params))
