"""The port's training slice on the CPU against the JAX package.

The same numpy inputs (drawn from a seed) go to both.  Tolerances, and
why:

* BatchNorm in train mode and the tiny ResNet step: f32 throughout, but
  the two frameworks sum the batch statistics, the convolutions and
  their gradients in different orders; each sum differs by a few f32
  ulps and the differences compound through the depth and through the
  statistics' gradient: ``rtol=1e-4`` with an absolute floor scaled to
  each tensor's magnitude, ``1e-5 * max|want|`` for one BN and
  ``1e-4 * max|want|`` for the ResNet step, whose weight gradients are
  sums over the batch and the image with cancellations (measured:
  1.2e-5 of the largest element of ``blocks.0.conv1.weight``'s).
* The optimizer: both add ``wd * p`` and the momentum trace in f32, but
  PyTorch fuses ``a + alpha * b`` into one rounding where optax rounds
  twice: ``rtol=1e-6`` after every step.
* The augment and the batch streams select and copy bytes, and
  normalize with the same f32 ops: exact, or ``rtol=1e-6`` where XLA
  may reassociate the normalization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.data.imagenet import ImageNet_data as JaxImageNet
from theanompi_tpu.data.imagenet import prepare_imagenet_shards
from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
from theanompi_tpu.ops.augment import make_device_augment as jax_augment
from theanompi_tpu.utils.helper_funcs import build_optimizer as jax_opt
from theanompi_tpu.utils.helper_funcs import set_learning_rate as jax_set_lr
from theanompi_tpu_torch.data.imagenet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageNet_data,
)
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.bridge import (
    batch_stats_from_flax,
    params_from_flax,
    state_dict_from_flax,
)
from theanompi_tpu_torch.models.resnet50 import ResNet, ResNet50
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.ops.augment import crop_flip_normalize
from theanompi_tpu_torch.rules.bsp import BSP, run_bsp_session
from theanompi_tpu_torch.utils import helper_funcs as H
from theanompi_tpu_torch.utils.recorder import Recorder

TINY = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=10)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The suite runs in parallel workers: keep PyTorch's CPU thread pool
    small so these tests do not crowd out the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, rtol=1e-4, floor=1e-5, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(scale, 1e-30), err_msg=msg)


# -- BatchNormAct in train mode ------------------------------------------------


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("residual", [False, True])
def test_batchnorm_train_matches_jax_pallas(act, residual):
    rng = np.random.default_rng(11)
    c = 16
    x = (rng.standard_normal((4, 5, 6, c)) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    jbn = JL.BatchNormAct(use_running_average=False, dtype=jnp.float32,
                          act=act, impl="pallas")
    jres = jnp.asarray(res) if residual else None

    def f(x_, s_, b_, r_):
        return jbn.apply({"params": {"scale": s_, "bias": b_},
                          "batch_stats": {"mean": jnp.asarray(mean0),
                                          "var": jnp.asarray(var0)}},
                         x_, residual=r_, mutable=["batch_stats"])

    y, upd = f(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), jres)
    _, vjp_fn = jax.vjp(lambda *a: f(*a)[0], jnp.asarray(x),
                        jnp.asarray(scale), jnp.asarray(bias), jres)
    dx, ds, db, dr = vjp_fn(jnp.asarray(g))

    bn = L.BatchNormAct(c, torch.float32, act=act).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).requires_grad_()
    tr = torch.from_numpy(res).requires_grad_() if residual else None
    ty = bn(tx, residual=tr)
    ty.backward(torch.from_numpy(g))

    assert_close(ty.detach().numpy(), y, msg="y")
    assert_close(tx.grad.numpy(), dx, msg="dx")
    assert_close(bn.scale.grad.numpy(), ds, msg="dscale")
    assert_close(bn.bias.grad.numpy(), db, msg="dbias")
    if residual:
        assert_close(tr.grad.numpy(), dr, msg="dres")
    assert_close(bn.mean.numpy(), upd["batch_stats"]["mean"], msg="mean")
    assert_close(bn.var.numpy(), upd["batch_stats"]["var"], msg="var")


def test_batchnorm_train_mode_drops_the_folded_affine():
    bn = L.BatchNormAct(8, torch.float32)
    L.prepare_inference(bn)
    assert bn._folded is not None
    bn.train()
    assert bn._folded is None
    x = torch.randn(2, 3, 3, 8) * 3 + 1
    y = bn(x)
    # batch statistics: each channel of the output is standardized
    assert torch.allclose(y.mean((0, 1, 2)), torch.zeros(8), atol=1e-5)


# -- heads -----------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_heads_match_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 16).astype(np.int32)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    assert_close(L.softmax_cross_entropy(tl, ty, smoothing).numpy(),
                 JL.softmax_cross_entropy(jl, jy, smoothing), rtol=1e-6)
    assert float(L.error_rate(tl, ty)) == float(JL.error_rate(jl, jy))
    for k in (1, 2, 5):   # 5 > 3 classes: clamped
        assert float(L.topk_error(tl, ty, k)) == pytest.approx(
            float(JL.topk_error(jl, jy, k)))


# -- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_trajectory_matches_optax(nesterov):
    """Params after 6 steps on the same gradient sequence, with the LR
    rewritten after step 3 (as ``adjust_hyperp`` does), against the
    optax chain ``add_decayed_weights -> sgd``."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=1e-3)
    tx = jax_opt(0.05, "sgd", **kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = H.build_optimizer(tp, 0.05, "sgd", **kw)
    for i, gs in enumerate(grads):
        if i == 3:
            opt_state = jax_set_lr(opt_state, 0.01)
            H.set_learning_rate(topt, 0.01)
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        topt.step()
        for a, b in zip(tp, jp):
            assert_close(a.detach().numpy(), b, rtol=1e-6, floor=1e-7,
                         msg=f"step {i}")
    assert H.get_learning_rate(topt) == 0.01


def test_adamw_trajectory_matches_optax():
    """Params after 6 AdamW steps (b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay 0.01) on the same gradient sequence, with the LR
    rewritten after step 3, against ``optax.adamw`` as the JAX
    ``build_optimizer`` chains it.  Both compute the bias-corrected
    moments in f32 but factor them differently (PyTorch divides by
    ``sqrt(v)/sqrt(1-b2^t)``, optax by ``sqrt(v/(1-b2^t))``, and applies
    the decay before the Adam step): ``rtol=1e-5`` after every step."""
    rng = np.random.default_rng(6)
    shapes = [(4, 3), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    kw = dict(weight_decay=0.01, beta1=0.9, beta2=0.999, eps=1e-8)
    tx = jax_opt(1e-2, "adamw", **kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = H.build_optimizer(tp, 1e-2, "adamw", **kw)
    assert isinstance(topt, torch.optim.AdamW)
    for i, gs in enumerate(grads):
        if i == 3:
            opt_state = jax_set_lr(opt_state, 3e-3)
            H.set_learning_rate(topt, 3e-3)
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        topt.step()
        for a, b in zip(tp, jp):
            assert_close(a.detach().numpy(), b, rtol=1e-5, floor=1e-6,
                         msg=f"step {i}")


def test_helpers_and_unported_optimizers():
    """The helpers, every optimizer family of the JAX package built (each
    of its own class, the LR readable), and the unknown-name check."""
    assert H.scale_lr(0.1, 4) == pytest.approx(0.4)
    assert H.scale_lr(0.1, 4, "sqrt") == pytest.approx(0.2)
    assert H.divide_batches(10, 4) == 2
    assert H.divide_batches(10, 4, drop_remainder=False) == 3
    p = [torch.nn.Parameter(torch.zeros(2))]
    want = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam,
            "adamw": torch.optim.AdamW, "rmsprop": H.RMSprop,
            "lars": H.LARS}
    assert set(want) == set(H.OPTIMIZERS)
    for name, cls in want.items():
        opt = H.build_optimizer(p, 0.1, name, momentum=0.9)
        assert type(opt) is cls, name
        assert H.get_learning_rate(opt) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        H.build_optimizer(p, 0.1, "sgdw")


# -- the augment ---------------------------------------------------------------


def test_train_augment_matches_jax_with_replayed_draws():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (6, 20, 24, 3), dtype=np.uint8)
    crop = 16
    key = jax.random.key(3)
    want = np.asarray(jax_augment(crop, IMAGENET_MEAN, IMAGENET_STD)(
        jnp.asarray(x), key, train=True))
    # the draws the JAX transform makes, replayed on the same key
    ky, kx, kf = jax.random.split(key, 3)
    ys = np.array(jax.random.randint(ky, (6,), 0, 20 - crop + 1))
    xs = np.array(jax.random.randint(kx, (6,), 0, 24 - crop + 1))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (6,)))
    assert flips.any() and not flips.all()
    got = crop_flip_normalize(
        torch.from_numpy(x), torch.from_numpy(ys), torch.from_numpy(xs),
        torch.from_numpy(flips), crop, torch.tensor(IMAGENET_MEAN),
        torch.tensor(IMAGENET_STD)).numpy()
    assert_close(got, want, rtol=1e-6, floor=1e-7)
    # eval branch: center crop
    data = ImageNet_data(crop=crop)
    want = np.asarray(jax_augment(crop, IMAGENET_MEAN, IMAGENET_STD)(
        jnp.asarray(x), None, train=False))
    assert_close(data.device_transform(torch.from_numpy(x)).numpy(), want,
                 rtol=1e-6, floor=1e-7)
    # train branch from a generator: right shape, offsets in range
    gen = torch.Generator().manual_seed(0)
    out = data.device_transform(torch.from_numpy(x), gen, train=True)
    assert out.shape == (6, crop, crop, 3) and out.dtype == torch.float32


# -- the batch streams ---------------------------------------------------------


def _same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_synthetic_streams_byte_identical_to_jax():
    kw = dict(crop=32, seed=3, synthetic_n=96, synthetic_pool=8,
              synthetic_store=36, augment_on_device=True)
    jd, td = JaxImageNet(**kw), ImageNet_data(**kw)
    assert (jd.n_train, jd.n_val) == (td.n_train, td.n_val)
    for epoch in (0, 1):
        _same_stream(jd.train_batches(epoch, 16), td.train_batches(epoch, 16))
        for rank in (0, 1):
            _same_stream(jd.host_train_batches(epoch, 16, rank, 2),
                         td.host_train_batches(epoch, 16, rank, 2))
    _same_stream(jd.val_batches(16), td.val_batches(16))
    assert jd.n_train_batches_for(1, 16) == td.n_train_batches_for(1, 16)


def test_host_augmented_stream_matches_jax():
    kw = dict(crop=32, seed=4, synthetic_n=32, synthetic_pool=4,
              synthetic_store=36, augment_on_device=False)
    jd, td = JaxImageNet(**kw), ImageNet_data(**kw)
    for (xa, ya), (xb, yb) in zip(jd.train_batches(0, 8),
                                  td.train_batches(0, 8)):
        np.testing.assert_array_equal(ya, yb)
        assert_close(xb, xa, rtol=1e-6, floor=1e-6)


def test_file_streams_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (70, 12, 12, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 70).astype(np.int32)
    prepare_imagenet_shards(imgs[:54], labels[:54], str(tmp_path), "train",
                            shard_size=10)
    prepare_imagenet_shards(imgs[54:], labels[54:], str(tmp_path), "val",
                            shard_size=10)
    kw = dict(data_dir=str(tmp_path), crop=8, seed=2, augment_on_device=True)
    jd, td = JaxImageNet(**kw), ImageNet_data(**kw)
    assert (jd.n_train, jd.n_val) == (td.n_train, td.n_val) == (54, 16)
    for epoch in (0, 3):
        _same_stream(jd.train_batches(epoch, 8), td.train_batches(epoch, 8))
        for rank in (0, 1):
            _same_stream(jd.train_batches(epoch, 4, rank, 2),
                         td.train_batches(epoch, 4, rank, 2))
            assert (jd.n_train_batches_for(epoch, 4, rank, 2)
                    == td.n_train_batches_for(epoch, 4, rank, 2))
    _same_stream(jd.val_batches(8), td.val_batches(8))


# -- the tiny ResNet train step ------------------------------------------------


def random_variables(jax_module, seed: int, hw: int = 32) -> dict:
    """numpy ``{'params', 'batch_stats'}``: convs N(0, 1/fan_in), every
    BN scale in [0.5, 1.5] (none zero), biases and running means
    N(0, 0.1), running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, hw, hw, 3)),
        train=True))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def test_tiny_resnet_train_step_matches_jax_pallas():
    """Loss, every gradient and the new batch_stats of one train-mode
    step, JAX with both Pallas kernels (interpret mode) against the
    port's autograd through its plain versions."""
    jmod = JaxResNet(**TINY, dtype=jnp.float32, bn_act_impl="pallas",
                     pool_impl="pallas")
    variables = random_variables(jmod, seed=21)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)

    def loss_fn(params):
        logits, upd = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JL.softmax_cross_entropy(logits, jnp.asarray(y)), upd

    (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])

    module = ResNet(**TINY, dtype=torch.float32)
    module.load_state_dict(state_dict_from_flax(
        module, variables["params"], variables["batch_stats"]))
    module.train()
    tloss = L.softmax_cross_entropy(module(torch.from_numpy(x), train=True),
                                    torch.from_numpy(y))
    tloss.backward()
    assert_close(tloss.item(), loss, msg="loss")
    want = params_from_flax(module, jax.tree.map(np.asarray, grads))
    for name, p in module.named_parameters():
        assert_close(p.grad.numpy(), want[name], floor=1e-4, msg=name)
    want = batch_stats_from_flax(module, jax.tree.map(
        np.asarray, upd["batch_stats"]))
    buffers = dict(module.named_buffers())
    assert set(want) == set(buffers)
    for name, b in buffers.items():
        assert_close(b.numpy(), want[name], floor=1e-4, msg=name)


def test_forward_train_flag_must_match_the_mode():
    module = ResNet(**TINY).eval()
    with pytest.raises(ValueError, match="train"):
        module(torch.zeros(1, 32, 32, 3), train=True)


# -- the session ---------------------------------------------------------------


def _tiny_model(tmp_path, **cfg):
    config = ModelConfig(**{**dict(batch_size=16, n_epochs=2,
                                   learning_rate=0.05, print_freq=2,
                                   snapshot_dir=str(tmp_path),
                                   track_top5=True), **cfg})
    data = ImageNet_data(crop=32, seed=0, synthetic_n=48, synthetic_pool=8,
                         synthetic_store=36, n_classes=10)
    return ResNet50(config=config, device="cpu", **TINY, crop=32, data=data)


def test_run_bsp_session_on_cpu(tmp_path):
    model = _tiny_model(tmp_path)
    before = _kernels.launch_counts()
    out = run_bsp_session(model, max_epochs=1)
    assert out["epochs_run"] == 1
    rec = out["records"][0]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    assert set(out["val"]) == {"loss", "error", "top5_error"}
    assert model.state.step == 3                       # 48 // 16
    assert model._train_prefetcher is None              # cleaned up
    assert _kernels.launch_counts() == before           # CPU: plain versions
    # adjust_hyperp ran for epoch 1 (step schedule: no decay yet)
    assert H.get_learning_rate(model.state.optimizer) == pytest.approx(0.05)


def test_bsp_rule_and_refusals(tmp_path):
    rule = BSP()
    rule.init(device="cpu", config=ModelConfig(
        batch_size=16, n_epochs=1, print_freq=0, snapshot_dir=str(tmp_path)),
        **TINY, crop=32, max_epochs=1,
        data=ImageNet_data(crop=32, synthetic_n=32, synthetic_pool=4,
                           synthetic_store=32, n_classes=10))
    assert np.isfinite(rule.wait()["val"]["loss"])
    # ROADMAP item 13's planes (ZeRO-1, FSDP) train; JAX's refusal of
    # LARS under ZeRO stays
    for knob in ("zero_sharding", "fsdp_sharding"):
        out = run_bsp_session(_tiny_model(tmp_path / knob, **{knob: True}),
                              max_epochs=1, checkpoint=False)
        assert np.isfinite(out["records"][0]["train_loss"]), knob
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        run_bsp_session(_tiny_model(tmp_path, zero_sharding=True,
                                    optimizer="lars"))
    # sync_bn with FSDP is refused as JAX refuses it
    with pytest.raises(ValueError, match="sync_bn needs a shard_map"):
        _tiny_model(tmp_path, sync_bn=True,
                    fsdp_sharding=True).compile_iter_fns()
    # the bf16 wire (by dtype and by the reference's strategy name), the
    # two cadences and sync_bn (ported) compile and take a step
    for cfg in (dict(exchange_dtype="bf16"), dict(steps_per_call=2),
                dict(grad_accum_steps=2), dict(exchange_strategy="nccl16"),
                dict(sync_bn=True)):
        model = _tiny_model(tmp_path, **cfg)
        model.compile_iter_fns()
        model.begin_epoch(0)
        covered = model.train_iter(0, Recorder(print_freq=0))
        model._flush_metrics(Recorder(print_freq=0))
        assert covered == max(cfg.get("steps_per_call", 1),
                              cfg.get("grad_accum_steps", 1)), cfg
        assert model.state.step == (2 if "steps_per_call" in cfg else 1)
        assert all(torch.isfinite(p).all()
                   for p in model.module.parameters()), cfg
        model.cleanup()


@pytest.mark.parametrize("schedule,warmup,want", [
    ("step", 0, [0.1, 0.1, 0.01, 0.001]),
    ("constant", 0, [0.1] * 4),
    ("poly", 1, [0.1, 0.1, 0.1 * 2 / 3, 0.1 / 3]),
    ("cosine", 0, [0.1, 0.05 * (1 + np.cos(np.pi / 4)), 0.05,
                   0.05 * (1 + np.cos(3 * np.pi / 4))])])
def test_adjust_hyperp_schedules(tmp_path, schedule, warmup, want):
    """The JAX schedules (``TpuModel.adjust_hyperp``) written out for
    four epochs at base LR 0.1."""
    model = _tiny_model(tmp_path, lr_schedule=schedule, warmup_epochs=warmup,
                        lr_decay_epochs=(2, 3), lr_poly_power=1.0,
                        n_epochs=4, learning_rate=0.1)
    got = [model.adjust_hyperp(e) for e in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert H.get_learning_rate(model.state.optimizer) == pytest.approx(
        want[-1])
