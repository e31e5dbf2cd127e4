"""The port's AlexNet slice on the CPU against the JAX package.

The tiny AlexNet of the JAX zoo tests (full layer widths, 67-pixel
crops: 67 -> 15 -> 7 -> 3 -> 1 through conv1 and the three pools) with
10 classes, f32, the same numpy weights on both sides (carried across by
``zoo_state_dict_from_flax``):

* the eval forward;
* one BSP step (loss, every gradient, every parameter after SGD with
  momentum and weight decay) against ``jax.value_and_grad`` and the
  optax chain, with dropout made the identity on both sides by a
  test-time ``monkeypatch`` (no JAX file is edited);
* dropout's own contract, the bridge at full width (shapes only, via
  ``jax.eval_shape``), and an export served by ``InferenceServer``.

Tolerances as the ResNet step of test_torch_train.py (f32; convolutions,
matmuls and their gradients sum in different orders):
``rtol=1e-4``, floor ``1e-5 * max|want|`` for the forward and
``1e-4 * max|want|`` for the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.alex_net import AlexNetCNN as JaxAlexNet
from theanompi_tpu.utils.helper_funcs import build_optimizer as jax_opt
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.alex_net import AlexNet, AlexNetCNN
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.bridge import zoo_state_dict_from_flax
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.serving import (
    BatchPolicy,
    InferenceServer,
    export_model,
)

CROP, CLASSES = 67, 10


def bridged(params, n_classes: int = CLASSES, crop: int = CROP):
    """The port's AlexNet ``state_dict`` from a flax ``params``-shaped
    tree, through the zoo's mechanical bridge."""
    with torch.device("meta"):
        module = AlexNetCNN(n_classes=n_classes, crop=crop)
    return zoo_state_dict_from_flax(module, params)


def random_params(seed: int, n_classes: int = CLASSES, crop: int = CROP):
    """numpy flax ``params``: kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    so activations stay O(1) through the depth."""
    shapes = jax.eval_shape(JaxAlexNet(n_classes=n_classes).init,
                            jax.random.key(0), jnp.zeros((1, crop, crop, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes["params"]))


def tiny_model(lr=0.01, batch=4, **data_kw) -> AlexNet:
    cfg = dataclasses.replace(AlexNet.default_config(), batch_size=batch,
                              learning_rate=lr, compute_dtype="float32",
                              print_freq=0)
    kw = dict(crop=CROP, seed=0, synthetic_n=16, synthetic_pool=4,
              synthetic_store=CROP + 5, n_classes=CLASSES)
    kw.update(data_kw)
    return AlexNet(config=cfg, device="cpu", n_classes=CLASSES, crop=CROP,
                   data=ImageNet_data(**kw))


def test_eval_forward_matches_jax():
    params = random_params(seed=1)
    x = np.random.default_rng(2).standard_normal(
        (3, CROP, CROP, 3)).astype(np.float32)
    want = np.asarray(JaxAlexNet(n_classes=CLASSES).apply(
        {"params": params}, jnp.asarray(x)))
    module = AlexNetCNN(n_classes=CLASSES, crop=CROP).eval()
    module.load_state_dict(bridged(params))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, floor=1e-5)


def test_bsp_step_matches_jax_and_optax(monkeypatch):
    monkeypatch.setattr(JL.Dropout, "__call__", lambda self, x, train: x)
    monkeypatch.setattr(L.Dropout, "forward",
                        lambda self, x, train, rng=None: x)
    params = random_params(seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, CROP, CROP, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    lr = 0.01
    jmod = JaxAlexNet(n_classes=CLASSES)

    def loss_fn(p):
        logits = jmod.apply({"params": p}, jnp.asarray(x), train=True)
        return JL.softmax_cross_entropy(logits, jnp.asarray(y))

    tx = jax_opt(lr, "sgd", momentum=0.9, nesterov=False,
                 weight_decay=5e-4)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, jax.tree.map(lambda a, u: a + u, p, updates)

    loss, grads, new_params = step(params)

    # the port: the TorchModel's own loss and BSP step, host-side data
    # (no device transform) so both sides see the same x
    model = tiny_model(lr=lr, augment_on_device=False)
    model.module.load_state_dict(bridged(params))
    model.compile_iter_fns()
    metrics = model.train_step(
        model.state, (torch.from_numpy(x), torch.from_numpy(y).long()),
        torch.Generator().manual_seed(0))
    assert_close(float(metrics["loss"]), float(loss), msg="loss")
    want_g = bridged(jax.tree.map(np.asarray, grads))
    want_p = bridged(jax.tree.map(np.asarray,
                                                       new_params))
    named = dict(model.module.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    for name, p in named.items():
        assert_close(p.grad.numpy(), want_g[name].numpy(), floor=1e-4,
                     msg=f"grad {name}")
        assert_close(p.detach().numpy(), want_p[name].numpy(), floor=1e-4,
                     msg=f"param {name}")


def test_dropout_draws_replay_from_the_step_generator():
    """With dropout on, the step's generator decides the masks: the same
    seed gives the same gradients, another seed others."""
    params = bridged(random_params(seed=5))
    rng = np.random.default_rng(6)
    batch = (torch.from_numpy(rng.standard_normal(
        (4, CROP, CROP, 3)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, CLASSES, 4)))

    def grads(seed):
        model = tiny_model(augment_on_device=False)
        model.module.load_state_dict(params)
        model.compile_iter_fns()
        model.train_step(model.state, batch,
                         torch.Generator().manual_seed(seed))
        return model.module.Dense_1.weight.grad

    a, b, c = grads(0), grads(0), grads(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_dropout_contract():
    drop = L.Dropout(0.5)
    x = torch.randn(200_000, dtype=torch.float32) + 3.0   # never 0
    y = drop(x, True, torch.Generator().manual_seed(7))
    kept = y != 0
    # flax: where(mask, x / keep, 0)
    assert torch.equal(y[kept], x[kept] / 0.5)
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.equal(y, drop(x, True, torch.Generator().manual_seed(7)))
    assert not torch.equal(y, drop(x, True,
                                   torch.Generator().manual_seed(8)))
    assert drop(x, False) is x                  # eval: the identity
    xb = x[:64].to(torch.bfloat16)
    yb = drop(xb, True, torch.Generator().manual_seed(7))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], xb[yb != 0] / 0.5)
    with pytest.raises(ValueError, match="Generator"):
        drop(x, True)
    assert L.Dropout(0.0)(x, True) is x


@pytest.mark.parametrize("pool", ["max_pool", "avg_pool"])
def test_pools_match_flax(pool):
    """VALID 3x3/2 pools over NHWC, as flax's (which the JAX layers
    call)."""
    import flax.linen as nn

    x = np.random.default_rng(11).standard_normal((2, 15, 13, 8)).astype(
        np.float32)
    want = np.asarray(getattr(nn, pool)(jnp.asarray(x), (3, 3), (2, 2),
                                        "VALID"))
    got = getattr(L, pool)(torch.from_numpy(x), 3, 2)
    assert got.is_contiguous() and got.shape == want.shape == (2, 7, 6, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_bridge_maps_every_leaf_of_the_full_width_alexnet():
    shapes = jax.eval_shape(JaxAlexNet().init, jax.random.key(0),
                            jnp.zeros((1, 227, 227, 3)))["params"]
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         dict(shapes))
    got = bridged(zeros, 1000, 227)
    with torch.device("meta"):
        module = AlexNetCNN()
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    # conv2's grouped kernel: OIHW (256, 96/2, 5, 5)
    assert want["Conv_1.weight"] == (256, 48, 5, 5)
    assert want["Dense_0.weight"] == (4096, 6 * 6 * 256)


def test_bridge_refuses_missing_and_leftover_leaves():
    params = random_params(seed=8)
    missing = jax.tree.map(lambda v: v, params)
    del missing["Dense_2"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        bridged(missing)
    extra = jax.tree.map(lambda v: v, params)
    extra["Dense_3"] = {"Dense_0": {"bias": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="left unmapped"):
        bridged(extra)


def test_export_served_by_inference_server_equals_module_eval(tmp_path):
    model = tiny_model()
    model.module.load_state_dict(
        bridged(random_params(seed=9)))
    export_model(model, str(tmp_path), version=0)
    rows = np.random.default_rng(10).integers(0, 256, (6, CROP, CROP, 3),
                                              dtype=np.uint8)
    with torch.no_grad():
        want = model.module.eval()(model.data.device_transform(
            torch.from_numpy(rows))).numpy()
    server = InferenceServer(str(tmp_path), replicas=1, device="cpu",
                             reload_poll_s=0,
                             policy=BatchPolicy(max_batch=4))
    server.start()
    try:
        got = np.concatenate([server.submit(rows[i:i + 2])
                              for i in range(0, 6, 2)])
    finally:
        server.stop()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_data_at_crop_227_matches_jax():
    """AlexNet's data: the synthetic stream of 256x256 store images is
    byte-identical to the JAX package's, and the device transform at
    crop 227 (eval: center crop; train: the JAX draws replayed) agrees
    with JAX's within f32 rounding of the normalization."""
    from theanompi_tpu.data.imagenet import ImageNet_data as JaxImageNet
    from theanompi_tpu.ops.augment import make_device_augment as jax_aug
    from theanompi_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from theanompi_tpu_torch.ops.augment import crop_flip_normalize

    kw = dict(crop=227, seed=5, synthetic_n=24, synthetic_pool=3,
              synthetic_store=256, augment_on_device=True)
    jd, td = JaxImageNet(**kw), ImageNet_data(**kw)
    (jx, jy), = list(jd.train_batches(0, 24))
    (tx, ty), = list(td.train_batches(0, 24))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    x = tx[:4]
    aug = jax_aug(227, IMAGENET_MEAN, IMAGENET_STD)
    want = np.asarray(aug(jnp.asarray(x), None, False))
    got = td.device_transform(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 227, 227, 3)
    assert_close(got, want, rtol=1e-6, floor=1e-7)
    key = jax.random.key(1)
    want = np.asarray(aug(jnp.asarray(x), key, True))
    ky, kx, kf = jax.random.split(key, 3)
    ys, xs = (np.array(jax.random.randint(k, (4,), 0, 30))
              for k in (ky, kx))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (4,)))
    got = crop_flip_normalize(
        torch.from_numpy(x), torch.from_numpy(ys), torch.from_numpy(xs),
        torch.from_numpy(flips), 227, torch.tensor(IMAGENET_MEAN),
        torch.tensor(IMAGENET_STD)).numpy()
    assert_close(got, want, rtol=1e-6, floor=1e-7)


def test_refusals_and_recipe():
    # the BN variant is ported (tests/test_torch_zoo.py holds it to JAX's)
    bn = AlexNet(config=ModelConfig(batch_norm=True), device="cpu",
                 n_classes=CLASSES, crop=CROP, data=tiny_model().data)
    assert bn.uses_batchnorm and bn.module.Conv_0.bias is None
    assert isinstance(bn.module.BatchNorm_4, L.BatchNormAct)
    cfg = AlexNet.default_config()
    assert (cfg.batch_size, cfg.learning_rate, cfg.momentum,
            cfg.weight_decay, cfg.lr_decay_epochs, cfg.compute_dtype,
            cfg.track_top5) == (128, 0.01, 0.9, 5e-4, (20, 40, 60),
                                "bfloat16", True)
    module = AlexNetCNN(n_classes=CLASSES, crop=CROP).eval()
    with pytest.raises(ValueError, match="train"):
        module(torch.zeros(1, CROP, CROP, 3), train=True)
    model = tiny_model()
    assert model._net_cfg == {"n_classes": CLASSES, "crop": CROP}
    assert model.data.crop == CROP
    # the recipe's inits: conv biases 0 / 0.1, weights of the stated std
    m = model.module
    assert float(m.Conv_0.bias.detach().abs().max()) == 0.0
    assert torch.all(m.Conv_1.bias == 0.1) and torch.all(m.Dense_1.bias
                                                         == 0.1)
    assert abs(float(m.Dense_1.weight.detach().std()) - 0.005) < 1e-4
    before = _kernels.launch_counts()
    with torch.no_grad():
        m(torch.zeros(1, CROP, CROP, 3))
    assert _kernels.launch_counts() == before   # CPU: plain versions
