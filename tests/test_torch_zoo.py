"""The port's classifier zoo on the CPU against the JAX package: VGG16/19,
the BN variants of VGG and AlexNet, ResNet-101/152, ``resnet50_large``,
the zoo's layers and bridges, and ``MODEL_ZOO``.

The same numpy weights (drawn from a seed: kernels N(0, 1/fan_in), BN
scales and running variances in [0.5, 1.5], biases and running means
N(0, 0.1^2)) go to both packages through the port's bridges, and the same
numpy inputs.  Small sizes: VGG with blocks ((1, 8), (1, 16)) at 32
pixels (its 4096-wide fc layers kept), AlexNet at 67 pixels, ResNets at
width 8 and 32 pixels.  Dropout is the identity on both sides in the step
comparisons (a test-time ``monkeypatch``; no JAX file is edited).  JAX's
own ``TpuModel.loss_fn`` computes the reference loss (label smoothing,
aux heads, the BN statistics update), optax the update.

Tolerances, as test_torch_train.py's (f32; the frameworks sum
convolutions, matmuls, batch statistics and gradients in different
orders): ``rtol=1e-4`` with an absolute floor of ``1e-5 * max|want|``
for a forward and ``1e-4 * max|want|`` for a step's loss, gradients,
updated parameters and running statistics.  :class:`BiasAct` against
JAX's ``BiasAct``: bit for bit against its fused (``'pallas'``) route in
f32 and bf16 and against its ``'xla'`` route in f32; in bf16 the
``'xla'`` route adds a bf16-rounded bias in bf16, so it is within one
bf16 ulp of the bias plus one of the output of the port's single
rounding.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu.models import MODEL_ZOO as JAX_ZOO
from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.alex_net import AlexNetCNN as JaxAlexNet
from theanompi_tpu.models.base import TpuModel
from theanompi_tpu.models.model_zoo import ResNet50_LargeBatch as JaxLarge
from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
from theanompi_tpu.models.vgg16 import VGGCNN as JaxVGG
from theanompi_tpu.utils.helper_funcs import build_optimizer as jax_opt
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models import MODEL_ZOO
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.alex_net import AlexNet, AlexNetCNN
from theanompi_tpu_torch.models.bridge import (
    state_dict_from_flax,
    zoo_arrays_from_flax,
    zoo_state_dict_from_flax,
)
from theanompi_tpu_torch.models.model_zoo import (
    VGG19,
    VGG19_BLOCKS,
    ResNet50_LargeBatch,
    ResNet101,
    ResNet152,
)
from theanompi_tpu_torch.models.vgg16 import VGG16, VGG16_BLOCKS, VGGCNN
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.rules.base import resolve_model_class
from theanompi_tpu_torch.rules.bsp import run_bsp_session

TINY_BLOCKS = ((1, 8), (1, 16))
CLASSES = 10


# -- shared with test_torch_googlenet.py and test_torch_cifar10.py -----------


def jax_variables(jax_module, shape, seed: int) -> dict:
    """numpy ``{'params'[, 'batch_stats']}`` of ``jax_module`` at input
    ``shape`` (initialized in train mode, so aux heads exist), drawn as
    the module docstring says."""
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros(shape), train=True))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape_ = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape_) / np.sqrt(np.prod(shape_[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape_)
        else:
            v = 0.1 * rng.standard_normal(shape_)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def no_dropout(monkeypatch) -> None:
    """Dropout the identity in both packages."""
    monkeypatch.setattr(JL.Dropout, "__call__", lambda self, x, train: x)
    monkeypatch.setattr(L.Dropout, "forward",
                        lambda self, x, train, rng=None: x)


def jax_step(jax_module, variables, x, y, lr, weight_decay,
             optimizer="sgd", label_smoothing=0.0, **opt_kw):
    """One step of the JAX package: its ``TpuModel.loss_fn`` (aux heads,
    label smoothing, the batch_stats update) under ``value_and_grad``,
    then its optax chain.  Returns numpy (loss, grads, new params, new
    batch_stats or None)."""
    me = SimpleNamespace(module=jax_module, data=SimpleNamespace(),
                         config=SimpleNamespace(
                             label_smoothing=label_smoothing,
                             track_top5=False))
    model_state = {k: v for k, v in variables.items() if k != "params"}
    tx = jax_opt(lr, optimizer, momentum=0.9, weight_decay=weight_decay,
                 **opt_kw)

    @jax.jit
    def step(params):
        (loss, (new_ms, _)), grads = jax.value_and_grad(
            lambda p: TpuModel.loss_fn(me, p, model_state,
                                       (jnp.asarray(x), jnp.asarray(y)),
                                       jax.random.key(0)),
            has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new = jax.tree.map(lambda a, u: a + u, params, updates)
        return loss, grads, new, new_ms.get("batch_stats")

    out = step(variables["params"])
    return jax.tree.map(np.asarray, out)


def port_step(model, variables, x, y) -> dict:
    """Load ``variables`` into the port model, run its BSP step once on
    host-side ``(x, y)``; returns the step's metrics."""
    model.module.load_state_dict(zoo_state_dict_from_flax(
        model.module, variables["params"], variables.get("batch_stats")))
    model.compile_iter_fns()
    return model.train_step(
        model.state, (torch.from_numpy(x), torch.from_numpy(y).long()),
        torch.Generator().manual_seed(0))


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_step_matches(model, metrics, want, bridge=zoo_arrays_from_flax,
                        grad_rel_l2=None, old_params=None):
    """The port step's loss, gradients, updated parameters and running
    statistics against :func:`jax_step`'s.  ``grad_rel_l2`` holds the
    flattened gradient, and the flattened update from ``old_params``
    (the flax tree the step started from), to that relative L2 error
    instead of element by element (for a step where a relu mask flips,
    see its caller)."""
    loss, grads, new_params, new_stats = want
    module = model.module
    assert_close(float(metrics["loss"]), float(loss), msg="loss")
    want_g = bridge(module, grads)
    want_p = bridge(module, new_params)
    named = dict(module.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    if grad_rel_l2 is None:
        for name, p in named.items():
            assert_close(p.grad.numpy(), want_g[name], floor=1e-4,
                         msg=f"grad {name}")
            assert_close(p.detach().numpy(), want_p[name], floor=1e-4,
                         msg=f"param {name}")
    else:
        old = bridge(module, old_params)

        def flat(arrays):
            return np.concatenate([np.ravel(a) for a in arrays])

        got_g = flat(p.grad.numpy() for p in named.values())
        got_u = flat(p.detach().numpy() - old[n] for n, p in named.items())
        for what, got_, want_ in (
                ("gradient", got_g, flat(want_g[n] for n in named)),
                ("update", got_u, flat(want_p[n] - old[n] for n in named))):
            err = np.linalg.norm(got_ - want_) / np.linalg.norm(want_)
            assert err <= grad_rel_l2, f"{what}: rel L2 {err:.3g}"
    buffers = dict(module.named_buffers())
    if new_stats is None:
        assert not buffers
        return
    want_s = bridge(module, None, new_stats)
    assert set(want_s) == set(buffers) and buffers
    for name, b in buffers.items():
        assert_close(b.numpy(), want_s[name], floor=1e-4, msg=f"stat {name}")


def forward_both(jax_module, module, variables, x):
    """(port logits, JAX logits) of the eval forward on ``x``."""
    want = np.asarray(jax_module.apply(jax.tree.map(jnp.asarray, variables),
                                       jnp.asarray(x), train=False))
    module.load_state_dict(zoo_state_dict_from_flax(
        module, variables["params"], variables.get("batch_stats")))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    return got.numpy(), want


def tiny_data(crop: int, **kw) -> ImageNet_data:
    return ImageNet_data(**{**dict(
        crop=crop, seed=0, synthetic_n=16, synthetic_pool=4,
        synthetic_store=crop + 4, n_classes=CLASSES,
        augment_on_device=False), **kw})


def cpu_config(cls, **kw):
    return dataclasses.replace(cls.default_config(), compute_dtype="float32",
                               print_freq=0, **kw)


class TinyVGG(VGG16):
    blocks = TINY_BLOCKS


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bias_act_matches_jax(dtype, impl):
    """Forward and the input/bias gradients against JAX's ``BiasAct``;
    the unit scale is no parameter and receives nothing."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmod = JL.BiasAct(16, act="relu", impl=impl)

    def f(xj, b):
        return jmod.apply({"params": {"bias": b}}, xj)

    want, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(bias))
    want_dx, want_db = vjp(jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    layer = L.BiasAct(16)
    assert [n for n, _ in layer.named_parameters()] == ["bias"]
    assert list(layer.state_dict()) == ["bias"]
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = layer(xt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and layer.ones().grad is None
    assert not layer.ones().requires_grad
    got = y.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    got_dx = xt.grad.float().numpy()
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    if impl == "xla" and dtype == "bfloat16":
        # JAX rounds the bias to bf16 (half its ulp), then the sum (half
        # an ulp of each result); its relu mask follows that bf16 sum, so
        # dx is not compared
        ulp = 2.0 ** -7 * (np.abs(bias) + np.maximum(np.abs(got),
                                                      np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp)
        # JAX sums db in bf16: within a bf16 ulp of the sum of |g|
        bf16_sum = 2.0 ** -7 * np.abs(g).reshape(-1, 16).sum(0)
        assert np.all(np.abs(layer.bias.grad.numpy() - np.asarray(want_db))
                      <= bf16_sum)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_dx, want_dx)
        assert_close(layer.bias.grad.numpy(), np.asarray(want_db),
                     rtol=1e-5, floor=1e-6)


@pytest.mark.parametrize("pool", ["max_pool", "avg_pool"])
@pytest.mark.parametrize("hw,window,stride", [
    ((15, 13), 3, 2), ((112, 112), 3, 2), ((14, 14), 3, 1), ((9, 10), 5, 3),
    ((8, 8), 2, 2)])
def test_same_pools_match_flax(pool, hw, window, stride):
    """flax's SAME pools (max pads -inf, avg counts the zero pads),
    asymmetric pads included (112 at 3x3/2 pads (0, 1))."""
    import flax.linen as nn

    x = np.random.default_rng(11).standard_normal((2, *hw, 8)).astype(
        np.float32)
    want = np.asarray(getattr(nn, pool)(jnp.asarray(x), (window, window),
                                        (stride, stride), "SAME"))
    got = getattr(L, pool)(torch.from_numpy(x), window, stride, "SAME")
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="padding"):
        getattr(L, pool)(torch.from_numpy(x), window, stride, "FULL")


def test_conv_inits_count_the_receptive_field():
    """he_normal / xavier_uniform on an OIHW conv weight use flax's fans
    (in * kh * kw, out * kh * kw)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(256, 128, 3, 3)
    L.he_normal()(w, gen)
    assert abs(float(w.std()) - np.sqrt(2.0 / (128 * 9))) < 2e-3
    L.xavier_uniform()(w, gen)
    a = np.sqrt(6.0 / ((128 + 256) * 9))
    assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.99 * a


# -- VGG ----------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["xla", "pallas", "batch_norm"])
def test_vgg_eval_forward_matches_jax(tree):
    """From both JAX ``bn_act_impl`` trees (the conv biases in ``Conv_i``
    or in ``BiasAct_i``) and the BN variant's."""
    bn = tree == "batch_norm"
    jmod = JaxVGG(blocks=TINY_BLOCKS, n_classes=CLASSES,
                  act_impl="pallas" if bn else tree, batch_norm=bn)
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=3)
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    got, want = forward_both(jmod, VGGCNN(TINY_BLOCKS, CLASSES, crop=32,
                                          batch_norm=bn), variables, x)
    assert_close(got, want, floor=1e-5)


@pytest.mark.parametrize("bn", [False, True])
def test_vgg_bsp_step_matches_jax_and_optax(monkeypatch, bn):
    """The recipe's SGD (momentum 0.9, wd 5e-4): loss, gradients, the
    updated weights and, with BN, the running statistics."""
    no_dropout(monkeypatch)
    jmod = JaxVGG(blocks=TINY_BLOCKS, n_classes=CLASSES, act_impl="pallas",
                  batch_norm=bn)
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    want = jax_step(jmod, variables, x, y, lr=0.01, weight_decay=5e-4)
    model = TinyVGG(config=cpu_config(VGG16, batch_size=4, batch_norm=bn),
                    device="cpu", n_classes=CLASSES, crop=32,
                    data=tiny_data(32))
    assert_step_matches(model, port_step(model, variables, x, y), want)


def test_vgg_recipe_widths_and_launch_free_cpu():
    from theanompi_tpu.models.vgg16 import VGG16 as JaxVGG16

    cfg = VGG16.default_config()
    assert (cfg.batch_size, cfg.lr_decay_epochs, cfg.weight_decay,
            cfg.compute_dtype) == (64, (25, 50, 65), 5e-4, "bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxVGG16.default_config())
    with torch.device("meta"):
        full = VGGCNN(VGG16_BLOCKS)
        e = VGGCNN(VGG19_BLOCKS, batch_norm=True)
    assert len(full.layers) == 13 and len(e.layers) == 16
    assert full.Dense_0.weight.shape == (4096, 7 * 7 * 512)
    assert all(isinstance(getattr(e, f"BatchNorm_{i}"), L.BatchNormAct)
               for i in range(16))
    model = TinyVGG(config=cpu_config(VGG16, batch_size=2), device="cpu",
                    n_classes=CLASSES, crop=32, data=tiny_data(32))
    assert model._net_cfg == {"n_classes": CLASSES, "crop": 32}
    assert float(model.module.BiasAct_0.bias.abs().max()) == 0.0
    assert torch.all(model.module.Dense_1.bias == 0.1)
    before = _kernels.launch_counts()
    with torch.no_grad():
        model.module(torch.zeros(1, 32, 32, 3))
    assert _kernels.launch_counts() == before        # CPU: plain versions
    assert VGG19.blocks == VGG19_BLOCKS and VGG19.name == "vgg19"


@pytest.mark.parametrize("cls", [TinyVGG, AlexNet])
def test_bn_variants_follow_config_and_warn_on_small_shards(cls):
    kw = (dict(crop=32, data=tiny_data(32)) if cls is TinyVGG
          else dict(crop=67, data=tiny_data(67)))
    plain = cls(config=cpu_config(cls, batch_size=4), device="cpu",
                n_classes=CLASSES, **kw)
    assert not plain.uses_batchnorm
    assert not list(plain.module.buffers())
    model = cls(config=cpu_config(cls, batch_size=4, batch_norm=True),
                device="cpu", n_classes=CLASSES, **kw)
    assert model.uses_batchnorm
    bns = [m for m in model.module.modules()
           if isinstance(m, L.BatchNormAct)]
    convs = [m for m in model.module.modules() if isinstance(m, L.Conv)]
    assert len(bns) == len(convs) and all(c.bias is None for c in convs)
    assert all(b.act == "relu" for b in bns)
    with pytest.warns(UserWarning, match="BatchNorm"):
        model.compile_iter_fns()


# -- AlexNet's BN variant -----------------------------------------------------


def test_alexnet_bn_variant_matches_jax(monkeypatch):
    """Eval forward on running statistics, then one train step (batch
    statistics, the running statistics' update) against JAX's BN
    AlexNet (conv biases dropped, BatchNorm + relu, the LRNs kept)."""
    jmod = JaxAlexNet(n_classes=CLASSES, batch_norm=True)
    variables = jax_variables(jmod, (2, 67, 67, 3), seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 67, 67, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    got, want = forward_both(jmod, AlexNetCNN(CLASSES, 67, batch_norm=True),
                             variables, x)
    assert_close(got, want, floor=1e-5)
    no_dropout(monkeypatch)
    want = jax_step(jmod, variables, x, y, lr=0.01, weight_decay=5e-4)
    model = AlexNet(config=cpu_config(AlexNet, batch_size=4,
                                      batch_norm=True),
                    device="cpu", n_classes=CLASSES, crop=67,
                    data=tiny_data(67))
    assert_step_matches(model, port_step(model, variables, x, y), want)


# -- the ResNet zoo -----------------------------------------------------------


@pytest.mark.parametrize("cls,stages", [(ResNet101, (3, 4, 23, 3)),
                                        (ResNet152, (3, 8, 36, 3))])
def test_deep_resnets_match_jax(cls, stages):
    """The class's stage sizes reach the network with no argument (as
    ``-c ResNet101`` from the launcher), and the width-8 network's eval
    forward matches JAX's at those stages."""
    from theanompi_tpu.models import model_zoo as jz

    assert cls.stage_sizes == stages == getattr(jz, cls.__name__).stage_sizes
    model = cls(config=cpu_config(cls), device="cpu", width=8,
                n_classes=CLASSES, crop=32, data=tiny_data(32))
    assert model._net_cfg["stage_sizes"] == list(stages)
    module = model.module
    assert len(module.blocks) == sum(stages)
    jmod = JaxResNet(stage_sizes=stages, width=8, n_classes=CLASSES,
                     dtype=jnp.float32)
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=9)
    x = np.random.default_rng(10).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    module.load_state_dict(state_dict_from_flax(
        module, variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    assert_close(got, want, floor=1e-5)


def test_resnet50_large_step_matches_jax_and_optax(tmp_path):
    """The large-batch recipe's step: the s2d stem, label smoothing 0.1
    and LARS at the recipe's LR (0.7 x sqrt(1 worker)), against JAX's
    loss and optax's lars; then a short CPU session stays finite."""
    from theanompi_tpu_torch.models.bridge import params_from_flax

    cfg = ResNet50_LargeBatch.default_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxLarge.default_config())
    jmod = JaxResNet(stage_sizes=(1, 1, 1, 1), width=8, n_classes=CLASSES,
                     dtype=jnp.float32, stem="s2d", bn_act_impl="pallas",
                     pool_impl="pallas")
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    want = jax_step(jmod, variables, x, y, lr=0.7, weight_decay=1e-4,
                    optimizer="lars", label_smoothing=0.1,
                    lars_trust_coefficient=0.001)
    model = ResNet50_LargeBatch(
        config=cpu_config(ResNet50_LargeBatch, batch_size=4,
                          snapshot_dir=str(tmp_path)),
        device="cpu", stage_sizes=(1, 1, 1, 1), width=8, n_classes=CLASSES,
        crop=32, data=tiny_data(32))
    assert model.module.stem == "s2d" and model._base_lr == 0.7
    model.module.load_state_dict(state_dict_from_flax(
        model.module, variables["params"], variables["batch_stats"]))
    model.compile_iter_fns()
    metrics = model.train_step(
        model.state, (torch.from_numpy(x), torch.from_numpy(y).long()),
        torch.Generator().manual_seed(0))

    def bridge(module, params, stats=None):
        if params is None:
            from theanompi_tpu_torch.models.bridge import (
                batch_stats_from_flax,
            )
            return {k: v.numpy() for k, v in
                    batch_stats_from_flax(module, stats).items()}
        return {k: v.numpy() for k, v in
                params_from_flax(module, params).items()}

    assert_step_matches(model, metrics, want, bridge=bridge)
    session = ResNet50_LargeBatch(
        config=cpu_config(ResNet50_LargeBatch, batch_size=8, n_epochs=2,
                          warmup_epochs=1, snapshot_dir=str(tmp_path)),
        device="cpu", stage_sizes=(1, 1, 1, 1), width=8, n_classes=CLASSES,
        crop=32, data=tiny_data(32, augment_on_device=True))
    out = run_bsp_session(session, checkpoint=False)
    assert all(np.isfinite(r["train_loss"]) for r in out["records"])


# -- MODEL_ZOO and the bridges at full width ----------------------------------


def test_model_zoo_lists_every_ported_classifier():
    assert set(MODEL_ZOO) == set(JAX_ZOO) - {
        "transformer_lm_tp", "transformer_lm_pp", "transformer_lm_moe"}
    for key, (modelfile, classname) in MODEL_ZOO.items():
        assert modelfile.startswith("theanompi_tpu_torch.models.")
        assert modelfile.split(".")[-1] == JAX_ZOO[key][0].split(".")[-1]
        assert classname == JAX_ZOO[key][1]
        cls = resolve_model_class(modelfile, classname)
        assert cls.name == key


def _full_width_case(name):
    """(JAX module, input shape, port module on the meta device)."""
    from theanompi_tpu.models.cifar10 import Cifar10CNN as JaxCifar
    from theanompi_tpu.models.googlenet import GoogLeNetCNN as JaxGoogLeNet
    from theanompi_tpu_torch.models.cifar10 import Cifar10CNN
    from theanompi_tpu_torch.models.googlenet import GoogLeNetCNN

    impl = "pallas" if name.endswith("pallas") else "xla"
    bn = "_bn" in name
    with torch.device("meta"):
        if name.startswith("vgg"):
            blocks = VGG19_BLOCKS if name.startswith("vgg19") else \
                VGG16_BLOCKS
            return (JaxVGG(blocks=blocks, act_impl=impl, batch_norm=bn),
                    (1, 224, 224, 3), VGGCNN(blocks, batch_norm=bn))
        if name.startswith("googlenet"):
            return (JaxGoogLeNet(act_impl=impl, batch_norm=bn),
                    (1, 224, 224, 3), GoogLeNetCNN(batch_norm=bn))
        if name == "alexnet_bn":
            return (JaxAlexNet(batch_norm=True), (1, 227, 227, 3),
                    AlexNetCNN(batch_norm=True))
        return JaxCifar(), (1, 32, 32, 3), Cifar10CNN()


@pytest.mark.parametrize("name", [
    "vgg16_xla", "vgg16_pallas", "vgg19_pallas", "vgg16_bn",
    "googlenet_xla", "googlenet_pallas", "googlenet_bn", "alexnet_bn",
    "cifar10"])
def test_bridge_maps_every_leaf_of_the_full_width_model(name):
    jmod, shape, module = _full_width_case(name)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros(shape), train=True))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         dict(shapes))
    got = zoo_arrays_from_flax(module, zeros["params"],
                               zeros.get("batch_stats"))
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    n_bias_act = sum(isinstance(m, L.BiasAct) for m in module.modules())
    if name.startswith("googlenet"):
        # 3 stem convs, 6 per inception, 1 per aux tower
        assert n_bias_act == (0 if "_bn" in name else 59)
        assert want["aux1.Dense_0.weight"] == (1024, 4 * 4 * 128)
    elif name.startswith("vgg"):
        assert n_bias_act == (0 if "_bn" in name else
                              16 if name.startswith("vgg19") else 13)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_zoo_bridge_refuses_missing_and_leftover_leaves(impl):
    jmod = JaxVGG(blocks=TINY_BLOCKS, n_classes=CLASSES, act_impl=impl)
    params = jax_variables(jmod, (2, 32, 32, 3), seed=13)["params"]
    module = VGGCNN(TINY_BLOCKS, CLASSES, crop=32)
    assert set(zoo_state_dict_from_flax(module, params)) == {
        n for n, _ in module.named_parameters()}
    missing = jax.tree.map(lambda v: v, params)
    if impl == "xla":
        del missing["Conv_1"]["Conv_0"]["bias"]
    else:
        del missing["BiasAct_1"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        zoo_state_dict_from_flax(module, missing)
    extra = jax.tree.map(lambda v: v, params)
    extra["Dense_3"] = {"Dense_0": {"bias": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="left unmapped"):
        zoo_state_dict_from_flax(module, extra)
    bn = VGGCNN(TINY_BLOCKS, CLASSES, crop=32, batch_norm=True)
    bn_vars = jax_variables(JaxVGG(blocks=TINY_BLOCKS, n_classes=CLASSES,
                                   batch_norm=True), (2, 32, 32, 3), seed=14)
    with pytest.raises(KeyError, match="BatchNorm_0/scale is missing"):
        zoo_state_dict_from_flax(bn, params)     # a BN-free tree
    stats = zoo_state_dict_from_flax(bn, None, bn_vars["batch_stats"])
    assert set(stats) == {n for n, _ in bn.named_buffers()}
