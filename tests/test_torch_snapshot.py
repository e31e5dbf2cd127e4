"""The model contract's npz parameter snapshots, ``compile_grad_fn`` and
``optimizer_hyperparams`` of the port against the JAX package's, for a
tiny ResNet (width 8, stages (1, 1, 1, 1), 32 pixels), AlexNet (67
pixels), VGG with BN (blocks ((1, 8), (1, 16)), 32 pixels), the
TransformerLM (2 layers, d_model 16, vocab 32, 16 tokens) and the WGAN
(width 8).

Each case builds the JAX model (its ``TpuModel`` on a one-device mesh)
and the port's at the same dims.  Random weights (numpy, from a seed:
kernels N(0, 1/fan_in), BN scales in [0.5, 1.5], tables N(0, 0.5^2),
other vectors N(0, 0.1^2)) are written as an npz and loaded by one
package; its own ``save`` is then loaded by the other, and both models'
eval outputs on the same numpy inputs must agree (``rtol=1e-4``, floor
``1e-5 * max|want|``: f32, sums in different orders, the forward
tolerance of test_torch_zoo.py).  The two ``save`` files hold the same
members, in the same order, with the same shapes.  A snapshot of
another width (AlexNet: another class count) raises JAX's
``ValueError``.  ``compile_grad_fn``'s
gradients and new running statistics match JAX's on the same batch
(dropout the identity on both sides; ``rtol=1e-4``, floor ``1e-4 *
max|want|``, the step tolerance of test_torch_train.py), with the live
state left as it was; ``optimizer_hyperparams()`` equals JAX's for the
same config."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from test_torch_zoo import no_dropout
from theanompi_tpu.models import base as JB
from theanompi_tpu.parallel.mesh import data_mesh
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch.models import base as TB
from theanompi_tpu_torch.models.bridge import module_params_from_flax
from theanompi_tpu_torch.utils import helper_funcs as TH

CASES = ("resnet", "alexnet", "vgg_bn", "transformer", "wgan")
TINY_BLOCKS = ((1, 8), (1, 16))
LM = dict(vocab=32, seq_len=16, n_layers=2, d_model=16, n_heads=2)
CLASSES = 10


def _configs(case: str, **over):
    """(JAX ModelConfig, port ModelConfig) of the case, equal fields."""
    kw = dict(batch_size=4, n_epochs=1, print_freq=0,
              lr_schedule="constant", track_top5=False,
              augment_on_device=False, **over)
    if case == "vgg_bn":
        kw["batch_norm"] = True
    return JB.ModelConfig(**kw), TB.ModelConfig(**kw)


_BUILT: dict = {}


def built(case: str):
    """``build(case)``, built once per test session (the tests that take
    it load their own weights first)."""
    if case not in _BUILT:
        _BUILT[case] = build(case)
    return _BUILT[case]


def build(case: str, width: int = 8, port_only: bool = False, **over):
    """The JAX model (None with ``port_only``) and the port's model of
    ``case``."""
    pair = _build(case, width, **over)
    return (None if port_only else pair[0](), pair[1]())


def _build(case: str, width: int, **over):
    """(JAX model maker, port model maker) of ``case``."""
    jcfg, tcfg = _configs(case, **over)
    mesh = data_mesh(1, jax.devices()[:1])
    jkw = dict(config=jcfg, mesh=mesh, verbose=False)
    tkw = dict(config=tcfg, device="cpu")
    if case == "wgan":
        from theanompi_tpu.models.wasserstein_gan import Wasserstein_GAN as J
        from theanompi_tpu_torch.models.wasserstein_gan import (
            Wasserstein_GAN as T,
        )
        return (lambda: J(**jkw, width=width),
                lambda: T(**tkw, width=width))
    if case == "transformer":
        from theanompi_tpu.data.lm import SeqLM_data as JD
        from theanompi_tpu.models.transformer import TransformerLM as J
        from theanompi_tpu_torch.data.lm import SeqLM_data as TD
        from theanompi_tpu_torch.models.transformer import TransformerLM as T

        dims = dict(LM, d_model=2 * width)
        data = dict(vocab=LM["vocab"], seq_len=LM["seq_len"], n_train=8,
                    n_val=4)
        return (lambda: J(**jkw, data=JD(**data), **dims),
                lambda: T(**tkw, data=TD(**data), **dims))
    from theanompi_tpu.data.imagenet import ImageNet_data as JD
    from theanompi_tpu_torch.data.imagenet import ImageNet_data as TD

    crop = 67 if case == "alexnet" else 32
    data = dict(crop=crop, synthetic_n=16, synthetic_pool=4,
                synthetic_store=crop, augment_on_device=False)

    # AlexNet has no width: its "wider" model has more classes
    classes = CLASSES * width // 8 if case == "alexnet" else CLASSES

    def jdata():
        d = JD(**data)
        d.n_classes = classes          # the JAX dataset fixes 1000
        return d

    if case == "resnet":
        from theanompi_tpu.models.resnet50 import ResNet as JNet
        from theanompi_tpu.models.resnet50 import ResNet50 as J
        from theanompi_tpu_torch.models.resnet50 import ResNet50 as T

        class JaxTiny(J):
            def build_module(self):
                return JNet(stage_sizes=(1, 1, 1, 1), width=width,
                            n_classes=CLASSES, dtype=jnp.float32)

        return (lambda: JaxTiny(**jkw, data=jdata()),
                lambda: T(**tkw, stage_sizes=(1, 1, 1, 1), width=width,
                          n_classes=CLASSES, crop=crop,
                          data=TD(**data, n_classes=CLASSES)))
    if case == "alexnet":
        from theanompi_tpu.models.alex_net import AlexNet as J
        from theanompi_tpu_torch.models.alex_net import AlexNet as T

        return (lambda: J(**jkw, data=jdata()),
                lambda: T(**tkw, n_classes=classes, crop=crop,
                          data=TD(**data, n_classes=classes)))
    from theanompi_tpu.models.vgg16 import VGG16 as J
    from theanompi_tpu_torch.models.vgg16 import VGG16 as T

    blocks = tuple((n, f * width // 8) for n, f in TINY_BLOCKS)
    JV = type("JaxTinyVGG", (J,), {"blocks": blocks})
    TV = type("TinyVGG", (T,), {"blocks": blocks})
    return (lambda: JV(**jkw, data=jdata()),
            lambda: TV(**tkw, n_classes=CLASSES, crop=crop,
                       data=TD(**data, n_classes=CLASSES)))


def random_params(like, seed: int):
    """A numpy tree shaped as ``like`` (module docstring's draws)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("embedding", "pos_emb"):
            v = 0.5 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, like)


def inputs(case: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    if case == "transformer":
        t = rng.integers(0, LM["vocab"], (2, LM["seq_len"] + 1)).astype(
            np.int32)
        return t[:, :-1], t[:, 1:]
    if case == "wgan":
        return (rng.standard_normal((4, 100)).astype(np.float32),
                rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    crop = 67 if case == "alexnet" else 32
    return (rng.standard_normal((4, crop, crop, 3)).astype(np.float32),
            rng.integers(0, CLASSES, 4).astype(np.int32))


def jax_eval(case, jm, batch) -> np.ndarray:
    st = jm.state
    if case == "wgan":
        z, x = (jnp.asarray(a) for a in batch)
        fake = jm.generator.apply({"params": st.gen_params}, z)
        scores = jm.critic.apply({"params": st.critic_params},
                                 jnp.concatenate([fake, x]))
        return np.concatenate([np.asarray(fake).ravel(),
                               np.asarray(scores)])
    if case == "transformer":
        return np.asarray(jm.module.apply(
            {"params": st.params}, jnp.asarray(batch[0]), train=False,
            seq_axis=None))
    return np.asarray(jm.module.apply({"params": st.params,
                                       **st.model_state},
                                      jnp.asarray(batch[0]), train=False))


def port_eval(case, tm, batch) -> np.ndarray:
    module = tm.module.eval()
    with torch.no_grad():
        if case == "wgan":
            z, x = (torch.from_numpy(a) for a in batch)
            fake = module["generator"](z)
            scores = module["critic"](torch.cat([fake, x]))
            return np.concatenate([fake.numpy().ravel(), scores.numpy()])
        if case == "transformer":
            return module(torch.from_numpy(batch[0])).numpy()
        return module(torch.from_numpy(batch[0]), train=False).numpy()


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.shape(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(params=CASES)
def pair(request):
    return request.param, *built(request.param)


def test_jax_save_loads_in_the_port(pair, tmp_path):
    case, jm, tm = pair
    JH.save_params_npz(str(tmp_path / "rand.npz"), random_params(
        jax.tree.map(np.asarray, jm.params), seed=11))
    jm.load(str(tmp_path / "rand.npz"))
    path = jm.save(str(tmp_path / "jax.npz"))
    tm.load(path)
    batch = inputs(case)
    assert_close(port_eval(case, tm, batch), jax_eval(case, jm, batch),
                 floor=1e-5, msg=case)


def test_port_save_loads_in_jax(pair, tmp_path):
    case, jm, tm = pair
    TH.save_params_npz(str(tmp_path / "rand.npz"),
                       random_params(tm.params, seed=12))
    tm.load(str(tmp_path / "rand.npz"))
    path = tm.save(str(tmp_path / "port.npz"))
    jm.load(path)
    batch = inputs(case)
    assert_close(port_eval(case, tm, batch), jax_eval(case, jm, batch),
                 floor=1e-5, msg=case)


def test_snapshot_keys_and_shapes_match(pair, tmp_path):
    """The same flax paths and shapes in ``params``, and the two ``save``
    files' members in the same order; the default path is
    ``<snapshot_dir>/<name>_params.npz``."""
    case, jm, tm = pair
    want = _flat(jax.tree.map(np.asarray, jm.params))
    assert _flat(tm.params) == want
    tm.config = dataclasses.replace(tm.config, snapshot_dir=str(tmp_path))
    path = tm.save()
    assert path == str(tmp_path / f"{tm.name}_params.npz")
    assert tm.name == jm.name
    with np.load(path) as got, np.load(jm.save(str(tmp_path / "j.npz"))) \
            as ref:
        assert got.files == ref.files
        assert {k: got[k].shape for k in got.files} == want
        assert all(got[k].dtype == np.float32 for k in got.files)


def test_snapshot_of_another_width_is_refused(pair, tmp_path):
    case, jm, tm = pair
    other = build(case, width=16, port_only=True)[1]
    path = other.save(str(tmp_path / "wide.npz"))
    with pytest.raises(ValueError, match="shape mismatch for "):
        tm.load(path)
    with pytest.raises(ValueError, match="shape mismatch for "):
        jm.load(path)


def _stats(case: str, tm, tree) -> dict:
    from theanompi_tpu_torch.models.bridge import (
        batch_stats_from_flax,
        zoo_state_dict_from_flax,
    )

    if case == "resnet":
        return batch_stats_from_flax(tm.module, tree)
    return zoo_state_dict_from_flax(tm.module, batch_stats=tree)


@pytest.mark.parametrize("case", [c for c in CASES if c != "wgan"])
def test_compile_grad_fn_matches_jax(monkeypatch, tmp_path, case):
    """JAX's WGAN inherits the classifier ``compile_grad_fn``, which has
    no meaning for its two networks, so the WGAN is not a case here."""
    no_dropout(monkeypatch)
    jm, tm = built(case)
    JH.save_params_npz(str(tmp_path / "w.npz"), random_params(
        jax.tree.map(np.asarray, jm.params), seed=13))
    jm.load(str(tmp_path / "w.npz"))
    tm.load(str(tmp_path / "w.npz"))
    batch = inputs(case, seed=14)
    jg, jms, jmet = jm.compile_grad_fn()(
        jm.state, tuple(jnp.asarray(a) for a in batch), jax.random.key(0))
    state = tm._ensure_state()
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    tm.module.eval()
    grads, new_ms, metrics = tm.compile_grad_fn()(
        state, tuple(torch.from_numpy(a) for a in batch),
        torch.Generator().manual_seed(0))
    # the live state is as it was
    assert not tm.module.training
    assert all(p.grad is None for p in tm.module.parameters())
    for k, v in tm.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert_close(float(metrics["loss"]), float(jmet["loss"]), msg="loss")
    want = module_params_from_flax(tm.module,
                                   jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want)
    for name, w in want.items():
        assert_close(grads[name].numpy(), w.numpy(), floor=1e-4, msg=name)
    if "batch_stats" in jms:
        want_ms = _stats(case, tm, jax.tree.map(np.asarray,
                                                jms["batch_stats"]))
        assert set(new_ms) == set(want_ms)
        for name, w in want_ms.items():
            assert_close(new_ms[name].numpy(), w.numpy(), floor=1e-4,
                         msg=name)
    else:
        assert new_ms == {}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_biasact_biases_follow_bn_act_impl(impl):
    """A BN-free VGG's ``params`` put each conv's bias where the JAX model
    built with the same ``bn_act_impl`` holds it: in ``Conv_i`` ('xla')
    or in ``BiasAct_i`` ('pallas')."""
    from theanompi_tpu.models.vgg16 import VGGCNN as JaxVGG
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.vgg16 import VGG16

    shapes = jax.eval_shape(lambda: JaxVGG(
        blocks=TINY_BLOCKS, n_classes=CLASSES, act_impl=impl).init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((1, 32, 32, 3)), train=True))["params"]
    tm = type("TinyVGG", (VGG16,), {"blocks": TINY_BLOCKS})(
        config=_configs("vgg", bn_act_impl=impl)[1], device="cpu",
        n_classes=CLASSES, crop=32, data=ImageNet_data(
            crop=32, synthetic_n=16, synthetic_pool=4, synthetic_store=32,
            augment_on_device=False, n_classes=CLASSES))
    assert _flat(tm.params) == _flat(shapes)
    assert any(k.startswith("BiasAct_") for k in tm.params) == (
        impl == "pallas")


@pytest.mark.parametrize("case", CASES)
def test_optimizer_hyperparams_match_jax(case):
    """A port model built with the config, and the JAX model's contract
    scaffolding (config, worker-scaled LR) rerun on it."""
    over = dict(optimizer="adam", learning_rate=0.03, momentum=0.8,
                weight_decay=1e-3, adam_beta2=0.99, rmsprop_decay=0.7,
                lr_scale_with_workers="linear")
    jcfg, _ = _configs(case, **over)
    jm = copy.copy(built(case)[0])
    jm._init_scaffold(jcfg, jm.mesh, False, 0, 1, jm.data)
    tm = build(case, port_only=True, **over)[1]
    want = jm.optimizer_hyperparams()
    assert tm.optimizer_hyperparams() == want
    assert want["learning_rate"] == 0.03 and want["optimizer"] == "adam"
