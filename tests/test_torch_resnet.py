"""The port's ResNet (theanompi_tpu_torch/models/resnet50.py) on the CPU
against the JAX ``ResNet`` with both Pallas kernels on (interpret mode),
on weights drawn with numpy and carried across by the bridge
(theanompi_tpu_torch/models/bridge.py).

Tolerance: f32 logits within ``rtol=1e-4, atol=1e-5``: XLA and oneDNN sum
each convolution in different orders, and the differences compound
through the depth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.base import ModelConfig as JaxModelConfig
from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.bridge import state_dict_from_flax
from theanompi_tpu_torch.models.layers import BatchNormAct, same_pads
from theanompi_tpu_torch.models.resnet50 import ResNet, ResNet50

TINY = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=10)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The suite runs in parallel workers: keep PyTorch's CPU thread pool
    small so these tests do not crowd out the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(jax_module, seed: int, hw: int = 32) -> dict:
    """numpy ``{'params', 'batch_stats'}`` for ``jax_module``: convs
    N(0, 1/fan_in), every BN scale in [0.5, 1.5] (none zero, unlike the
    JAX init of the exit BN), biases and running means N(0, 0.1),
    running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, hw, hw, 3)),
        train=True))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def port_resnet(variables, stem: str = "conv7", **kw) -> ResNet:
    module = ResNet(**{**TINY, **kw}, dtype=torch.float32, stem=stem).eval()
    module.load_state_dict(state_dict_from_flax(
        module, variables["params"], variables["batch_stats"]))
    return module


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_tiny_resnet_matches_jax_pallas(stem):
    jmod = JaxResNet(**TINY, dtype=jnp.float32, stem=stem,
                     bn_act_impl="pallas", pool_impl="pallas")
    variables = random_variables(jmod, seed=7 if stem == "s2d" else 5)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port_resnet(variables, stem)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bridge_refuses_missing_and_extra_leaves():
    jmod = JaxResNet(**TINY, dtype=jnp.float32)
    variables = random_variables(jmod, seed=0)
    module = ResNet(**TINY)
    missing = jax.tree.map(lambda a: a, variables)
    del missing["params"]["BottleneckBlock_2"]["BatchNorm_1"]["scale"]
    with pytest.raises(KeyError, match="BatchNorm_1/scale is missing"):
        state_dict_from_flax(module, missing["params"],
                             missing["batch_stats"])
    extra = jax.tree.map(lambda a: a, variables)
    extra["batch_stats"]["stem_bn"]["count"] = np.zeros(())
    with pytest.raises(KeyError, match="left unmapped"):
        state_dict_from_flax(module, extra["params"], extra["batch_stats"])


def test_full_width_bridge_maps_every_leaf():
    """ResNet-50 at full width: 161 param leaves, 53 BNs, all mapped; the
    port's model holds the same 25.6M parameters."""
    jmod = JaxResNet(dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        train=True))
    assert len(jax.tree.leaves(shapes["params"])) == 161
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    model = ResNet50(device="cpu")
    state = state_dict_from_flax(model.module, zeros["params"],
                                 zeros["batch_stats"])
    assert set(state) == set(model.module.state_dict())
    assert sum(isinstance(m, BatchNormAct)
               for m in model.module.modules()) == 53
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree.leaves(shapes["params"]))
    assert n_jax == sum(p.numel() for p in model.module.parameters()) \
        == 25_557_032


def test_same_padding_is_flax_same():
    # stride 2 on an even input: the odd pixel goes to the END
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(7, 3, 2) == (1, 1)


def test_model_config_is_a_field_for_field_copy():
    jax_fields = [(f.name, f.default) for f in
                  dataclasses.fields(JaxModelConfig)]
    port_fields = [(f.name, f.default) for f in
                   dataclasses.fields(ModelConfig)]
    assert port_fields == jax_fields


def test_entry_points_default_to_cuda():
    """No card here: the default device raises instead of falling back."""
    with pytest.raises(RuntimeError, match="cuda"):
        ResNet50(**TINY)
    assert ResNet50(**TINY, device="cpu").device.type == "cpu"
