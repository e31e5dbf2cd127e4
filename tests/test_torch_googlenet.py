"""The port's GoogLeNet on the CPU against the JAX package.

GoogLeNet at ``width_mult=0.125`` (every width ``max(8, round(n /
8))``) on 80-pixel crops (the smallest whose 4a output, 5x5, still feeds
the aux heads' 5x5/3 pool), 10 classes, f32, with the same numpy
weights on both sides (``zoo_state_dict_from_flax``), from both JAX
``bn_act_impl`` trees and the BN variant's:

* the eval forward (main logits only: the aux towers do not run);
* one BSP step with the aux-weighted loss, ``CE(main) + 0.3 CE(aux1) +
  0.3 CE(aux2)``, computed by JAX's own ``TpuModel.loss_fn``, and optax's
  SGD: loss, every gradient (the aux towers' too), every updated
  parameter and, in the BN variant, the running statistics;
* the loss contract itself (label smoothing on each term, metrics from
  the main logits) and the launches the card would make per step;
* an export served by ``InferenceServer``.

Tolerances as test_torch_zoo.py's: ``rtol=1e-4`` with a floor of
``1e-5 * max|want|`` (forward) or ``1e-4 * max|want|`` (step); the BN
variant's step holds the flattened gradient and update to 2e-2 in
relative L2 instead (a relu mask flip, explained in the test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from test_torch_zoo import (
    assert_step_matches,
    forward_both,
    jax_step,
    jax_variables,
    no_dropout,
    port_step,
    tiny_data,
)
from theanompi_tpu.models.googlenet import GoogLeNet as JaxGoogLeNetModel
from theanompi_tpu.models.googlenet import GoogLeNetCNN as JaxGoogLeNet
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.bridge import zoo_state_dict_from_flax
from theanompi_tpu_torch.models.googlenet import (
    GoogLeNet,
    GoogLeNetCNN,
    widths,
)
from theanompi_tpu_torch.serving import (
    BatchPolicy,
    InferenceServer,
    export_model,
)

CROP, CLASSES, MULT = 80, 10, 0.125


def jax_module(tree: str) -> JaxGoogLeNet:
    bn = tree == "batch_norm"
    return JaxGoogLeNet(n_classes=CLASSES, width_mult=MULT,
                        act_impl="pallas" if bn else tree, batch_norm=bn)


def tiny_model(bn: bool = False, batch: int = 4, **data_kw) -> GoogLeNet:
    cfg = dataclasses.replace(GoogLeNet.default_config(), batch_size=batch,
                              compute_dtype="float32", print_freq=0,
                              batch_norm=bn)
    return GoogLeNet(config=cfg, device="cpu", n_classes=CLASSES, crop=CROP,
                     width_mult=MULT, data=tiny_data(CROP, **data_kw))


@pytest.mark.parametrize("tree", ["xla", "pallas", "batch_norm"])
def test_eval_forward_matches_jax(tree):
    jmod = jax_module(tree)
    variables = jax_variables(jmod, (2, CROP, CROP, 3), seed=1)
    x = np.random.default_rng(2).standard_normal(
        (3, CROP, CROP, 3)).astype(np.float32)
    module = GoogLeNetCNN(CLASSES, CROP, width_mult=MULT,
                          batch_norm=tree == "batch_norm")
    got, want = forward_both(jmod, module, variables, x)
    assert got.shape == want.shape == (3, CLASSES)
    assert_close(got, want, floor=1e-5)


@pytest.mark.parametrize("tree", ["xla", "batch_norm"])
def test_bsp_step_with_aux_heads_matches_jax_and_optax(monkeypatch, tree):
    """The recipe's SGD (momentum 0.9, wd 2e-4) on the aux-weighted
    loss: the aux towers' gradients and updates included."""
    no_dropout(monkeypatch)
    jmod = jax_module(tree)
    variables = jax_variables(jmod, (2, CROP, CROP, 3), seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, CROP, CROP, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    want = jax_step(jmod, variables, x, y, lr=0.01, weight_decay=2e-4)
    model = tiny_model(bn=tree == "batch_norm")
    metrics = port_step(model, variables, x, y)
    # BN variant: the two forwards differ by f32 rounding compounded
    # through 22 normalized layers (~1e-5 of the activations), enough to
    # flip the relu of one pre-activation near 0 (one of 36 elements of
    # the 5b 1x1 branch's channel 29 on this draw), which moves the
    # gradient, and so the update, of every layer below it by about 1%;
    # the flattened gradient and update are held in relative L2, the
    # loss and the running statistics element-wise
    assert_step_matches(model, metrics, want,
                        grad_rel_l2=2e-2 if tree == "batch_norm" else None,
                        old_params=variables["params"])
    assert model.module.aux1.Dense_1.weight.grad.abs().max() > 0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_aux_loss_contract_and_eval_returns_main_logits(smoothing):
    """In training the module returns ``(main, (aux1, 0.3), (aux2,
    0.3))`` and the loss is ``CE(main) + 0.3 CE(aux1) + 0.3 CE(aux2)``,
    each smoothed, with the error of ``main``; eval returns the main
    logits alone, which the train-mode main equals without dropout."""
    model = tiny_model()
    model.config = dataclasses.replace(model.config,
                                       label_smoothing=smoothing)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (4, CROP, CROP, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, 4))
    module = model.module
    for m in module.modules():
        if isinstance(m, L.Dropout):
            m.rate = 0.0
    with torch.no_grad():
        main_eval = module.eval()(x)
        out = module.train()(x, train=True)
        assert isinstance(out, tuple) and len(out) == 3
        main, (a1, w1), (a2, w2) = out
        assert (w1, w2) == (0.3, 0.3)
        assert all(t.shape == (4, CLASSES) and t.dtype == torch.float32
                   for t in (main, a1, a2))
        np.testing.assert_array_equal(main.numpy(), main_eval.numpy())
        ce = L.softmax_cross_entropy
        loss, metrics = model.loss_fn(module, (x, y), None)
        want = (ce(main, y, smoothing) + 0.3 * ce(a1, y, smoothing)
                + 0.3 * ce(a2, y, smoothing))
        assert float(loss) == pytest.approx(float(want), rel=1e-6)
        assert float(metrics["error"]) == float(L.error_rate(main, y))
        module.eval()
        ev = model.eval_fn(module, (x, y))
        assert float(ev["loss"]) == pytest.approx(
            float(ce(main_eval, y)), rel=1e-6)


def test_widths_launches_and_recipe():
    """Full width: every conv width a multiple of 8 (the bf16 rule of the
    fused kernels); per training step 59 BiasAct (K1a, and K1c in the
    backward) and 2 LRN (K3a, K3b) launches, per eval 57 and 2 (counted
    with hooks at the test's width: the structure is the same)."""
    stem, incs = widths(1.0)
    assert all(w % 8 == 0 for w in stem + sum(incs, ()))
    assert widths(MULT)[0] == (8, 8, 24)
    model = tiny_model()
    module = model.module
    calls = {"bias_act": 0, "lrn": 0}

    def counter(kind):
        def hook(*_):
            calls[kind] += 1
        return hook

    for m in module.modules():
        if isinstance(m, L.BiasAct):
            m.register_forward_hook(counter("bias_act"))
        elif isinstance(m, L.LRN):
            m.register_forward_hook(counter("lrn"))
    x = torch.zeros(2, CROP, CROP, 3)
    with torch.no_grad():
        module.train()(x, train=True, rng=torch.Generator().manual_seed(0))
        assert calls == {"bias_act": 59, "lrn": 2}
        calls.update(bias_act=0, lrn=0)
        module.eval()(x)
        assert calls == {"bias_act": 57, "lrn": 2}
    cfg = GoogLeNet.default_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxGoogLeNetModel.default_config())
    assert model._net_cfg == {"n_classes": CLASSES, "crop": CROP,
                              "width_mult": MULT}
    assert torch.all(module.ConvRelu_0.BiasAct_0.bias == 0.2)
    assert torch.all(module.aux2.Dense_0.bias == 0.1)
    assert not model.uses_batchnorm and tiny_model(bn=True).uses_batchnorm
    with pytest.raises(ValueError, match="aux head"):
        GoogLeNetCNN(CLASSES, crop=64, width_mult=MULT)
    with pytest.raises(ValueError, match="train"):
        module.eval()(x, train=True)


def test_export_served_by_inference_server_equals_module_eval(tmp_path):
    model = tiny_model(augment_on_device=True)
    variables = jax_variables(jax_module("pallas"), (2, CROP, CROP, 3),
                              seed=6)
    model.module.load_state_dict(zoo_state_dict_from_flax(
        model.module, variables["params"]))
    export_model(model, str(tmp_path), version=0)
    rows = np.random.default_rng(7).integers(0, 256, (6, CROP, CROP, 3),
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
    assert got.shape == (6, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
