"""The port's entry points (``theanompi_tpu_torch/entry.py``)
against the JAX package's (``__graft_entry__.py``).

``entry()``: the port's bf16 ResNet-50 eval forward equals JAX's on the
same variables (carried across by ``models/bridge.py``) and a seeded
nonzero batch of 2.  JAX's ``entry()`` draws its variables with
``model.init(key(0), zeros(8, 224, 224, 3))``; flax's init depends on the
key and the channel counts only, so the test draws them at one small
image under ``jit`` (the eager 224-pixel init takes over half a minute
on one core) and applies them with the same module and ``fwd``.

``dryrun_multichip(n)`` on gloo ranks: every leg JAX's rules give at
``n`` runs with a finite loss and equal parameters on every rank; at
``n = 2`` the SP, PP and EP legs run at degree 1 and TP is skipped, at
``n = 4`` all four run at degree 2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theanompi_tpu_torch import entry as E
from theanompi_tpu_torch.models import bridge

#: per-row relative L2 of the logits: both sides compute in bf16, with
#: different convolution algorithms, through 53 BN layers
ENTRY_REL_L2 = 0.02


def test_entry_forward_matches_jax_entry():
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models.resnet50 import ResNet

    model = ResNet(dtype=jnp.bfloat16)  # JAX's entry(): full ResNet-50
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))

    def fwd(variables, x):  # JAX's entry() fwd
        return model.apply(variables, x, train=False)

    fn, (net, x) = E.entry("cpu")
    assert tuple(x.shape) == (8, 224, 224, 3) and x.dtype == torch.float32
    assert net.dtype == torch.bfloat16 and not net.training
    net.load_state_dict(bridge.state_dict_from_flax(
        net, variables["params"], variables["batch_stats"]))
    xb = np.random.default_rng(0).uniform(
        -2.0, 2.0, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(fwd)(variables, jnp.asarray(xb)), np.float32)
    got = fn(net, torch.from_numpy(xb)).float().numpy()
    assert got.shape == want.shape == (2, 1000)
    rel = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert rel.max() <= ENTRY_REL_L2, rel


def test_entry_is_the_full_resnet50_with_its_launches():
    fn, (net, x) = E.entry("cpu")
    assert [len(s) for s in _stages(net)] == [3, 4, 6, 3]
    assert E.resnet_launches(net, train=False) == {
        "scale_bias_act": 37, "scale_bias_act_res": 16, "maxpool3x3s2": 1}
    out = fn(net, x[:1])
    assert out.shape == (1, 1000) and torch.isfinite(out).all()


def _stages(net):
    stages, last = [], None
    for blk in net.blocks:
        if last is None or blk.proj_conv is not None:
            stages.append([])
        stages[-1].append(blk)
        last = blk
    return stages


def test_entry_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        E.entry("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        E.dryrun_multichip(1, device="cuda")


def test_tiny_resnet_launch_counts_are_derived_from_the_module():
    from theanompi_tpu_torch.models.resnet50 import ResNet

    net = ResNet(stage_sizes=E.TINY_RESNET["stage_sizes"],
                 width=E.TINY_RESNET["width"])
    assert E.resnet_launches(net, train=True) == {
        "scale_bias_act": 13, "scale_bias_act_res": 4,
        "scale_bias_act_bwd": 13, "scale_bias_act_res_bwd": 4,
        "maxpool3x3s2_argmax": 1, "maxpool3x3s2_bwd": 1}


@pytest.mark.parametrize("n, want", [
    (1, {}), (2, {"sp": 1, "pp": 1, "ep": 1}),
    (4, {"sp": 2, "tp": 2, "pp": 2, "ep": 2}),
    (6, {"sp": 3, "pp": 3, "ep": 3}),
    (8, {"sp": 4, "tp": 4, "pp": 4, "ep": 4})])
def test_lm_legs_follow_jaxs_degree_rules(n, want):
    got = {leg: E.lm_degree(leg, n) for leg in E.LM_LEGS
           if E.lm_degree(leg, n) is not None}
    assert got == want
    assert E.legs_for(n) == list(E.RESNET_LEGS) + list(want)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo(n):
    result = E.dryrun_multichip(n, device="cpu", timeout=240)
    assert list(result) == E.legs_for(n)
    for leg, r in result.items():
        assert np.isfinite(r["loss"]), (leg, r)
        assert len(r["digests"]) == n and len(set(r["digests"])) == 1
        assert r["launches"] == {}  # the CPU takes the plain versions
    for leg in ("zero", "fsdp", "accum"):
        assert result[leg]["consumed"] == 2
    for leg in ("bsp", "sync_bn"):
        assert result[leg]["consumed"] == 1
    lm = {leg: result[leg]["degree"] for leg in E.LM_LEGS if leg in result}
    assert lm == ({"sp": 1, "pp": 1, "ep": 1} if n == 2 else
                  {"sp": 2, "tp": 2, "pp": 2, "ep": 2})
