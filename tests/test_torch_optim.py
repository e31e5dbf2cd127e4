"""The port's adam, rmsprop and lars against the optax chains the JAX
``build_optimizer`` makes, and their state through a checkpoint.

Each trajectory test feeds the same numpy gradient sequence to both for
6 steps, rewriting the learning rate after step 3 (as ``adjust_hyperp``
does), and compares the parameters after every step at the tolerance of
``test_torch_train.py::test_adamw_trajectory_matches_optax``:
``rtol=1e-5`` with a floor of ``1e-6 * max|want|``.  Both sides compute
in f32, but round in different places: PyTorch's Adam divides by
``sqrt(v)/sqrt(1-b2^t)`` where optax divides by ``sqrt(v/(1-b2^t))``;
rmsprop's ``rsqrt(nu + eps)`` is one op in XLA and ``torch.rsqrt`` here;
the LARS norms sum in different orders.  The LR change is what tells an
optimizer that keeps its momentum before the LR (torch.optim.RMSprop)
from optax, which keeps it after.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from theanompi_tpu.utils.helper_funcs import build_optimizer as jax_opt
from theanompi_tpu.utils.helper_funcs import set_learning_rate as jax_set_lr
from theanompi_tpu_torch.utils import helper_funcs as H
from theanompi_tpu_torch.utils.checkpoint import Checkpointer, state_digest
from test_torch_train import assert_close

SHAPES = [(4, 3), (7,), (2, 2, 3)]


def _trajectory(name, kw, lr0, lr1, zero_param=False, seed=5):
    """Parameters after each of 6 steps, port and optax side by side."""
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if zero_param:          # |p| = 0: the trust ratio falls back to 1
        params[1][:] = 0.0
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(6)]
    tx = jax_opt(lr0, name, **kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = H.build_optimizer(tp, lr0, name, **kw)
    out = []
    for i, gs in enumerate(grads):
        if i == 3:
            opt_state = jax_set_lr(opt_state, lr1)
            H.set_learning_rate(topt, lr1)
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        topt.step()
        out.append(([p.detach().numpy().copy() for p in tp],
                    [np.asarray(p) for p in jp]))
    return out, topt


def _assert_trajectory(out):
    for i, (got, want) in enumerate(out):
        for a, b in zip(got, want):
            assert_close(a, b, rtol=1e-5, floor=1e-6, msg=f"step {i}")


def test_adam_with_weight_decay_matches_optax():
    """``torch.optim.Adam``'s coupled decay is the chain
    ``add_decayed_weights -> adam``."""
    out, topt = _trajectory("adam", dict(weight_decay=0.01, beta1=0.9,
                                         beta2=0.999, eps=1e-8), 1e-2, 3e-3)
    assert type(topt) is torch.optim.Adam
    _assert_trajectory(out)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("weight_decay,eps", [(0.0, 1e-8), (1e-3, 1e-8),
                                              (0.0, 0.1)])
def test_rmsprop_matches_optax(momentum, weight_decay, eps):
    """eps inside the square root (eps 0.1 against nu of about 0.1 is
    where that shows), nu from 0, momentum after the LR."""
    out, _ = _trajectory("rmsprop", dict(momentum=momentum,
                                         weight_decay=weight_decay,
                                         rmsprop_decay=0.9, eps=eps),
                         1e-2, 2e-3)
    _assert_trajectory(out)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("zero_param", [False, True])
def test_lars_matches_optax(nesterov, zero_param):
    """Decay and trust ratio on every parameter, the ratio 1 where a norm
    is 0 (``zero_param``: an all-zero parameter, and with no decay its
    update norm at step 0 is that of its gradient), momentum after the
    LR."""
    out, _ = _trajectory("lars", dict(momentum=0.9, nesterov=nesterov,
                                      weight_decay=5e-5,
                                      lars_trust_coefficient=0.001),
                         0.5, 0.1, zero_param=zero_param)
    _assert_trajectory(out)


def test_lars_zero_update_keeps_ratio_one():
    """A zero gradient on a zero parameter: both norms 0, ratio 1, no
    NaN (optax's ``jnp.where`` guard)."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = H.build_optimizer([p], 0.1, "lars", momentum=0.9)
    p.grad = torch.zeros(3)
    opt.step()
    assert torch.equal(p.detach(), torch.zeros(3))


@pytest.mark.parametrize("name", ["adam", "rmsprop", "lars"])
def test_state_round_trips_through_a_checkpoint(tmp_path, name):
    """``state_dict()`` saved by ``Checkpointer`` and loaded into a fresh
    optimizer: same digest, and the next step lands on the same
    parameters bit for bit."""
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    kw = dict(momentum=0.9, weight_decay=1e-4)

    def fresh():
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
        return ps, H.build_optimizer(ps, 1e-2, name, **kw)

    def step(ps, opt, gs):
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        opt.step()

    ps, opt = fresh()
    for gs in grads[:2]:
        step(ps, opt, gs)
    ck = Checkpointer(str(tmp_path), async_save=False)
    payload = {"params": {str(i): p.detach() for i, p in enumerate(ps)},
               "opt_state": opt.state_dict(), "step": 2}
    ck.save(0, payload)
    _, restored = ck.restore_latest_verified()
    ck.close()
    assert state_digest(restored) == state_digest(payload)
    ps2, opt2 = fresh()
    with torch.no_grad():
        for i, p in enumerate(ps2):
            p.copy_(restored["params"][str(i)])
    opt2.load_state_dict(restored["opt_state"])
    step(ps, opt, grads[2])
    step(ps2, opt2, grads[2])
    for a, b in zip(ps, ps2):
        assert torch.equal(a, b)


def _leaf_ids(shapes):
    """A params-shaped numpy tree whose i-th leaf is filled with i."""
    leaves, treedef = jax.tree.flatten(shapes)
    return len(leaves), jax.tree.unflatten(treedef, [
        np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])


@pytest.mark.parametrize("net", ["resnet50", "alexnet"])
def test_lars_norms_pair_one_jax_leaf_per_parameter(net):
    """LARS's norms are per optax leaf there and per parameter here, so
    they agree only where the bridge carries each JAX leaf onto exactly
    one torch parameter, whole: each port parameter holds one leaf's id
    and every id lands once (ResNet-50: 161 each side, at the real stage
    sizes; widths do not change the pairing)."""
    if net == "resnet50":
        from theanompi_tpu.models.resnet50 import ResNet as JaxNet
        from theanompi_tpu_torch.models.bridge import params_from_flax
        from theanompi_tpu_torch.models.resnet50 import ResNet

        dims = dict(stage_sizes=(3, 4, 6, 3), width=8, n_classes=10)
        module = ResNet(**dims)
        shapes = jax.eval_shape(lambda: JaxNet(**dims).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=True))
        n, ids = _leaf_ids(shapes["params"])
        got = params_from_flax(module, ids)
    else:
        from theanompi_tpu.models.alex_net import AlexNetCNN as JaxNet
        from theanompi_tpu_torch.models.alex_net import AlexNetCNN
        from theanompi_tpu_torch.models.bridge import (
            zoo_state_dict_from_flax,
        )

        module = AlexNetCNN(n_classes=10, crop=67)
        shapes = jax.eval_shape(JaxNet(n_classes=10).init, jax.random.key(0),
                                jnp.zeros((1, 67, 67, 3)))
        n, ids = _leaf_ids(shapes["params"])
        got = zoo_state_dict_from_flax(module, ids)
    names = [name for name, _ in module.named_parameters()]
    assert sorted(got) == sorted(names) and len(names) == n
    if net == "resnet50":
        assert n == 161
    seen = []
    for name in names:
        vals = torch.unique(got[name])
        assert vals.numel() == 1, name        # one leaf, whole
        seen.append(int(vals))
    assert sorted(seen) == list(range(n))     # every leaf once
