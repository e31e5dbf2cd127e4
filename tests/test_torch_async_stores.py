"""The port's in-process parameter stores against the JAX package's.

A scripted sequence of calls from two "workers" goes through JAX's
``EASGDServer``/``ASGDServer``/``GossipHub`` and the port's on the same
numpy trees (the port's stores take lists of tensors in the tree's
flattening order: sorted keys); returns, centers and counts agree within
f32 rounding (``rtol=1e-6``, absolute floor ``1e-6`` of each tensor's
largest magnitude; ASGD with Adam ``rtol=1e-5``: its update divides by
``sqrt(nu) + eps``).  GossipHub's refusals (full inbox, deactivated
worker) and its drain order are JAX's.  Aliasing: no tensor a store
returns or enqueues changes when its source is later updated in place,
and a store's center does not change when a returned tensor is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import server as jserver
from theanompi_tpu.utils.helper_funcs import build_optimizer as jax_opt
from theanompi_tpu.utils.helper_funcs import get_learning_rate
from theanompi_tpu_torch.parallel import server as pserver
from theanompi_tpu_torch.resilience import faults

SHAPES = {"a_conv": (3, 3, 2, 4), "b_bias": (4,), "c_dense": (6, 3)}
KEYS = sorted(SHAPES)


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def as_list(t):
    return [torch.from_numpy(np.array(t[k])) for k in KEYS]


def close(got_list, want_tree, rtol=1e-6):
    for k, g in zip(KEYS, got_list):
        w = np.asarray(want_tree[k], np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


def test_easgd_exchange_sequence_matches_jax():
    c0, w0, w1 = tree(0), tree(1), tree(2)
    js = jserver.EASGDServer(c0, alpha=0.4)
    ps = pserver.EASGDServer(as_list(c0), alpha=0.4)
    seq = [w0, w1, tree(3), w1]
    for w in seq:
        want = js.exchange({k: jnp.asarray(v) for k, v in w.items()})
        close(ps.exchange(as_list(w)), want)
        close(ps.get_center(), js.get_center())
    mean = tree(4)
    want = js.exchange_n({k: jnp.asarray(v) for k, v in mean.items()}, 2)
    close(ps.exchange_n(as_list(mean), 2), want)
    close(ps.get_center(), js.get_center())
    assert ps.n_exchanges == js.n_exchanges == len(seq) + 2
    with pytest.raises(ValueError, match="n >= 1"):
        ps.exchange_n(as_list(mean), 0)


@pytest.mark.parametrize("optimizer,rtol", [("sgd", 1e-6), ("adam", 1e-5)])
def test_asgd_push_pull_sequence_matches_jax(optimizer, rtol):
    hp = {"learning_rate": 0.05, "optimizer": optimizer, "momentum": 0.9,
          "nesterov": False, "weight_decay": 1e-3}
    c0 = tree(10)
    js = jserver.ASGDServer({k: jnp.asarray(v) for k, v in c0.items()},
                            jax_opt(**hp))
    ps = pserver.ASGDServer(as_list(c0), hp)
    pushes = [tree(11 + i, 0.1) for i in range(5)]
    for i, g in enumerate(pushes):
        if i == 3:  # an LR change between pushes (the epoch schedule)
            js.set_lr(0.01)
            ps.set_lr(0.01)
        want = js.push_pull({k: jnp.asarray(v) for k, v in g.items()})
        close(ps.push_pull(as_list(g)), want, rtol)
    want = js.push_pull_n({k: jnp.asarray(v) for k, v in pushes[0].items()},
                          2)
    close(ps.push_pull_n(as_list(pushes[0]), 2), want, rtol)
    close(ps.get_center(), js.get_center(), rtol)
    assert ps.n_updates == js.n_updates == len(pushes) + 2
    sd = ps.get_opt_state()
    # JAX holds the injected LR in f32
    assert sd["param_groups"][0]["lr"] == 0.01
    assert get_learning_rate(js.get_opt_state()) == pytest.approx(0.01)
    slot = "momentum_buffer" if optimizer == "sgd" else "exp_avg"
    jstate = js.get_opt_state()
    flat = [s for s in jax_tree_leaves_named(jstate,
                                             "trace" if optimizer == "sgd"
                                             else "mu")]
    close([sd["state"][i][slot] for i in range(len(KEYS))], flat[0], rtol)


def jax_tree_leaves_named(state, field):
    """The dict sub-trees held under optax state field ``field``."""
    import jax

    out = []

    def visit(node):
        if hasattr(node, "_fields"):
            for f in node._fields:
                v = getattr(node, f)
                if f == field and isinstance(v, dict):
                    out.append(v)
                else:
                    visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)

    visit(jax.device_get(state))
    return out


def test_asgd_opt_state_round_trips_into_a_new_server():
    hp = {"learning_rate": 0.1, "optimizer": "sgd", "momentum": 0.9}
    a = pserver.ASGDServer(as_list(tree(20)), hp)
    for i in range(3):
        a.push_pull(as_list(tree(21 + i, 0.1)))
    b = pserver.ASGDServer(a.get_center(), hp)
    b.set_opt_state(a.get_opt_state())
    g = as_list(tree(30, 0.1))
    for x, y in zip(a.push_pull(g), b.push_pull(g)):
        assert torch.equal(x, y)


def test_gossip_hub_refusals_and_drain_order_match_jax():
    jh, ph = jserver.GossipHub(3, maxsize=2), pserver.GossipHub(3, maxsize=2)
    trees = [tree(40 + i) for i in range(4)]
    got, want = [], []
    for i, t in enumerate(trees):  # the third push to worker 1 is refused
        want.append(jh.push(1, t, 0.5 ** (i + 1)))
        got.append(ph.push(1, as_list(t), 0.5 ** (i + 1)))
    assert got == want == [True, True, False, False]
    jh.deactivate(2)
    ph.deactivate(2)
    assert ph.push(2, as_list(trees[0]), 0.25) is jh.push(2, trees[0],
                                                         0.25) is False
    jd, pd = jh.drain(1), ph.drain(1)
    assert [w for _, w in pd] == [w for _, w in jd] == [0.5, 0.25]
    for (pp, _), (jp, _) in zip(pd, jd):
        close(pp, jp)
    assert ph.drain(1) == [] and ph.drain(0) == [] and jh.drain(1) == []
    # drained: the inbox takes pushes again
    assert ph.push(1, as_list(trees[0]), 0.5) is True


def test_stores_fire_the_exchange_fault_site():
    faults.install([{"site": "exchange", "kind": "asgd"}])
    try:
        s = pserver.ASGDServer(as_list(tree(50)), {"learning_rate": 0.1})
        with pytest.raises(faults.FaultInjected, match="exchange"):
            s.push_pull(as_list(tree(51)))
        assert s.n_updates == 0
        s.push_pull(as_list(tree(51)))  # the plan fired once
        assert s.n_updates == 1
    finally:
        faults.clear()


# -- aliasing: what crosses a store is a copy ------------------------------


def test_easgd_exchange_returns_no_alias():
    worker = as_list(tree(60))
    s = pserver.EASGDServer(as_list(tree(61)), alpha=0.5)
    new = s.exchange(worker)
    center = s.get_center()
    kept_new = [t.clone() for t in new]
    kept_center = [t.clone() for t in center]
    for w in worker:  # the worker trains on in place
        w.add_(1.0)
    for t, k in zip(new, kept_new):
        assert torch.equal(t, k)
    for t in new:  # and its new parameters are its own
        t.mul_(3.0)
    for t, k in zip(s.get_center(), kept_center):
        assert torch.equal(t, k)
    center[0].zero_()  # a returned center is a copy too
    assert torch.equal(s.get_center()[0], kept_center[0])


def test_asgd_push_pull_returns_no_alias():
    s = pserver.ASGDServer(as_list(tree(70)), {"learning_rate": 0.1,
                                                "momentum": 0.9})
    grads = as_list(tree(71, 0.1))
    fresh = s.push_pull(grads)
    kept = [t.clone() for t in fresh]
    center = [t.clone() for t in s.get_center()]
    for g in grads:  # the worker reuses its gradient buffers
        g.add_(5.0)
    for t in fresh:
        t.add_(1.0)
    for t, k in zip(s.get_center(), center):
        assert torch.equal(t, k)
    s.push_pull(as_list(tree(72, 0.1)))  # the next update is in place
    for t, k in zip(fresh, kept):
        assert torch.equal(t, k + 1.0)


def test_gossip_push_enqueues_a_copy():
    hub = pserver.GossipHub(2)
    params = as_list(tree(80))
    kept = [t.clone() for t in params]
    assert hub.push(1, params, 0.5)
    for p in params:  # the sender trains on in place
        p.mul_(-2.0)
    (got, w), = hub.drain(1)
    assert w == 0.5
    for t, k in zip(got, kept):
        assert torch.equal(t, k)


def test_publish_and_receive_are_noops_on_the_cpu():
    ts = as_list(tree(90))
    assert pserver.publish(ts) is None
    pserver.receive(ts, None)
    assert pserver.publish([]) is None
