"""The async rules' merge arithmetic against the JAX package's.

Every function of the port's ``parallel/exchanger.py`` async block
(``easgd_worker_update``, ``easgd_center_update``,
``easgd_both_updates``, ``easgd_center_update_n``, ``easgd_apply_delta``,
``asgd_apply_grads``, ``gosgd_merge``, ``gosgd_scale_momentum``) on the
same numpy trees as JAX's, f32: within ``rtol=1e-6`` and an absolute
floor of ``1e-6`` of each tensor's largest magnitude (one f32 rounding:
XLA may fuse what PyTorch rounds twice).  Every port function leaves its
arguments as they were (JAX's donate instead), so what it returns never
aliases a tensor a later in-place step updates.  ``gosgd_scale_momentum``
is held against optax on SGD-momentum and Adam states after three steps
of the same gradients; second moments and counts stay unscaled.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from theanompi_tpu.parallel import exchanger as jx
from theanompi_tpu_torch.parallel import exchanger as px
from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

SHAPES = {"conv": (3, 3, 4, 8), "bias": (8,), "dense": (16, 5)}


def tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def as_torch(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def as_jax(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def close(got, want):
    for k in want:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def unchanged(tensors, ref):
    for k in ref:
        assert np.array_equal(tensors[k].numpy(), ref[k]), k


@pytest.mark.parametrize("name,args", [
    ("easgd_worker_update", ("T0", "T1", 0.5)),
    ("easgd_center_update", ("T0", "T1", 0.3)),
    ("easgd_center_update_n", ("T0", "T1", 0.75)),
    ("easgd_apply_delta", ("T0", "T1", "T2")),
    ("asgd_apply_grads", ("T0", "T1", 0.01)),
])
def test_leafwise_function_matches_jax(name, args):
    """Each function on trees ``T0``.. (and a scalar) against JAX's; the
    port's inputs are left as they were and the outputs are new."""
    trees = {a: tree(10 + i) for i, a in enumerate(("T0", "T1", "T2"))}
    port_in = [as_torch(trees[a]) if a in trees else a for a in args]
    jax_in = [as_jax(trees[a]) if a in trees else a for a in args]
    got = getattr(px, name)(*port_in)
    want = getattr(jx, name)(*jax_in)
    close(got, want)
    for a, p in zip(args, port_in):
        if a in trees:
            unchanged(p, trees[a])
            for k in got:
                assert got[k].data_ptr() != p[k].data_ptr()


def test_both_updates_match_jax_and_lists_work():
    w, c = tree(1), tree(2)
    got_w, got_c = px.easgd_both_updates(as_torch(w), as_torch(c), 0.5)
    want_w, want_c = jx.easgd_both_updates(as_jax(w), as_jax(c), 0.5)
    close(got_w, want_w)
    close(got_c, want_c)
    # lists (the rules' form) give the same values leaf for leaf
    keys = sorted(SHAPES)
    lw, lc = px.easgd_both_updates([torch.from_numpy(w[k]) for k in keys],
                                   [torch.from_numpy(c[k]) for k in keys],
                                   0.5)
    for k, a, b in zip(keys, lw, lc):
        assert torch.equal(a, got_w[k]) and torch.equal(b, got_c[k])


@pytest.mark.parametrize("own_w,recv_w", [(0.5, 0.25), (1 / 3, 1 / 6),
                                          (0.125, 0.5)])
def test_gosgd_merge_matches_jax(own_w, recv_w):
    own, recv = tree(3), tree(4)
    got, got_w = px.gosgd_merge(as_torch(own), own_w, as_torch(recv), recv_w)
    want, want_w = jx.gosgd_merge(as_jax(own), own_w, as_jax(recv), recv_w)
    close(got, want)
    # the weight is JAX's f32 sum, to the bit
    assert got_w == float(want_w)
    assert isinstance(got_w, float)


def _optax_state(optimizer, grads_seq, params):
    if optimizer == "sgd":
        tx = optax.sgd(0.1, momentum=0.9)
    else:
        tx = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    p = as_jax(params)
    state = tx.init(p)
    for g in grads_seq:
        updates, state = tx.update(as_jax(g), state, p)
        p = optax.apply_updates(p, updates)
    return state


def _port_optimizer(optimizer, grads_seq, params):
    keys = sorted(SHAPES)
    ps = [torch.from_numpy(params[k].copy()) for k in keys]
    opt = build_optimizer(ps, 0.1 if optimizer == "sgd" else 0.01,
                          optimizer=optimizer, momentum=0.9)
    for g in grads_seq:
        for p, k in zip(ps, keys):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return opt, ps, keys


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_gosgd_scale_momentum_matches_optax(optimizer):
    params = tree(5)
    grads_seq = [tree(20 + i) for i in range(3)]
    frac = 0.375
    jstate = jx.gosgd_scale_momentum(
        _optax_state(optimizer, grads_seq, params), frac)
    opt, ps, keys = _port_optimizer(optimizer, grads_seq, params)
    before = {k: {s: v.clone() for s, v in opt.state[p].items()}
              for k, p in zip(keys, ps)}
    assert px.gosgd_scale_momentum(opt, frac) is opt
    if optimizer == "sgd":
        first = jstate[0].trace
        for k, p in zip(keys, ps):
            close({k: opt.state[p]["momentum_buffer"]}, {k: first[k]})
    else:
        mu, nu, count = jstate[0].mu, jstate[0].nu, jstate[0].count
        for k, p in zip(keys, ps):
            st = opt.state[p]
            close({k: st["exp_avg"]}, {k: mu[k]})
            # the second moment and the step count stay as they were
            close({k: st["exp_avg_sq"]}, {k: nu[k]})
            assert torch.equal(st["exp_avg_sq"], before[k]["exp_avg_sq"])
            assert float(st["step"]) == int(count) == 3
    for k, p in zip(keys, ps):
        for slot, v in opt.state[p].items():
            if slot in px.FIRST_MOMENT_SLOTS:
                assert torch.equal(v, before[k][slot] * frac)


def test_scale_momentum_first_moment_names_cover_port_optimizers():
    """Every port optimizer's first-moment slot is scaled, no other."""
    params = tree(6)
    grads = [tree(30)]
    for optimizer, want in (("sgd", {"momentum_buffer"}),
                            ("lars", {"momentum_buffer"}),
                            ("rmsprop", {"momentum_buffer"}),
                            ("adam", {"exp_avg"}), ("adamw", {"exp_avg"})):
        opt, ps, _ = _port_optimizer(optimizer, grads, params)
        slots = {s for per in opt.state.values() for s in per}
        assert slots & px.FIRST_MOMENT_SLOTS == want, optimizer
