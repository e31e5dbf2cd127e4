"""Deterministic two-worker schedules of the async rules against JAX.

Two workers of the Cifar10 CNN (dropout-free, two LRNs: the K3 path on a
card) on a 128/48/64-image synthetic set with the host augment (numpy
draws both packages make alike, so the steps draw nothing else), each on
its shard of the epoch, start from the JAX model's weights (carried into
the port by ``models/bridge.py``).  A fixed round-robin order, with no
threads, drives in both packages the same calls the rules' worker
threads make:

* EASGD at tau = 2, alpha = 0.5: 8 iterations a worker, exchanging
  before iterations 0, 2, 4, 6, then the final elastic sync;
* ASGD with momentum SGD: 3 pushes a worker in each of 2 epochs, the
  step schedule forwarded to the server by rank 0 in between (LR 0.01 ->
  0.001);
* GOSGD at p_push = 1 with ``merge_momentum='scale'``: 4 iterations a
  worker, each pushing to the other (both packages' seeded rngs pick
  the same peer), then the shutdown drain.

The port drives its rule's own workers (``rule.prepare(...)``, then each
worker's ``open``/``step``/``end_epoch``/``finish``); the JAX side
replays ``theanompi_tpu/rules/async_rules.py``'s worker loops on its
models and stores.  The center and every worker's parameters agree
within ``rtol=1e-5`` and an absolute floor of ``1e-5`` of each tensor's
largest magnitude (f32 convolutions in another summation order, a few
ulps a step, carried through 8-10 updates; about 1e-6 is seen); the
counts and GOSGD's weights exactly.  A worker's shard stream (the model's ``begin_epoch``)
equals JAX's worker's byte for byte.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.data.cifar10 import Cifar10_data as JaxData
from theanompi_tpu.models.base import ModelConfig as JaxConfig
from theanompi_tpu.models.cifar10 import Cifar10_model as JaxCifar
from theanompi_tpu.parallel.exchanger import gosgd_merge as jax_merge
from theanompi_tpu.parallel.exchanger import gosgd_scale_momentum
from theanompi_tpu.parallel.mesh import data_mesh, replicate
from theanompi_tpu.parallel.server import ASGDServer as JaxASGDServer
from theanompi_tpu.parallel.server import EASGDServer as JaxEASGDServer
from theanompi_tpu.parallel.server import GossipHub as JaxGossipHub
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder
from theanompi_tpu_torch import ASGD, EASGD, GOSGD
from theanompi_tpu_torch.data.cifar10 import Cifar10_data
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.cifar10 import Cifar10_model
from theanompi_tpu_torch.parallel.exchanger import gosgd_merge

RTOL, FLOOR = 1e-5, 1e-5
SEED = 7


class SchedCifar(Cifar10_model):
    """The Cifar10 model started from given flax parameters."""

    def __init__(self, config=None, device="cuda", data=None, shard_rank=0,
                 shard_size=1, init_params=None):
        super().__init__(config, device, data=data, shard_rank=shard_rank,
                         shard_size=shard_size)
        if init_params is not None:
            self._load_params(self.module, init_params)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    base = dict(batch_size=8, n_epochs=2, learning_rate=0.01, momentum=0.9,
                weight_decay=1e-4, lr_schedule="step", lr_decay_epochs=(1,),
                lr_decay_factor=0.1, print_freq=0, seed=SEED,
                snapshot_dir="unused")
    base.update(kw)
    return JaxConfig(**base), ModelConfig(**base)


def jax_workers(jcfg, n_images, n=2):
    data = JaxData(synthetic_n=n_images, seed=SEED)
    return [JaxCifar(config=jcfg, mesh=data_mesh(1, [jax.devices()[i]]),
                     verbose=False, shard_rank=i, shard_size=n, data=data)
            for i in range(n)]


def port_rule(rule_cls, pcfg, n_images, init_params, **opts):
    return rule_cls().prepare(
        devices=2, device="cpu", modelfile=__name__, modelclass="SchedCifar",
        config=pcfg, checkpoint=False, init_params=init_params,
        data=Cifar10_data(synthetic_n=n_images, seed=SEED), **opts)


def initial_params(jax_model):
    """A numpy copy of the model's parameters (``device_get`` may return
    views of buffers a later step frees and reuses)."""
    return jax.tree.map(np.array, jax.device_get(jax_model.state.params))


def recorders(n=2):
    return [JaxRecorder(rank=i, size=n, print_freq=0) for i in range(n)]


def flax_of(model, tensors):
    """``tensors`` (parameters order) as a flax tree, through ``model``."""
    with torch.no_grad():
        for p, t in zip(model.module.parameters(), tensors):
            p.copy_(t)
    return model.params


def assert_tree_close(got, want, what):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(jax.device_get(want))
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            np.asarray(g, np.float64), w, rtol=RTOL,
            atol=FLOOR * np.abs(w).max(),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_worker_shard_stream_equals_jax():
    """Worker 1 of 2: the batches its model's ``begin_epoch`` stages (the
    raw uint8 images of the device augment) and its epoch length are
    JAX's worker 1's, and its random stream is keyed by the shard."""
    jcfg, pcfg = configs(augment_on_device=True)
    kw = dict(synthetic_n=64, seed=SEED, augment_on_device=True)
    jm = JaxCifar(config=jcfg, mesh=data_mesh(1, [jax.devices()[1]]),
                  verbose=False, shard_rank=1, shard_size=2,
                  data=JaxData(**kw))
    pm = [Cifar10_model(config=pcfg, device="cpu", shard_rank=r,
                        shard_size=2, data=Cifar10_data(**kw))
          for r in (0, 1)]
    for epoch in (0, 1):
        n = jm.begin_epoch(epoch)
        assert pm[1].begin_epoch(epoch) == n == 4
        for _ in range(n):
            (jx, jy), (px, py) = next(jm._train_iter), next(pm[1]._train_iter)
            assert px.dtype == torch.uint8
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    pm[0].begin_epoch(0)
    assert pm[0]._rng.initial_seed() != pm[1]._epoch_rng(0).initial_seed()
    for m in (jm, *pm):
        m.cleanup()


def test_easgd_round_robin_matches_jax():
    tau, alpha, iters = 2, 0.5, 8
    jcfg, pcfg = configs()
    jm = jax_workers(jcfg, 128)
    params0 = initial_params(jm[0])
    srv = JaxEASGDServer(jm[0].state.params, alpha=alpha)
    recs = recorders()
    for m in jm:
        m.compile_iter_fns("avg")
        assert m.begin_epoch(0) == iters
    for it in range(iters):
        for r, m in enumerate(jm):
            if it % tau == 0:
                m.state = m.state.replace(
                    params=srv.exchange(m.state.params))
            m.train_iter(it, recs[r])
    for m in jm:
        m.state = m.state.replace(params=srv.exchange(m.state.params))
        m.cleanup()

    rule = port_rule(EASGD, pcfg, 128, params0, tau=tau, alpha=alpha)
    try:
        ws = rule.workers
        for w in ws:
            w.open()
            assert w.model.begin_epoch(0) == iters
        for it in range(iters):
            for w in ws:
                w.step(it)
        for w in ws:
            w.finish()
            w.close()
        got_workers = [w.model.params for w in ws]
        center = flax_of(rule.val_model, rule.server.get_center())
    finally:
        rule.close()
    assert rule.server.n_exchanges == srv.n_exchanges == 2 * (iters // tau
                                                              + 1)
    assert_tree_close(center, srv.get_center(), "center")
    for r, m in enumerate(jm):
        assert_tree_close(got_workers[r], m.state.params, f"worker {r}")


def test_asgd_round_robin_across_an_epoch_matches_jax():
    jcfg, pcfg = configs()
    jm = jax_workers(jcfg, 48)
    params0 = initial_params(jm[0])
    srv = JaxASGDServer(params0, jm[0].tx)
    gsteps = [m.compile_grad_fn() for m in jm]
    for epoch in range(2):
        for m in jm:
            assert m.begin_epoch(epoch) == 3
        for it in range(3):
            for r, m in enumerate(jm):
                batch = next(m._train_iter)
                grads, new_ms, _ = gsteps[r](m.state, batch, m._next_rng())
                fresh = srv.push_pull(grads)
                m.state = m.state.replace(params=replicate(fresh, m.mesh),
                                          model_state=new_ms)
        for r, m in enumerate(jm):
            lr = m.adjust_hyperp(epoch + 1)
            if r == 0:
                srv.set_lr(lr)
    for m in jm:
        m.cleanup()

    rule = port_rule(ASGD, pcfg, 48, params0)
    try:
        ws = rule.workers
        for w in ws:
            w.open()
        for epoch in range(2):
            for w in ws:
                assert w.model.begin_epoch(epoch) == 3
            for it in range(3):
                for w in ws:
                    w.step(it)
            for w in ws:
                w.end_epoch(epoch)
        for w in ws:
            w.finish()
            w.close()
        got_workers = [w.model.params for w in ws]
        center = flax_of(rule.models[0], rule.server.get_center())
        lr = rule.server.get_opt_state()["param_groups"][0]["lr"]
    finally:
        rule.close()
    assert rule.server.n_updates == srv.n_updates == 12
    assert lr == pytest.approx(0.001)
    assert_tree_close(center, srv.get_center(), "center")
    for r, m in enumerate(jm):
        assert_tree_close(got_workers[r], m.state.params, f"worker {r}")


def test_gosgd_round_robin_at_p_push_1_matches_jax():
    iters = 4
    jcfg, pcfg = configs()
    jm = jax_workers(jcfg, 64)
    params0 = initial_params(jm[0])
    hub = JaxGossipHub(2)
    weights = [0.5, 0.5]
    rngs = [np.random.default_rng(SEED + 31 * r) for r in range(2)]
    recs = recorders()
    peers = []
    for m in jm:
        m.compile_iter_fns("avg")
        assert m.begin_epoch(0) == iters
    for it in range(iters):
        for r, m in enumerate(jm):
            for recv, recv_w in hub.drain(r):
                own_w = weights[r]
                merged, new_w = jax_merge(m.state.params, own_w, recv,
                                          recv_w)
                m.state = m.state.replace(
                    params=merged, opt_state=gosgd_scale_momentum(
                        m.state.opt_state, own_w / float(new_w)))
                weights[r] = float(new_w)
            m.train_iter(it, recs[r])
            if rngs[r].random() < 1.0:
                dst = int(rngs[r].integers(0, 1))
                dst = dst if dst < r else dst + 1
                peers.append(dst)
                half = weights[r] / 2.0
                if hub.push(dst, m.state.params, half):
                    weights[r] = half
    for r, m in enumerate(jm):  # the shutdown drain
        for recv, recv_w in hub.drain(r):
            merged, new_w = jax_merge(jax.device_get(m.state.params),
                                      weights[r], recv, recv_w)
            m.state = m.state.replace(params=replicate(merged, m.mesh))
            weights[r] = float(new_w)
        m.cleanup()
    assert peers == [1, 0] * iters

    rule = port_rule(GOSGD, pcfg, 64, params0, p_push=1.0)
    try:
        ws = rule.workers
        for w in ws:
            w.open()
            assert w.model.begin_epoch(0) == iters
        for it in range(iters):
            for w in ws:
                w.step(it)
        for w in ws:
            w.finish()
            w.close()
        for w in ws:
            w.merge_inbox(scale_momentum=False)
        got = [w.model.params for w in ws]
        consensus, acc = gosgd_merge(
            [p.detach() for p in ws[0].params], rule.weights[0],
            [p.detach() for p in ws[1].params], rule.weights[1])
        consensus = flax_of(ws[0].model, consensus)
    finally:
        rule.close()
    assert rule.weights == weights
    assert sum(rule.weights) == pytest.approx(1.0, abs=1e-6)
    for r, m in enumerate(jm):
        assert_tree_close(got[r], m.state.params, f"worker {r}")
    want, want_w = jax_merge(jax.device_get(jm[0].state.params), weights[0],
                             jax.device_get(jm[1].state.params), weights[1])
    assert acc == float(want_w) == 1.0
    assert_tree_close(consensus, want, "consensus")


def test_schedule_model_carries_the_jax_weights():
    jcfg, pcfg = configs()
    jm = jax_workers(jcfg, 64, n=1)[0]
    params0 = initial_params(jm)
    pm = SchedCifar(config=dataclasses.replace(pcfg), device="cpu",
                    data=Cifar10_data(synthetic_n=64, seed=SEED),
                    init_params=params0)
    for (pa, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(pm.params),
                               jax.tree_util.tree_leaves_with_path(params0)):
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
