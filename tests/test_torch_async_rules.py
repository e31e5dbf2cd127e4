"""Threaded sessions of the port's async rules on the CPU.

Two or three CPU workers of a Cifar10 CNN on a 128-image synthetic set
(8 iterations a worker an epoch), in the spirit of the JAX package's
``tests/test_async_rules.py``: EASGD exchanges (``n_exchanges`` as the
iteration counts give) and its center is finite; ASGD counts an update
a push and forwards the LR schedule to its server; GOSGD's weights sum to
1 within 1e-6; a straggling worker 0 neither deadlocks EASGD nor skips a
validation; an injected ``worker_step`` fault aborts a long session in
seconds; a supervised worker restarts from the center; the overlap pipe
runs both rules; EASGD's center checkpoint resumes under BSP, a BSP
checkpoint seeds GOSGD, ASGD resumes with its server's momentum, GOSGD
from its sidecars; the rules and the launcher refuse what JAX's refuse
(the remote paths themselves: ``test_torch_{service,shards,aggregate}.py``).
``python -m theanompi_tpu_torch.launcher {EASGD,ASGD,GOSGD} -D 2
--platform cpu`` writes its result JSON.

Every session is waited on through :func:`finish`, which fails after a
stated deadline instead of hanging.  This file imports no JAX: it is the
model module the rules and the launched workers import (``-m
test_torch_async_rules -c TinyCifar``).
"""

import dataclasses
import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from theanompi_tpu_torch import ASGD, EASGD, GOSGD, launcher
from theanompi_tpu_torch.data.cifar10 import Cifar10_data
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.cifar10 import Cifar10_model
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.rules.base import resolve_devices
from theanompi_tpu_torch.rules.bsp import run_bsp_session
from theanompi_tpu_torch.utils.checkpoint import Checkpointer

TESTS = os.path.dirname(os.path.abspath(__file__))
HERE = "test_torch_async_rules"
#: seconds a session of this file may take before the test fails
DEADLINE = 60


class TinyCifar(Cifar10_model):
    """The Cifar10 CNN over a 128-image synthetic set (one thread)."""

    def build_data(self):
        torch.set_num_threads(1)
        return Cifar10_data(synthetic_n=128, seed=self.config.seed)


class StragglerTinyCifar(TinyCifar):
    """Worker 0 sleeps every iteration: the session's straggler."""

    def train_iter(self, count, recorder):
        if self.shard_rank == 0:
            time.sleep(0.02)
        return super().train_iter(count, recorder)


def tiny_cfg(tmp_path, **kw):
    base = dict(batch_size=8, n_epochs=1, learning_rate=0.01,
                snapshot_dir=str(tmp_path), print_freq=0)
    base.update(kw)
    return ModelConfig(**base)


def finish(rule, deadline=DEADLINE):
    """``rule.wait()``, failing the test if the session outlives
    ``deadline`` seconds."""
    rule._thread.join(deadline)
    assert not rule._thread.is_alive(), \
        f"{rule.name} session still running after {deadline} s"
    return rule.wait()


def run(rule_cls, tmp_path, n=2, model="TinyCifar", cfg=None, **kw):
    kw.setdefault("checkpoint", False)
    rule = rule_cls().init(devices=n, device="cpu", modelfile=HERE,
                           modelclass=model, config=cfg or tiny_cfg(tmp_path),
                           **kw)
    return rule, finish(rule)


def finite_tree(center: dict) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in center.values())


# -- sessions ---------------------------------------------------------------


def test_easgd_session(tmp_path):
    rule, res = run(EASGD, tmp_path, tau=4, alpha=0.5)
    # 8 iterations a worker: exchanges before 0 and 4, then the final sync
    assert res["n_exchanges"] == 2 * (8 // 4 + 1)
    assert res["iterations"] == 16
    assert finite_tree(res["center"])
    assert math.isfinite(res["val"]["loss"]) and len(res["val_curve"]) == 1
    assert res["val_batches"] == 256 // 8
    # CPU tensors take the plain versions: no kernel launched
    assert not any(res["launches"].values())


def test_asgd_session_and_lr_schedule_reaches_server(tmp_path):
    cfg = tiny_cfg(tmp_path, n_epochs=2, learning_rate=0.02,
                   lr_schedule="step", lr_decay_epochs=(1,),
                   lr_decay_factor=0.1)
    rule, res = run(ASGD, tmp_path, cfg=cfg)
    assert res["n_updates"] == res["iterations"] == 2 * 2 * 8
    assert math.isfinite(res["val"]["loss"])
    assert finite_tree(res["center"])
    lr = rule.server.get_opt_state()["param_groups"][0]["lr"]
    assert lr == pytest.approx(0.002)


def test_gosgd_three_workers_conserve_weight(tmp_path):
    rule, res = run(GOSGD, tmp_path, n=3, p_push=0.5)
    assert all(w > 0 for w in res["weights"])
    assert sum(res["weights"]) == pytest.approx(1.0, abs=1e-6)
    assert finite_tree(res["consensus"])
    assert math.isfinite(res["val"]["loss"])


@pytest.mark.parametrize("rule_cls,key", [(EASGD, "n_exchanges"),
                                          (ASGD, "n_updates")])
def test_overlapped_exchange_sessions(tmp_path, rule_cls, key):
    kw = {"tau": 2} if rule_cls is EASGD else {}
    _, res = run(rule_cls, tmp_path, overlap=True, **kw)
    assert res[key] == (2 * (8 // 2 + 1) if rule_cls is EASGD else 16)
    assert math.isfinite(res["val"]["loss"])


def test_easgd_straggler_worker0(tmp_path):
    """A slow worker 0 drives the orchestrator's cadence: one validation
    per epoch, no deadlock, and the fast workers exchange meanwhile."""
    cfg = tiny_cfg(tmp_path, n_epochs=2)
    _, res = run(EASGD, tmp_path, n=3, model="StragglerTinyCifar", cfg=cfg,
                 tau=4)
    assert len(res["val_curve"]) == 2
    # 128 images / 3 shards / batch 8: 5 iterations a worker an epoch
    assert res["n_exchanges"] >= 3 * 2 * (5 // 4)


def test_worker_step_fault_aborts_session_fast(tmp_path):
    faults.install([{"site": "worker_step", "rule": "gosgd", "worker": 1,
                     "step": 3}])
    t0 = time.monotonic()
    try:
        rule = GOSGD().init(devices=3, device="cpu", modelfile=HERE,
                            modelclass="TinyCifar", p_push=0.3,
                            config=tiny_cfg(tmp_path, n_epochs=50),
                            checkpoint=False)
        with pytest.raises(faults.FaultInjected, match="worker_step"):
            finish(rule)
    finally:
        faults.clear()
    assert time.monotonic() - t0 < 30


def test_supervised_restart_from_center(tmp_path):
    faults.install([{"site": "worker_step", "rule": "easgd", "worker": 1,
                     "step": 2}])
    try:
        rule, res = run(EASGD, tmp_path, tau=4, max_restarts=1)
    finally:
        faults.clear()
    assert res["restarts"] == {1: 1} and res["lost_workers"] == []
    # worker 1's second life ran its whole epoch from the center
    assert rule.workers[1].iterations == 2 + 8
    assert finite_tree(res["center"])


# -- cross-rule resume ------------------------------------------------------


def test_easgd_center_checkpoint_resumes_under_bsp(tmp_path):
    """The orchestrator saves the center it validated after worker 0's
    epoch; BSP restores it (checking its digest) and trains on."""
    run(EASGD, tmp_path, tau=4, checkpoint=True)
    saved = Checkpointer(os.path.join(tmp_path, "cifar10"),
                         read_only=True).restore(0)
    assert saved["epoch"] == 0 and finite_tree(saved["params"])
    model = TinyCifar(config=tiny_cfg(tmp_path, n_epochs=2), device="cpu")
    out = run_bsp_session(model, resume=True)
    assert out["epochs_run"] == 1
    assert out["checkpoint"]["restore"]["epoch"] == 0


def test_bsp_checkpoint_seeds_gosgd(tmp_path):
    model = TinyCifar(config=tiny_cfg(tmp_path), device="cpu")
    run_bsp_session(model)
    bsp_params = {n: p.detach().clone()
                  for n, p in model.module.named_parameters()}
    rule = GOSGD().prepare(devices=2, device="cpu", modelfile=HERE,
                           modelclass="TinyCifar", resume=True,
                           config=tiny_cfg(tmp_path, n_epochs=2))
    try:
        assert rule.start_epoch == 1 and rule.weights == [0.5, 0.5]
        for m in rule.models:
            for n, p in m.module.named_parameters():
                assert torch.equal(p, bsp_params[n])
    finally:
        rule.close()
    _, res = run(GOSGD, tmp_path, resume=True, checkpoint=True,
                 cfg=tiny_cfg(tmp_path, n_epochs=2))
    assert sum(res["weights"]) == pytest.approx(1.0, abs=1e-6)
    assert math.isfinite(res["val"]["loss"])


def test_asgd_resumes_with_the_servers_momentum(tmp_path):
    """Rank 0 checkpoints the server's center and momentum when its epoch
    ends (the other worker may push after); a resume installs exactly
    those on the new server."""
    rule, _ = run(ASGD, tmp_path, checkpoint=True)
    saved = Checkpointer(os.path.join(tmp_path, "cifar10"),
                         read_only=True).restore(0)
    want = saved["opt_state"]
    center = list(saved["params"].values())
    assert len(want["state"]) == len(center) == 10
    resumed = ASGD().prepare(devices=2, device="cpu", modelfile=HERE,
                             modelclass="TinyCifar", resume=True,
                             config=tiny_cfg(tmp_path, n_epochs=2))
    try:
        got = resumed.server.get_opt_state()
        assert resumed.start_epoch == 1
        assert set(got["state"]) == set(want["state"]) and got["state"]
        for i, per in want["state"].items():
            assert torch.equal(got["state"][i]["momentum_buffer"],
                               per["momentum_buffer"])
        for a, b in zip(resumed.server.get_center(), center):
            assert torch.equal(a, b)
    finally:
        resumed.close()
    _, res = run(ASGD, tmp_path, resume=True, checkpoint=True,
                 cfg=tiny_cfg(tmp_path, n_epochs=2))
    assert res["n_updates"] == 16 and math.isfinite(res["val"]["loss"])


def test_gosgd_resumes_every_worker_from_its_sidecars(tmp_path):
    rule, res = run(GOSGD, tmp_path, p_push=0.5, checkpoint=True)
    d = os.path.join(tmp_path, "cifar10")
    with open(os.path.join(d, "gosgd_meta_0.json")) as f:
        meta = json.load(f)
    assert meta["n_workers"] == 2
    resumed = GOSGD().prepare(devices=2, device="cpu", modelfile=HERE,
                              modelclass="TinyCifar", resume=True,
                              config=tiny_cfg(tmp_path, n_epochs=2))
    try:
        total = sum(meta["weights"])
        assert resumed.weights == [w / total for w in meta["weights"]]
        for i, m in enumerate(resumed.models):
            with np.load(os.path.join(d, f"gosgd_w{i}_0.npz")) as z:
                got = dict(m.params)
                for path, arr in z.items():
                    node = got
                    for key in path.split("/"):
                        node = node[key]
                    np.testing.assert_array_equal(node, arr)
    finally:
        resumed.close()


# -- refusals and devices ---------------------------------------------------


@pytest.mark.parametrize("rule_cls,kw,err,match", [
    (EASGD, {"tau": 0}, ValueError, "tau must be >= 1"),
    (ASGD, {"server_addr": " , "}, ValueError, "no addresses"),
    (EASGD, {"config_kw": {"zero_sharding": True}}, ValueError,
     "BSP feature"),
    (EASGD, {"local_aggregation": True, "alpha": 0.9}, ValueError,
     "n\\*alpha"),
    (ASGD, {"config_kw": {"grad_accum_steps": 2}}, ValueError,
     "BSP feature"),
    (GOSGD, {"n_total_workers": 4}, ValueError, "need server_addr"),
    (GOSGD, {"rank_offset": 2}, ValueError, "need server_addr"),
    (GOSGD, {"server_addr": "h:1,h:2"}, ValueError, "unsharded"),
    (GOSGD, {"local_aggregation": True}, ValueError, "aggregation"),
    (GOSGD, {"merge_momentum": "drop"}, ValueError, "merge_momentum"),
    (EASGD, {"config_kw": {"steps_per_call": 2}}, ValueError, "BSP feature"),
    (ASGD, {"config_kw": {"fsdp_sharding": True}}, ValueError,
     "BSP feature"),
    (ASGD, {"resume": True, "checkpoint": False}, ValueError,
     "requires checkpoint"),
])
def test_refusals(tmp_path, rule_cls, kw, err, match):
    kw = dict(kw)
    cfg = tiny_cfg(tmp_path, **kw.pop("config_kw", {}))
    kw.setdefault("checkpoint", False)
    with pytest.raises(err, match=match):
        rule_cls().prepare(devices=2, device="cpu", modelfile=HERE,
                           modelclass="TinyCifar", config=cfg, **kw)


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert resolve_devices(None, "cpu") == [cpu]
    assert resolve_devices(3, "cpu") == [cpu] * 3
    assert resolve_devices(["cpu", cpu]) == [cpu, cpu]
    with pytest.raises(ValueError, match=">= 1"):
        resolve_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_devices(1)
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_devices(["cuda:0", "cuda:0"], "cpu")


def test_params_property_is_a_snapshot():
    """``model.params`` is a copy: the next in-place step leaves it as it
    was (a CPU view used to follow the live parameters)."""
    model = TinyCifar(config=ModelConfig(batch_size=8), device="cpu")
    before = model.params
    kept = {k: {n: np.array(v) for n, v in d.items()}
            for k, d in ((k, _flat(v)) for k, v in before.items())}
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(1.0)
    for k, d in kept.items():
        for n, v in d.items():
            np.testing.assert_array_equal(_flat(before[k])[n], v)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# -- the launcher -----------------------------------------------------------


@pytest.fixture
def workers_import_this_file(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", TESTS)


def _launch(argv, timeout=DEADLINE * 2):
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=launcher.main(argv)),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"launcher still running after {timeout} s"
    return out["rc"]


@pytest.mark.parametrize("rule,extra,key,want", [
    ("EASGD", ["--tau", "4", "--alpha", "0.5"], "n_exchanges", 6),
    ("ASGD", [], "n_updates", 16),
    ("GOSGD", ["--p-push", "0.5", "--merge-momentum", "keep"], "weights",
     None)])
def test_launcher_two_cpu_workers(tmp_path, workers_import_this_file, capfd,
                                  rule, extra, key, want):
    out = tmp_path / "result.json"
    rc = _launch([rule, "-D", "2", "--platform", "cpu", "-m", HERE, "-c",
                  "TinyCifar", "--epochs", "1", "--set", "batch_size=8",
                  "--set", "print_freq=0", "--snapshot-dir", str(tmp_path),
                  "--result-json", str(out), *extra])
    stdout, stderr = capfd.readouterr()
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["rule"] == rule and res["devices"] == ["cpu", "cpu"]
    assert len(res["param_digests"]) == 2
    assert all(math.isfinite(v) for v in res["val"].values())
    assert res["iterations"] == 16 and res["val_batches"] > 0
    assert not any(res["launches"].values())
    if key == "weights":
        assert sum(res["weights"]) == pytest.approx(1.0, abs=1e-6)
    else:
        assert res[key] == want
    assert "final val" in stdout


@pytest.mark.parametrize("argv,match", [
    (["BSP", "--server-addr", "h:1"], "applies to EASGD/ASGD/GOSGD only"),
    (["GOSGD", "--local-aggregation"], "applies to EASGD/ASGD only"),
    (["GOSGD", "--tau", "3"], "--tau applies to EASGD only"),
    (["BSP", "--p-push", "0.5"], "--p-push applies to GOSGD only"),
    (["GOSGD", "--overlap-exchange"], "applies to EASGD/ASGD only"),
    (["BSP", "--min-workers", "1"], "applies to EASGD/ASGD/GOSGD only"),
    (["EASGD", "--shards", "2", "--multihost", "--coordinator", "h:1",
      "--nhosts", "2", "--host-id", "0"], "single-host"),
])
def test_launcher_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        launcher.main(argv + ["-m", "x", "-c", "y"])


def test_config_is_forwarded_unchanged(tmp_path):
    """``init``'s keyword arguments beyond the rule's options reach the
    model constructor (here its ``data``)."""
    data = Cifar10_data(synthetic_n=64, seed=3)
    rule = EASGD().prepare(devices=2, device="cpu", modelfile=HERE,
                           modelclass="TinyCifar", data=data,
                           config=tiny_cfg(tmp_path), checkpoint=False)
    try:
        assert all(m.data is data for m in rule.models)
        assert rule.val_model.data is data
        assert [m.shard_rank for m in rule.models] == [0, 1]
        assert dataclasses.asdict(rule.model.config)["batch_size"] == 8
    finally:
        rule.close()
