"""FSDP in the port (parallel/fsdp.py, ``ModelConfig.fsdp_sharding``)
against the JAX package's (theanompi_tpu/parallel/fsdp.py), on the CPU.

Two gloo ranks run every case of ``CASES`` in one spawn, from the same
weights over the same two global batches of 16 rows as
tests/test_torch_zero.py (rank r takes rows ``[8r, 8r + 8)``, shard r of
JAX's 2-device mesh): sgd with momentum, adamw, rmsprop and LARS; one
and three buckets; ``multi``, ``accum`` and 'cdd'; and a network with a
BatchNorm.  Each case is held against JAX's FSDP step (GSPMD over a
2-device slice of the mesh): parameters and each per-parameter optimizer
state within JAX's ``rtol=2e-5, atol=1e-6``.  The BN case also holds the
running statistics, which settles what JAX's FSDP BN computes: its
GSPMD step takes ``xf.mean`` over the whole sharded batch, so its
statistics are the global batch's (its running variance is the global
variance's, not the mean of the shards'), and the port's FSDP averages
each BN's ``[mean, E[x^2]]`` over the ranks to match.

In the same spawn every case also runs the port's plain BSP step from
the same weights (the BN case with ``sync=True`` BNs): at two ranks on
the f32 wire FSDP ends bit-identical to it, optimizer state included,
but for LARS, whose norms of a parameter split across the two shards sum
in another order (one process pins LARS bit for bit here, one card in
``chip_smoke.py`` phase 20).  Each rank's state at rest holds no
parameter but its flat shard, and optimizer state only of the shard's
length.

JAX's ``test_specs_pick_largest_divisible_dim`` and
``test_fsdp_bucket_barriers_in_lowering`` pin GSPMD placements and
barriers in a lowered program; the port shards a flat vector instead
(the layout tests of tests/test_torch_zero.py) and issues its bucket
collectives from the backward (restated there).  JAX's donation has no
eager counterpart.

The file is also the rank program: ``python test_torch_fsdp.py RANK
WORLD PORT DIR``.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_zero import (
    LR,
    MLP,
    STEPS,
    WORLD,
    check_resume,
    drive,
    exchanger_for,
    jax_run,
    opt_kw,
    port_loss,
    rank_batches,
    same_tensors,
    tiny_resnet,
    train_two_epochs,
)

#: the two-rank cases (tests/test_torch_zero.py's keys; ``tc``: LARS's
#: trust coefficient; ``bn``: the BN network)
CASES = {
    "sgd-b1": dict(opt="sgd"),
    "sgd-b3": dict(opt="sgd", B=3),
    "adamw-b3": dict(opt="adamw", B=3),
    "rmsprop-b1": dict(opt="rmsprop", eps=1e-4),
    "sgd-multi-b3": dict(opt="sgd", B=3, cadence="multi"),
    "adamw-accum-b1": dict(opt="adamw", cadence="accum"),
    "sgd-cdd-b3": dict(opt="sgd", B=3, avg=False),
    "lars-b1": dict(opt="lars", tc=0.01),
    "lars-b3": dict(opt="lars", tc=0.01, B=3),
    "bn-sgd-b3": dict(opt="sgd", B=3, bn=True),
}


def fsdp_opt_kw(case: dict) -> dict:
    kw = opt_kw(case)
    if "tc" in case:
        kw["lars_trust_coefficient"] = case["tc"]
    return kw


def bn_arrays(data: dict) -> dict:
    """The BN network's weights, drawn from the MLP's seed stream."""
    rng = np.random.default_rng(5)
    return {"w1": rng.standard_normal((5, 8)).astype(np.float32),
            "scale": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(8)).astype(np.float32),
            "w2": rng.standard_normal((8, 3)).astype(np.float32),
            "b": data["b"]}


class BNMLP(nn.Module):
    """``tanh(BN(x @ w1)) @ w2 + b``; ``sync``: the BN's statistics over
    the ranks."""

    def __init__(self, arrays: dict, sync: bool = False):
        from theanompi_tpu_torch.models.layers import BatchNormAct

        super().__init__()
        self.w1 = nn.Parameter(torch.tensor(arrays["w1"]))
        self.bn = BatchNormAct(8, torch.float32, sync=sync)
        with torch.no_grad():
            self.bn.scale.copy_(torch.tensor(arrays["scale"]))
            self.bn.bias.copy_(torch.tensor(arrays["bias"]))
        self.w2 = nn.Parameter(torch.tensor(arrays["w2"]))
        self.b = nn.Parameter(torch.tensor(arrays["b"]))

    def forward(self, x):
        return torch.tanh(self.bn(x @ self.w1)) @ self.w2 + self.b


#: the BN network's port names -> its JAX tree paths
BN_NAMES = {"w1": ("w1",), "bn.scale": ("bn", "scale"),
            "bn.bias": ("bn", "bias"), "w2": ("w2",), "b": ("b",)}


def _run_case(name: str, data: dict, rank: int, world: int,
              sharded: bool, sync: bool = True) -> dict:
    """One case on this rank: FSDP (``sharded``) or its plain twin
    (``sync``: the BN network's BNs over the ranks)."""
    from theanompi_tpu_torch.parallel import bsp
    from theanompi_tpu_torch.parallel.fsdp import (
        full_params,
        init_fsdp_state,
        make_bsp_fsdp_step,
        per_param_opt_state,
    )
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    case = CASES[name]
    cadence = case.get("cadence", "single")
    module = (BNMLP(bn_arrays(data), sync=sync and not sharded)
              if case.get("bn") else MLP(data)).train()
    ex = exchanger_for(case)

    def make_opt(params):
        return build_optimizer(params, LR, case["opt"], **fsdp_opt_kw(case))

    if sharded:
        state = init_fsdp_state(module, make_opt, ex.exchange_buckets)
        step = make_bsp_fsdp_step(port_loss, ex, accum=cadence == "accum",
                                  multi=cadence == "multi")
    else:
        state = bsp.TrainState(module, make_opt(module.parameters()))
        step = {"single": bsp.make_bsp_train_step,
                "multi": bsp.make_bsp_multi_step,
                "accum": bsp.make_bsp_accum_step}[cadence](port_loss, ex)
    drive(step, state, rank_batches(data, rank, world), cadence)
    out = {"buffers": {n: b.clone() for n, b in module.named_buffers()},
           "step": state.step}
    if sharded:
        shard = state.sharding
        tensors = [t for t in state.optimizer.state[shard.shard].values()
                   if torch.is_tensor(t) and t.dim() > 0]
        out["at_rest"] = {
            "params": [p.numel() for p in module.parameters()],
            "shard": shard.shard.numel(), "per_shard": shard.layout.per_shard,
            "opt": [t.numel() for t in tensors]}
        sd = per_param_opt_state(state)
        with full_params(state):
            out["params"] = {n: p.detach().clone()
                             for n, p in module.named_parameters()}
    else:
        sd = state.optimizer.state_dict()
        out["params"] = {n: p.detach().clone()
                         for n, p in module.named_parameters()}
    names = [n for n, _ in module.named_parameters()]
    keys = [k for k, v in sd["state"][0].items()
            if torch.is_tensor(v) and v.dim() > 0]
    out["opt"] = [{n: sd["state"][i][k].clone() for i, n in enumerate(names)}
                  for k in keys]
    return out


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for name in CASES:
            fsdp = _run_case(name, data, rank, world, True)
            plain = _run_case(name, data, rank, world, False)
            fsdp["same_as_bsp"] = {k: same_tensors(fsdp[k], plain[k])
                                   for k in ("params", "opt", "buffers")}
            if CASES[name].get("bn"):
                fsdp["per_rank_bn"] = _run_case(name, data, rank, world,
                                                False, sync=False)["buffers"]
            out[name] = fsdp
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of ``CASES`` on two gloo ranks: one spawn."""
    from test_torch_exchange import spawn_ranks
    from test_torch_zero import draw

    tmp = tmp_path_factory.mktemp("fsdp")
    data = draw()
    np.savez(tmp / "inputs.npz", **data)
    spawn_ranks(os.path.abspath(__file__), tmp, timeout=240)
    return data, [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)]


def jax_bn_run(mesh8, data: dict, case: dict):
    """The BN network under JAX's FSDP step on 2 devices (JAX's
    ``layers.BatchNormAct``, the models' BN): parameters and running
    statistics, by the port's names."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models import layers as JL
    from theanompi_tpu.parallel import fsdp as jfsdp
    from theanompi_tpu.parallel.mesh import data_mesh, shard_batch
    from theanompi_tpu.utils.helper_funcs import build_optimizer

    arrays = bn_arrays(data)
    bn = JL.BatchNormAct(momentum=0.9, epsilon=1e-5)

    def loss(params, model_state, batch, rng):
        x, y = batch
        h, upd = bn.apply({"params": params["bn"], **model_state},
                          x @ params["w1"], mutable=["batch_stats"])
        pred = jnp.tanh(h) @ params["w2"] + params["b"]
        value = jnp.mean((pred - y) ** 2)
        return value, (upd, {"loss": value, "error": value})

    mesh = data_mesh(WORLD, mesh8.devices.ravel()[:WORLD])
    params = {"w1": arrays["w1"], "w2": arrays["w2"], "b": arrays["b"],
              "bn": {"scale": arrays["scale"], "bias": arrays["bias"]}}
    params = jax.tree.map(jnp.asarray, params)
    ms = {"batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    tx = build_optimizer(LR, optimizer=case["opt"], **fsdp_opt_kw(case))
    state = jfsdp.init_fsdp_state(params, tx, ms, mesh,
                                  jfsdp.fsdp_specs(params, mesh))
    step = jfsdp.make_bsp_fsdp_step(loss, tx, mesh, params, donate=False,
                                    exchange_buckets=case.get("B", 1))
    for i in range(STEPS):
        state, _ = step(state, shard_batch(
            (jnp.asarray(data[f"x{i}"]), jnp.asarray(data[f"y{i}"])), mesh),
            jax.random.key(0))
    got = {}
    for name, path in BN_NAMES.items():
        leaf = state.params
        for k in path:
            leaf = leaf[k]
        got[name] = np.asarray(leaf)
    stats = {f"bn.{k}": np.asarray(v)
             for k, v in state.model_state["batch_stats"].items()}
    return got, stats


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax_fsdp(ranks, mesh8, name):
    data, outs = ranks
    case = CASES[name]
    got = outs[0][name]
    for k in got["params"]:                  # the replicas agree
        assert torch.equal(got["params"][k], outs[1][name]["params"][k]), k
    if case.get("bn"):
        want, stats = jax_bn_run(mesh8, data, case)
        for k, w in stats.items():
            np.testing.assert_allclose(got["buffers"][k].numpy(), w,
                                       rtol=2e-5, atol=1e-6, err_msg=k)
        slots = []
    else:
        want, slots = jax_run(mesh8, data, case, fsdp=True,
                              optimizer_kw=fsdp_opt_kw(case))
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n].numpy(), w, rtol=2e-5,
                                   atol=1e-6, err_msg=n)
    assert len(got["opt"]) == len(slots) or case.get("bn")
    for slot, (mine, theirs) in enumerate(zip(got["opt"], slots)):
        for n, w in theirs.items():
            np.testing.assert_allclose(mine[n].numpy(), w, rtol=2e-5,
                                       atol=1e-6, err_msg=f"slot {slot} {n}")


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n]["opt"] != "lars"])
def test_bit_identical_to_plain_bsp_at_two_ranks(ranks, name):
    """Two terms sum in one order: FSDP's reduce-scatter and BSP's
    all-reduce agree bit for bit; the BN network's plain twin takes its
    statistics over the ranks (``sync``), as FSDP does."""
    _, outs = ranks
    for r in range(WORLD):
        same = outs[r][name]["same_as_bsp"]
        assert all(same.values()), (r, same)


def test_bn_statistics_are_the_global_batchs(ranks, mesh8):
    """JAX's FSDP running variance after one step from (0, 1) with
    momentum 0.9 is 0.9 + 0.1 * the GLOBAL batch's variance, not the
    mean of the shards' variances; the port's FSDP matches it (the
    parametrized test above holds it after two steps), and the port's
    plain per-rank BN does not."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models import layers as JL
    from theanompi_tpu.parallel import fsdp as jfsdp
    from theanompi_tpu.parallel.mesh import data_mesh, shard_batch
    from theanompi_tpu.utils.helper_funcs import build_optimizer

    data, outs = ranks
    arrays = bn_arrays(data)
    bn = JL.BatchNormAct(momentum=0.9, epsilon=1e-5)

    def loss(params, model_state, batch, rng):
        h, upd = bn.apply({"params": params, **model_state}, batch[0],
                          mutable=["batch_stats"])
        return jnp.mean(h ** 2), (upd, {"loss": jnp.mean(h),
                                        "error": jnp.mean(h)})

    mesh = data_mesh(WORLD, mesh8.devices.ravel()[:WORLD])
    params = {"scale": jnp.asarray(arrays["scale"]),
              "bias": jnp.asarray(arrays["bias"])}
    tx = build_optimizer(0.0)
    state = jfsdp.init_fsdp_state(
        params, tx, {"batch_stats": {"mean": jnp.zeros(8),
                                     "var": jnp.ones(8)}}, mesh,
        jfsdp.fsdp_specs(params, mesh))
    h = (data["x0"] @ arrays["w1"]).astype(np.float32)
    step = jfsdp.make_bsp_fsdp_step(loss, tx, mesh, params, donate=False)
    state, _ = step(state, shard_batch((jnp.asarray(h),), mesh),
                    jax.random.key(0))
    var = np.asarray(state.model_state["batch_stats"]["var"])
    global_var = 0.9 + 0.1 * h.astype(np.float64).var(0)
    shards_var = 0.9 + 0.1 * np.mean([h[:8].astype(np.float64).var(0),
                                      h[8:].astype(np.float64).var(0)], 0)
    np.testing.assert_allclose(var, global_var, rtol=1e-5)
    assert np.abs(var - shards_var).max() > 1e-3
    got = outs[0]["bn-sgd-b3"]
    for r in range(WORLD):
        assert torch.equal(outs[r]["bn-sgd-b3"]["buffers"]["bn.var"],
                           got["buffers"]["bn.var"])
        assert not torch.equal(outs[r]["bn-sgd-b3"]["per_rank_bn"]["bn.var"],
                               got["buffers"]["bn.var"])


def test_state_at_rest_is_the_shard(ranks):
    """At rest a rank's module holds empty parameters, its shard
    per_shard elements, and each optimizer state tensor the same."""
    _, outs = ranks
    for name in CASES:
        for r in range(WORLD):
            rest = outs[r][name]["at_rest"]
            assert set(rest["params"]) == {0}
            assert rest["shard"] == rest["per_shard"]
            assert rest["opt"] and set(rest["opt"]) == {rest["per_shard"]}


@pytest.mark.parametrize("b", [1, 3])
def test_lars_one_process_bit_identical_to_plain(b):
    """At one process every parameter is whole in the shard: FSDP's LARS
    takes each norm as the plain LARS does, bit for bit, through three
    steps."""
    from test_torch_zero import draw

    from theanompi_tpu_torch.parallel import bsp
    from theanompi_tpu_torch.parallel.fsdp import (
        full_params,
        init_fsdp_state,
        make_bsp_fsdp_step,
    )
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    data = draw()
    batches = rank_batches(data, 0, 1)
    kw = fsdp_opt_kw(CASES["lars-b1"])
    plain = MLP(data)
    ps = bsp.TrainState(plain, build_optimizer(plain.parameters(), LR,
                                               "lars", **kw))
    ex = BSP_Exchanger(exchange_buckets=b)
    pstep = bsp.make_bsp_train_step(port_loss, ex)
    sharded = MLP(data)
    fs = init_fsdp_state(sharded, lambda p: build_optimizer(
        p, LR, "lars", **kw), b)
    fstep = make_bsp_fsdp_step(port_loss, ex)
    for i in range(3):
        pstep(ps, batches[i % STEPS], None)
        fstep(fs, batches[i % STEPS], None)
    with full_params(fs):
        for (n, a), c in zip(plain.named_parameters(), sharded.parameters()):
            assert torch.equal(a, c), n


def test_fsdp_refusals_match_jax(tmp_path):
    """JAX's refusals: FSDP with ZeRO, the bf16 strategy spelling, the
    bf16 wire and error feedback (model and step), and ``sync_bn``."""
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu_torch.parallel.fsdp import make_bsp_fsdp_step

    for bad, msg in [
            (dict(zero_sharding=True), "meaningless"),
            (dict(exchange_strategy="nccl16"), "bf16-compressed"),
            (dict(exchange_dtype="bf16"), "exchange_dtype"),
            (dict(exchange_dtype="bf16", exchange_error_feedback=True),
             "exchange_dtype"),
            (dict(exchange_what="params"), "IS the gradient exchange"),
            (dict(sync_bn=True), "use per-shard BN")]:
        with pytest.raises(ValueError, match=msg):
            tiny_resnet(tmp_path, fsdp_sharding=True,
                        **bad).compile_iter_fns("avg")
    for ex in (BSP_Exchanger(exchange_dtype="bf16"),
               BSP_Exchanger(exchange_dtype="bf16", error_feedback=True)):
        with pytest.raises(ValueError, match="no seam"):
            make_bsp_fsdp_step(port_loss, ex)
    with pytest.raises(ValueError, match="exchange_buckets"):
        BSP_Exchanger(exchange_buckets=0)


def test_model_trains_with_fsdp_schedule_multi_snapshots_and_payload(
        tmp_path):
    """``fsdp_sharding`` through ``compile_iter_fns``/``train_iter`` with
    ``steps_per_call=2``, three buckets, lars and the LR schedule,
    bit-identical to the plain model at one process: the checkpoint
    payload (whole parameters, per-parameter optimizer state) has the
    plain model's state digest; the parameters are empty at rest; npz
    ``save`` -> ``load`` into a fresh FSDP model re-shards the same
    parameters; ``adopt_restored_state`` of the plain payload gives the
    FSDP model the same digest; ``export_model`` writes the whole
    parameters."""
    from theanompi_tpu_torch.serving.export import STATE_FILE, export_model
    from theanompi_tpu_torch.utils.checkpoint import state_digest

    cfg = dict(steps_per_call=2, optimizer="lars", momentum=0.9,
               lars_trust_coefficient=0.01)
    fsdp = tiny_resnet(tmp_path / "f", fsdp_sharding=True,
                       exchange_buckets=3, **cfg)
    plain = tiny_resnet(tmp_path / "p", **cfg)
    losses = [train_two_epochs(m) for m in (fsdp, plain)]
    assert losses[0] == losses[1]
    assert all(p.numel() == 0 for p in fsdp.module.parameters())
    payload = fsdp.checkpoint_payload(1)
    assert state_digest(payload) == state_digest(plain.checkpoint_payload(1))
    assert all(p.numel() == 0 for p in fsdp.module.parameters())
    path = fsdp.save()
    fresh = tiny_resnet(tmp_path / "n", fsdp_sharding=True, **cfg)
    fresh.load(path)
    with fsdp.full_params(), fresh.full_params():
        for (n, a), b in zip(fsdp.module.named_parameters(),
                             fresh.module.parameters()):
            assert torch.equal(a, b), n
    fresh.adopt_restored_state(plain.checkpoint_payload(1))
    assert state_digest(fresh.checkpoint_payload(1)) == state_digest(
        payload)
    export_model(fsdp, str(tmp_path / "export"), version=0)
    exported = torch.load(tmp_path / "export" / "0" / STATE_FILE)
    for k, v in plain.module.state_dict().items():
        assert torch.equal(exported[k], v.float()), k
    assert np.isfinite(train_two_epochs(fresh)).all()


#: the launcher's --set for FSDP: four buckets and LARS
FSDP_SETS = ("fsdp_sharding=true", "exchange_buckets=4", "optimizer=lars",
             "lars_trust_coefficient=0.01", "n_epochs=2")


def test_launcher_stopped_and_resumed_matches_unbroken(tmp_path):
    """Two gloo ranks under FSDP (4 buckets, LARS, the ResNet's BNs over
    the global batch): stopped after epoch 0 and resumed, the run ends on
    the unbroken run's digests; the checkpoint holds whole parameters and
    per-parameter momentum."""
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    check_resume(tmp_path, FSDP_SETS)
    ck = Checkpointer(str(tmp_path / "r" / "resnet50"), read_only=True)
    payload = ck.restore(0)
    ck.close()
    opt = payload["opt_state"]["state"]
    assert len(opt) == len(payload["params"])
    for i, (name, p) in enumerate(payload["params"].items()):
        assert opt[i]["momentum_buffer"].shape == p.shape, name


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
