"""ZeRO-1 in the port (parallel/zero.py, ``ModelConfig.zero_sharding``)
against the JAX package's (theanompi_tpu/parallel/zero.py), on the CPU.

Two gloo ranks run every case of ``CASES`` in one spawn: JAX's test
model (``tanh(x @ w1) @ w2 + b`` under a squared loss, drawn with numpy)
from the same weights over the same two global batches of 16 rows, rank
r taking rows ``[8r, 8r + 8)`` as shard r of JAX's 2-device mesh does:
sgd with momentum, adamw and rmsprop; one and three buckets; single
steps, ``steps_per_call`` (``multi``) and accumulation (``accum``);
'avg' and 'cdd'; the bf16 wire with and without error feedback.  Each
case is held against JAX's ZeRO step on a 2-device slice of the mesh:
parameters and each per-parameter optimizer state within JAX's own
``rtol=2e-5, atol=1e-6`` (each side unravelled by its own layout: the
port's leaves run in the backward's order, JAX's in flax's), the bf16
wire's floor raised by what one bf16 ulp of each rank's gradient moves
a parameter by (tests/test_torch_bsp_dist.py's rule: ``LR * (2 +
momentum) * 2^-7 * max|g|``).  In the same spawn every case also runs
the port's plain BSP step from the same weights: on the f32 wire at two
ranks a sum has one order, so ZeRO must end bit-identical to it (parameters, optimizer
state, error-feedback residual); the bf16 wire too (a bf16 all-gather
summed in f32 against an all-to-all summed in f32).  The spawn also
records each rank's state at rest (its shard and every optimizer state
tensor ``per_shard`` long) and, with three buckets, how many bucket
reduce-scatters the gradient hooks had started when the backward ended.

JAX's ``test_zero_bucketed_collectives_in_lowering`` pins B
reduce-scatters interleaved with the backward in the lowered program;
its restatement here is "bucket 0's reduce-scatter is issued before the
backward ends" (eager PyTorch has no program to lower).  Its donation
tests (``test_zero_stacked_cadence_donates_staged_batch``,
``test_zero_bucketed_donation_unchanged``) have no counterpart: an
eager step allocates no output for its inputs to alias, so there is
nothing to donate.  ``test_zero_composes_with_sequence_parallel`` has
its counterpart on four more gloo ranks (a second spawn): the
TransformerLM over (data 2 x seq 2) with and without ZeRO from JAX's
initial weights, two steps: the ZeRO run's losses and parameters within
JAX's ``rtol=2e-5, atol=1e-6`` of the plain SP run's and of JAX's own
ZeRO-over-seq run, the optimizer state cut over ``data`` only (each
rank's momentum half the flat vector, equal across the ``seq`` pair).

The file is also the rank program: ``python test_torch_zero.py RANK
WORLD PORT DIR``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_BATCH, STEPS = 2, 16, 2
LR = 0.05
OPT = dict(momentum=0.9, weight_decay=1e-4)
#: the two-rank cases: optimizer, buckets, cadence, 'avg'/'cdd', wire.
#: rmsprop runs at eps 1e-4: at 1e-8 it scales an element's update by up
#: to rsqrt(eps) = 1e4, so an element whose gradient is 3e-5 moves by 1e-5
#: (measured) for the two frameworks' 1e-9 difference in that gradient
#: (sums in other orders), beyond JAX's atol, with no fault on either side
CASES = {
    "sgd-b1": dict(opt="sgd"),
    "sgd-b3": dict(opt="sgd", B=3),
    "adamw-b1": dict(opt="adamw"),
    "adamw-b3": dict(opt="adamw", B=3),
    "rmsprop-b3": dict(opt="rmsprop", B=3, eps=1e-4),
    "sgd-multi-b3": dict(opt="sgd", B=3, cadence="multi"),
    "sgd-accum-b1": dict(opt="sgd", cadence="accum"),
    "adamw-accum-b3": dict(opt="adamw", B=3, cadence="accum"),
    "sgd-cdd-b1": dict(opt="sgd", avg=False),
    "bf16-b1": dict(opt="sgd", wire="bf16"),
    "ef-b1": dict(opt="sgd", wire="bf16", ef=True),
    "ef-b3": dict(opt="sgd", wire="bf16", ef=True, B=3),
}


def draw() -> dict:
    """The weights (JAX's test shapes: not divisible by two, so the pad
    path runs) and two global batches."""
    rng = np.random.default_rng(3)
    out = {"w1": rng.standard_normal((5, 7)),
           "w2": rng.standard_normal((7, 3)),
           "b": 0.1 * rng.standard_normal(3)}
    for i in range(STEPS):
        out[f"x{i}"] = rng.standard_normal((GLOBAL_BATCH, 5))
        out[f"y{i}"] = rng.standard_normal((GLOBAL_BATCH, 3))
    return {k: v.astype(np.float32) for k, v in out.items()}


class MLP(nn.Module):
    """JAX's test model, its parameters from ``arrays``."""

    def __init__(self, arrays: dict):
        super().__init__()
        for k in ("w1", "w2", "b"):
            setattr(self, k, nn.Parameter(torch.tensor(arrays[k])))

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2 + self.b


def port_loss(module, batch, rng):
    x, y = batch
    loss = ((module(x) - y) ** 2).mean()
    return loss, {"error": loss.detach()}


def jax_loss(params, model_state, batch, rng):
    import jax.numpy as jnp

    x, y = batch
    pred = jnp.tanh(x @ params["w1"]) @ params["w2"] + params["b"]
    loss = jnp.mean((pred - y) ** 2)
    return loss, (model_state, {"loss": loss, "error": loss})


def opt_kw(case: dict) -> dict:
    """The optimizer's keyword arguments of a case (both packages')."""
    return {**OPT, **({"eps": case["eps"]} if "eps" in case else {})}


def rank_batches(data: dict, rank: int, world: int) -> list:
    per = GLOBAL_BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    return [(torch.tensor(data[f"x{i}"][rows]),
             torch.tensor(data[f"y{i}"][rows])) for i in range(STEPS)]


def exchanger_for(case: dict):
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    return BSP_Exchanger(avg=case.get("avg", True),
                         exchange_dtype=case.get("wire"),
                         error_feedback=case.get("ef", False),
                         exchange_buckets=case.get("B", 1))


def drive(step, state, batches, cadence: str) -> None:
    """The case's calls: one single step per batch, or one stacked call."""
    if cadence == "single":
        for b in batches:
            step(state, b, None)
    else:
        step(state, batches, None)


def shard_opt_per_param(state) -> list[dict]:
    """Each shard-length optimizer state tensor, gathered from every rank
    and cut into parameters: one ``{name: tensor}`` per state slot."""
    from theanompi_tpu_torch.parallel.zero import _unravel_bucketed

    shard = state.sharding
    names = [n for n, _ in state.module.named_parameters()][::-1]
    per = state.optimizer.state[shard.shard]
    return [{n: v.reshape(s).clone() for n, v, s in zip(
        names, _unravel_bucketed(shard.gather_flat(t), shard.layout),
        shard.shapes)}
        for t in per.values() if torch.is_tensor(t) and t.dim() == 1]


def plain_opt_per_param(state) -> list[dict]:
    """The plain optimizer's per-parameter state tensors, per slot."""
    named = list(state.module.named_parameters())
    keys = [k for k, v in state.optimizer.state[named[0][1]].items()
            if torch.is_tensor(v) and v.dim() > 0]
    return [{n: state.optimizer.state[p][k].clone() for n, p in named}
            for k in keys]


def _run_case(name: str, data: dict, rank: int, world: int,
              sharded: bool, hooks: list) -> dict:
    """One case on this rank: ZeRO (``sharded``) or its plain twin."""
    from theanompi_tpu_torch.parallel import bsp
    from theanompi_tpu_torch.parallel.zero import (
        _unravel_bucketed,
        init_zero_exchange_residual,
        init_zero_opt_state,
        make_bsp_zero_step,
    )
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    case = CASES[name]
    cadence = case.get("cadence", "single")
    module = MLP(data)
    ex = exchanger_for(case)
    names = [n for n, _ in module.named_parameters()]
    gmax = dict.fromkeys(names, 0.0)
    for n, p in module.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda q, n=n: gmax.__setitem__(n, max(
                gmax[n], float(q.grad.abs().max()))))

    def make_opt(params):
        return build_optimizer(params, LR, case["opt"], **opt_kw(case))

    if sharded:
        opt, shard = init_zero_opt_state(module, make_opt,
                                         ex.exchange_buckets)
        state = bsp.TrainState(
            module, opt, sharding=shard,
            exchange_residual=(init_zero_exchange_residual(
                module, ex.exchange_buckets) if ex.error_feedback else None))
        step = make_bsp_zero_step(port_loss, ex, accum=cadence == "accum",
                                  multi=cadence == "multi")
    else:
        state = bsp.TrainState(
            module, make_opt(module.parameters()),
            exchange_residual=(bsp.init_exchange_residual(module)
                               if ex.error_feedback else None))
        step = {"single": bsp.make_bsp_train_step,
                "multi": bsp.make_bsp_multi_step,
                "accum": bsp.make_bsp_accum_step}[cadence](port_loss, ex)
    del hooks[:]
    drive(step, state, rank_batches(data, rank, world), cadence)
    out = {"params": {n: p.detach().clone()
                      for n, p in module.named_parameters()},
           "gmax": gmax, "hooks": list(hooks), "step": state.step}
    res = state.exchange_residual
    if sharded:
        out["opt"] = shard_opt_per_param(state)
        tensors = [t for t in opt.state[shard.shard].values()
                   if torch.is_tensor(t) and t.dim() > 0]
        out["at_rest"] = {"shard": shard.shard.numel(),
                          "per_shard": shard.layout.per_shard,
                          "opt": [t.numel() for t in tensors],
                          "params": sum(p.numel()
                                        for p in module.parameters())}
        if res is not None:
            out["residual"] = {n: v.reshape(s).clone() for n, v, s in zip(
                names[::-1], _unravel_bucketed(res, shard.layout),
                shard.shapes)}
    else:
        out["opt"] = plain_opt_per_param(state)
        if res is not None:
            out["residual"] = {n: r.clone() for n, r in zip(names, res)}
    return out


def same_tensors(a, b) -> bool:
    """Equal bit for bit, through nested dicts and lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same_tensors, a, b))
    return torch.equal(a, b)


def record_hooks(hooks: list):
    """Patch ``BucketedBackward.finish`` to append, per overlapped step,
    (buckets started, buckets planned) as the backward ends; returns the
    original."""
    from theanompi_tpu_torch.parallel.exchanger import BucketedBackward

    finish = BucketedBackward.finish

    def recording_finish(self):
        hooks.append((self._next, len(self.buckets)))
        finish(self)

    BucketedBackward.finish = recording_finish
    return finish


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.exchanger import BucketedBackward

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    hooks: list = []
    finish = record_hooks(hooks)
    try:
        data = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for name in CASES:
            zero = _run_case(name, data, rank, world, True, hooks)
            plain = _run_case(name, data, rank, world, False, hooks)
            zero["same_as_bsp"] = {
                k: same_tensors(zero[k], plain[k])
                for k in ("params", "opt", "residual") if k in zero}
            out[name] = zero
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    finally:
        BucketedBackward.finish = finish
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of ``CASES`` on two gloo ranks: one spawn."""
    from test_torch_exchange import spawn_ranks

    tmp = tmp_path_factory.mktemp("zero")
    data = draw()
    np.savez(tmp / "inputs.npz", **data)
    spawn_ranks(os.path.abspath(__file__), tmp, timeout=240)
    return data, [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)]


def jax_run(mesh8, data: dict, case: dict, fsdp: bool = False,
            optimizer_kw: dict | None = None):
    """JAX's ZeRO (or FSDP) step on a 2-device slice of ``mesh8``: the
    parameters and, per state slot, the per-parameter optimizer state,
    as numpy dicts (``optimizer_kw``: default the case's)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.parallel.bsp import TrainState
    from theanompi_tpu.parallel.mesh import data_mesh, shard_batch
    from theanompi_tpu.parallel import fsdp as jfsdp
    from theanompi_tpu.parallel import zero as jzero
    from theanompi_tpu.utils.helper_funcs import build_optimizer

    mesh = data_mesh(WORLD, mesh8.devices.ravel()[:WORLD])
    cadence = case.get("cadence", "single")
    params = {k: jnp.asarray(data[k]) for k in ("w1", "w2", "b")}
    tx = build_optimizer(LR, optimizer=case["opt"],
                         **(optimizer_kw or opt_kw(case)))
    b = case.get("B", 1)
    kw = dict(avg=case.get("avg", True), donate=False,
              accum=cadence == "accum", multi=cadence == "multi",
              exchange_buckets=b)
    if fsdp:
        state = jfsdp.init_fsdp_state(params, tx, {}, mesh,
                                      jfsdp.fsdp_specs(params, mesh))
        step = jfsdp.make_bsp_fsdp_step(jax_loss, tx, mesh, params, **kw)
    else:
        ef = case.get("ef", False)
        opt0, _ = jzero.init_zero_opt_state(tx, params, mesh,
                                            exchange_buckets=b)
        res = (jax.device_put(jzero.init_zero_exchange_residual(
            params, mesh, b), NamedSharding(mesh, P("data"))) if ef
            else None)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=opt0, model_state={},
                           exchange_residual=res)
        step = jzero.make_bsp_zero_step(
            jax_loss, tx, mesh, params, exchange_dtype=case.get("wire")
            or "f32", error_feedback=ef, **kw)
    batches = [(jnp.asarray(data[f"x{i}"]), jnp.asarray(data[f"y{i}"]))
               for i in range(STEPS)]
    key = jax.random.key(0)
    if cadence == "single":
        for batch in batches:
            state, _ = step(state, shard_batch(batch, mesh), key)
    else:
        stacked = jax.device_put(jax.tree.map(lambda *t: jnp.stack(t),
                                              *batches),
                                 NamedSharding(mesh, P(None, "data")))
        state, _ = step(state, stacked, key)
    got = {k: np.asarray(v) for k, v in state.params.items()}
    return got, jax_opt_slots(state.opt_state, params, b, fsdp)


def jax_opt_slots(opt_state, params, b: int, fsdp: bool) -> list[dict]:
    """JAX's per-parameter optimizer state, one ``{name: array}`` per
    slot, in the order of the state's leaves."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.parallel import zero as jzero

    if fsdp:
        slots: dict = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state):
            key = getattr(path[-1], "key", None)
            if key in params and leaf.shape == params[key].shape:
                slots.setdefault(jax.tree_util.keystr(path[:-1]), {})[
                    key] = np.asarray(leaf)
        return list(slots.values())
    layout = jzero._zero_layout(params, WORLD, b)
    out = []
    for leaf in jax.tree.leaves(opt_state):
        if getattr(leaf, "shape", None) == (WORLD * layout.per_shard,):
            rows = np.asarray(leaf).reshape(WORLD, layout.per_shard)
            flat = np.concatenate([rows[:, so:so + pb].reshape(-1)
                                   for so, pb in zip(layout.shard_off,
                                                     layout.pb)])
            out.append({k: np.asarray(v) for k, v in
                        jzero._unravel_bucketed(jnp.asarray(flat), params,
                                                layout).items()})
    return out


def assert_matches_jax(ranks: list, want_params: dict, want_slots: list,
                       case: dict) -> None:
    """Rank 0's parameters and optimizer state (``ranks``: each rank's
    output of the case) within JAX's tolerance, the bf16 wire's floor
    raised by one bf16 ulp of each rank's gradient."""
    got = ranks[0]
    floor = dict.fromkeys(want_params, 1e-6)
    if case.get("wire") == "bf16":
        for n in floor:
            floor[n] = max(1e-6, LR * (2 + OPT["momentum"]) * 2.0 ** -7
                           * max(r["gmax"][n] for r in ranks))
    for n, w in want_params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), w, rtol=2e-5,
                                   atol=floor[n], err_msg=n)
    assert len(got["opt"]) == len(want_slots)
    for slot, (mine, theirs) in enumerate(zip(got["opt"], want_slots)):
        assert set(mine) == set(theirs)
        for n, w in theirs.items():
            np.testing.assert_allclose(
                mine[n].numpy(), w, rtol=2e-5,
                atol=floor[n] / (LR if case.get("wire") == "bf16" else 1),
                err_msg=f"slot {slot} {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax_zero(ranks, mesh8, name):
    data, outs = ranks
    case = CASES[name]
    for k in outs[0][name]["params"]:         # the replicas agree
        assert torch.equal(outs[0][name]["params"][k],
                           outs[1][name]["params"][k]), k
    assert outs[0][name]["step"] == (1 if case.get("cadence") == "accum"
                                     else STEPS)
    want, slots = jax_run(mesh8, data, case)
    assert_matches_jax([out[name] for out in outs], want, slots, case)


@pytest.mark.parametrize("name", list(CASES))
def test_bit_identical_to_plain_bsp_at_two_ranks(ranks, name):
    """A sum of two terms has one order: ZeRO's reduce-scatter (or the
    bf16 all-to-all) and the plain all-reduce (or all-gather) agree bit
    for bit, and so does everything downstream."""
    _, outs = ranks
    for r in range(WORLD):
        same = outs[r][name]["same_as_bsp"]
        assert same and all(same.values()), (r, same)


def test_state_at_rest_is_one_nth(ranks):
    """Each rank's shard and each optimizer state tensor hold per_shard
    elements: about 1/N of the parameters, never the whole."""
    _, outs = ranks
    for name in CASES:
        for r in range(WORLD):
            rest = outs[r][name]["at_rest"]
            assert rest["shard"] == rest["per_shard"]
            assert rest["opt"] and set(rest["opt"]) == {rest["per_shard"]}
            assert WORLD * rest["per_shard"] >= rest["params"]
            assert rest["per_shard"] < rest["params"]


def test_bucket_zero_scatter_starts_before_the_backward_ends(ranks):
    """JAX's lowering pin restated: with three buckets, the hooks had
    started bucket 0's reduce-scatter (at least) when the backward
    ended, in every single step and every step of ``multi``."""
    _, outs = ranks
    for name in ("sgd-b3", "adamw-b3", "rmsprop-b3", "sgd-multi-b3",
                 "ef-b3"):
        for r in range(WORLD):
            hooks = outs[r][name]["hooks"]
            assert len(hooks) == STEPS, (name, hooks)
            assert all(started >= 1 and planned == 3
                       for started, planned in hooks), (name, hooks)
    assert all(outs[r]["adamw-accum-b3"]["hooks"] == [] for r in
               range(WORLD))   # accumulation scatters after the backward


def test_layout_properties_and_jax_layout():
    """JAX's ``test_zero_bucket_layout_properties``: segments divisible
    by N, consistent offsets, one bucket the plain padded layout, and the
    shard length strictly rising with the bucket count (the B-encoding
    pad), so a resume under another bucket count fails on shape.  The
    layout of the same leaf sizes equals JAX's field for field."""
    import dataclasses

    from theanompi_tpu.parallel import zero as jzero
    from theanompi_tpu_torch.parallel.zero import _flat_info, _zero_layout

    sizes = [35, 21, 3]
    total, pad, per_shard = _flat_info(sizes, 8)
    l1 = _zero_layout(sizes, 8, 1)
    assert l1.per_shard == per_shard and l1.total_flat == total + pad
    lengths = [_zero_layout(sizes, 8, b).per_shard for b in (1, 2, 3)]
    assert lengths == sorted(set(lengths)), lengths
    many = [32] * 16
    many_lengths = [_zero_layout(many, 8, b).per_shard
                    for b in (1, 2, 4, 8, 16)]
    assert many_lengths == sorted(set(many_lengths)), many_lengths
    for b in (2, 3):
        lb = _zero_layout(sizes, 8, b)
        assert lb == _zero_layout(sizes, 8, b)
        assert all(s % 8 == 0 for s in lb.seg)
        assert sum(lb.m) == total and lb.per_shard == sum(lb.pb)
        assert lb.total_flat == sum(lb.seg)
    for leaves in (sizes, many, [5, 7, 11, 13, 2]):
        tree = {f"l{i:02d}": np.zeros(n) for i, n in enumerate(leaves)}
        for n_shards in (2, 8):
            for b in (1, 2, 3, 4):
                assert dataclasses.asdict(
                    _zero_layout(leaves, n_shards, b)) == dataclasses.asdict(
                    jzero._zero_layout(tree, n_shards, b)), (leaves, b)


def test_ravel_and_shards_round_trip():
    """The shards of the bucketed flat vector, stacked as an all-gather
    returns them, give the vector back, and the leaves come back whole."""
    from theanompi_tpu_torch.parallel.zero import (
        _bucketed_from_rows,
        _ravel_bucketed,
        _shard_slice,
        _unravel_bucketed,
        _zero_layout,
    )

    leaves = [torch.randn(5, 7), torch.randn(3), torch.randn(7, 3),
              torch.randn(2, 2, 2)]
    for n in (1, 2, 3):
        for b in (1, 2, 4):
            lay = _zero_layout(leaves, n, b)
            flat = _ravel_bucketed(leaves, lay)
            assert flat.numel() == lay.total_flat
            rows = torch.stack([_shard_slice(flat, lay, i)
                                for i in range(n)])
            assert torch.equal(_bucketed_from_rows(rows, lay), flat)
            for t, v in zip(leaves, _unravel_bucketed(flat, lay)):
                assert torch.equal(v.view(t.shape), t)


# -- the model contract ------------------------------------------------------


def tiny_resnet(tmp_path, **cfg):
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    config = ModelConfig(batch_size=16, n_epochs=2, learning_rate=0.05,
                         compute_dtype="float32", print_freq=0,
                         lr_schedule="step", lr_decay_epochs=(1,),
                         snapshot_dir=str(tmp_path), **cfg)
    data = ImageNet_data(crop=32, seed=0, synthetic_n=48, synthetic_pool=8,
                         synthetic_store=36, n_classes=10)
    data.n_val = 16
    return ResNet50(config=config, device="cpu", stage_sizes=(1, 1, 1, 1),
                    width=8, n_classes=10, crop=32, data=data)


def train_two_epochs(model) -> list[float]:
    """compile, one stacked dispatch in epoch 0, the schedule's LR, one
    in epoch 1; returns the losses."""
    from theanompi_tpu_torch.utils.recorder import Recorder

    model.compile_iter_fns("avg")
    rec = Recorder(rank=0, size=1, print_freq=0)
    assert model.begin_epoch(0) == 2          # 3 batches, stacks of 2
    assert model.train_iter(0, rec) == 2
    model._flush_metrics(rec)
    assert model.adjust_hyperp(1) == pytest.approx(0.005)
    assert all(g["lr"] == pytest.approx(0.005)
               for g in model.state.optimizer.param_groups)
    model.begin_epoch(1)
    model.train_iter(0, rec)
    model._flush_metrics(rec)
    val = model.val_epoch(rec)
    model.cleanup()
    assert np.isfinite(rec.train_losses).all() and np.isfinite(val["loss"])
    return rec.train_losses


def test_model_trains_with_zero_schedule_multi_and_snapshots(tmp_path):
    """``zero_sharding`` through ``compile_iter_fns``/``train_iter`` with
    ``steps_per_call=2`` and the LR schedule, bit-identical to the plain
    model at one process (the shard is the whole vector); the optimizer
    holds one per_shard tensor per slot; npz ``save`` -> ``load`` into a
    fresh ZeRO model gives the same parameters, which then train on."""
    zero = tiny_resnet(tmp_path / "z", zero_sharding=True, steps_per_call=2,
                       exchange_buckets=3)
    plain = tiny_resnet(tmp_path / "p", steps_per_call=2)
    losses = [train_two_epochs(m) for m in (zero, plain)]
    assert losses[0] == losses[1]
    for (n, a), b in zip(zero.module.state_dict().items(),
                         plain.module.state_dict().values()):
        assert torch.equal(a, b), n
    shard = zero.state.sharding
    assert [t.numel() for t in zero.state.optimizer.state[
        shard.shard].values()] == [shard.layout.per_shard]
    path = zero.save()
    fresh = tiny_resnet(tmp_path / "f", zero_sharding=True,
                        steps_per_call=2)
    fresh.load(path)
    for (n, a), b in zip(zero.module.named_parameters(),
                         fresh.module.parameters()):
        assert torch.equal(a, b), n
    assert np.isfinite(train_two_epochs(fresh)).all()


def test_zero_refusals_match_jax(tmp_path):
    """JAX's refusals, with its messages: LARS (not elementwise), the
    'params' exchange, the bf16 strategy spelling, ZeRO with FSDP, the
    two stacked cadences together, and the WGAN; the bf16 wire itself is
    taken."""
    from theanompi_tpu_torch.models.wasserstein_gan import Wasserstein_GAN

    for bad, msg in [
            (dict(optimizer="lars"), "ELEMENTWISE"),
            (dict(exchange_what="params"), "IS the gradient exchange"),
            (dict(exchange_strategy="nccl16"), "bf16-compressed"),
            (dict(fsdp_sharding=True), "meaningless"),
            (dict(steps_per_call=2, grad_accum_steps=2),
             "stacked-batch cadences")]:
        with pytest.raises(ValueError, match=msg):
            tiny_resnet(tmp_path, zero_sharding=True,
                        **bad).compile_iter_fns("avg")
    tiny_resnet(tmp_path, zero_sharding=True, exchange_dtype="bf16",
                exchange_error_feedback=True).compile_iter_fns("avg")
    import dataclasses

    for knob in ("zero_sharding", "fsdp_sharding"):
        cfg = dataclasses.replace(Wasserstein_GAN.default_config(),
                                  batch_size=4, **{knob: True})
        gan = Wasserstein_GAN(device="cpu", width=8, config=cfg)
        with pytest.raises(ValueError,
                           match=f"{knob} is not implemented for the"):
            gan.compile_iter_fns("avg")


# -- the launcher -------------------------------------------------------------

#: the launcher's --set for ZeRO: four buckets, the bf16 wire with error
#: feedback (its flat residual rides the checkpoints)
ZERO_SETS = ("zero_sharding=true", "exchange_buckets=4",
             "exchange_dtype=bf16", "exchange_error_feedback=true",
             "n_epochs=2")


def launch(tmp_path, runs: dict) -> dict:
    """``launcher BSP -D 2 --platform cpu`` on the EF tiny ResNet of
    tests/test_torch_resilience.py, the runs side by side: ``runs`` maps
    a name to (snapshot dir, --set list, extra arguments); returns per
    name (exit code, result or None, stderr)."""
    import json

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = {}
    try:
        for name, (snap, sets, extra) in runs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "theanompi_tpu_torch.launcher", "BSP",
                 "-D", "2", "--platform", "cpu", "-m",
                 "test_torch_resilience", "-c", "TinyResNetEF",
                 "--snapshot-dir", str(tmp_path / snap), "--result-json",
                 str(tmp_path / f"{name}.json"),
                 *[a for kv in sets for a in ("--set", kv)], *extra],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, cwd=REPO)
        out = {}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=240)
            path = tmp_path / f"{name}.json"
            out[name] = (proc.returncode, json.loads(path.read_text())
                         if proc.returncode == 0 and path.exists() else None,
                         err)
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def check_resume(tmp_path, sets, other=None) -> dict:
    """Unbroken beside a run stopped after epoch 0, then that run resumed
    (beside ``other``: a resume of a copy of its checkpoints under the
    --set list ``other``): the resumed run ends on the unbroken run's
    state and parameter digests, the ranks agreeing.  Returns every
    run's (exit code, result, stderr)."""
    import shutil

    runs = launch(tmp_path, {"unbroken": ("u", sets, ()),
                             "first": ("r", sets, ("--epochs", "1"))})
    for rc, _, err in runs.values():
        assert rc == 0, err[-3000:]
    unbroken, first = runs["unbroken"][1], runs["first"][1]
    assert len(set(unbroken["state_digests"])) == 1
    assert [r["train_steps"] for r in unbroken["records"]] == [4, 4]
    assert first["state_digests"] != unbroken["state_digests"]
    later = {"resumed": ("r", sets, ("--resume", "--epochs", "1"))}
    if other is not None:
        shutil.copytree(tmp_path / "r", tmp_path / "r-other")
        later["other"] = ("r-other", other, ("--resume",))
    runs.update(launch(tmp_path, later))
    rc, res, err = runs["resumed"]
    assert rc == 0, err[-3000:]
    restore = res["checkpoint"]["restore"]
    assert restore["epoch"] == 0
    assert restore["digest_restored"] == restore["digest_at_save"]
    assert res["state_digests"] == unbroken["state_digests"]
    assert res["param_digests"] == unbroken["param_digests"]
    return runs


def test_launcher_resume_and_a_resume_under_other_buckets(tmp_path):
    """Two gloo ranks under ZeRO (4 buckets, bf16 wire, error feedback):
    stopped and resumed ends equal to the unbroken run; the checkpoint
    holds the optimizer state and residual gathered into JAX's global
    flat vectors; resuming it under ``exchange_buckets=2`` exits
    non-zero on the layout's shape."""
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    other = [s for s in ZERO_SETS if not s.startswith("exchange_buckets")]
    runs = check_resume(tmp_path, ZERO_SETS, [*other, "exchange_buckets=2"])
    rc, _, err = runs["other"]
    assert rc != 0
    assert "ZeRO layout needs" in err, err[-3000:]
    ck = Checkpointer(str(tmp_path / "r" / "resnet50"), read_only=True)
    payload = ck.restore(0)
    ck.close()
    (momentum,) = payload["opt_state"]["state"][0].values()
    residual = payload["exchange_residual"]
    assert residual.shape[0] == 2 and residual.dim() == 2
    assert momentum.dim() == 1 and momentum.numel() % 2 == 0
    assert not torch.equal(residual[0], residual[1])


def _seq_rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """The ZeRO-over-seq ranks: plain SP and ZeRO SP, two steps each."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_lm_ranks import init_ranks, save_rank, train_port
    from theanompi_tpu_torch.models.transformer import TransformerLM

    init_ranks(rank, world, port)
    try:
        whole = torch.load(os.path.join(workdir, "weights.pt"))
        out = {}
        for zero in (False, True):
            out[zero], model = train_port(TransformerLM, dict(data=2, seq=2),
                                          whole, steps=2, zero_sharding=zero)
        shard = model.state.sharding
        (mom,) = [v for v in model.state.optimizer.state[shard.shard]
                  .values() if torch.is_tensor(v) and v.dim() == 1]
        out["momentum"] = mom.numpy().copy()
        out["layout"] = (shard.n, shard.layout.per_shard,
                         sum(p.numel() for p in model.module.parameters()))
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def seq_ranks(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_lm_ranks import jax_model, jax_tree, load_ranks
    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.models.transformer import TransformerLM as JaxLM
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )

    tmp = tmp_path_factory.mktemp("zero_seq")
    torch.save(transformer_state_dict_from_flax(jax_tree(jax_model(
        JaxLM, dict(data=2, seq=2), 4))), tmp / "weights.pt")
    spawn_ranks(os.path.abspath(__file__), tmp, world=4, extra=("seq",),
                timeout=240)
    return load_ranks(tmp, 4)


def test_zero_composes_with_sequence_parallel(seq_ranks):
    from _torch_lm_ranks import (
        assert_params_close,
        jax_model,
        train_jax,
    )
    from theanompi_tpu.models.transformer import TransformerLM as JaxLM

    want = train_jax(jax_model(JaxLM, dict(data=2, seq=2), 4,
                               zero_sharding=True), steps=2)
    for o in seq_ranks:
        np.testing.assert_allclose(o[True]["losses"], o[False]["losses"],
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(o[True]["losses"], want["losses"],
                                   rtol=2e-5, atol=1e-6)
        assert_params_close(o[True]["params"], o[False]["params"])
    # rank r sits at (data r // 2, seq r % 2): the shard is data's
    n, per_shard, total = seq_ranks[0]["layout"]
    assert n == 2 and per_shard == -(-total // 2)
    for r in (0, 2):
        np.testing.assert_array_equal(seq_ranks[r]["momentum"],
                                      seq_ranks[r + 1]["momentum"])
    assert not np.array_equal(seq_ranks[0]["momentum"],
                              seq_ranks[2]["momentum"])


def test_fsdp_and_error_feedback_over_seq_refused_as_jax():
    """JAX composes neither with a (data x seq) reduce: FSDP is the
    pure-DP path, and the error-feedback residual is per data shard."""
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.transformer import TransformerLM

    kw = dict(device="cpu", data=SeqLM_data(vocab=32, seq_len=16,
                                            n_train=16, n_val=8),
              vocab=32, seq_len=16, d_model=32)
    m = TransformerLM(config=ModelConfig(fsdp_sharding=True), **kw)
    with pytest.raises(ValueError, match="fsdp_sharding is the pure-DP "
                       "parameter-sharding path .* this model reduces "
                       "over \\('data', 'seq'\\)"):
        m.compile_iter_fns()
    m = TransformerLM(config=ModelConfig(exchange_dtype="bf16",
                                         exchange_error_feedback=True), **kw)
    with pytest.raises(ValueError, match="exchange_error_feedback keeps one "
                                         "residual per DATA shard"):
        m.compile_iter_fns()


if __name__ == "__main__":
    main = _seq_rank_main if sys.argv[5:] == ["seq"] else _rank_main
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
