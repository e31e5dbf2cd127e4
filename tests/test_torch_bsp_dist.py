"""Two-rank BSP on the CPU (gloo, spawned processes) against the JAX BSP
step on a 2-device data mesh, at the same global batch.

Both start from the same weights (drawn with numpy, carried across by
the bridge) and take two SGD steps (LR 0.002, momentum 0.9, weight
decay 1e-3) on the same two global batches of 16 images of 64x64; rank
r of the port takes rows ``[8r, 8r + 8)`` of each, as shard r of the
JAX mesh does.  The LR and sizes keep the tiny net well conditioned: at
LR 0.05 on 4 images of 32x32 per rank, its BN statistics over a handful
of values amplify the 1e-5 rounding differences of the first step to
1e-1 in the second's gradients, and at LR 0.01 on these sizes to 1.7e-4
of the largest weight (measured), in either framework.  After the
steps, the parameters and the BN running statistics (averaged over the
ranks in both) must agree, and the two ranks must hold identical
copies.  Tolerance as the one-step check of test_torch_train.py (f32,
sums in different orders): ``rtol=1e-4``, floor ``1e-4 * max|want|``.

The other exchange modes run in one more spawn of two ranks, each from
the same weights over the same two steps: the bf16 wire, the bf16 wire
with error feedback, parameter averaging (``exchange_what='params'``),
three buckets overlapped with the backward, and gradient accumulation
(the two global batches as two microbatches of one update).  Each is
held against JAX's 2-device step in the same mode (JAX's
``make_bsp_accum_step`` for accumulation) at the tolerance above,
except the buckets: JAX's bucketed step is not bit-identical to its own
one-bucket step (its bucket pins are red, ROADMAP.md section C), so the
port's three buckets are held against JAX's one-bucket f32 step at the
tolerance above and against the port's one bucket bit for bit.  A
parameter the forward never uses must not hang the overlapped step (its
bucket goes out after the backward; the spawn runs under a timeout),
and leaves the same result as one bucket; so does, with error feedback,
one that rank 0 uses only in the first step (its zero gradient and
residual go on the wire, JAX's rule).  The rank program records how
many buckets the hooks started while each backward ran.  Where the bf16
wire rounds, the two frameworks' f32 gradients (measured 1e-5 of each
tensor's largest element apart) round to neighbouring bf16 values in 1-3%
of the elements: the bf16 modes' absolute floor adds what one bf16 ulp of
each rank's gradient at each step moves a parameter by (at most
``LR * (2 + momentum) * 2^-7 * max|g|``, ``max|g|`` that tensor's
largest local gradient over the ranks and steps).

The file is also the rank program: ``python test_torch_bsp_dist.py
RANK WORLD PORT DIR [modes]``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

TINY = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=10)
OPT = dict(momentum=0.9, nesterov=False, weight_decay=1e-3)
LR, STEPS, GLOBAL_BATCH, HW = 0.002, 2, 16, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: the other modes (name -> port ModelConfig-like knobs); "unused-*" add
#: a parameter the forward never uses, "ef-unused-*" one that both ranks
#: use in step 0 and only rank 1 uses in step 1
MODES = {
    "f32-b1": dict(),
    "bf16": dict(exchange_dtype="bf16"),
    "ef": dict(exchange_dtype="bf16", error_feedback=True),
    "params": dict(exchange_what="params"),
    "f32-b3": dict(exchange_buckets=3),
    "accum": dict(),
    "unused-b1": dict(),
    "unused-b3": dict(exchange_buckets=3),
    "ef-unused-b1": dict(exchange_dtype="bf16", error_feedback=True),
    "ef-unused-b3": dict(exchange_dtype="bf16", error_feedback=True,
                         exchange_buckets=3),
}


def _modes_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank running every mode of ``MODES`` from the same weights."""
    import torch.distributed as dist

    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        init_exchange_residual,
        make_bsp_accum_step,
        make_bsp_train_step,
    )
    from theanompi_tpu_torch.parallel.exchanger import (
        BSP_Exchanger,
        BucketedBackward,
    )
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    # what the hooks launched while the backward ran: per overlapped
    # step, (buckets started, buckets planned, collectives in flight)
    # when finish() begins
    hooks: list = []
    finish = BucketedBackward.finish

    def recording_finish(self):
        hooks.append((self._next, len(self.buckets), len(self._pending)))
        finish(self)

    BucketedBackward.finish = recording_finish
    try:
        data = np.load(os.path.join(workdir, "batches.npz"))
        per = GLOBAL_BATCH // world
        rows = slice(rank * per, (rank + 1) * per)
        batches = [(torch.from_numpy(data[f"x{i}"][rows]),
                    torch.from_numpy(data[f"y{i}"][rows]))
                   for i in range(STEPS)]
        calls = [0]

        def loss_fn(mod, batch, rng):
            x, y = batch
            logits = mod(x, train=True)
            loss = L.softmax_cross_entropy(logits, y)
            if hasattr(mod, "extra") and (calls[0] == 0 or rank == 1):
                loss = loss + 0.01 * (mod.extra * x.reshape(-1)[:5]).sum()
            calls[0] += 1
            return loss, {"error": L.error_rate(logits.detach(), y)}

        out = {}
        for mode, kw in MODES.items():
            module = ResNet(**TINY, dtype=torch.float32)
            module.load_state_dict(torch.load(os.path.join(workdir,
                                                           "init.pt")))
            if mode.startswith("unused"):
                module.unused = torch.nn.Parameter(torch.ones(3))
            if mode.startswith("ef-unused"):
                module.extra = torch.nn.Parameter(torch.ones(5))
            module.train()
            calls[0] = 0
            hooks.clear()
            ex = BSP_Exchanger("psum", avg=True, **kw)
            state = TrainState(module, build_optimizer(
                module.parameters(), LR, "sgd", **OPT),
                exchange_residual=(init_exchange_residual(module)
                                   if ex.error_feedback else None))
            # the largest |local gradient| per parameter over the steps
            # (before the exchange), for the bf16 wire's tolerance
            gmax: dict = {}
            for name, p in module.named_parameters():
                p.register_post_accumulate_grad_hook(
                    lambda q, n=name: gmax.__setitem__(n, max(
                        gmax.get(n, 0.0), float(q.grad.abs().max()))))
            residuals = []
            if mode == "accum":
                make_bsp_accum_step(loss_fn, ex)(state, batches, None)
            else:
                step = make_bsp_train_step(loss_fn, ex)
                for b in batches:
                    step(state, b, None)
                    if ex.error_feedback:
                        residuals.append([r.clone() for r in
                                          state.exchange_residual])
            out[mode] = {"state": module.state_dict(),
                         "residual": state.exchange_residual,
                         "residuals": residuals, "hooks": list(hooks),
                         "step": state.step, "gmax": gmax}
        torch.save(out, os.path.join(workdir, f"modes{rank}.pt"))
    finally:
        BucketedBackward.finish = finish
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the port's BSP step."""
    import torch.distributed as dist

    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        make_bsp_train_step,
    )
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        module = ResNet(**TINY, dtype=torch.float32)
        module.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
        module.train()
        state = TrainState(module, build_optimizer(module.parameters(), LR,
                                                   "sgd", **OPT))

        def loss_fn(mod, batch, rng):
            x, y = batch
            logits = mod(x, train=True)
            loss = L.softmax_cross_entropy(logits, y)
            return loss, {"error": L.error_rate(logits.detach(), y)}

        step = make_bsp_train_step(loss_fn, BSP_Exchanger("psum", avg=True))
        data = np.load(os.path.join(workdir, "batches.npz"))
        per = GLOBAL_BATCH // world
        rows = slice(rank * per, (rank + 1) * per)
        for i in range(STEPS):
            metrics = step(state, (torch.from_numpy(data[f"x{i}"][rows]),
                                   torch.from_numpy(data[f"y{i}"][rows])),
                           None)
        torch.save({"state": module.state_dict(),
                    "loss": float(metrics["loss"])},
                   os.path.join(workdir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_bsp_matches_jax_data_mesh(tmp_path, mesh8):
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models import layers as JL
    from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
    from theanompi_tpu.parallel.bsp import TrainState as JaxState
    from theanompi_tpu.parallel.bsp import make_bsp_train_step
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu.parallel.mesh import data_mesh, replicate, shard_batch
    from theanompi_tpu.utils.helper_funcs import build_optimizer
    from theanompi_tpu_torch.models.bridge import (
        batch_stats_from_flax,
        params_from_flax,
        state_dict_from_flax,
    )
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from test_torch_train import assert_close, random_variables

    jmod = JaxResNet(**TINY, dtype=jnp.float32, bn_act_impl="pallas",
                     pool_impl="pallas")
    variables = random_variables(jmod, seed=31, hw=HW)
    rng = np.random.default_rng(8)
    batches = {}
    for i in range(STEPS):
        batches[f"x{i}"] = rng.standard_normal(
            (GLOBAL_BATCH, HW, HW, 3)).astype(np.float32)
        batches[f"y{i}"] = rng.integers(0, 10, GLOBAL_BATCH).astype(np.int32)
    np.savez(tmp_path / "batches.npz", **batches)
    module = ResNet(**TINY, dtype=torch.float32)
    torch.save(state_dict_from_flax(module, variables["params"],
                                    variables["batch_stats"]),
               tmp_path / "init.pt")

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        # the JAX step on a 2-device data mesh while the ranks run
        def loss_fn(params, model_state, batch, rng_):
            x, y = batch
            logits, upd = jmod.apply({"params": params, **model_state}, x,
                                     train=True, mutable=["batch_stats"])
            loss = JL.softmax_cross_entropy(logits, y)
            return loss, ({**model_state, **upd},
                          {"error": JL.error_rate(logits, y)})

        mesh = data_mesh(2, mesh8.devices.ravel()[:2])
        tx = build_optimizer(LR, "sgd", **OPT)
        state = replicate(JaxState.create(
            variables["params"], tx,
            {"batch_stats": variables["batch_stats"]}), mesh)
        step = make_bsp_train_step(loss_fn, tx, mesh,
                                   BSP_Exchanger("psum", avg=True))
        for i in range(STEPS):
            state, metrics = step(state, shard_batch(
                (jnp.asarray(batches[f"x{i}"]),
                 jnp.asarray(batches[f"y{i}"])), mesh), jax.random.key(0))

        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out
        outs = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]
        for k, v in outs[0]["state"].items():        # replicas stay identical
            assert torch.equal(v, outs[1]["state"][k]), k
        got = outs[0]["state"]
        assert_close(outs[0]["loss"], metrics["loss"], msg="loss")
        want = params_from_flax(module, jax.tree.map(np.asarray,
                                                     state.params))
        want.update(batch_stats_from_flax(module, jax.tree.map(
            np.asarray, state.model_state["batch_stats"])))
        assert set(want) == set(got)
        for name, w in want.items():
            assert_close(got[name].numpy(), w.numpy(), floor=1e-4, msg=name)
    finally:
        # a rank that hangs, or a failure above, must not outlive the
        # test (communicate's timeout does not end the process)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


# -- the other exchange modes and accumulation -------------------------------


def _inputs(tmp_path):
    """The seeded weights (numpy, the JAX tree) and the two global
    batches, written where the ranks read them."""
    import jax.numpy as jnp

    from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from test_torch_train import random_variables

    jmod = JaxResNet(**TINY, dtype=jnp.float32, bn_act_impl="pallas",
                     pool_impl="pallas")
    variables = random_variables(jmod, seed=31, hw=HW)
    rng = np.random.default_rng(8)
    batches = {}
    for i in range(STEPS):
        batches[f"x{i}"] = rng.standard_normal(
            (GLOBAL_BATCH, HW, HW, 3)).astype(np.float32)
        batches[f"y{i}"] = rng.integers(0, 10, GLOBAL_BATCH).astype(np.int32)
    np.savez(tmp_path / "batches.npz", **batches)
    module = ResNet(**TINY, dtype=torch.float32)
    torch.save(state_dict_from_flax(module, variables["params"],
                                    variables["batch_stats"]),
               tmp_path / "init.pt")
    return jmod, variables, batches


@pytest.fixture(scope="module")
def modes_run(tmp_path_factory):
    """Every mode of ``MODES`` on two gloo ranks: one spawn."""
    from test_torch_exchange import spawn_ranks

    tmp = tmp_path_factory.mktemp("bsp_modes")
    jmod, variables, batches = _inputs(tmp)
    spawn_ranks(os.path.abspath(__file__), tmp, extra=("modes",),
                timeout=240)
    ranks = [torch.load(tmp / f"modes{r}.pt") for r in range(2)]
    return jmod, variables, batches, ranks


def _jax_mode(jmod, variables, batches, mesh8, mode: str):
    """JAX's 2-device step in ``mode`` (``MODES``) after the two steps:
    the port's state-dict names -> numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.models import layers as JL
    from theanompi_tpu.parallel.bsp import TrainState as JaxState
    from theanompi_tpu.parallel.bsp import (
        init_exchange_residual,
        make_bsp_accum_step,
        make_bsp_train_step,
    )
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu.parallel.mesh import data_mesh, replicate, shard_batch
    from theanompi_tpu.utils.helper_funcs import build_optimizer
    from theanompi_tpu_torch.models.bridge import (
        batch_stats_from_flax,
        params_from_flax,
    )
    from theanompi_tpu_torch.models.resnet50 import ResNet

    def loss_fn(params, model_state, batch, rng_):
        x, y = batch
        logits, upd = jmod.apply({"params": params, **model_state}, x,
                                 train=True, mutable=["batch_stats"])
        loss = JL.softmax_cross_entropy(logits, y)
        return loss, ({**model_state, **upd},
                      {"error": JL.error_rate(logits, y)})

    mesh = data_mesh(2, mesh8.devices.ravel()[:2])
    tx = build_optimizer(LR, "sgd", **OPT)
    state = replicate(JaxState.create(
        variables["params"], tx,
        {"batch_stats": variables["batch_stats"]}), mesh)
    kw = {k: v for k, v in MODES[mode].items() if k != "exchange_buckets"}
    ex = BSP_Exchanger("psum", avg=True, **kw)
    if ex.error_feedback:
        sh = NamedSharding(mesh, P("data"))
        state = state.replace(exchange_residual=jax.tree.map(
            lambda x: jax.device_put(x, sh),
            init_exchange_residual(variables["params"], 2)))
    xs = [(jnp.asarray(batches[f"x{i}"]), jnp.asarray(batches[f"y{i}"]))
          for i in range(STEPS)]
    if mode == "accum":
        # each rank's block of both global batches, stacked (a, ...)
        stacked = jax.tree.map(lambda *t: jnp.stack(t), *xs)
        sharded = jax.device_put(stacked, NamedSharding(
            mesh, P(None, "data")))
        step = make_bsp_accum_step(loss_fn, tx, mesh, ex)
        state, _ = step(state, sharded, jax.random.key(0))
    else:
        step = make_bsp_train_step(loss_fn, tx, mesh, ex)
        for x in xs:
            state, _ = step(state, shard_batch(x, mesh), jax.random.key(0))
    module = ResNet(**TINY, dtype=torch.float32)
    want = params_from_flax(module, jax.tree.map(np.asarray, state.params))
    want.update(batch_stats_from_flax(module, jax.tree.map(
        np.asarray, state.model_state["batch_stats"])))
    return want


@pytest.mark.parametrize("mode", ["bf16", "ef", "params", "f32-b3",
                                  "accum"])
def test_two_rank_modes_match_jax_data_mesh(modes_run, mesh8, mode):
    from test_torch_train import assert_close

    jmod, variables, batches, ranks = modes_run
    for k, v in ranks[0][mode]["state"].items():  # replicas stay identical
        assert torch.equal(v, ranks[1][mode]["state"][k]), k
    assert ranks[0][mode]["step"] == (1 if mode == "accum" else STEPS)
    want = _jax_mode(jmod, variables, batches, mesh8,
                     "f32-b1" if mode == "f32-b3" else mode)
    got = ranks[0][mode]["state"]
    assert set(want) == set(got)
    for name, w in want.items():
        floor = 1e-4
        if MODES[mode].get("exchange_dtype") == "bf16":
            # a gradient element near a bf16 rounding midpoint may round
            # to the neighbouring value on one side: one bf16 ulp (at
            # most 2^-7 of it) on either rank moves the average by at
            # most 2^-7 of the larger |g|, and a parameter by LR times
            # that, (1 + momentum) times for step 0's gradient
            g = max(r[mode]["gmax"].get(name, 0.0) for r in ranks)
            scale = float(np.abs(w.numpy()).max())
            floor += LR * (2 + OPT["momentum"]) * 2.0 ** -7 * g / scale
        assert_close(got[name].numpy(), w.numpy(), floor=floor,
                     msg=f"{mode} {name}")


def test_error_feedback_residual_is_per_rank(modes_run):
    """Each rank keeps its own residual: f32, one per parameter, below
    one bf16 quantization step of its gradient, and the two ranks'
    differ (their batches do)."""
    ranks = modes_run[3]
    res = [ranks[r]["ef"]["residual"] for r in range(2)]
    names = list(ranks[0]["ef"]["state"])
    assert len(res[0]) == len(res[1]) > 0
    assert all(r.dtype == torch.float32 for r in res[0])
    assert any(not torch.equal(a, b) for a, b in zip(*res))
    assert any(r.abs().max() > 0 for r in res[0]), names


@pytest.mark.parametrize("pair", [("f32-b3", "f32-b1"),
                                  ("unused-b3", "unused-b1"),
                                  ("ef-unused-b3", "ef-unused-b1")])
def test_overlapped_buckets_bit_identical_to_one_bucket(modes_run, pair):
    """Three buckets launched from the backward's hooks leave the state
    (and the error-feedback residual) of one post-backward bucket, bit
    for bit, and the two ranks stay identical.  With a parameter the
    forward never uses, the step still ends (the spawn's timeout) and
    that parameter moves as SGD moves it on a zero gradient (weight
    decay and momentum; JAX's rule).  The hooks launch each bucket while
    the backward runs once all its parameters have their gradients: all
    three, or the first two when the one parameter the backward does not
    reach (registered first, so in the last bucket) is left out."""
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    ranks = modes_run[3]
    for r in range(2):
        got, want = (ranks[r][m]["state"] for m in pair)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (pair, r, k)
            assert torch.equal(got[k], ranks[1 - r][pair[0]]["state"][k])
        for a, b in zip(*(ranks[r][m]["residuals"] for m in pair)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (pair, r)
    for r in range(2):
        assert ranks[r][pair[1]]["hooks"] == []
        # buckets the hooks started in each step's backward
        started = {"f32-b3": [3, 3], "unused-b3": [2, 2],
                   "ef-unused-b3": [3, 2 if r == 0 else 3]}[pair[0]]
        hooks = ranks[r][pair[0]]["hooks"]
        assert [n for n, _, _ in hooks] == started, (r, hooks)
        assert all(planned == 3 and live >= n > 0
                   for n, planned, live in hooks), (r, hooks)
    if pair[0] == "unused-b3":
        twin = torch.nn.Parameter(torch.ones(3))
        opt = build_optimizer([twin], LR, "sgd", **OPT)
        for _ in range(STEPS):
            twin.grad = torch.zeros(3)
            opt.step()
        for m in pair:
            assert torch.equal(ranks[0][m]["state"]["unused"], twin.detach())


def test_error_feedback_zero_gradient_keeps_its_residual(modes_run):
    """A parameter that rank 0 does not use in step 1 goes on the wire
    with a zero gradient, so rank 0's residual of it becomes ``r -
    bf16(r)`` of its step-0 residual (the bf16 part is sent, as in JAX),
    at one bucket and at three; rank 1, which used it, differs."""
    ranks = modes_run[3]
    assert next(iter(ranks[0]["ef-unused-b1"]["state"])) == "extra"
    for mode in ("ef-unused-b1", "ef-unused-b3"):
        r0, r1 = ranks[0][mode]["residuals"]        # ``extra`` is first
        assert r0[0].shape == (5,) and r0[0].abs().max() > 0, mode
        assert torch.equal(r1[0], r0[0] - r0[0].bfloat16().float()), mode
        assert not torch.equal(ranks[1][mode]["residuals"][1][0], r1[0])


if __name__ == "__main__":
    if sys.argv[5:] == ["modes"]:
        _modes_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                    sys.argv[4])
    else:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4])
