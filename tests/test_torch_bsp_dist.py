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

The file is also the rank program: ``python test_torch_bsp_dist.py
RANK WORLD PORT DIR``.
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


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
