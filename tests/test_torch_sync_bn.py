"""``sync_bn`` on the CPU: two gloo ranks (spawned processes) against the
JAX BSP step on a 2-device data mesh with its BNs' ``bn_axis='data'``.

Each BN family takes two SGD steps (LR 0.002, momentum 0.9, weight decay
1e-3) from the same weights (drawn with numpy, carried across by the
bridges) on the same two global batches of 16 rows; rank r of the port
takes rows ``[8r, 8r + 8)``, as shard r of the JAX mesh does (rank 1's
rows drawn from N(0.5, 2^2), rank 0's from N(0, 1)).  The
families: a tiny ResNet (width 8, stages (1, 1, 1, 1), 64 pixels), VGG
with BN (blocks ((1, 8), (1, 16)), 32 pixels), GoogLeNet with BN (width
1/8, 80 pixels, both aux heads in the loss) and AlexNet with BN (67
pixels); dropout is the identity on both sides.  After the steps the
parameters and the BN running statistics must agree with JAX's
(``rtol=1e-4``, floor ``1e-4 * max|want|``, the tolerance of
test_torch_bsp_dist.py: f32, sums in different orders; GoogLeNet's 22
normalized layers are held in relative L2 instead, 2e-3 (2.5e-4
measured), as test_torch_zoo.py holds its BN step, where a relu mask
may flip under another order of sums), and the two ranks must hold
identical copies.

That the knob reached the layers: the ResNet's ranks with ``sync_bn``
end with the running statistics of one process stepping on the whole
global batch (the same tolerance), and without it with different ones
(by more than 1e-2 of the largest statistic).  The ResNet also runs
with three buckets overlapped with the backward under the spawn's
timeout (the statistics' all-reduce is issued inside the backward
beside the buckets' hooks, on the same group) and ends bit-identical to
its one-bucket run.  And on one process without a process group a
``sync_bn`` step is bit for bit the per-shard step.

The file is also the rank program: ``python test_torch_sync_bn.py RANK
WORLD PORT DIR``.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

LR, STEPS, GLOBAL_BATCH, CLASSES = 0.002, 2, 16, 10
OPT = dict(momentum=0.9, nesterov=False, weight_decay=1e-3)
TINY_BLOCKS = ((1, 8), (1, 16))
#: family -> input pixels
FAMILIES = {"resnet": 64, "vgg": 32, "googlenet": 80, "alexnet": 67}
#: the port's runs in the rank program: (label, family, sync, buckets)
RUNS = (("resnet-b3", "resnet", True, 3),
        *((f"{f}{tag}", f, sync, 1) for f in FAMILIES
          for tag, sync in (("", True), ("-per-shard", False))))


def port_module(family: str, sync: bool):
    from theanompi_tpu_torch.models.alex_net import AlexNetCNN
    from theanompi_tpu_torch.models.googlenet import GoogLeNetCNN
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from theanompi_tpu_torch.models.vgg16 import VGGCNN

    if family == "resnet":
        return ResNet((1, 1, 1, 1), 8, CLASSES, sync_bn=sync)
    if family == "vgg":
        return VGGCNN(TINY_BLOCKS, CLASSES, crop=32, batch_norm=True,
                      sync_bn=sync)
    if family == "googlenet":
        return GoogLeNetCNN(CLASSES, crop=80, width_mult=0.125,
                            batch_norm=True, sync_bn=sync)
    return AlexNetCNN(CLASSES, crop=67, batch_norm=True, sync_bn=sync)


def port_loss_fn():
    """The port's ``TorchModel.loss_fn`` (aux heads included) on batches
    that need no device transform."""
    from theanompi_tpu_torch.models.base import TorchModel

    me = SimpleNamespace(data=SimpleNamespace(), config=SimpleNamespace(
        label_smoothing=0.0, track_top5=False))
    return lambda module, batch, rng: TorchModel.loss_fn(me, module, batch,
                                                         rng)


def no_port_dropout():
    from theanompi_tpu_torch.models import layers as L

    L.Dropout.forward = lambda self, x, train, rng=None: x


def run_port(module, batches, buckets: int = 1):
    """Two SGD steps of the port's BSP step on this process's batches;
    the module's state dict after."""
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        make_bsp_train_step,
    )
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    module.train()
    state = TrainState(module, build_optimizer(module.parameters(), LR,
                                               "sgd", **OPT))
    step = make_bsp_train_step(port_loss_fn(), BSP_Exchanger(
        "psum", avg=True, exchange_buckets=buckets))
    for b in batches:
        step(state, b, None)
    return {k: v.clone() for k, v in module.state_dict().items()}


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    no_port_dropout()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        per = GLOBAL_BATCH // world
        rows = slice(rank * per, (rank + 1) * per)
        out = {}
        for label, family, sync, buckets in RUNS:
            data = np.load(os.path.join(workdir, f"{family}.npz"))
            batches = [(torch.from_numpy(data[f"x{i}"][rows]),
                        torch.from_numpy(data[f"y{i}"][rows]))
                       for i in range(STEPS)]
            module = port_module(family, sync)
            module.load_state_dict(torch.load(
                os.path.join(workdir, f"{family}.pt")))
            out[label] = run_port(module, batches, buckets)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the test process ---------------------------------------------------------


def _jax_module(family: str, bn_axis):
    import jax.numpy as jnp

    from theanompi_tpu.models.alex_net import AlexNetCNN
    from theanompi_tpu.models.googlenet import GoogLeNetCNN
    from theanompi_tpu.models.resnet50 import ResNet
    from theanompi_tpu.models.vgg16 import VGGCNN

    if family == "resnet":
        return ResNet(stage_sizes=(1, 1, 1, 1), width=8, n_classes=CLASSES,
                      dtype=jnp.float32, bn_axis=bn_axis)
    if family == "vgg":
        return VGGCNN(blocks=TINY_BLOCKS, n_classes=CLASSES, batch_norm=True,
                      bn_axis=bn_axis)
    if family == "googlenet":
        return GoogLeNetCNN(n_classes=CLASSES, width_mult=0.125,
                            batch_norm=True, bn_axis=bn_axis)
    return AlexNetCNN(n_classes=CLASSES, batch_norm=True, bn_axis=bn_axis)


def _bridge(family: str, module, params=None, batch_stats=None) -> dict:
    from theanompi_tpu_torch.models.bridge import (
        batch_stats_from_flax,
        params_from_flax,
        zoo_state_dict_from_flax,
    )

    if family != "resnet":
        return zoo_state_dict_from_flax(module, params, batch_stats)
    out = {}
    if params is not None:
        out.update(params_from_flax(module, params))
    if batch_stats is not None:
        out.update(batch_stats_from_flax(module, batch_stats))
    return out


def _jax_steps(family, variables, batches, mesh):
    """JAX's two sync_bn SGD steps on the 2-device mesh: the port's
    state-dict names -> tensors."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models.base import TpuModel
    from theanompi_tpu.parallel.bsp import TrainState as JaxState
    from theanompi_tpu.parallel.bsp import make_bsp_train_step
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu.parallel.mesh import replicate, shard_batch
    from theanompi_tpu.utils.helper_funcs import build_optimizer

    me = SimpleNamespace(module=_jax_module(family, "data"),
                         data=SimpleNamespace(), config=SimpleNamespace(
                             label_smoothing=0.0, track_top5=False))

    def loss_fn(params, model_state, batch, rng):
        return TpuModel.loss_fn(me, params, model_state, batch, rng)

    tx = build_optimizer(LR, "sgd", **OPT)
    state = replicate(JaxState.create(
        variables["params"], tx,
        {"batch_stats": variables["batch_stats"]}), mesh)
    step = make_bsp_train_step(loss_fn, tx, mesh,
                               BSP_Exchanger("psum", avg=True))
    for x, y in batches:
        state, _ = step(state, shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                           mesh), jax.random.key(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return _bridge(family, port_module(family, False),
                   to_np(state.params),
                   to_np(state.model_state["batch_stats"]))


def _rows(rng, hw: int) -> np.ndarray:
    """A global batch whose second half (rank 1's rows) is drawn from
    N(0.5, 2^2) and first half from N(0, 1), so that per-shard and
    global statistics differ plainly."""
    x = rng.standard_normal((GLOBAL_BATCH, hw, hw, 3)).astype(np.float32)
    x[GLOBAL_BATCH // 2:] = 2.0 * x[GLOBAL_BATCH // 2:] + 0.5
    return x


@pytest.fixture(scope="module")
def synced(tmp_path_factory, devices8):
    """Every run of ``RUNS`` on two gloo ranks (one spawn) beside JAX's
    two-device sync_bn steps, each from the same weights and batches."""
    from test_torch_exchange import spawn_ranks
    from test_torch_zoo import jax_variables
    from theanompi_tpu.models import layers as JL
    from theanompi_tpu.parallel.mesh import data_mesh

    tmp = tmp_path_factory.mktemp("sync_bn")
    inputs = {}
    for k, (family, hw) in enumerate(FAMILIES.items()):
        variables = jax_variables(_jax_module(family, None),
                                  (2, hw, hw, 3), seed=40 + k)
        rng = np.random.default_rng(50 + k)
        batches = [(_rows(rng, hw),
                    rng.integers(0, CLASSES, GLOBAL_BATCH).astype(np.int32))
                   for _ in range(STEPS)]
        np.savez(tmp / f"{family}.npz",
                 **{f"{n}{i}": a for i, b in enumerate(batches)
                    for n, a in zip("xy", b)})
        torch.save(_bridge(family, port_module(family, False),
                           variables["params"], variables["batch_stats"]),
                   tmp / f"{family}.pt")
        inputs[family] = (variables, batches)
    spawn_ranks(os.path.abspath(__file__), tmp, timeout=300)
    ranks = [torch.load(tmp / f"out{r}.pt") for r in range(2)]
    mesh = data_mesh(2, np.asarray(devices8)[:2])
    saved = JL.Dropout.__call__
    JL.Dropout.__call__ = lambda self, x, train: x
    try:
        want = {f: _jax_steps(f, *inputs[f], mesh) for f in FAMILIES}
    finally:
        JL.Dropout.__call__ = saved
    return ranks, want, inputs


def _stats_gap(got: dict, want: dict) -> float:
    """The largest difference of a running statistic, relative to that
    statistic's largest value."""
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
               for k in want if k.endswith((".mean", ".var")))


def _assert_state(got: dict, want: dict, family: str) -> None:
    from test_torch_train import assert_close

    assert set(got) == set(want), family
    if family == "googlenet":
        names = sorted(want)
        g = np.concatenate([got[n].numpy().ravel() for n in names])
        w = np.concatenate([want[n].numpy().ravel() for n in names])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 2e-3, rel
        return
    for name, w in want.items():
        assert_close(got[name].numpy(), w.numpy(), floor=1e-4,
                     msg=f"{family} {name}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_rank_sync_bn_matches_jax(synced, family):
    """The port's sync_bn ranks end where JAX's sync_bn mesh does; its
    per-shard ranks do not (their running statistics are off by more
    than 1e-2 of each statistic's largest value; 0.076-0.27 measured):
    the knob reached every BN of the family."""
    ranks, want, _ = synced
    for k, v in ranks[0][family].items():          # replicas stay identical
        assert torch.equal(v, ranks[1][family][k]), (family, k)
    _assert_state(ranks[0][family], want[family], family)
    assert _stats_gap(ranks[0][f"{family}-per-shard"], want[family]) > 1e-2


def test_sync_bn_statistics_are_the_global_batch(synced):
    """The ranks' running statistics with sync_bn are one process's on
    the whole global batch; per-shard ones differ."""
    from test_torch_train import assert_close

    ranks, _, inputs = synced
    variables, batches = inputs["resnet"]
    module = port_module("resnet", False)
    module.load_state_dict(_bridge("resnet", module, variables["params"],
                                   variables["batch_stats"]))
    whole = run_port(module, [(torch.from_numpy(x), torch.from_numpy(y))
                              for x, y in batches])
    stats = [k for k in whole if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 17                    # every BN of the net
    sync, per_shard = ranks[0]["resnet"], ranks[0]["resnet-per-shard"]
    for k in stats:
        assert_close(sync[k].numpy(), whole[k].numpy(), floor=1e-4, msg=k)
    assert _stats_gap(per_shard, whole) > 1e-2


def test_sync_bn_with_three_buckets_is_bit_identical(synced):
    ranks = synced[0]
    for r in range(2):
        one, three = ranks[r]["resnet"], ranks[r]["resnet-b3"]
        for k in one:
            assert torch.equal(one[k], three[k]), (r, k)


def test_one_process_sync_bn_is_bit_identical_to_per_shard():
    """Without a process group the world is this process, whose mean is
    its own statistics: two steps with sync_bn end bit for bit where two
    without it do (the stacking and its backward add nothing)."""
    rng = np.random.default_rng(3)
    batches = [(torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(
                    np.float32)),
                torch.from_numpy(rng.integers(0, CLASSES, 8)))
               for _ in range(STEPS)]
    torch.manual_seed(0)
    init = port_module("resnet", False)
    for p in init.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    out = []
    for sync in (False, True):
        module = port_module("resnet", sync)
        module.load_state_dict(init.state_dict())
        out.append(run_port(module, batches))
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


@pytest.mark.parametrize("sync_bn", [False, True])
def test_small_shard_warning_only_without_sync_bn(tmp_path, sync_bn):
    """JAX's rule: a per-rank batch under 16 on a BN network warns at
    compile only when sync_bn is off (the global batch's statistics are
    not noisy)."""
    import warnings

    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    model = ResNet50(config=ModelConfig(
        batch_size=8, sync_bn=sync_bn, snapshot_dir=str(tmp_path)),
        device="cpu", stage_sizes=(1, 1, 1, 1), width=8, n_classes=CLASSES,
        crop=32, data=ImageNet_data(crop=32, synthetic_n=16,
                                    synthetic_pool=4, synthetic_store=36,
                                    n_classes=CLASSES))
    assert all(m.sync == sync_bn for m in model.module.modules()
               if hasattr(m, "sync"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model.compile_iter_fns()
    noisy = [w for w in caught if "too noisy" in str(w.message)]
    assert len(noisy) == (0 if sync_bn else 1)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
