"""The port's exchanger (theanompi_tpu_torch/parallel/exchanger.py)
against the JAX ``BSP_Exchanger``.

* The bucket plan and the bucket-count check: equal to JAX's on the same
  size lists, clamping and error text included.
* Two gloo ranks (spawned processes; this file is also their program:
  ``python test_torch_exchange.py RANK WORLD PORT DIR``) against the JAX
  exchanger in ``shard_map`` on a 2-device CPU mesh, with the same
  per-rank tensors drawn from a numpy seed: the f32 wire averaged and
  summed, the bf16 wire averaged and summed, and error feedback over 3
  steps (outputs and residuals), each at 1 bucket, 3 buckets and one
  bucket per tensor.  Tolerance: none, bit for bit.  With two ranks the
  sum of one element has one order (``a + b``), the bf16 quantization is
  round-to-nearest-even on both sides, and the bf16 wire sums the
  gathered values in f32 in rank order on both sides.
* Without a process group, a mixed-dtype bucket goes tensor by tensor.
* The exchange's gauges: the names, labels and values JAX sets per
  trace, set once per built step.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tensors one exchange moves (5: one bucket per tensor is B = 5)
SHAPES = [(3, 4), (5,), (2, 3, 2), (7,), (4, 4)]
BUCKETS = (1, 3, len(SHAPES))
#: (case name, exchanger keyword arguments, steps)
MODES = {
    "f32-avg": (dict(avg=True), 1),
    "f32-sum": (dict(avg=False), 1),
    "bf16-avg": (dict(avg=True, exchange_dtype="bf16"), 1),
    "bf16-sum": (dict(avg=False, strategy="nccl16"), 1),
    "ef-avg": (dict(avg=True, exchange_dtype="bf16", error_feedback=True),
               3),
}
WORLD = 2


def _draw(seed: int = 17) -> dict:
    """Per (mode, step, rank) tensors; magnitudes from 1e-3 to 1e2 so the
    bf16 rounding is live in every tensor."""
    rng = np.random.default_rng(seed)
    out = {}
    for mode, (_, steps) in MODES.items():
        for s in range(steps):
            for r in range(WORLD):
                for i, shape in enumerate(SHAPES):
                    out[f"{mode}/{s}/{r}/{i}"] = (
                        rng.standard_normal(shape)
                        * 10.0 ** rng.uniform(-3, 2, shape)
                    ).astype(np.float32)
    return out


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        out = {}
        for mode, (kw, steps) in MODES.items():
            for b in BUCKETS:
                ex = BSP_Exchanger(exchange_buckets=b, **kw)
                res = [torch.zeros(s) for s in SHAPES]
                for s in range(steps):
                    ts = [torch.from_numpy(data[f"{mode}/{s}/{rank}/{i}"])
                          for i in range(len(SHAPES))]
                    if ex.error_feedback:
                        ex.exchange_with_residual(ts, res)
                    else:
                        ex.exchange(ts)
                    for i, t in enumerate(ts):
                        out[f"{mode}/{b}/{s}/out/{i}"] = t.numpy().copy()
                        out[f"{mode}/{b}/{s}/res/{i}"] = res[i].numpy().copy()
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(script: str, workdir, world: int = WORLD, extra=(),
                timeout: float = 180) -> None:
    """Run ``script RANK WORLD PORT DIR *extra`` as ``world`` processes
    on one gloo group; fails with a rank's output if one fails, and
    kills any rank that outlives the call."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port),
         str(workdir), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    """The port's outputs per rank, after one spawn of two ranks."""
    tmp = tmp_path_factory.mktemp("exchange")
    data = _draw()
    np.savez(tmp / "inputs.npz", **data)
    spawn_ranks(os.path.abspath(__file__), tmp)
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _jax_exchange(mode: str, b: int, data: dict):
    """JAX's outputs and residuals per (step, rank, tensor)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu.parallel.mesh import data_mesh

    mesh = data_mesh(WORLD, jax.devices()[:WORLD])
    kw, steps = MODES[mode]
    ex = BSP_Exchanger(exchange_buckets=b, **kw)
    spec = [P("data")] * len(SHAPES)
    if ex.error_feedback:
        fn = jax.jit(jax.shard_map(ex.exchange_with_residual, mesh=mesh,
                                   in_specs=(spec, spec),
                                   out_specs=(spec, spec), check_vma=False))
    else:
        fn = jax.jit(jax.shard_map(ex.exchange, mesh=mesh, in_specs=(spec,),
                                   out_specs=spec, check_vma=False))
    res = [jnp.zeros((WORLD,) + s, jnp.float32) for s in SHAPES]
    outs = []
    for s in range(steps):
        ts = [jnp.asarray(np.stack([data[f"{mode}/{s}/{r}/{i}"]
                                    for r in range(WORLD)]))
              for i in range(len(SHAPES))]
        if ex.error_feedback:
            out, res = fn(ts, res)
        else:
            out = fn(ts)
        outs.append(([np.asarray(o) for o in out],
                     [np.asarray(r) for r in res]))
    return outs


# -- the bucket plan ------------------------------------------------------


@pytest.mark.parametrize("sizes,k", [
    ([4, 4, 4, 4], 2), ([10, 1, 1, 1, 1, 10], 3), ([1, 100, 1], 2),
    ([5], 1), ([3, 1, 4, 1, 5, 9, 2, 6], 4), ([8, 8, 8], 7),
    ([2, 7, 1, 8, 2, 8], 6), ([9, 9, 9, 1], 1)])
def test_bucket_plan_matches_jax(sizes, k):
    from theanompi_tpu.parallel.exchanger import bucket_ranges as jax_plan

    from theanompi_tpu_torch.parallel.exchanger import bucket_ranges

    assert bucket_ranges(sizes, k) == jax_plan(sizes, k)


@pytest.mark.parametrize("bad", [0, -1, True, 2.0, "2", None])
def test_bucket_count_check_matches_jax(bad):
    from theanompi_tpu.parallel.exchanger import (
        validate_bucket_count as jax_check,
    )

    from theanompi_tpu_torch.parallel.exchanger import (
        BSP_Exchanger,
        validate_bucket_count,
    )

    with pytest.raises(ValueError) as want:
        jax_check(bad)
    with pytest.raises(ValueError) as got:
        validate_bucket_count(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exchange_buckets"):
        BSP_Exchanger(exchange_buckets=bad)
    assert validate_bucket_count(4) == jax_check(4) == 4


@pytest.mark.parametrize("kw,msg", [
    (dict(error_feedback=True), "needs exchange_dtype='bf16'"),
    (dict(error_feedback=True, exchange_dtype="bf16",
          exchange_what="params"), "no residual semantics"),
    (dict(exchange_dtype="f16"), "exchange_dtype must be"),
    (dict(exchange_what="both"), "exchange_what must be"),
    (dict(strategy="mpi"), "unknown exchange strategy")])
def test_exchanger_validation_matches_jax(kw, msg):
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JaxEx

    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    with pytest.raises(ValueError, match=msg):
        JaxEx(**kw)
    with pytest.raises(ValueError, match=msg):
        BSP_Exchanger(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(strategy="nccl16"), dict(strategy="asa16"),
    dict(strategy="nccl16", exchange_dtype="f32"),
    dict(exchange_dtype="bf16")])
def test_wire_dtype_matches_jax(kw):
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JaxEx

    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    want, got = JaxEx(**kw), BSP_Exchanger(**kw)
    assert (got.resolved, got.wire_dtype) == (want.resolved,
                                              want.wire_dtype)


# -- two ranks against the JAX exchanger ---------------------------------


@pytest.mark.parametrize("b", BUCKETS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_rank_exchange_bit_identical_to_jax(exchanged, mode, b):
    data, ranks = exchanged
    want = _jax_exchange(mode, b, data)
    for s, (outs, res) in enumerate(want):
        for r in range(WORLD):
            for i in range(len(SHAPES)):
                got = ranks[r][f"{mode}/{b}/{s}/out/{i}"]
                np.testing.assert_array_equal(
                    got, outs[i][r], err_msg=f"{mode} B={b} step {s} rank "
                    f"{r} tensor {i}")
                if MODES[mode][0].get("error_feedback"):
                    np.testing.assert_array_equal(
                        ranks[r][f"{mode}/{b}/{s}/res/{i}"], res[i][r],
                        err_msg=f"residual step {s} rank {r} tensor {i}")


def test_error_feedback_residual_is_the_quantization_error(exchanged):
    """Step 0 from a zero residual: each rank's residual is exactly
    ``g - bf16(g)``, and its output is the f32 mean of the two ranks'
    ``bf16(g)``."""
    data, ranks = exchanged
    q = [[torch.from_numpy(data[f"ef-avg/0/{r}/{i}"]).bfloat16().float()
          for i in range(len(SHAPES))] for r in range(WORLD)]
    for r in range(WORLD):
        for i in range(len(SHAPES)):
            g = torch.from_numpy(data[f"ef-avg/0/{r}/{i}"])
            res = torch.from_numpy(ranks[r][f"ef-avg/1/0/res/{i}"])
            assert torch.equal(res, g - q[r][i])
            out = torch.from_numpy(ranks[r][f"ef-avg/1/0/out/{i}"])
            assert torch.equal(out, (q[0][i] + q[1][i]) / 2)


# -- one process ------------------------------------------------------------


GAUGES = ("exchange/bytes_per_call", "exchange/traces_total",
          "bsp/exchange_buckets", "bsp/exchange_bucket_bytes")


def _gauges(snapshot) -> set:
    return {(r["name"], tuple(sorted(r["labels"].items())),
             r.get("value")) for r in snapshot if r["name"] in GAUGES}


@pytest.mark.parametrize("kw", [dict(exchange_buckets=3),
                                dict(exchange_dtype="bf16",
                                     exchange_buckets=3),
                                dict(strategy="nccl16")])
def test_exchange_gauges_as_jax_sets_them(tmp_path, kw):
    """The port's step sets, once when built (its first call), the
    gauges JAX's exchange sets once per trace: same names, labels and
    values for the same tensors."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu import monitor as jax_monitor
    from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JaxEx
    from theanompi_tpu.parallel.mesh import data_mesh
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        make_bsp_train_step,
    )
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    mesh = data_mesh(1, jax.devices()[:1])
    ex = JaxEx(**kw)
    fn = jax.jit(jax.shard_map(ex.exchange, mesh=mesh, in_specs=(P(),),
                               out_specs=P(), check_vma=False))
    with jax_monitor.session(str(tmp_path / "jax")):
        fn([jnp.ones(s) for s in SHAPES])
        want = _gauges(jax_monitor.registry().snapshot())

    module = torch.nn.Module()
    for i, s in enumerate(SHAPES):
        module.register_parameter(f"p{i}", torch.nn.Parameter(torch.ones(s)))

    def loss_fn(mod, batch, rng):
        return sum(p.sum() for p in mod.parameters()), {}

    state = TrainState(module, torch.optim.SGD(module.parameters(), 0.1))
    step = make_bsp_train_step(loss_fn, BSP_Exchanger(**kw))
    with monitor.session(str(tmp_path / "port")):
        step(state, None, None)
        step(state, None, None)          # built once: no second count
        got = _gauges(monitor.registry().snapshot())
    assert want and got == want



@pytest.mark.parametrize("wire", [None, "bf16"])
def test_mixed_dtype_bucket_goes_tensor_by_tensor(wire):
    """A bucket holding f32 and bf16 tensors is reduced per tensor, each
    keeping its dtype: with no process group the f32 wire leaves them as
    they are and the bf16 wire rounds each to bf16."""
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
          torch.from_numpy(rng.standard_normal(3).astype(np.float32))
          .bfloat16(),
          torch.from_numpy(rng.standard_normal(4).astype(np.float32))]
    want = [t.bfloat16().to(t.dtype) if wire else t.clone() for t in ts]
    BSP_Exchanger(exchange_dtype=wire, exchange_buckets=1).exchange(ts)
    for t, w in zip(ts, want):
        assert t.dtype == w.dtype and torch.equal(t, w)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
