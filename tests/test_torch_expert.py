"""Expert parallelism in the port (parallel/expert.py,
``TransformerLM_MoE``) against the JAX package's, on the CPU.

One spawn of four gloo ranks on a (data 2 x expert 2) mesh: a 2-layer
switch LM with 4 experts (two a rank), the batch over data x expert,
from JAX's initial weights, two sgd steps under 'avg', two under 'cdd'
and two with the worker-scaled LR (``lr_scale_with_workers='linear'``:
the workers are data x ep = 4), on the same stream as JAX's
``TransformerLM_MoE`` on a 4-device mesh.  The losses (the CE; the aux
loss joins the objective as ``aux_weight * aux / n_layers``) and every
parameter after, gathered whole, are held within ``rtol=2e-5`` and an
absolute floor of ``1e-6`` of the largest parameter (f32; the dispatch
and combine einsums and the expert all-to-all sum in other orders).
The routing itself (``top1_dispatch``: first-max argmax, queue
positions, capacity drop, aux loss) is held against JAX's on one
process, bit for bit on the dispatch and to f32 rounding on the rest.

The file is also the rank program: ``python test_torch_expert.py RANK
WORLD PORT DIR``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_lm_ranks import (  # noqa: E402
    DATA,
    assert_params_close,
    init_ranks,
    load_ranks,
    port_config,
    save_rank,
    train_port,
)

WORLD = 4
SPEC = dict(data=2, expert=2)
MOE = dict(n_experts=4)
RUNS = {"avg": dict(), "cdd": dict(sync_type="cdd"),
        "scaled": dict(lr_scale_with_workers="linear")}


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_MoE
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh

    init_ranks(rank, world, port)
    try:
        whole = torch.load(os.path.join(workdir, "weights.pt"))
        out = {}
        for name, kw in RUNS.items():
            out[name], model = train_port(TransformerLM_MoE, SPEC, whole,
                                          steps=2, dims=MOE, **kw)
            out[name]["lr"] = model._base_lr
            out[name]["global_batch"] = model.global_batch
        out["expert_shapes"] = {n: tuple(p.shape) for n, p in
                                model.module.named_parameters()
                                if n.startswith("experts.")}
        try:
            TransformerLM_MoE(config=port_config(TransformerLM_MoE),
                              device="cpu",
                              mesh=make_training_mesh(MeshSpec(**SPEC)),
                              data=SeqLM_data(**DATA), n_experts=3)
        except ValueError as e:
            out["indivisible"] = str(e)
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _torch_lm_ranks import jax_model, jax_tree
    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.models.transformer import TransformerLM_MoE as JaxMoE
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree

    tmp = tmp_path_factory.mktemp("expert")
    tree = jax_tree(jax_model(JaxMoE, SPEC, WORLD, dims=MOE))
    torch.save(state_dict_from_flax_tree("moe", tree), tmp / "weights.pt")
    spawn_ranks(os.path.abspath(__file__), tmp, world=WORLD, timeout=240)
    return tree, load_ranks(tmp, WORLD)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_moe_steps_match_jax(ranks, run):
    from _torch_lm_ranks import jax_model, train_jax
    from theanompi_tpu.models.transformer import TransformerLM_MoE as JaxMoE
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree

    kw = dict(RUNS[run])
    sync = kw.pop("sync_type", "avg")
    jm = jax_model(JaxMoE, SPEC, WORLD, dims=MOE, **kw)
    lr, gb = jm._base_lr, jm.global_batch
    want = train_jax(jm, steps=2, sync_type=sync)
    want_p = {k: v.numpy() for k, v in
              state_dict_from_flax_tree("moe", want["params"]).items()}
    for o in ranks[1]:
        assert o[run]["global_batch"] == gb == 16
        assert o[run]["lr"] == pytest.approx(lr)
        np.testing.assert_allclose(o[run]["losses"], want["losses"],
                                   rtol=2e-5)
        assert_params_close(o[run]["params"], want_p, msg=run)


def test_each_rank_holds_its_experts(ranks):
    for o in ranks[1]:
        assert o["expert_shapes"]["experts.0.up_kernel"] == (2, 32, 128)
        assert o["expert_shapes"]["experts.1.down_bias"] == (2, 32)
        assert o["indivisible"] == ("n_experts=3 not divisible by "
                                    "expert-parallel degree 2")


@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_top1_dispatch_matches_jax(capacity):
    """Logits with ties (the first maximum wins), capacities that drop
    most tokens, some, and none."""
    import jax.numpy as jnp

    from theanompi_tpu.parallel.expert import top1_dispatch as jax_dispatch
    from theanompi_tpu_torch.parallel.expert import top1_dispatch

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 4)).astype(np.float32)
    logits[::5] = 1.0                       # four-way ties
    want = [np.asarray(t) for t in jax_dispatch(jnp.asarray(logits),
                                                capacity)]
    got = [t.numpy() for t in top1_dispatch(torch.from_numpy(logits),
                                            capacity)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


def test_capacity_drops_overflow():
    """JAX's ``test_capacity_drops_overflow``: every token routed to one
    expert with capacity 3 keeps exactly 3 (the first ones)."""
    from theanompi_tpu_torch.parallel.expert import top1_dispatch

    logits = torch.zeros(10, 4)
    logits[:, 2] = 5.0
    dispatch, combine, _ = top1_dispatch(logits, 3)
    assert dispatch.sum() == 3
    assert dispatch[2].sum(0).tolist() == [1.0] * 3 + [0.0] * 7
    assert (combine[3:] == 0).all()


def test_moe_refusals_match_jax():
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_MoE

    for knob, value, msg in (
            ("grad_accum_steps", 2, "grad_accum_steps>1 is not implemented "
                                    "for the pipeline/expert step"),
            ("fsdp_sharding", True, "fsdp_sharding is not implemented for "
                                    "the pipeline/expert step"),
            ("steps_per_call", 2, "steps_per_call>1 is not implemented for "
                                  "the expert-parallel path")):
        m = TransformerLM_MoE(config=port_config(TransformerLM_MoE,
                                                 **{knob: value}),
                              device="cpu", data=SeqLM_data(**DATA))
        with pytest.raises(ValueError, match=msg):
            m.compile_iter_fns()


def test_moe_flops_discount_the_experts_as_jax():
    """``_lm_train_flops`` with the expert mask: the whole tree's
    matmul parameters, each expert tensor at 1/n_experts."""
    from _torch_lm_ranks import DIMS, jax_model
    from theanompi_tpu.models.transformer import TransformerLM_MoE as JaxMoE
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_MoE

    jm = jax_model(JaxMoE, dict(data=1), 1, dims=MOE)
    m = TransformerLM_MoE(config=port_config(TransformerLM_MoE),
                          device="cpu", data=SeqLM_data(**DATA), **DIMS,
                          **MOE)
    assert m.train_flops_per_sample == jm.train_flops_per_sample


def test_npz_snapshots_cross_the_packages(tmp_path):
    """The MoE model's snapshot is JAX's (its lists as decimal keys):
    JAX's ``save`` read by the port's ``load`` and the port's read back
    by JAX's, every leaf bit for bit."""
    import jax

    from _torch_lm_ranks import DIMS, jax_model, jax_tree
    from theanompi_tpu.models.transformer import TransformerLM_MoE as JaxMoE
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_MoE

    jm = jax_model(JaxMoE, dict(data=1), 1, dims=MOE, seed=11)
    jm.save(str(tmp_path / "jax.npz"))
    port = TransformerLM_MoE(config=port_config(TransformerLM_MoE),
                             device="cpu", data=SeqLM_data(**DATA),
                             **DIMS, **MOE)
    port.load(str(tmp_path / "jax.npz"))
    got = port.params
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree(jm))[0]:
        node = got
        for k in path:
            node = node[str(getattr(k, "key", getattr(k, "idx", k)))]
        np.testing.assert_array_equal(node, leaf)
    port.save(str(tmp_path / "port.npz"))
    back = jax_model(JaxMoE, dict(data=1), 1, dims=MOE)
    back.load(str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree.leaves(jax_tree(back)),
                    jax.tree.leaves(jax_tree(jm))):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
