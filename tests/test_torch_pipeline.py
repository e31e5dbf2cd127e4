"""Pipeline parallelism in the port (parallel/pipeline.py,
``TransformerLM_PP``) against the JAX package's, on the CPU.

One spawn of four gloo ranks on a (data 2 x pipe 2) mesh: a 4-layer LM
(two blocks a stage), two microbatches a data shard, from JAX's initial
weights (``pos_emb`` is ``(seq_len, d)`` in this tree), two sgd steps
under 'avg' and two under 'cdd' on the same stream as JAX's
``TransformerLM_PP`` on a 4-device mesh.  The losses (real on the last
stage, summed over ``pipe``, averaged over ``data``) and every parameter
after, gathered whole, are held within ``rtol=2e-5`` and an absolute
floor of ``1e-6`` of the largest parameter: f32, and the port's
per-microbatch backward weights each microbatch's mean by 1/M where JAX
takes one mean over the local batch.  The same run on one process
(one stage, the whole global batch of 8) must agree within the same
limits (JAX's ``test_pp_trajectory_matches_single_stage``), and every
rank must end with the same validation metrics.  The spawn also records
each stage's blocks and JAX's refusal of 3 layers over 2 stages.

The file is also the rank program: ``python test_torch_pipeline.py RANK
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
SPEC = dict(data=2, pipe=2)
PP = dict(n_layers=4, n_microbatches=2)


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_PP
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh

    init_ranks(rank, world, port)
    try:
        whole = torch.load(os.path.join(workdir, "weights.pt"))
        out = {}
        for sync in ("avg", "cdd"):
            out[sync], model = train_port(TransformerLM_PP, SPEC, whole,
                                          steps=2, dims=PP, sync_type=sync)
        out["blocks"] = sorted({n.split(".")[1] for n, _ in
                                model.module.named_parameters()
                                if n.startswith("blocks.")}, key=int)
        try:
            TransformerLM_PP(config=port_config(TransformerLM_PP),
                             device="cpu",
                             mesh=make_training_mesh(MeshSpec(**SPEC)),
                             data=SeqLM_data(**DATA), n_layers=3)
        except ValueError as e:
            out["indivisible"] = str(e)
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _torch_lm_ranks import jax_model, jax_tree
    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.models.transformer import TransformerLM_PP as JaxPP
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree

    tmp = tmp_path_factory.mktemp("pipeline")
    tree = jax_tree(jax_model(JaxPP, SPEC, WORLD, dims=PP))
    torch.save(state_dict_from_flax_tree("pp", tree), tmp / "weights.pt")
    spawn_ranks(os.path.abspath(__file__), tmp, world=WORLD, timeout=240)
    return tree, load_ranks(tmp, WORLD)


@pytest.mark.parametrize("sync", ["avg", "cdd"])
def test_pp_steps_match_jax(ranks, sync):
    from _torch_lm_ranks import jax_model, train_jax
    from theanompi_tpu.models.transformer import TransformerLM_PP as JaxPP
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree

    want = train_jax(jax_model(JaxPP, SPEC, WORLD, dims=PP), steps=2,
                     sync_type=sync)
    want_p = {k: v.numpy() for k, v in
              state_dict_from_flax_tree("pp", want["params"]).items()}
    for o in ranks[1]:
        np.testing.assert_allclose(o[sync]["losses"], want["losses"],
                                   rtol=2e-5)
        assert_params_close(o[sync]["params"], want_p, msg=sync)


def test_pp_matches_one_stage_on_one_process(ranks):
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.bridge import state_dict_from_flax_tree
    from theanompi_tpu_torch.models.transformer import TransformerLM_PP
    from theanompi_tpu_torch.utils.recorder import Recorder
    from _torch_lm_ranks import DIMS

    tree, outs = ranks
    model = TransformerLM_PP(config=port_config(TransformerLM_PP,
                                                batch_size=8),
                             device="cpu", data=SeqLM_data(**DATA),
                             **dict(DIMS, **PP))
    model.load_whole_state_dict(state_dict_from_flax_tree("pp", tree))
    model.compile_iter_fns()
    rec = Recorder(rank=0, size=1, print_freq=0)
    model.begin_epoch(0)
    for i in range(2):
        model.train_iter(i, rec)
    model._flush_metrics(rec)
    val = model.val_epoch(rec)
    model.cleanup()
    want_p = {k: v.numpy() for k, v in model.whole_state_dict().items()}
    for o in outs:
        np.testing.assert_allclose(o["avg"]["losses"], rec.train_losses,
                                   rtol=2e-5)
        assert_params_close(o["avg"]["params"], want_p)
        assert o["avg"]["val"] == outs[0]["avg"]["val"]
        np.testing.assert_allclose(o["avg"]["val"]["loss"], val["loss"],
                                   rtol=2e-5)


def test_each_stage_owns_its_blocks(ranks):
    # rank r sits at (data r // 2, pipe r % 2): stage 0 owns blocks 0-1
    for r, o in enumerate(ranks[1]):
        stage = r % 2
        assert o["blocks"] == [str(2 * stage), str(2 * stage + 1)]
        assert o["indivisible"] == "n_layers=3 not divisible by pipe=2 stages"


def test_pp_refusals_match_jax():
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_PP

    with pytest.raises(ValueError, match="per-data-shard batch 4 not "
                                         "divisible by 3 microbatches"):
        TransformerLM_PP(config=port_config(TransformerLM_PP), device="cpu",
                         data=SeqLM_data(**DATA), n_microbatches=3)
    for knob, value, msg in (
            ("grad_accum_steps", 2, "grad_accum_steps>1 is not implemented "
                                    "for the pipeline/expert step"),
            ("zero_sharding", True, "zero_sharding is not implemented for "
                                    "the pipeline/expert step"),
            ("steps_per_call", 2, "steps_per_call>1 is not implemented for "
                                  "the pipeline-parallel path")):
        m = TransformerLM_PP(config=port_config(TransformerLM_PP,
                                                **{knob: value}),
                             device="cpu", data=SeqLM_data(**DATA))
        with pytest.raises(ValueError, match=msg):
            m.compile_iter_fns()


def test_pp_bridge_round_trips_jax_tree():
    """JAX's PP tree (stacked blocks) -> the port's names -> the tree."""
    from _torch_lm_ranks import jax_model, jax_tree
    from theanompi_tpu.models.transformer import TransformerLM_PP as JaxPP
    from theanompi_tpu_torch.models.bridge import (
        flax_from_state_dict,
        state_dict_from_flax_tree,
    )

    tree = jax_tree(jax_model(JaxPP, dict(data=1), 1, dims=PP))
    back = flax_from_state_dict("pp", state_dict_from_flax_tree("pp", tree))

    def flat(t, p=""):
        return ({k2: v2 for k, v in t.items() for k2, v2 in
                 flat(v, f"{p}{k}/").items()} if isinstance(t, dict)
                else {p[:-1]: np.asarray(t)})

    a, b = flat(tree), flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_snapshots_cross_the_packages(tmp_path):
    """The PP model's snapshot is JAX's: JAX's ``save`` read by the
    port's ``load`` and the port's read back by JAX's, every leaf
    bit for bit."""
    import jax

    from _torch_lm_ranks import DIMS, jax_model, jax_tree
    from theanompi_tpu.models.transformer import TransformerLM_PP as JaxPP
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_PP

    jm = jax_model(JaxPP, dict(data=1), 1, dims=PP, seed=11)
    jm.save(str(tmp_path / "jax.npz"))
    port = TransformerLM_PP(config=port_config(TransformerLM_PP),
                            device="cpu", data=SeqLM_data(**DATA),
                            **dict(DIMS, **PP))
    port.load(str(tmp_path / "jax.npz"))
    want = jax.tree_util.tree_flatten_with_path(jax_tree(jm))[0]
    got = port.params
    for path, leaf in want:
        node = got
        for k in path:
            node = node[str(getattr(k, "key", getattr(k, "idx", k)))]
        np.testing.assert_array_equal(node, leaf)
    port.save(str(tmp_path / "port.npz"))
    back = jax_model(JaxPP, dict(data=1), 1, dims=PP)
    back.load(str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree.leaves(jax_tree(back)),
                    jax.tree.leaves(jax_tree(jm))):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
