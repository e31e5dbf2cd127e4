"""Tensor parallelism in the port (parallel/tensor.py,
``TransformerLM_TP``) against the JAX package's GSPMD path, on the CPU.

One spawn of four gloo ranks on a (data 2 x model 2) mesh runs every
case from JAX's initial weights (the whole tree, each rank taking its
block) on the same stream as JAX's ``TransformerLM_TP`` on a 4-device
mesh: two sgd steps under 'avg', two under 'cdd' (the summed exchange,
JAX's ``grad_scale = data``), and two as one ``steps_per_call=2``
dispatch.  The losses and every parameter after, gathered whole, are
held within ``rtol=2e-5`` and an absolute floor of ``1e-6`` of the
largest parameter (f32; the row-parallel sums add two partial products
where one matmul sums in one order).  The spawn also records each rank's
parameter shapes (the column blocks of q/k/v_proj and mlp_up, the row
blocks of o_proj and mlp_down, everything else whole), a checkpoint
payload adopted by a fresh model (the same whole parameters and the same
next step), and JAX's refusal of 3 heads over 2 ranks.

The file is also the rank program: ``python test_torch_tensor_parallel.py
RANK WORLD PORT DIR``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_lm_ranks import (  # noqa: E402
    DIMS,
    assert_params_close,
    init_ranks,
    load_ranks,
    save_rank,
    train_port,
)

WORLD = 4
SPEC = dict(data=2, model=2)
RUNS = {"avg": dict(), "cdd": dict(sync_type="cdd"),
        "multi": dict(steps_per_call=2)}


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.models.transformer import TransformerLM_TP
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh

    init_ranks(rank, world, port)
    try:
        whole = torch.load(os.path.join(workdir, "weights.pt"))
        out = {}
        for name, kw in RUNS.items():
            out[name], model = train_port(TransformerLM_TP, SPEC, whole,
                                          steps=2, **kw)
        out["shapes"] = {n: tuple(p.shape)
                         for n, p in model.module.named_parameters()}
        out["bytes"] = model.state_bytes()
        # a checkpoint adopted by a fresh model: the same next step
        payload = model.checkpoint_payload(0)
        from _torch_lm_ranks import DATA, port_config
        from theanompi_tpu_torch.data.lm import SeqLM_data

        mesh = make_training_mesh(MeshSpec(**SPEC))
        twin = TransformerLM_TP(config=port_config(TransformerLM_TP),
                                device="cpu", mesh=mesh,
                                data=SeqLM_data(**DATA), **DIMS)
        twin.compile_iter_fns()
        twin.adopt_restored_state(payload)
        out["adopted"] = {k: v.numpy().copy()
                          for k, v in twin.whole_state_dict().items()}
        out["payload"] = {k: v.numpy().copy()
                          for k, v in payload["params"].items()}
        batch = next(iter(twin.data.train_batches(1, twin.global_batch)))
        batch = tuple(torch.from_numpy(x)
                      for x in next(twin._host_batches([batch])))
        out["next"] = [float(m.train_step(m.state, batch, None)["loss"])
                       for m in (model, twin)]
        try:
            TransformerLM_TP(config=port_config(TransformerLM_TP),
                             device="cpu", mesh=mesh,
                             data=SeqLM_data(**DATA),
                             **dict(DIMS, n_heads=3, d_model=24))
        except ValueError as e:
            out["indivisible"] = str(e)
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _torch_lm_ranks import jax_model, jax_tree
    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.models.transformer import TransformerLM_TP as JaxTP
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )

    tmp = tmp_path_factory.mktemp("tensor")
    tree = jax_tree(jax_model(JaxTP, SPEC, WORLD))
    torch.save(transformer_state_dict_from_flax(tree), tmp / "weights.pt")
    spawn_ranks(os.path.abspath(__file__), tmp, world=WORLD, timeout=240)
    return tree, load_ranks(tmp, WORLD)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tp_steps_match_jax(ranks, run):
    from _torch_lm_ranks import jax_model, train_jax
    from theanompi_tpu.models.transformer import TransformerLM_TP as JaxTP
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )

    kw = dict(RUNS[run])
    sync = kw.pop("sync_type", "avg")
    want = train_jax(jax_model(JaxTP, SPEC, WORLD, **kw), steps=2,
                     sync_type=sync)
    want_p = {k: v.numpy() for k, v in
              transformer_state_dict_from_flax(want["params"]).items()}
    for o in ranks[1]:
        np.testing.assert_allclose(o[run]["losses"], want["losses"],
                                   rtol=2e-5)
        assert_params_close(o[run]["params"], want_p, msg=run)


def test_each_rank_holds_its_megatron_blocks(ranks):
    d, ff = DIMS["d_model"], 4 * DIMS["d_model"]
    for o in ranks[1]:
        shapes = o["shapes"]
        for i in range(DIMS["n_layers"]):
            b = f"blocks.{i}."
            for n in ("q_proj", "k_proj", "v_proj"):
                assert shapes[b + n + ".weight"] == (d // 2, d)
            assert shapes[b + "o_proj.weight"] == (d, d // 2)
            assert shapes[b + "mlp_up.weight"] == (ff // 2, d)
            assert shapes[b + "mlp_up.bias"] == (ff // 2,)
            assert shapes[b + "mlp_down.weight"] == (d, ff // 2)
            assert shapes[b + "mlp_down.bias"] == (d,)
            assert shapes[b + "LayerNorm_0.scale"] == (d,)
        assert shapes["Dense_0.weight"] == (DIMS["vocab"], d)
        assert o["bytes"]["optimizer"] > 0
        assert o["bytes"]["optimizer"] == o["bytes"]["params"]


def test_checkpoint_round_trips_the_whole_tree(ranks):
    for o in ranks[1]:
        assert set(o["payload"]) == set(o["adopted"])
        for k, v in o["payload"].items():
            np.testing.assert_array_equal(o["adopted"][k], v, err_msg=k)
        assert o["next"][0] == o["next"][1]
    # every rank gathered the same whole tree
    for o in ranks[1][1:]:
        for k, v in o["payload"].items():
            np.testing.assert_array_equal(ranks[1][0]["payload"][k], v)


def test_indivisible_heads_refused_as_jax(ranks):
    for o in ranks[1]:
        assert o["indivisible"].startswith(
            "tensor parallelism 2 must divide n_heads=3 and d_ff=96")


def test_tp_refuses_accumulation_and_sharded_state_by_jax_message():
    from _torch_lm_ranks import DATA, port_config
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_TP

    cases = {"grad_accum_steps": (2, "grad_accum_steps>1 is not "
                                  "implemented for the GSPMD "
                                  "tensor-parallel step"),
             "zero_sharding": (True, "zero_sharding is not implemented "
                               "for the GSPMD tensor-parallel step (its "
                               "optimizer state is already sharded like "
                               "the params)"),
             "exchange_buckets": (2, "exchange_buckets is not implemented")}
    for knob, (value, msg) in cases.items():
        m = TransformerLM_TP(config=port_config(TransformerLM_TP,
                                                **{knob: value}),
                             device="cpu", data=SeqLM_data(**DATA), **DIMS)
        with pytest.raises(ValueError, match=msg.replace("(", r"\(")
                           .replace(")", r"\)")):
            m.compile_iter_fns()


def test_tp_specs_follow_the_megatron_rules():
    """JAX's rule over the port's names: column-parallel weights and
    biases on dim 0 (the port's weights are (out, in)), row-parallel
    weights on dim 1, the rest whole."""
    from theanompi_tpu_torch.models.transformer import TransformerLMNet
    from theanompi_tpu_torch.parallel.mesh import AxisGroup, local_named
    from theanompi_tpu_torch.parallel.tensor import transformer_tp_specs

    net = TransformerLMNet(**DIMS)
    specs = transformer_tp_specs(dict(net.named_parameters()))
    cut = {k: v for k, v in specs.items() if v is not None}
    assert cut == {f"blocks.{i}.{n}": d for i in range(DIMS["n_layers"])
                   for n, d in (("q_proj.weight", 0), ("k_proj.weight", 0),
                                ("v_proj.weight", 0), ("mlp_up.weight", 0),
                                ("mlp_up.bias", 0), ("o_proj.weight", 1),
                                ("mlp_down.weight", 1))}
    sd = net.state_dict()
    halves = [local_named(sd, {k: (AxisGroup(("model",), 2, i, (0, 1)), d)
                               for k, d in cut.items()}, list(sd))
              for i in range(2)]
    for k, d in specs.items():
        if d is None:
            assert all(torch.equal(h[k], sd[k]) for h in halves)
        else:
            assert torch.equal(torch.cat([h[k] for h in halves], d), sd[k])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
