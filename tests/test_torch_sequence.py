"""Sequence parallelism in the port (parallel/sequence.py, the LM over a
(data x seq) mesh) against the JAX package's, on the CPU.

One spawn of four gloo ranks runs every case:

* each strategy (ring, all-gather, Ulysses), causal and not, on a seq
  group of four: JAX's test shapes (B 2, T 32, H 8, D 16, T_local 8),
  the same seeded q, k, v and output cotangent on both sides; each rank
  keeps its time block of the output and of dq, dk, dv, held against
  JAX's ``sequence_attention`` under ``shard_map`` on a 4-device seq
  mesh: the forward within JAX's own ``rtol=2e-5, atol=2e-6`` and the
  gradients within its ``rtol=5e-5, atol=5e-6``
  (tests/test_sequence_parallel.py);
* Ulysses refusing 6 heads over 4 ranks, by JAX's message;
* the TransformerLM over (data 2 x seq 2), each strategy, two sgd steps
  from JAX's initial weights on the same stream: the losses and every
  parameter after against JAX's model on the same mesh (``rtol=2e-5``,
  an absolute floor of ``1e-6`` of the largest parameter: f32, sums in
  other orders), and against the port's pure data-parallel model on one
  process at the same global batch (JAX's
  ``test_dp_sp_equivalent_to_pure_dp``); the ring run again under
  ``remat``, bit for bit.

The file is also the rank program: ``python test_torch_sequence.py RANK
WORLD PORT DIR``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_lm_ranks import (  # noqa: E402
    assert_params_close,
    init_ranks,
    load_ranks,
    save_rank,
    train_port,
)

WORLD = 4
B, T, H, D = 2, 32, 8, 16
STRATEGIES = ("ring", "allgather", "ulysses")


def draw() -> dict:
    rng = np.random.RandomState(0)
    out = {n: (rng.randn(B, T, H, D) * 0.3).astype(np.float32)
           for n in ("q", "k", "v")}
    out["ct"] = np.random.RandomState(2).randn(B, T, H, D).astype(
        np.float32)
    return out


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from theanompi_tpu_torch.models import transformer as T_
    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh
    from theanompi_tpu_torch.parallel.sequence import sequence_attention

    init_ranks(rank, world, port)
    try:
        data = dict(np.load(os.path.join(workdir, "inputs.npz")))
        mesh = make_training_mesh(MeshSpec(data=1, seq=world))
        seq = mesh.axis("seq")
        tl = T // world
        blk = slice(seq.index * tl, (seq.index + 1) * tl)
        out = {"attn": {}}
        for strategy in STRATEGIES:
            for causal in (False, True):
                q, k, v = (torch.from_numpy(data[n][:, blk].copy())
                           .requires_grad_() for n in ("q", "k", "v"))
                o = sequence_attention(q, k, v, seq, causal=causal,
                                       strategy=strategy)
                (o * torch.from_numpy(data["ct"][:, blk])).sum().backward()
                out["attn"][strategy, causal] = {
                    "o": o.detach().numpy().copy(),
                    **{f"d{n}": t.grad.numpy().copy()
                       for n, t in zip("qkv", (q, k, v))}}
        z = torch.zeros(1, 16 // world, 6, 4)
        try:
            sequence_attention(z, z, z, seq, strategy="ulysses")
        except ValueError as e:
            out["ulysses_heads"] = str(e)
        whole = torch.load(os.path.join(workdir, "weights.pt"))
        out["lm"] = {}
        for strategy in STRATEGIES:
            cls = type(f"LM_{strategy}", (T_.TransformerLM,),
                       {"sp_strategy": strategy})
            out["lm"][strategy], _ = train_port(
                cls, dict(data=2, seq=2), whole, steps=2)
        out["remat"], _ = train_port(T_.TransformerLM, dict(data=2, seq=2),
                                     whole, steps=2, remat=True)
        save_rank(workdir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four gloo ranks: one spawn.  The LM's weights are
    JAX's initial ones, carried to the port's names."""
    from _torch_lm_ranks import jax_model, jax_tree
    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.models.transformer import TransformerLM as JaxLM
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )

    tmp = tmp_path_factory.mktemp("sequence")
    data = draw()
    np.savez(tmp / "inputs.npz", **data)
    tree = jax_tree(jax_model(JaxLM, dict(data=2, seq=2), 4))
    torch.save(transformer_state_dict_from_flax(tree), tmp / "weights.pt")
    spawn_ranks(os.path.abspath(__file__), tmp, world=WORLD, timeout=240)
    return data, tree, load_ranks(tmp, WORLD)


def _jax_attention(data, strategy, causal):
    """JAX's sharded attention and its gradients under ``shard_map`` on a
    4-device seq mesh (tests/test_sequence_parallel.py's harness)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from theanompi_tpu.parallel.mesh import MeshSpec, make_training_mesh
    from theanompi_tpu.parallel.sequence import sequence_attention

    mesh = make_training_mesh(MeshSpec(data=1, seq=WORLD),
                              jax.devices()[:WORLD])
    spec = P(None, "seq", None, None)
    attn = jax.jit(jax.shard_map(
        lambda q, k, v: sequence_attention(q, k, v, causal=causal,
                                           strategy=strategy),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
    q, k, v, ct = (jnp.asarray(data[n]) for n in ("q", "k", "v", "ct"))
    o = attn(q, k, v)
    grads = jax.grad(lambda q, k, v: (attn(q, k, v) * ct).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_jax_forward_and_gradients(ranks, strategy, causal):
    data, _, outs = ranks
    want_o, want_g = _jax_attention(data, strategy, causal)
    got = {k: np.concatenate([o["attn"][strategy, causal][k] for o in outs],
                             axis=1) for k in ("o", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["o"], want_o, rtol=2e-5, atol=2e-6)
    for name, want in zip(("dq", "dk", "dv"), want_g):
        np.testing.assert_allclose(got[name], want, rtol=5e-5, atol=5e-6,
                                   err_msg=name)


def test_ulysses_refuses_heads_not_divisible_by_the_group(ranks):
    outs = ranks[2]
    for o in outs:
        assert o["ulysses_heads"] == ("ulysses needs heads (6) divisible by "
                                      "seq axis (4)")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_lm_over_data_and_seq_matches_jax(ranks, strategy):
    from _torch_lm_ranks import jax_model, train_jax
    from theanompi_tpu.models.transformer import TransformerLM as JaxLM
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )

    _, tree, outs = ranks
    cls = type(f"JaxLM_{strategy}", (JaxLM,), {"sp_strategy": strategy})
    jm = jax_model(cls, dict(data=2, seq=2), 4)   # the same seed: ``tree``
    want = train_jax(jm, steps=2)
    want_p = {k: v.numpy() for k, v in
              transformer_state_dict_from_flax(want["params"]).items()}
    for o in outs:
        got = o["lm"][strategy]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
        assert_params_close(got["params"], want_p, msg=strategy)


def test_lm_over_data_and_seq_equals_pure_data_parallel(ranks):
    """The same two steps on one process at the whole global batch (8
    sequences of 16): the (data x seq) runs' losses and parameters."""
    from _torch_lm_ranks import DATA, DIMS, port_config
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.bridge import (
        transformer_state_dict_from_flax,
    )
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.utils.recorder import Recorder

    _, tree, outs = ranks
    model = TransformerLM(config=port_config(TransformerLM, batch_size=8),
                          device="cpu", data=SeqLM_data(**DATA), **DIMS)
    model.module.load_state_dict(transformer_state_dict_from_flax(tree))
    model.compile_iter_fns()
    rec = Recorder(rank=0, size=1, print_freq=0)
    model.begin_epoch(0)
    for i in range(2):
        model.train_iter(i, rec)
    model._flush_metrics(rec)
    model.cleanup()
    want_p = {k: p.detach().numpy() for k, p in
              model.module.named_parameters()}
    for strategy in STRATEGIES:
        got = outs[0]["lm"][strategy]
        np.testing.assert_allclose(got["losses"], rec.train_losses,
                                   rtol=2e-5)
        assert_params_close(got["params"], want_p, msg=strategy)


def test_remat_over_data_and_seq_is_bit_identical(ranks):
    """``remat`` composes with the (data x seq) ring step (JAX's
    ``test_remat_trains_through_sp_spine``): the recompute re-issues the
    ring's sends in the backward, and the two steps end bit for bit
    where the plain run does."""
    for o in ranks[2]:
        assert o["remat"]["losses"] == o["lm"]["ring"]["losses"]
        for k, v in o["lm"]["ring"]["params"].items():
            np.testing.assert_array_equal(o["remat"]["params"][k], v,
                                          err_msg=k)


def test_unknown_strategy_refused_by_name():
    from theanompi_tpu_torch.parallel.sequence import sequence_attention

    z = torch.zeros(1, 4, 2, 4)
    with pytest.raises(ValueError, match="unknown sequence-parallel "
                                         "strategy 'nope'"):
        sequence_attention(z, z, z, strategy="nope")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_rank_group_is_plain_attention(strategy, causal):
    """Without a seq group every strategy is the plain attention of the
    whole sequence (ring: one block; the others: K4's plain twin on the
    CPU), within f32 rounding of ``attention_reference``."""
    from theanompi_tpu_torch.parallel.sequence import (
        attention_reference,
        sequence_attention,
    )

    data = draw()
    q, k, v = (torch.from_numpy(data[n]) for n in ("q", "k", "v"))
    got = sequence_attention(q, k, v, causal=causal, strategy=strategy)
    want = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-6)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
