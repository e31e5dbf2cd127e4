"""The port's TransformerLM slice on the CPU against the JAX package.

A tiny LM (2 layers, d_model 64, 4 heads, vocab 32; seq 32 and a ragged
seq 40), f32, the same numpy weights on both sides (carried across by
``transformer_state_dict_from_flax``).  The JAX side reaches its fused
Pallas attention in interpret mode through
``THEANOMPI_TPU_ATTN_IMPL=pallas`` (set with ``monkeypatch``, as the JAX
package's own tests reach the kernel on the CPU); the port's attention
takes its plain versions on CPU tensors.

* the eval logits;
* one BSP step under sgd and under adamw on a one-device mesh: the loss,
  every gradient and every parameter after the update, against
  ``jax.grad`` of the JAX model's own ``loss_fn`` and its ``train_step``;
  the same with ``ModelConfig.remat`` on both sides, and the remat net
  against the plain one bit for bit (loss and gradients);
* ``SeqLM_data``'s streams (train by epoch, rank blocks, validation),
  byte-identical; ``_lm_train_flops``, equal.

Tolerances as the AlexNet step of test_torch_alexnet.py (f32; matmuls,
the attention's sums and their gradients in different orders):
``rtol=1e-4``, floor ``1e-5 * max|want|`` for the logits and
``1e-4 * max|want|`` for the step (the updated parameters too, under
both optimizers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu.data.lm import SeqLM_data as JaxSeqLM
from theanompi_tpu.models.base import ModelConfig as JaxConfig
from theanompi_tpu.models.transformer import TransformerLM as JaxLM
from theanompi_tpu.models.transformer import TransformerLMNet as JaxNet
from theanompi_tpu.models.transformer import _lm_train_flops as jax_flops
from theanompi_tpu.parallel.mesh import data_mesh, shard_batch
from theanompi_tpu_torch.data.lm import SeqLM_data
from theanompi_tpu_torch.models import transformer as T
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.bridge import transformer_state_dict_from_flax
from theanompi_tpu_torch.ops import _kernels

DIMS = dict(vocab=32, n_layers=2, d_model=64, n_heads=4)


@pytest.fixture
def pallas_attention(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_ATTN_IMPL", "pallas")


def random_params(seed: int, seq_len: int = 32):
    """numpy flax ``params`` of the tiny net: matrices N(0, 1/fan_in),
    tables N(0, 0.5^2), LayerNorm scales 1 + N(0, 0.1^2), other vectors
    N(0, 0.1^2), so activations stay O(1) through the depth."""
    net = JaxNet(d_ff=4 * DIMS["d_model"], max_len=2048, **DIMS)
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, seq_len), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        elif name in ("embedding", "pos_emb"):
            v = 0.5 * rng.standard_normal(leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes["params"]))


def port_model(seq_len: int = 32, optimizer: str = "sgd", lr: float = 0.1,
               batch: int = 2, **cfg) -> T.TransformerLM:
    config = dataclasses.replace(
        T.TransformerLM.default_config(), batch_size=batch, optimizer=optimizer,
        learning_rate=lr, print_freq=0, **cfg)
    return T.TransformerLM(config=config, device="cpu", seq_len=seq_len,
                           data=SeqLM_data(vocab=DIMS["vocab"],
                                           seq_len=seq_len, n_train=8,
                                           n_val=4), **DIMS)


@pytest.mark.parametrize("seq_len", [32, 40])
def test_eval_logits_match_jax(pallas_attention, seq_len):
    params = random_params(seed=1, seq_len=seq_len)
    tokens = np.random.default_rng(2).integers(
        0, DIMS["vocab"], (2, seq_len)).astype(np.int32)
    want = np.asarray(JaxNet(d_ff=4 * DIMS["d_model"], **DIMS).apply(
        {"params": params}, jnp.asarray(tokens), train=False))
    module = T.TransformerLMNet(seq_len=seq_len, **DIMS).eval()
    module.load_state_dict(transformer_state_dict_from_flax(params))
    with torch.no_grad():
        got = module(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got.numpy(), want, floor=1e-5)


def test_bf16_logits_track_f32():
    """bf16 compute on f32 master weights: the same net in both dtypes
    on the port, logits within 5% in relative L2 (bf16 keeps 8 bits
    through 2 blocks), the residual stream and logits in their dtypes."""
    params = transformer_state_dict_from_flax(random_params(seed=4))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, DIMS["vocab"], (2, 32)).astype(np.int32))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        m = T.TransformerLMNet(seq_len=32, dtype=dt, **DIMS).eval()
        m.load_state_dict(params)
        with torch.no_grad():
            out[dt] = m(tokens)
    assert out[torch.bfloat16].dtype == torch.float32
    err = float(torch.linalg.vector_norm(out[torch.bfloat16]
                                         - out[torch.float32])
                / torch.linalg.vector_norm(out[torch.float32]))
    assert err < 0.05, err


@pytest.mark.parametrize("optimizer,lr,wd", [("sgd", 0.1, 0.0),
                                             ("adamw", 1e-3, 0.01)])
def test_bsp_step_matches_jax(pallas_attention, optimizer, lr, wd):
    seq_len = 32
    jcfg = JaxConfig(batch_size=2, n_epochs=1, optimizer=optimizer,
                     learning_rate=lr, weight_decay=wd,
                     lr_schedule="constant", print_freq=10**9)
    mesh = data_mesh(1, jax.devices()[:1])
    jm = JaxLM(config=jcfg, mesh=mesh, seq_len=seq_len, verbose=False,
               **DIMS)
    params = random_params(seed=3, seq_len=seq_len)
    data = SeqLM_data(vocab=DIMS["vocab"], seq_len=seq_len, n_train=8,
                      n_val=4)
    tokens, targets = next(iter(data.train_batches(0, 2)))
    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    rng = jax.random.key(0)
    loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {}, batch, rng)[0])(params)
    jm.compile_iter_fns("avg")
    state = jm.state.replace(params=jax.tree.map(jnp.asarray, params),
                             opt_state=jm.tx.init(params))
    state, metrics = jm.train_step(
        state, shard_batch(batch, mesh, spec=jm.batch_partition), rng)
    assert np.isclose(float(metrics["loss"]), float(loss), rtol=1e-6)
    jm.cleanup()

    model = port_model(seq_len, optimizer, lr, weight_decay=wd)
    model.module.load_state_dict(transformer_state_dict_from_flax(params))
    model.compile_iter_fns()
    out = model.train_step(model.state, (torch.from_numpy(tokens),
                                         torch.from_numpy(targets)), None)
    assert_close(float(out["loss"]), float(loss), msg="loss")
    want_g = transformer_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    want_p = transformer_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params))
    named = dict(model.module.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    for name, p in named.items():
        g = want_g[name].numpy()
        assert_close(p.grad.numpy(), g, floor=1e-4, msg=f"grad {name}")
        assert_close(p.detach().numpy(), want_p[name].numpy(), floor=1e-4,
                     msg=f"param {name}")


def test_session_trains_on_the_plain_versions(tmp_path):
    """``run_bsp_session`` on the CPU: every loss finite, the loss falls
    over the epoch, and the K4 kernels were never launched (CPU tensors
    take the plain versions); validation runs its batches."""
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    config = dataclasses.replace(
        T.TransformerLM.default_config(), batch_size=8, n_epochs=1,
        optimizer="adamw", learning_rate=1e-2, weight_decay=0.01,
        print_freq=4, snapshot_dir=str(tmp_path))
    model = T.TransformerLM(config=config, device="cpu", seq_len=16,
                            data=SeqLM_data(vocab=DIMS["vocab"], seq_len=16,
                                            n_train=96, n_val=16), **DIMS)
    before = _kernels.launch_counts()
    result = run_bsp_session(model)
    rec = result["records"][0]
    assert rec["train_steps"] == 12 and rec["val_batches"] == 2
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    for part in ("train", "val"):
        assert {k: v for k, v in rec["launches"][part].items()
                if k.startswith("attention")} == {
            "attention": 0, "attention_bwd_dq": 0, "attention_bwd_dkdv": 0}
    assert _kernels.launch_counts() == before
    assert model.train_flops_per_sample > 0


def test_seqlm_streams_byte_identical_to_jax():
    kw = dict(vocab=40, seq_len=24, n_train=48, n_val=20, seed=3)
    jd, td = JaxSeqLM(**kw), SeqLM_data(**kw)
    np.testing.assert_array_equal(jd.table, td.table)
    assert (jd.n_train, jd.n_val, jd.sample_shape, jd.n_classes) == (
        td.n_train, td.n_val, td.sample_shape, td.n_classes)

    def same(a, b):
        a, b = list(a), list(b)
        assert len(a) == len(b) and a
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.dtype == xb.dtype == ya.dtype == yb.dtype == np.int32
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)

    for epoch in (0, 1):
        same(jd.train_batches(epoch, 8), td.train_batches(epoch, 8))
        for rank in (0, 1):
            same(jd.host_train_batches(epoch, 8, rank, 2),
                 td.host_train_batches(epoch, 8, rank, 2))
    same(jd.val_batches(8), td.val_batches(8))
    for rank in (0, 1):
        same(jd.host_val_batches(8, rank, 2), td.host_val_batches(8, rank, 2))


@pytest.mark.parametrize("dims", [DIMS, dict(vocab=256, n_layers=12,
                                             d_model=768, n_heads=12)])
def test_train_flops_equal_jax(dims):
    seq_len = 1024 if dims["n_layers"] == 12 else 32
    net = JaxNet(d_ff=4 * dims["d_model"], max_len=max(2048, seq_len),
                 **dims)
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, seq_len), jnp.int32))["params"]
    want = jax_flops(shapes, dims["n_layers"], seq_len, dims["d_model"])
    module = T.TransformerLMNet(seq_len=seq_len, **dims)
    assert T._lm_train_flops(module, dims["n_layers"], seq_len,
                             dims["d_model"]) == want
    # the bridge maps every leaf of the net onto the port's state_dict
    assert set(transformer_state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))) == set(
        module.state_dict())


def test_recipe_and_refusals():
    """The recipe, and the variants that once refused: ``remat`` builds
    under the non-remat names, the TP, PP and MoE models build on one
    process (every axis of degree 1) with JAX's names and batch
    partitions, and an unknown SP strategy and an over-long sequence
    still refuse."""
    assert T.TransformerLM.default_config() == ModelConfig(
        batch_size=16, n_epochs=5, learning_rate=0.1, momentum=0.9,
        weight_decay=0.0, lr_schedule="constant", print_freq=20)
    model = port_model()
    assert model._net_cfg == dict(vocab=32, seq_len=32, n_layers=2,
                                  d_model=64, n_heads=4)
    assert model.module.max_len == 2048
    remat = port_model(remat=True)
    assert remat.module.remat and [n for n, _ in
                                   remat.module.named_parameters()] == [
        n for n, _ in model.module.named_parameters()]
    assert (T.TransformerLM.batch_partition, T.TransformerLM.seq_axis) == (
        ("data", "seq"), "seq")
    for cls, name, part in (
            (T.TransformerLM_TP, "transformer_lm_tp", ("data",)),
            (T.TransformerLM_PP, "transformer_lm_pp", ("data",)),
            (T.TransformerLM_MoE, "transformer_lm_moe", (("data", "expert"),))):
        m = cls(device="cpu", data=SeqLM_data(vocab=256, seq_len=128,
                                              n_train=64, n_val=16))
        assert (m.name, m.batch_partition) == (name, part)
        assert m.train_flops_per_sample > 0
    with pytest.raises(ValueError, match="unknown sequence-parallel "
                                         "strategy 'tree'"):
        T.sequence_attention(*[torch.zeros(1, 4, 2, 4)] * 3, strategy="tree")
    with pytest.raises(ValueError, match="max_len"):
        model.module.eval()(torch.zeros(1, 2049, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_same_loss_and_grads_bit_for_bit(dtype):
    """``ModelConfig.remat`` (each block under ``checkpoint``): the same
    parameter names, and the same loss and gradients bit for bit as the
    plain net (the recompute runs the same ops on the same inputs), in
    f32 and in bf16 compute (JAX's ``test_remat_identical_params_and_
    grads`` holds its two programs to 1e-5: XLA may fuse them apart)."""
    sd = transformer_state_dict_from_flax(random_params(seed=6))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, DIMS["vocab"], (2, 32)).astype(np.int32))
    out = {}
    for remat in (False, True):
        net = T.TransformerLMNet(seq_len=32, dtype=dtype, remat=remat,
                                 **DIMS).train()
        net.load_state_dict(sd)
        loss = (net(tokens, train=True) ** 2).mean()
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      net.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    assert out[False][1].keys() == out[True][1].keys()
    for n, g in out[False][1].items():
        assert torch.equal(g, out[True][1][n]), n


def test_remat_step_matches_jax_remat_step(pallas_attention):
    """One BSP step of the remat model against JAX's remat model on a
    one-device mesh, under the step test's limits."""
    seq_len = 32
    jcfg = JaxConfig(batch_size=2, n_epochs=1, learning_rate=0.1,
                     weight_decay=0.0, lr_schedule="constant",
                     print_freq=10**9, remat=True)
    mesh = data_mesh(1, jax.devices()[:1])
    jm = JaxLM(config=jcfg, mesh=mesh, seq_len=seq_len, verbose=False,
               **DIMS)
    params = random_params(seed=8, seq_len=seq_len)
    data = SeqLM_data(vocab=DIMS["vocab"], seq_len=seq_len, n_train=8,
                      n_val=4)
    tokens, targets = next(iter(data.train_batches(0, 2)))
    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    jm.compile_iter_fns("avg")
    state = jm.state.replace(params=jax.tree.map(jnp.asarray, params),
                             opt_state=jm.tx.init(params))
    state, metrics = jm.train_step(
        state, shard_batch(batch, mesh, spec=jm.batch_partition),
        jax.random.key(0))
    jm.cleanup()
    model = port_model(seq_len, remat=True)
    model.module.load_state_dict(transformer_state_dict_from_flax(params))
    model.compile_iter_fns()
    out = model.train_step(model.state, (torch.from_numpy(tokens),
                                         torch.from_numpy(targets)), None)
    assert_close(float(out["loss"]), float(metrics["loss"]), msg="loss")
    want_p = transformer_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params))
    for name, p in model.module.named_parameters():
        assert_close(p.detach().numpy(), want_p[name].numpy(), floor=1e-4,
                     msg=f"param {name}")
