"""The port's Wasserstein GAN on the CPU against the JAX package's: the
generator and critic, ``ConvTranspose``, the round on one device and on
two gloo ranks, the eval W estimate, ``WGANCifar_data``, the refusals,
the checkpoint payload, ``save``/``load``/``generate`` and the launcher
with a resume.

The networks run at width 8 (both built at 16, JAX's ``width * 2``) in
f32; the same weights go to both packages through the bridge (JAX's
init, whose critic is clipped to 0.01) and the same noise: the test
derives each rank's ``z`` as JAX's ``shard_step`` does (the step key
folded with the axis index, then ``n_critic`` splits of ``fold_in(.,
0)`` for the critic and ``fold_in(., 1)`` for the generator) and hands
it to the port's round.  Tolerances: a forward at ``rtol=1e-4``, floor
``1e-5 * max|want|`` (f32, sums in different orders: test_torch_zoo.py's
forward tolerance); the round's two losses, which are differences of
means of small critic scores (about 1e-5 at this width) and so carry
f32's summation-order noise at about 1e-6 of their size (4.5e-6
measured), within relative 1e-4; each network's update over the round
(parameters after less before; the parameters themselves barely move:
the generator's by 3e-6 of their norm) within relative L2 1e-5.
RMSprop's first step ``g / sqrt(0.1 g^2 + 1e-8)`` is about ``sqrt(10)
sign(g)`` where ``|g| >> 3e-4`` and linear in ``g`` below, so its
relative error is at most ``g``'s (2.3e-6 measured on the worst leaf).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from theanompi_tpu_torch.models.wasserstein_gan import (
    Wasserstein_GAN,
    WGANCifar_data,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, BATCH, LATENT, N_CRITIC = 8, 4, 100, 5
LOSS_RTOL, PARAM_REL_L2 = 1e-4, 1e-5


def port_config(**kw):
    return dataclasses.replace(Wasserstein_GAN.default_config(),
                               batch_size=BATCH, print_freq=0, **kw)


class TinyWGAN(Wasserstein_GAN):
    """The launcher's model class: width 8 and a synthetic pool of 160
    training rows (8 rounds of 20 at batch 4) and 256 validation rows
    (12 batches)."""

    @classmethod
    def default_config(cls):
        return port_config()

    def __init__(self, config=None, device="cuda", data=None):
        cfg = config or self.default_config()
        super().__init__(cfg, device, width=WIDTH, data=data or
                         WGANCifar_data(synthetic_n=160, seed=cfg.seed))


def jax_model(world: int = 1, **cfg):
    import jax

    from theanompi_tpu.models.base import ModelConfig
    from theanompi_tpu.models.wasserstein_gan import Wasserstein_GAN
    from theanompi_tpu.parallel.mesh import data_mesh

    base = dataclasses.asdict(port_config(**cfg))
    base["lr_decay_epochs"] = tuple(base["lr_decay_epochs"])
    return Wasserstein_GAN(
        config=ModelConfig(**base),
        mesh=data_mesh(world, jax.devices()[:world]), verbose=False,
        width=WIDTH)


def port_model(params=None, **cfg):
    model = Wasserstein_GAN(config=port_config(**cfg), device="cpu",
                            width=WIDTH)
    if params is not None:
        model._load_params(model.module, params)
    return model


def jax_noise(key, rank: int, b: int):
    """Rank ``rank``'s noise of one JAX round: ((n_critic, b, latent),
    (b, latent))."""
    import jax

    r = jax.random.fold_in(key, rank)
    keys = jax.random.split(jax.random.fold_in(r, 0), N_CRITIC)
    zc = np.stack([np.asarray(jax.random.normal(k, (b, LATENT)))
                   for k in keys])
    zg = np.asarray(jax.random.normal(jax.random.fold_in(r, 1), (b, LATENT)))
    return zc.astype(np.float32), zg.astype(np.float32)


def _params_np(jm) -> dict:
    import jax

    return jax.tree.map(np.asarray, {"generator": jm.state.gen_params,
                                     "critic": jm.state.critic_params})


def _flat(tree: dict, net: str) -> np.ndarray:
    import jax

    return np.concatenate([a.ravel() for a in jax.tree.leaves(tree[net])])


def update_rel_l2(got: dict, want: dict, before: dict) -> dict:
    """Per network, the relative L2 distance of the round's two updates
    (parameters after less before), each a flax tree."""
    out = {}
    for net in ("generator", "critic"):
        g, w = (_flat(t, net) - _flat(before, net) for t in (got, want))
        out[net] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return out


def _clipped(model) -> bool:
    return all(float(p.detach().abs().max()) <= model.clip_c
               for p in model.module["critic"].parameters())


# -- layers and networks ------------------------------------------------------


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_matches_flax(kernel, stride, padding):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.models.bridge import zoo_state_dict_from_flax

    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    flax_ct = fnn.ConvTranspose(4, (kernel, kernel), strides=(stride, stride),
                                padding=padding)
    params = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        flax_ct.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = np.asarray(flax_ct.apply({"params": params}, jnp.asarray(x)))
    ct = L.ConvTranspose(3, 4, (kernel, kernel), (stride, stride), padding)
    ct.load_state_dict({k.split(".", 1)[1]: v for k, v in
                        zoo_state_dict_from_flax(torch.nn.ModuleDict(
                            {"ct": ct}), {"ct": params}).items()})
    got = ct(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert_close(got, want, floor=1e-5)


def test_conv_transpose_refuses_a_pad_it_cannot_express():
    from theanompi_tpu_torch.models import layers as L

    with pytest.raises(ValueError, match="want 'SAME'"):
        L.ConvTranspose(3, 4, (3, 3), (2, 2), ((1, 1), (1, 1)))


def test_generator_and_critic_match_flax():
    """Both networks on flax's init tree with every leaf redrawn (so the
    biases are not zero), bridged."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.models.wasserstein_gan import Critic as JC
    from theanompi_tpu.models.wasserstein_gan import Generator as JG
    from theanompi_tpu_torch.models.bridge import module_params_from_flax
    from theanompi_tpu_torch.models.wasserstein_gan import Critic, Generator

    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, LATENT)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    for jnet, net, inp in ((JG(width=2 * WIDTH), Generator(2 * WIDTH), z),
                           (JC(width=2 * WIDTH), Critic(2 * WIDTH), x)):
        shapes = jnet.init(jax.random.key(0), jnp.asarray(inp))["params"]
        params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(
            a.shape)).astype(np.float32), shapes)
        want = np.asarray(jnet.apply({"params": params}, jnp.asarray(inp)))
        net.load_state_dict(module_params_from_flax(net, params))
        with torch.no_grad():
            got = net(torch.from_numpy(inp)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert_close(got, want, floor=1e-5, msg=type(net).__name__)


# -- the round ----------------------------------------------------------------


def test_one_round_matches_jax():
    """One device: the same weights, real rows and noise; both losses,
    both networks after the round, the clip."""
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.parallel.mesh import shard_batch

    jm = jax_model()
    jm.compile_iter_fns()
    params = _params_np(jm)
    model = port_model(params)
    model.compile_iter_fns()
    rng = np.random.default_rng(2)
    rows = N_CRITIC * BATCH
    x = rng.uniform(-1, 1, (rows, 32, 32, 3)).astype(np.float32)
    y = np.zeros(rows, np.int32)
    key = jax.random.key(5)
    zc, zg = jax_noise(key, 0, BATCH)
    state, want = jm.train_step(jm.state, shard_batch(
        (jnp.asarray(x), jnp.asarray(y)), jm.mesh), key)
    got = model.round(model.state, (torch.from_numpy(x), torch.from_numpy(y)),
                      None, noise=(torch.from_numpy(zc),
                                   torch.from_numpy(zg)))
    for k in ("loss", "error"):
        assert abs(float(got[k]) - float(want[k])) <= LOSS_RTOL * abs(
            float(want[k])), k
    jm.state = state
    rel = update_rel_l2(model.params, _params_np(jm), params)
    assert max(rel.values()) < PARAM_REL_L2, rel
    assert model.state.step == 1 and _clipped(model)


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank's round on its rows with its noise."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        params = torch.load(os.path.join(workdir, "params.pt"),
                            weights_only=False)
        model = port_model(params)
        model.compile_iter_fns()
        per = len(data["x"]) // world
        rows = slice(rank * per, (rank + 1) * per)
        metrics = model.round(
            model.state, (torch.from_numpy(data["x"][rows]),
                          torch.from_numpy(data["y"][rows])), None,
            noise=(torch.from_numpy(data[f"zc{rank}"]),
                   torch.from_numpy(data[f"zg{rank}"])))
        torch.save({"params": model.params, "clipped": _clipped(model),
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(workdir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_rank_round_matches_jax(tmp_path, devices8):
    """Two gloo ranks against JAX's round on a 2-device mesh: rank r
    takes rows ``[r n_critic b, (r + 1) n_critic b)`` and JAX's noise of
    axis index r; the exchanged gradients average over the ranks."""
    import jax
    import jax.numpy as jnp

    from test_torch_exchange import spawn_ranks
    from theanompi_tpu.parallel.mesh import shard_batch

    jm = jax_model(world=2)
    jm.compile_iter_fns()
    params = _params_np(jm)
    rng = np.random.default_rng(3)
    rows = 2 * N_CRITIC * BATCH
    x = rng.uniform(-1, 1, (rows, 32, 32, 3)).astype(np.float32)
    y = np.zeros(rows, np.int32)
    key = jax.random.key(7)
    noise = {}
    for r in range(2):
        noise[f"zc{r}"], noise[f"zg{r}"] = jax_noise(key, r, BATCH)
    np.savez(tmp_path / "inputs.npz", x=x, y=y, **noise)
    torch.save(params, tmp_path / "params.pt")
    spawn_ranks(os.path.abspath(__file__), tmp_path, timeout=240)
    state, want = jm.train_step(jm.state, shard_batch(
        (jnp.asarray(x), jnp.asarray(y)), jm.mesh), key)
    jm.state = state
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    for net in ("generator", "critic"):         # replicas stay identical
        for a, b in zip(jax.tree.leaves(outs[0]["params"][net]),
                        jax.tree.leaves(outs[1]["params"][net])):
            np.testing.assert_array_equal(a, b)
    for k in ("loss", "error"):
        assert outs[0]["metrics"][k] == outs[1]["metrics"][k]
        assert abs(outs[0]["metrics"][k] - float(want[k])) <= (
            LOSS_RTOL * abs(float(want[k]))), k
    rel = update_rel_l2(outs[0]["params"], _params_np(jm), params)
    assert max(rel.values()) < PARAM_REL_L2, rel
    assert outs[0]["clipped"]


def test_eval_w_estimate_matches_jax():
    import jax
    import jax.numpy as jnp

    from theanompi_tpu.parallel.mesh import shard_batch

    jm = jax_model()
    jm.compile_iter_fns()
    model = port_model(_params_np(jm))
    model.compile_iter_fns()
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    y = np.zeros(8, np.int32)
    key = jax.random.key(9)
    want = jm.eval_step(jm.state, shard_batch(
        (jnp.asarray(x), jnp.asarray(y)), jm.mesh), key)
    z = np.array(jax.random.normal(jax.random.fold_in(key, 0), (8, LATENT)),
                 np.float32)
    got = model.evaluate(model.state, (torch.from_numpy(x),
                                       torch.from_numpy(y)),
                         noise=torch.from_numpy(z))
    assert float(got["error"]) == float(want["error"]) == 0.0
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        LOSS_RTOL * abs(float(want["loss"])))


# -- data, refusals, contract -------------------------------------------------


def test_wgan_data_streams_match_jax():
    """Host-augmented train batches of two epochs and the val batches,
    byte for byte, scaled to [-1, 1]."""
    from theanompi_tpu.models.wasserstein_gan import WGANCifar_data as J
    from theanompi_tpu_torch.models.wasserstein_gan import WGANCifar_data as T

    jd, td = J(synthetic_n=256, seed=3), T(synthetic_n=256, seed=3)
    assert not td.augment_on_device and td.mean == td.std == (0.5,) * 3
    for epoch in (0, 1):
        for (jx, jy), (tx, ty) in zip(jd.train_batches(epoch, 40),
                                      td.train_batches(epoch, 40),
                                      strict=True):
            assert jx.tobytes() == tx.tobytes() and (jy == ty).all()
    for (jx, jy), (tx, ty) in zip(jd.val_batches(40), td.val_batches(40),
                                  strict=True):
        assert jx.tobytes() == tx.tobytes() and (jy == ty).all()
    assert -1.0 <= tx.min() and tx.max() <= 1.0


@pytest.mark.parametrize("knob", [
    dict(grad_accum_steps=2), dict(zero_sharding=True),
    dict(fsdp_sharding=True),
    dict(exchange_dtype="bf16", exchange_error_feedback=True),
    dict(exchange_buckets=2)])
def test_refusals_match_jax(knob):
    with pytest.raises(ValueError) as want:
        jax_model(**knob).compile_iter_fns()
    with pytest.raises(ValueError) as got:
        port_model(**knob).compile_iter_fns()
    assert str(got.value) == str(want.value)


def test_steps_per_call_is_refused():
    """JAX builds no stacked WGAN step; the port says so at compile."""
    with pytest.raises(ValueError, match="steps_per_call>1 is not "
                                         "implemented for the WGAN"):
        port_model(steps_per_call=2).compile_iter_fns()


def test_contract(tmp_path):
    """The recipe, the global batch, the init's clip, the payload's
    names, and save -> load into a fresh model -> ``generate`` bit for
    bit, with the npz holding JAX's flax paths."""
    jm = jax_model()
    model = port_model()
    assert model.global_batch == BATCH * N_CRITIC == jm.global_batch
    assert model.config == port_config()
    assert _clipped(model) and model.name == "wgan"
    assert model.adjust_hyperp(3) == 5e-5
    model.compile_iter_fns()
    payload = model.checkpoint_payload(epoch=0)
    assert set(payload) == {"step", "gen_params", "gen_opt",
                            "critic_params", "critic_opt", "epoch"}
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(0.003)
    path = model.save(str(tmp_path / "w.npz"))
    fresh = port_model()
    assert not np.array_equal(fresh.generate(8, seed=1),
                              model.generate(8, seed=1))
    fresh.load(path)
    np.testing.assert_array_equal(fresh.generate(8, seed=1),
                                  model.generate(8, seed=1))
    with np.load(path) as z:
        import jax
        from theanompi_tpu.utils.helper_funcs import _keypath_str

        want = [_keypath_str(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(np.asarray, jm.params))[0]]
        assert z.files == want
        assert "generator/ConvTranspose_0/kernel" in z.files


def test_launcher_rounds_and_resume(tmp_path):
    """``launcher BSP --platform cpu`` with the tiny WGAN: two epochs
    unbroken, and one epoch then ``--resume`` for the second; the two
    end with the same state digest, the losses are finite, the resumed
    run restores epoch 0 and the critic stays clipped."""
    def run(name, *extra):
        out = tmp_path / f"{name}.json"
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.launcher", "BSP",
               "-D", "1", "--platform", "cpu", "-m", "test_torch_wgan",
               "-c", "TinyWGAN", "--snapshot-dir", str(tmp_path / name),
               "--set", "n_epochs=2", "--result-json", str(out), *extra]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           cwd=REPO, env=dict(
                               os.environ, OMP_NUM_THREADS="2",
                               PYTHONPATH=os.pathsep.join(
                                   [REPO, os.path.join(REPO, "tests")])))
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
        with open(out) as f:
            return json.load(f)

    whole = run("whole")
    run("resumed", "--epochs", "1")
    resumed = run("resumed", "--resume")
    assert whole["epochs_run"] == 2 and resumed["epochs_run"] == 1
    assert resumed["checkpoint"]["restore"]["epoch"] == 0
    assert resumed["state_digests"] == whole["state_digests"]
    for rec in whole["records"] + resumed["records"]:
        assert rec["train_steps"] == 8 and rec["val_batches"] == 12
        assert np.isfinite(rec["train_loss"]) and np.isfinite(
            rec["val_loss"])
        assert all(v == 0 for part in rec["launches"].values()
                   for v in part.values())
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "whole" / "wgan"), read_only=True)
    payload = ck.restore(1)
    ck.close()
    assert payload["step"] == 16
    assert max(float(v.abs().max())
               for v in payload["critic_params"].values()) <= 0.01


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
