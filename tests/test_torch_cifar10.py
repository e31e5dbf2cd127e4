"""The port's Cifar10 slice on the CPU against the JAX package.

* The network (f32, the JAX model's shapes and names): the eval forward
  and one BSP step of the recipe (SGD, momentum 0.9, wd 1e-4) against
  JAX's loss and optax, on the same numpy weights and inputs; tolerances
  as test_torch_zoo.py's (``rtol=1e-4``, floors ``1e-5`` / ``1e-4`` of
  each tensor's largest magnitude).
* The data: ``Cifar10_data``'s train and val streams byte-identical to
  the JAX package's, synthetic (with ``label_noise``, whose realized
  fractions are equal too) and from a pickled ``cifar-10-batches-py``
  and an ``.npz`` the tests write; the host augment (4-pixel reflect
  pad, crop, mirror, normalize) within ``rtol=1e-6`` (the same f32 ops;
  XLA's and numpy's may round the normalization differently by an ulp).
* The padded device augment against JAX's ``make_device_augment(...,
  pad=4)``: eval exactly the image normalized, train with JAX's draws
  replayed through ``crop_flip_normalize``, ``rtol=1e-6``.
* ``launcher BSP --platform cpu -m theanompi_tpu_torch.models.cifar10
  -c Cifar10_model`` for a few steps.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import assert_close, two_torch_threads  # noqa: F401
from test_torch_zoo import (
    assert_step_matches,
    forward_both,
    jax_step,
    jax_variables,
    port_step,
)
from theanompi_tpu.data.cifar10 import Cifar10_data as JaxCifar
from theanompi_tpu.models.cifar10 import Cifar10_model as JaxCifarModel
from theanompi_tpu.models.cifar10 import Cifar10CNN as JaxCifarCNN
from theanompi_tpu.ops.augment import make_device_augment as jax_augment
from theanompi_tpu_torch.data.cifar10 import (
    CIFAR_MEAN,
    CIFAR_STD,
    Cifar10_data,
)
from theanompi_tpu_torch.models.cifar10 import Cifar10_model, Cifar10CNN
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.ops import _kernels
from theanompi_tpu_torch.ops.augment import crop_flip_normalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_eval_forward_matches_jax():
    jmod = JaxCifarCNN()
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=1)
    x = np.random.default_rng(2).standard_normal((5, 32, 32, 3)).astype(
        np.float32)
    got, want = forward_both(jmod, Cifar10CNN(), variables, x)
    assert got.shape == (5, 10)
    assert_close(got, want, floor=1e-5)


def test_bsp_step_matches_jax_and_optax():
    jmod = JaxCifarCNN()
    variables = jax_variables(jmod, (2, 32, 32, 3), seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    want = jax_step(jmod, variables, x, y, lr=0.01, weight_decay=1e-4)
    config = ModelConfig(**{**Cifar10_model.default_config().__dict__,
                            "batch_size": 8, "print_freq": 0})
    model = Cifar10_model(config=config, device="cpu",
                          data=Cifar10_data(synthetic_n=64))
    assert_step_matches(model, port_step(model, variables, x, y), want)


def test_recipe_inits_and_cpu_launches():
    cfg = Cifar10_model.default_config()
    assert cfg.__dict__ == JaxCifarModel.default_config().__dict__
    model = Cifar10_model(device="cpu", data=Cifar10_data(synthetic_n=64))
    assert not model.uses_batchnorm and model.name == "cifar10"
    m = model.module
    assert float(m.Conv_2.bias.abs().max()) == 0.0
    # He-normal on the 5x5x32 fan-in, truncated at two std
    w = m.Conv_1.weight.detach()
    std = np.sqrt(2.0 / (32 * 25))
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert abs(float(w.std()) - std) < 0.1 * std
    assert abs(float(m.Dense_1.weight.std()) - 0.01) < 1e-3
    before = _kernels.launch_counts()
    with torch.no_grad():
        m(torch.zeros(2, 32, 32, 3))
    assert _kernels.launch_counts() == before      # CPU: plain versions


@pytest.mark.parametrize("on_device", [True, False])
def test_synthetic_streams_with_label_noise_byte_identical_to_jax(on_device):
    kw = dict(synthetic_n=320, seed=3, label_noise=0.2,
              augment_on_device=on_device)
    jd, td = JaxCifar(**kw), Cifar10_data(**kw)
    assert (jd.n_train, jd.n_val) == (td.n_train, td.n_val) == (320, 256)
    assert td.train_noise_frac == jd.train_noise_frac > 0.1
    assert td.val_noise_frac == jd.val_noise_frac > 0.1
    for epoch in (0, 1):
        if on_device:
            _same_stream(jd.train_batches(epoch, 64),
                         td.train_batches(epoch, 64))
            for rank in (0, 1):
                _same_stream(jd.host_train_batches(epoch, 64, rank, 2),
                             td.host_train_batches(epoch, 64, rank, 2))
        else:
            for (xa, ya), (xb, yb) in zip(jd.train_batches(epoch, 64),
                                          td.train_batches(epoch, 64)):
                np.testing.assert_array_equal(ya, yb)
                assert xb.dtype == np.float32
                assert_close(xb, xa, rtol=1e-6, floor=1e-6)
    if on_device:
        _same_stream(jd.val_batches(64), td.val_batches(64))
    else:
        for (xa, ya), (xb, yb) in zip(jd.val_batches(64),
                                      td.val_batches(64)):
            np.testing.assert_array_equal(ya, yb)
            assert_close(xb, xa, rtol=1e-6, floor=1e-6)
    assert jd.n_train_batches_for(1, 64) == td.n_train_batches_for(1, 64)


def _write_pickles(d, rng):
    """A small ``cifar-10-batches-py``: 5 train batches of 12 and a test
    batch of 10, rows of 3072 bytes (R, G, B planes)."""
    os.makedirs(d)
    for name, n in [(f"data_batch_{i}", 12) for i in range(1, 6)] + [
            ("test_batch", 10)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)


def test_pickled_and_npz_batches_load_as_jax_does(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    root = tmp_path / "pickled"
    _write_pickles(str(root / "cifar-10-batches-py"), rng)
    for on_device in (True, False):
        kw = dict(data_dir=str(root), seed=1, augment_on_device=on_device)
        jd, td = JaxCifar(**kw), Cifar10_data(**kw)
        assert not td.synthetic and (td.n_train, td.n_val) == (60, 10)
        np.testing.assert_array_equal(td.x_train, jd.x_train)
        np.testing.assert_array_equal(td.y_val, jd.y_val)
        assert td.x_train.shape == (60, 32, 32, 3)
        if on_device:
            _same_stream(jd.train_batches(2, 20), td.train_batches(2, 20))
            _same_stream(jd.val_batches(5), td.val_batches(5))
    with pytest.raises(ValueError, match="label_noise"):
        Cifar10_data(data_dir=str(root), label_noise=0.1)
    npz = tmp_path / "npz"
    npz.mkdir()
    arrays = dict(x_train=rng.integers(0, 256, (24, 32, 32, 3),
                                       dtype=np.uint8),
                  y_train=rng.integers(0, 10, 24),
                  x_test=rng.integers(0, 256, (8, 32, 32, 3),
                                      dtype=np.uint8),
                  y_test=rng.integers(0, 10, 8))
    np.savez(npz / "cifar10.npz", **arrays)
    monkeypatch.setenv("THEANOMPI_TPU_DATA", str(npz))
    jd, td = JaxCifar(seed=2), Cifar10_data(seed=2)
    assert not td.synthetic and td.y_train.dtype == np.int32
    _same_stream(jd.train_batches(0, 8), td.train_batches(0, 8))


def test_padded_device_augment_matches_jax():
    x = np.random.default_rng(6).integers(0, 256, (5, 32, 32, 3),
                                          dtype=np.uint8)
    aug = jax_augment(32, CIFAR_MEAN, CIFAR_STD, pad=4)
    td = Cifar10_data(synthetic_n=64, augment_on_device=True)
    want = np.asarray(aug(jnp.asarray(x), None, False))
    got = td.device_transform(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 32, 32, 3)
    assert_close(got, want, rtol=1e-6, floor=1e-7)
    key = jax.random.key(3)
    want = np.asarray(aug(jnp.asarray(x), key, True))
    ky, kx, kf = jax.random.split(key, 3)
    ys, xs = (np.array(jax.random.randint(k, (5,), 0, 9)) for k in (ky, kx))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (5,)))
    got = crop_flip_normalize(
        torch.from_numpy(x), torch.from_numpy(ys), torch.from_numpy(xs),
        torch.from_numpy(flips), 32, torch.tensor(CIFAR_MEAN),
        torch.tensor(CIFAR_STD), pad=4).numpy()
    assert_close(got, want, rtol=1e-6, floor=1e-7)
    # the reflect pad reaches the frame's mirror pixels, edge not repeated
    corner = crop_flip_normalize(
        torch.from_numpy(x), torch.zeros(5, dtype=torch.long),
        torch.zeros(5, dtype=torch.long), torch.zeros(5, dtype=torch.bool),
        3, torch.zeros(3), torch.ones(3), pad=4).numpy()
    scaled = x.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(corner[:, 0, 0], scaled[:, 4, 4])
    np.testing.assert_array_equal(corner[:, 2, 1], scaled[:, 2, 3])
    # train: offsets within the padded frame, flips drawn from the rng
    gen = torch.Generator().manual_seed(0)
    out = td.device_transform(torch.from_numpy(x), gen, train=True)
    assert out.shape == (5, 32, 32, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="Generator"):
        td.device_transform(torch.from_numpy(x), None, train=True)


def test_launcher_trains_cifar10_on_the_cpu(tmp_path):
    """``python -m theanompi_tpu_torch.launcher BSP --platform cpu -m
    theanompi_tpu_torch.models.cifar10 -c Cifar10_model``: the default
    synthetic pool (4096 images) at batch 512, 8 steps and one
    validation batch, every loss finite and no kernel launched."""
    out = tmp_path / "result.json"
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.launcher", "BSP",
           "-D", "1", "--platform", "cpu", "-m",
           "theanompi_tpu_torch.models.cifar10", "-c", "Cifar10_model",
           "--epochs", "1", "--snapshot-dir", str(tmp_path), "--set",
           "batch_size=512", "--set", "print_freq=4", "--result-json",
           str(out)]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    res = json.loads(out.read_text())
    (rec,) = res["records"]
    assert (rec["train_steps"], rec["val_batches"]) == (8, 1)
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    assert not any(rec["launches"]["train"].values())
    assert res["world_size"] == 1 and res["device"] == "cpu"
