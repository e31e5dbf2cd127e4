"""The port's native host augment (``theanompi_tpu_torch/native``)
against the JAX package: bitwise equal to JAX's numpy oracle and to
JAX's native library on the same seeded uint8 batches, the dataset
wrappers equal to JAX's on the same seed, the same refusals, the numpy
path where no ``g++`` exists, a raised error where ``g++`` exists and
the build fails, and the call counter."""

from __future__ import annotations

import os

import numpy as np
import pytest

from theanompi_tpu import native as jax_native
from theanompi_tpu.data import utils as jax_utils
from theanompi_tpu_torch import native
from theanompi_tpu_torch.data import utils

CIFAR = ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616))
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

# name: (n, h, w, crop, pad, flip share)
CASES = {
    "cifar": (16, 32, 32, 32, 4, 0.5),
    "imagenet": (4, 256, 256, 224, 0, 0.5),
    "pad_above_image": (6, 4, 4, 8, 6, 0.5),
    "flip_mix": (10, 40, 36, 24, 2, 0.3),
}


@pytest.fixture
def fresh_native(monkeypatch):
    """The native module with no library bound yet; restored after."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native


def seeded(name, seed=0):
    n, h, w, crop, pad, share = CASES[name]
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    ys = rng.integers(0, h + 2 * pad - crop + 1, size=n)
    xs = rng.integers(0, w + 2 * pad - crop + 1, size=n)
    flips = rng.random(n) < share
    flips[0], flips[-1] = True, False
    mean, std = (np.asarray(a, np.float32)
                 for a in (IMAGENET if name == "imagenet" else CIFAR))
    return images, ys, xs, flips, crop, pad, mean, std


def jax_oracle(images, ys, xs, flips, crop, pad, mean, std):
    out = jax_utils._gather_crops(images, ys, xs, flips, crop, crop, pad)
    return jax_utils.normalize(out.astype(np.float32) / 255.0, mean, std)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_bitwise_equal_to_jax_oracle_and_library(name, threads):
    images, ys, xs, flips, crop, pad, mean, std = seeded(name)
    assert native.native_available() and jax_native.native_available()
    got = native.crop_flip_normalize(images, ys, xs, flips, crop, crop,
                                     mean, std, pad=pad, n_threads=threads)
    want = jax_oracle(images, ys, xs, flips, crop, pad, mean, std)
    lib = jax_native.crop_flip_normalize(images, ys, xs, flips, crop, crop,
                                         mean, std, pad=pad,
                                         n_threads=threads)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lib)


@pytest.mark.parametrize("name", ["cifar", "imagenet", "flip_mix"])
def test_dataset_wrappers_equal_jaxs(name, monkeypatch):
    images, _, _, _, crop, pad, mean, std = seeded(name, seed=3)
    calls = native.CALLS.value
    got = utils.augment_normalize(images, crop, crop,
                                  np.random.default_rng(11), mean=mean,
                                  std=std, pad=pad)
    want = jax_utils.augment_normalize(images, crop, crop,
                                       np.random.default_rng(11),
                                       pad=pad, mean=mean, std=std)
    np.testing.assert_array_equal(got, want)
    assert native.CALLS.value == calls + 1
    if pad == 0:
        got_c = utils.center_normalize(images, crop, crop, mean=mean,
                                       std=std)
        want_c = jax_utils.center_normalize(images, crop, crop, mean=mean,
                                            std=std)
        np.testing.assert_array_equal(got_c, want_c)
        assert native.CALLS.value == calls + 2
    # and equal to the port's own numpy path on the same seed
    monkeypatch.setattr(utils, "_use_native", lambda images: False)
    plain = utils.augment_normalize(images, crop, crop,
                                    np.random.default_rng(11), mean=mean,
                                    std=std, pad=pad)
    np.testing.assert_array_equal(got, plain)


def test_cifar10_dataset_batches_take_the_native_path():
    from theanompi_tpu_torch.data.cifar10 import Cifar10_data

    data = Cifar10_data(synthetic_n=64, seed=1,
                        augment_on_device=False)
    calls = native.CALLS.value
    x, _ = next(iter(data.train_batches(epoch=0, global_batch=16)))
    assert x.dtype == np.float32 and x.shape == (16, 32, 32, 3)
    assert native.CALLS.value == calls + 1


def _refusal(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", [
    "float_images", "ndim", "mean_shape", "ys_shape", "y_range", "x_range",
    "negative"])
def test_refusals_match_jaxs(case):
    images, ys, xs, flips, crop, pad, mean, std = seeded("flip_mix")
    args = dict(images=images, ys=ys, xs=xs, flips=flips, crop_h=crop,
                crop_w=crop, mean=mean, std=std, pad=pad)
    if case == "float_images":
        args["images"] = images.astype(np.float32)
    elif case == "ndim":
        args["images"] = images[0]
    elif case == "mean_shape":
        args["mean"] = mean[:2]
    elif case == "ys_shape":
        args["ys"] = ys[:-1]
    elif case == "y_range":
        args["ys"] = ys + 100
    elif case == "x_range":
        args["xs"] = xs + 100
    else:
        args["xs"] = xs - 100
    assert _refusal(native.crop_flip_normalize, **args) == \
        _refusal(jax_native.crop_flip_normalize, **args)


def test_wrapper_refuses_a_crop_larger_than_the_image():
    images = seeded("cifar")[0]
    msg = _refusal(utils.augment_normalize, images, 48, 48,
                   np.random.default_rng(0), mean=CIFAR[0], std=CIFAR[1])
    assert msg == _refusal(jax_utils.augment_normalize, images, 48, 48,
                           np.random.default_rng(0))


def test_without_gxx_it_takes_the_numpy_path(fresh_native, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not fresh_native.native_available()
    images, _, _, _, crop, pad, mean, std = seeded("cifar", seed=5)
    calls = native.CALLS.value
    got = utils.augment_normalize(images, crop, crop,
                                  np.random.default_rng(2), mean=mean,
                                  std=std, pad=pad)
    want = jax_utils.augment_normalize(images, crop, crop,
                                       np.random.default_rng(2), pad=pad,
                                       mean=mean, std=std)
    np.testing.assert_array_equal(got, want)
    assert native.CALLS.value == calls
    with pytest.raises(RuntimeError, match="unavailable"):
        fresh_native.crop_flip_normalize(*seeded("cifar")[:4], 32, 32,
                                         *CIFAR)


def test_a_broken_build_with_gxx_raises(fresh_native, monkeypatch,
                                        tmp_path):
    broken = tmp_path / "augment.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(fresh_native, "SOURCE", broken)
    monkeypatch.setattr(fresh_native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ exit"):
        fresh_native.native_available()
    images, _, _, _, crop, pad, mean, std = seeded("cifar")
    with pytest.raises(native.NativeBuildError):
        utils.augment_normalize(images, crop, crop,
                                np.random.default_rng(0), mean=mean,
                                std=std, pad=pad)
    assert not list((tmp_path / "out").glob("*.so"))


def test_switched_off_it_takes_the_numpy_path(monkeypatch):
    assert native.native_available()  # bound already: the switch still holds
    monkeypatch.setattr(native, "ENABLED", False)
    assert not native.native_available()
    images, _, _, _, crop, pad, mean, std = seeded("cifar")
    calls = native.CALLS.value
    utils.center_normalize(images, crop, crop, mean=mean, std=std)
    assert native.CALLS.value == calls


def test_the_library_lands_in_build_native_by_digest(fresh_native,
                                                     monkeypatch, tmp_path):
    assert str(native.BUILD_DIR).endswith(os.path.join("build", "native"))
    monkeypatch.setattr(fresh_native, "BUILD_DIR", tmp_path)
    assert fresh_native.native_available()
    path = fresh_native.library_path()
    assert path.parent == tmp_path and path.exists()
    assert path.name.startswith("augment-") and path.suffix == ".so"
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_the_counter_counts_calls():
    images, ys, xs, flips, crop, pad, mean, std = seeded("cifar")
    native.CALLS.reset()
    for _ in range(3):
        native.crop_flip_normalize(images, ys, xs, flips, crop, crop, mean,
                                   std, pad=pad)
    assert native.CALLS.value == 3
    with pytest.raises(ValueError):
        native.crop_flip_normalize(images.astype(np.float32), ys, xs, flips,
                                   crop, crop, mean, std, pad=pad)
    assert native.CALLS.value == 3
