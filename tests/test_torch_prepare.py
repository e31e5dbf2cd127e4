"""The port's shard preparation on the CPU against the JAX package's:
``prepare_imagenet_shards``, ``prepare_imagenet_from_images``, the
rerun rules, ``shard_tree_signature`` and the CLI
(``python -m theanompi_tpu_torch.tools.prepare_imagenet``).

Both packages write from the same inputs (uint8 arrays drawn with numpy
from a seed; a small ImageFolder tree of PNGs the test writes with
Pillow) and the trees must agree exactly: every ``.npy``,
``manifest.json`` and ``classes.json`` byte for byte; an ``.npz``
member by member (``np.savez`` stamps each zip member with the time of
writing, so two npz files are not byte-identical)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from theanompi_tpu.data import imagenet as J  # noqa: E402
from theanompi_tpu_torch.data import imagenet as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(n=21, hw=12, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8),
            rng.integers(0, 7, n).astype(np.int32))


def _png_tree(root, n_classes=3, per_class=5, seed=2):
    """An ImageFolder tree of random PNGs of varied sizes (lossless, so
    the decoded pixels are the file's)."""
    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(14, 40, 2))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(os.path.join(d, f"img_{i}.png"))


def assert_same_tree(got_dir, want_dir):
    """The same file names; npy/json byte for byte, npz member by
    member."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        got, want = (os.path.join(d, name) for d in (got_dir, want_dir))
        if name.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert g.files == w.files, name
                for k in w.files:
                    assert g[k].dtype == w[k].dtype, (name, k)
                    np.testing.assert_array_equal(g[k], w[k], err_msg=name)
        else:
            with open(got, "rb") as g, open(want, "rb") as w:
                assert g.read() == w.read(), name


@pytest.mark.parametrize("shard_format", ["npy", "npz"])
def test_shards_from_arrays_match_jax(tmp_path, shard_format):
    x, y = _arrays()
    for pkg, d in ((T, "port"), (J, "jax")):
        for prefix, (xs, ys) in (("train", (x, y)), ("val", (x[:9], y[:9]))):
            paths = pkg.prepare_imagenet_shards(
                xs, ys, str(tmp_path / d), prefix, shard_size=8,
                shard_format=shard_format)
            suffix = "x.npy" if shard_format == "npy" else "npz"
            assert [os.path.basename(p) for p in paths] == [
                f"{prefix}_{i:04d}.{suffix}" for i in range(-(-len(ys) // 8))]
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    with open(tmp_path / "port" / "manifest.json") as fh:
        manifest = json.load(fh)
    ds = T.ImageNet_data(data_dir=str(tmp_path / "port"), crop=8)
    assert not ds.synthetic and (ds.n_train, ds.n_val) == (21, 9)
    assert sum(manifest.values()) == 30
    for f in ds.train_files + ds.val_files:      # the counts are the arrays'
        assert manifest[os.path.basename(f)] == len(T._load_shard(f)[1])


@pytest.mark.parametrize("shard_format", ["npy", "npz"])
def test_shards_from_images_match_jax(tmp_path, shard_format):
    src = tmp_path / "raw"
    _png_tree(str(src))
    for pkg, d in ((T, "port"), (J, "jax")):
        paths = pkg.prepare_imagenet_from_images(
            str(src), str(tmp_path / d), prefix="train", store=16,
            shard_size=6, workers=2, shard_format=shard_format)
        assert len(paths) == 3                          # 15 images: 6+6+3
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    with open(tmp_path / "port" / "classes.json") as fh:
        assert json.load(fh) == {f"class_{c}": c for c in range(3)}
    # the decode itself, and list_image_dir's labels
    pairs, classes = T.list_image_dir(str(src))
    assert (pairs, classes) == J.list_image_dir(str(src))
    for path, _ in pairs[:4]:
        np.testing.assert_array_equal(T.decode_image(path, 16),
                                      J.decode_image(path, 16))


def test_cross_format_rerun_and_a_failed_run(tmp_path):
    """A rerun in the other format removes every leftover of the first
    (no orphan ``.y.npy``), and prunes the manifest; a run that meets a
    corrupt image leaves the earlier set whole, as JAX's does."""
    big, small, out = tmp_path / "big", tmp_path / "small", tmp_path / "out"
    _png_tree(str(big), per_class=6)        # 18 images
    _png_tree(str(small), per_class=2)      # 6
    kw = dict(prefix="train", store=16, shard_size=8, workers=2)
    T.prepare_imagenet_from_images(str(big), str(out), shard_format="npz",
                                   **kw)
    paths = T.prepare_imagenet_from_images(str(small), str(out), **kw)
    on_disk = sorted(f for f in os.listdir(out) if f.startswith("train_"))
    assert on_disk == ["train_0000.x.npy", "train_0000.y.npy"]
    assert [os.path.basename(p) for p in paths] == ["train_0000.x.npy"]
    with open(out / "manifest.json") as fh:
        assert json.load(fh) == {"train_0000.x.npy": 6}

    # a corrupt image late in the order: the npz rerun fails and the npy
    # set of the run before is left as it was
    before = {f: (out / f).read_bytes() for f in os.listdir(out)}
    (big / "class_2" / "zz_corrupt.png").write_bytes(b"not a png")
    with pytest.raises(Exception):
        T.prepare_imagenet_from_images(str(big), str(out),
                                       shard_format="npz", shuffle_seed=None,
                                       **kw)
    after = {f: (out / f).read_bytes() for f in os.listdir(out)}
    assert after == before


def test_flat_directory_refused(tmp_path):
    Image.new("RGB", (10, 10)).save(tmp_path / "img.png")
    for pkg in (T, J):
        with pytest.raises(FileNotFoundError):
            pkg.prepare_imagenet_from_images(str(tmp_path),
                                             str(tmp_path / "o"))


def test_shard_tree_signature_matches_jax(tmp_path):
    x, y = _arrays(n=40)
    paths = T.prepare_imagenet_shards(x, y, str(tmp_path), shard_size=16)
    sizes = {p: len(T._load_shard(p)[1]) for p in paths}
    for seed in (0, 7):
        sig = T.shard_tree_signature(paths, sizes, seed)
        assert sig == J.shard_tree_signature(paths, sizes, seed)
        assert sig["n_train"] == 40 and sig["n_files"] == 3


def test_cli_matches_jax_tool(tmp_path):
    """``python -m theanompi_tpu_torch.tools.prepare_imagenet`` with every
    flag against ``tools/prepare_imagenet.py``'s ``main`` on the same
    tree: the same shard trees."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import prepare_imagenet as jax_tool
    finally:
        sys.path.pop(0)
    src = tmp_path / "raw"
    _png_tree(str(src))
    flags = ["--store", "12", "--shard-size", "4", "--workers", "2",
             "--format", "npz"]
    for prefix, extra in (("train", []), ("val", ["--no-shuffle"])):
        argv = [str(src), None, "--prefix", prefix, *flags, *extra]
        if prefix == "val":
            argv += ["--classes", str(tmp_path / "jax" / "classes.json")]
        assert jax_tool.main([str(tmp_path / "jax") if a is None else a
                              for a in argv]) == 0
        out = subprocess.run(
            [sys.executable, "-m",
             "theanompi_tpu_torch.tools.prepare_imagenet",
             *[str(tmp_path / "port") if a is None else a for a in argv]],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0, out.stderr
        assert f"{prefix} shards to" in out.stdout
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_prepared_tree_trains_one_epoch(tmp_path):
    """A tree the port prepared from images feeds a short CPU epoch of a
    tiny ResNet through ``run_bsp_session``: every batch from the shards,
    finite losses."""
    import torch

    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    src, out = tmp_path / "raw", tmp_path / "shards"
    _png_tree(str(src), per_class=8)                      # 24 images
    for prefix in ("train", "val"):
        T.prepare_imagenet_from_images(str(src), str(out), prefix=prefix,
                                       store=20, shard_size=10, workers=2)
    data = T.ImageNet_data(data_dir=str(out), crop=16, augment_on_device=True)
    assert not data.synthetic and data.n_classes == 3
    assert (data.n_train, data.n_val) == (24, 24)
    torch.manual_seed(0)
    model = ResNet50(config=ModelConfig(
        batch_size=8, n_epochs=1, learning_rate=0.01, print_freq=0,
        snapshot_dir=str(tmp_path / "snap"), track_top5=False),
        device="cpu", stage_sizes=(1, 1, 1, 1), width=8, n_classes=3,
        crop=16, data=data)
    res = run_bsp_session(model, checkpoint=False)
    rec = res["records"][0]
    assert (rec["train_steps"], rec["val_batches"]) == (3, 3)
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
