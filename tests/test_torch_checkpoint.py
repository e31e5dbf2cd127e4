"""The port's checkpointer, step profiler and recorder reload on the CPU
(theanompi_tpu_torch/utils/{checkpoint,profiling,recorder}.py), mirroring
the JAX package's pins (tests/test_checkpoint.py, tests/test_profiling.py),
and one session test held against the JAX package: both run_bsp_sessions
checkpoint a tiny ResNet for 2 epochs, the latest is truncated, and a
resume must fall back alike in both (epochs run, kept and manifested
epochs, quarantine layout, manifest and crash-marker keys).

Payload round trips are exact: a restored state's ``state_digest`` (every
bit of the parameters, buffers, optimizer state and step) equals the
saved one's.
"""

import hashlib
import json
import os
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu import monitor as jax_monitor
from theanompi_tpu.data.imagenet import ImageNet_data as JaxImageNet
from theanompi_tpu.models.base import ModelConfig as JaxModelConfig
from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
from theanompi_tpu.models.resnet50 import ResNet50 as JaxResNet50
from theanompi_tpu.parallel.mesh import data_mesh
from theanompi_tpu.resilience import recovery as jax_recovery
from theanompi_tpu.rules.bsp import run_bsp_session as jax_session
from theanompi_tpu.utils.checkpoint import (
    _truncate_largest_file as jax_truncate,
)
from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.resilience import recovery
from theanompi_tpu_torch.rules.bsp import run_bsp_session
from theanompi_tpu_torch.utils import checkpoint as C
from theanompi_tpu_torch.utils.checkpoint import (
    Checkpointer,
    _truncate_largest_file,
    state_digest,
)
from theanompi_tpu_torch.utils.profiling import StepProfiler
from theanompi_tpu_torch.utils.recorder import Recorder

TINY = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=10)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_model(tmp_path, **cfg):
    config = ModelConfig(**{**dict(batch_size=16, n_epochs=3,
                                   learning_rate=0.05, print_freq=0,
                                   snapshot_dir=str(tmp_path)), **cfg})
    data = ImageNet_data(crop=32, seed=0, synthetic_n=48, synthetic_pool=8,
                         synthetic_store=36, n_classes=10)
    data.n_val = 32
    return ResNet50(config=config, device="cpu", **TINY, crop=32, data=data)


def _w(value):
    return {"params": {"w": torch.full((6,), float(value))}, "step": 0}


# -- the checkpointer (tests/test_checkpoint.py) ------------------------------


def test_async_save_snapshots_before_background_write(tmp_path):
    """save() returns while the files are written in the background; the
    payload was copied first, so a mutation after return never reaches
    the file."""
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    buf = torch.arange(8.0)
    ck.save(0, {"w": buf, "epoch": 0})
    buf += 100.0
    ck.save(1, {"w": buf, "epoch": 1})
    assert torch.equal(ck.restore(0)["w"], torch.arange(8.0))
    assert torch.equal(ck.restore(1)["w"], torch.arange(8.0) + 100.0)
    ck.close()
    ck2 = Checkpointer(str(tmp_path))
    assert ck2.latest_epoch() == 1
    assert ck2.kept_epochs() == {0, 1}
    ck2.close()


def test_sync_mode_still_available(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, {"x": torch.ones(3)})
    # written and manifested when save returns
    assert os.path.exists(recovery.manifest_path(str(tmp_path), 0))
    assert ck.latest_epoch() == 0
    ck.close()


def test_background_parts_run_one_at_a_time(tmp_path, monkeypatch):
    """While the writer pickles, ``background()`` names the write alone;
    the state digest and the manifest follow it, each timed; once closed
    nothing runs."""
    ck = Checkpointer(str(tmp_path))
    release, seen = threading.Event(), []
    real_save = C.torch.save

    def slow_save(obj, path):
        seen.append(ck.background())
        release.wait(10)
        real_save(obj, path)

    monkeypatch.setattr(C.torch, "save", slow_save)
    assert ck.background() is None
    ck.save(0, {"w": torch.ones(4)})
    while not seen:
        time.sleep(0.001)
    assert seen == ["write"] and ck.background() == "write"
    release.set()
    ck.close()
    assert ck.background() is None
    t = ck.timings[0]
    assert {"write_s", "digest_s", "manifest_s", "bytes"} <= set(t)
    assert recovery.verify_checkpoint(str(tmp_path), 0)[0] is True


def test_payload_written_without_the_zip_crc32(tmp_path):
    """The payload's zip records carry no CRC-32 (torch.load never checks
    it; the manifest's sha256 covers the file), and the file still loads
    and verifies."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, {"w": torch.arange(1000.0)})
    path = os.path.join(recovery.find_step_dir(str(tmp_path), 0),
                        C.PAYLOAD_FILE)
    with zipfile.ZipFile(path) as z:
        crcs = {i.filename: i.CRC for i in z.infolist()}
    assert crcs and set(crcs.values()) == {0}, crcs
    assert torch.equal(ck.restore(0)["w"], torch.arange(1000.0))
    ck.close()
    assert recovery.verify_checkpoint(str(tmp_path), 0)[0] is True
    from torch.utils.serialization import config
    assert config.save.compute_crc32 is True  # patched for the write only


def test_restore_missing_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore()
    ck.close()


def test_close_failure_chains_not_masks(tmp_path, monkeypatch):
    """A background write that fails while another error unwinds: close
    raises the write failure with the original chained, so neither is
    lost."""
    ck = Checkpointer(str(tmp_path))

    def broken_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(C.torch, "save", broken_save)
    ck.save(0, {"x": torch.ones(2)})

    class Boom(Exception):
        pass

    with pytest.raises(RuntimeError, match="background checkpoint write") as e:
        try:
            raise Boom("the real failure")
        finally:
            ck.close()
    assert isinstance(e.value.__context__, Boom)
    assert isinstance(e.value.__cause__, OSError)


def _dir_state(root):
    files, dirs = {}, set()
    for r, ds, fs in os.walk(root):
        for d in ds:
            dirs.add(os.path.relpath(os.path.join(r, d), root))
        for name in fs:
            full = os.path.join(r, name)
            with open(full, "rb") as f:
                files[os.path.relpath(full, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return files, dirs


def test_read_only_load_leaves_dir_byte_identical(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, _w(0))
    ck.save(1, _w(1))
    ck.close()
    before = _dir_state(tmp_path)
    ro = Checkpointer(str(tmp_path), read_only=True)
    assert ro.latest_epoch() == 1
    assert ro.kept_epochs() == {0, 1}
    epoch, payload = ro.restore_latest_verified()
    assert epoch == 1 and torch.equal(payload["params"]["w"],
                                      torch.full((6,), 1.0))
    ro.close()
    assert _dir_state(tmp_path) == before


def test_read_only_refuses_writes_and_missing_dir(tmp_path):
    ck = Checkpointer(str(tmp_path / "d"))
    ck.save(0, _w(0))
    ck.close()
    ro = Checkpointer(str(tmp_path / "d"), read_only=True)
    with pytest.raises(RuntimeError, match="read-only"):
        ro.save(1, _w(1))
    ro.close()
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "nope"), read_only=True)


def test_read_only_falls_back_without_quarantine(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, _w(0))
    ck.save(1, _w(1))
    ck.close()
    _truncate_largest_file(recovery.find_step_dir(str(tmp_path), 1))
    before = _dir_state(tmp_path)
    ro = Checkpointer(str(tmp_path), read_only=True)
    epoch, payload = ro.restore_latest_verified()
    ro.close()
    assert epoch == 0
    assert torch.equal(payload["params"]["w"], torch.zeros(6))
    assert _dir_state(tmp_path) == before
    assert not os.path.isdir(tmp_path / "quarantine")


def test_model_payload_round_trip_is_bit_exact(tmp_path):
    """A trained tiny ResNet's payload (parameters, BN running statistics,
    momentum buffers, step) saved, restored into a fresh model and
    compared by digest; the restored optimizer steps on as the original
    does."""
    model = _tiny_model(tmp_path, n_epochs=1)
    run_bsp_session(model, checkpoint=False)
    saved = state_digest(model.checkpoint_payload())
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(0, model.checkpoint_payload(0))
    assert ck.kept_epochs() == {0}
    assert ck.saved_digest(0) == saved
    payload = ck.restore(0)
    ck.close()
    assert set(payload) == {"params", "opt_state", "model_state", "epoch",
                            "step"}
    assert payload["epoch"] == 0 and payload["step"] == model.state.step
    assert payload["model_state"] and all(   # the BN running statistics
        k.endswith((".mean", ".var")) for k in payload["model_state"])
    fresh = _tiny_model(tmp_path, n_epochs=1)
    fresh.compile_iter_fns()
    assert state_digest(fresh.checkpoint_payload()) != saved
    fresh.adopt_restored_state(payload)
    assert state_digest(fresh.checkpoint_payload()) == saved
    # the same next step from both
    model.compile_iter_fns()
    x, y = next(iter(model.data.train_batches(5, 16)))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for m in (model, fresh):
        m.train_step(m.state, batch, m._epoch_rng(5))
    assert state_digest(fresh.checkpoint_payload()) == state_digest(
        model.checkpoint_payload())


@pytest.mark.parametrize("part", ["params", "model_state", "opt_state",
                                  "step"])
def test_state_digest_sees_every_part(tmp_path, part):
    model = _tiny_model(tmp_path, n_epochs=1)
    run_bsp_session(model, checkpoint=False, max_epochs=1)
    payload = model.checkpoint_payload()
    before = state_digest(payload)
    if part == "step":
        payload["step"] += 1
    elif part == "opt_state":
        buf = next(iter(payload["opt_state"]["state"].values()))
        buf["momentum_buffer"].view(-1)[0] += 1e-6
    else:
        t = next(iter(payload[part].values()))
        t.view(-1)[0] += 1e-6
    assert state_digest(payload) != before
    # the epoch label is not state
    assert state_digest({**payload, "epoch": 9}) == state_digest(payload)


def test_recorder_load_rebuilds_totals(tmp_path):
    rec = Recorder(save_dir=str(tmp_path), print_freq=0)
    for epoch in range(3):
        rec.start()
        rec.end("calc")
        rec.epoch_time["calc"] = 1.5 + epoch
        rec.epoch_summary(epoch, 1.0, 0.5)
    back = Recorder(print_freq=0)
    back.load(str(tmp_path))
    assert [r["epoch"] for r in back.epoch_records] == [0, 1, 2]
    assert back.epoch == 3
    assert back.all_time["calc"] == pytest.approx(1.5 + 2.5 + 3.5)
    # a resume that fell back to epoch 0 runs epochs 1.. again
    back = Recorder(print_freq=0)
    back.load(str(tmp_path), before_epoch=1)
    assert [r["epoch"] for r in back.epoch_records] == [0]
    assert back.epoch == 1 and back.all_time["calc"] == pytest.approx(1.5)
    Recorder(print_freq=0).load(str(tmp_path / "none"))  # nothing: no-op


# -- the step profiler (tests/test_profiling.py) ------------------------------


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_step_profiler_writes_trace(tmp_path):
    model = _tiny_model(tmp_path, n_epochs=1)
    out = run_bsp_session(model, checkpoint=False,
                          profile_dir=str(tmp_path / "trace"))
    path = out["profile_trace"]
    assert os.path.dirname(path) == str(tmp_path / "trace")
    names = _trace_names(path)
    # every one of the epoch's 3 iterations is labelled
    assert {"train#0", "train#1", "train#2"} <= names


def test_step_profiler_noop_without_dir(monkeypatch):
    monkeypatch.delenv("THEANOMPI_TPU_PROFILE", raising=False)
    p = StepProfiler()
    assert not p.enabled
    with p:
        assert p.label(0) is p.label(1)  # one shared null context
        p.maybe_start()
        p.step()
        assert not p.active
    p.stop()
    assert p.trace_path is None


def test_step_profiler_context_manager_flushes_on_crash(tmp_path):
    with pytest.raises(RuntimeError, match="mid-capture"):
        with StepProfiler(str(tmp_path), n_steps=100) as p:
            with p.label(0):
                torch.ones(4).sum()
            p.step()
            raise RuntimeError("mid-capture crash")
    assert not p.active
    assert "train#0" in _trace_names(p.trace_path)


def test_step_profiler_spans_epochs(tmp_path):
    p = StepProfiler(str(tmp_path), n_steps=5)
    p.maybe_start()
    for _ in range(3):   # epoch 0: 3 iterations, still tracing
        p.step()
    assert p.active and p.trace_path is None
    for _ in range(2):   # epoch 1 continues the same trace
        p.step()
    assert not p.active and os.path.exists(p.trace_path)
    p.maybe_start()      # done: no second trace
    assert not p.active


# -- held against the JAX package ---------------------------------------------


class _JaxTinyResNet(JaxResNet50):
    def build_module(self):
        return JaxResNet(stage_sizes=(1, 1, 1, 1), width=8,
                         n_classes=self.data.n_classes, dtype=jnp.float32,
                         stem=self.config.resnet_stem,
                         bn_axis=self._bn_axis())


def _jax_tiny_model(tmp_path):
    cfg = JaxModelConfig(batch_size=16, n_epochs=3, learning_rate=0.05,
                         print_freq=0, snapshot_dir=str(tmp_path),
                         compute_dtype="float32")
    data = JaxImageNet(crop=32, seed=0, synthetic_n=48, synthetic_pool=8,
                       synthetic_store=36, augment_on_device=True)
    data.n_val = 32
    return _JaxTinyResNet(config=cfg, mesh=data_mesh(1, jax.devices()[:1]),
                          verbose=False, data=data)


def _layout(root):
    ckpt = os.path.join(root, "resnet50")
    names = os.listdir(ckpt)
    manifests = sorted(n for n in names if n.startswith("manifest_"))
    with open(os.path.join(ckpt, manifests[0])) as f:
        manifest = json.load(f)
    qdir = os.path.join(ckpt, "quarantine")
    return {"kept": sorted(int(n) for n in names if n.isdigit()),
            "manifests": manifests,
            "quarantine": sorted(os.listdir(qdir)) if os.path.isdir(qdir)
            else None,
            "manifest_keys": sorted(manifest),
            "file_keys": sorted(next(iter(manifest["files"].values())))}


def test_corrupt_latest_resume_matches_jax(tmp_path):
    """Both packages: 2 checkpointed epochs of 3, the latest truncated
    on disk, then a resume to the end."""
    runs = {}
    for pkg, build, session, truncate, find in (
            ("jax", _jax_tiny_model, jax_session, jax_truncate,
             jax_recovery.find_step_dir),
            ("torch", _tiny_model, run_bsp_session, _truncate_largest_file,
             recovery.find_step_dir)):
        root = tmp_path / pkg
        first = session(build(root), max_epochs=2)
        truncate(find(str(root / "resnet50"), 1))
        second = session(build(root), resume=True)
        runs[pkg] = {"epochs_run": (first["epochs_run"],
                                    second["epochs_run"]),
                     "val_finite": bool(np.isfinite(second["val"]["loss"])),
                     **_layout(root)}
    assert runs["torch"] == runs["jax"]
    assert runs["torch"]["epochs_run"] == (2, 2)
    assert runs["torch"]["kept"] == [0, 1, 2]
    assert runs["torch"]["quarantine"] == ["1"]
    assert runs["torch"]["manifest_keys"] == ["epoch", "files", "n_files",
                                              "written"]


def test_crash_marker_keys_match_jax(tmp_path):
    markers = {}
    for pkg, mon, rec, build in (
            ("jax", jax_monitor, jax_recovery, _jax_tiny_model),
            ("torch", monitor, recovery, _tiny_model)):
        model = build(tmp_path / pkg / "snap")
        os.makedirs(os.path.join(model.config.snapshot_dir, model.name))
        with open(os.path.join(model.config.snapshot_dir, model.name,
                               "manifest_4.json"), "w") as f:
            f.write("{}")
        with mon.session(str(tmp_path / pkg / "mon")):
            path = rec.record_crash("BSP", RuntimeError("boom"),
                                    model=model)
        with open(path) as f:
            markers[pkg] = json.load(f)
    assert set(markers["torch"]) == set(markers["jax"]) == {
        "rule", "error", "time", "checkpoint_dir", "latest_manifest_epoch"}
    for key in ("rule", "error", "latest_manifest_epoch"):
        assert markers["torch"][key] == markers["jax"][key]
    assert markers["torch"]["latest_manifest_epoch"] == 4
    # off: no marker
    assert recovery.record_crash("BSP", RuntimeError("x")) is None


def test_run_bsp_session_checkpoints_by_default(tmp_path):
    model = _tiny_model(tmp_path, n_epochs=2)
    out = run_bsp_session(model)
    ckpt = out["checkpoint"]
    assert [s["epoch"] for s in ckpt["saves"]] == [0, 1]
    for s in ckpt["saves"]:
        assert s["pause_ms"] > 0 and s["write_s"] > 0 and s["bytes"] > 0
        assert s["digest_s"] > 0 and s["manifest_s"] > 0
    # every training step is filed under the save part it overlapped;
    # epoch 0 follows no save
    for rec in out["records"]:
        split = rec["ckpt_overlap"]
        assert sum(v["steps"] for v in split.values()) == rec["train_steps"]
        assert set(split) <= {"none", "write", "digest", "manifest",
                              "write+manifest", "digest+manifest"}
        assert sum(v["s"] for v in split.values()) <= rec["train_s"]
    assert set(out["records"][0]["ckpt_overlap"]) == {"none"}
    assert ckpt["restore"] is None
    for epoch in (0, 1):
        ok, detail = recovery.verify_checkpoint(
            str(tmp_path / "resnet50"), epoch)
        assert ok is True, detail
