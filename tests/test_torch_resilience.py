"""The port's resilience plane on the CPU (theanompi_tpu_torch/resilience,
utils/checkpoint.py, the launcher's resume and auto-resume), mirroring
the JAX package's pins (tests/test_resilience.py): the retry policy's
arithmetic, checkpoint manifests, truncation, the fallback past a corrupt
latest epoch with its quarantine, legacy checkpoints without a manifest,
manifest pruning, the fault plan's ``truncate``, the rule's resume and
its crash marker.

Then the launcher on a tiny ResNet (one gloo worker per run): a run that
is stopped and resumed, one whose latest checkpoint was corrupted by the
fault plan and that is resumed through the fallback, and one that
crashes and is auto-resumed by ``--max-restarts`` all end with the same
``state_digests`` as an unbroken run, bit for bit: the model's random
streams and data are pure functions of (seed, epoch, rank), and a
restored state equals the saved one.

This file imports no JAX: it is also the model module the launched
workers import (``-m test_torch_resilience -c TinyResNet``).
"""

import dataclasses
import json
import math
import os
import threading
import time

import pytest
import torch

from theanompi_tpu_torch import launcher, monitor
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.resilience import faults, recovery
from theanompi_tpu_torch.resilience.retry import RetryPolicy
from theanompi_tpu_torch.rules.bsp import BSP
from theanompi_tpu_torch.utils.checkpoint import (
    Checkpointer,
    _truncate_largest_file,
)

TESTS = os.path.dirname(os.path.abspath(__file__))


class TinyResNet(ResNet50):
    """ResNet at stage sizes (1, 1, 1, 1), width 8, 32-pixel crops, 10
    classes, f32, on 48 synthetic images (3 steps of 16 a rank per epoch)
    and 32 validation images; 3 epochs."""

    def __init__(self, config=None, device="cuda"):
        torch.set_num_threads(1)
        data = ImageNet_data(crop=32, seed=0, synthetic_n=48,
                             synthetic_pool=8, synthetic_store=36,
                             n_classes=10)
        data.n_val = 32
        super().__init__(config, device, stage_sizes=(1, 1, 1, 1), width=8,
                         n_classes=10, crop=32, data=data)

    @classmethod
    def default_config(cls):
        return dataclasses.replace(
            ResNet50.default_config(), batch_size=16, n_epochs=3,
            learning_rate=0.05, lr_scale_with_workers=None,
            lr_decay_epochs=(2,), compute_dtype="float32", print_freq=0)


class TinyResNetEF(TinyResNet):
    """TinyResNet on 128 synthetic images (4 steps of 2 x 16 an epoch at
    two ranks), for the error-feedback resume."""

    def __init__(self, config=None, device="cuda"):
        torch.set_num_threads(1)
        data = ImageNet_data(crop=32, seed=0, synthetic_n=128,
                             synthetic_pool=8, synthetic_store=36,
                             n_classes=10)
        data.n_val = 32
        ResNet50.__init__(self, config, device, stage_sizes=(1, 1, 1, 1),
                          width=8, n_classes=10, crop=32, data=data)


class CrashOnceResNet(TinyResNet):
    """Raises at step 1 of epoch 1 in the first life of a launcher group
    (``THEANOMPI_TPU_RESTART`` unset or 0), never after."""

    def train_iter(self, count, recorder):
        if (os.environ.get(launcher.RESTART_ENV, "0") == "0"
                and self.current_epoch == 1 and count == 1):
            raise RuntimeError("crash on purpose")
        return super().train_iter(count, recorder)


@pytest.fixture(autouse=True)
def fresh_faults():
    faults.clear()
    yield
    faults.clear()


def _payload(value: float) -> dict:
    return {"state": {"w": torch.full((4,), value)}, "epoch": 0}


# -- the retry policy ---------------------------------------------------------


class TestRetryPolicy:
    def test_delay_growth_and_cap(self):
        p = RetryPolicy(base_delay=0.1, max_delay=1.0, multiplier=2.0,
                        jitter=0.0)
        assert p.delay(0) == pytest.approx(0.1)
        assert p.delay(1) == pytest.approx(0.2)
        assert p.delay(2) == pytest.approx(0.4)
        assert p.delay(10) == pytest.approx(1.0)

    def test_jitter_bounds(self):
        p = RetryPolicy(base_delay=1.0, max_delay=1.0, jitter=0.5)
        for _ in range(100):
            assert 0.5 <= p.delay(0) <= 1.0

    def test_call_retries_transient_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionResetError("transient")
            return "ok"

        p = RetryPolicy(max_attempts=5, base_delay=0.001, jitter=0.0)
        assert p.call(flaky) == "ok"
        assert len(calls) == 3

    def test_call_does_not_retry_unretryable(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("logic bug")

        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=5, base_delay=0.001).call(bad)
        assert len(calls) == 1

    def test_call_exhausts_attempts(self):
        calls = []

        def down():
            calls.append(1)
            raise ConnectionRefusedError("down")

        p = RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)
        with pytest.raises(ConnectionRefusedError):
            p.call(down)
        assert len(calls) == 3

    def test_deadline_stops_early(self):
        def down():
            raise ConnectionRefusedError("down")

        p = RetryPolicy(max_attempts=100, base_delay=0.2, jitter=0.0,
                        deadline_s=0.05)
        t0 = time.monotonic()
        with pytest.raises(ConnectionRefusedError):
            p.call(down)
        assert time.monotonic() - t0 < 1.0

    def test_classifier_wins_over_types(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise ValueError("please retry me")
            return 7

        p = RetryPolicy(max_attempts=3, base_delay=0.001,
                        classify=lambda e: "retry me" in str(e))
        assert p.call(flaky) == 7
        assert len(calls) == 2


# -- checkpoint integrity -----------------------------------------------------


class TestCheckpointIntegrity:
    def test_manifest_written_and_verifies(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.close()
        with open(recovery.manifest_path(str(tmp_path), 0)) as f:
            assert set(json.load(f)) == {"epoch", "written", "n_files",
                                         "files"}
        ok, detail = recovery.verify_checkpoint(str(tmp_path), 0)
        assert ok is True, detail

    def test_truncation_detected(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.close()
        _truncate_largest_file(recovery.find_step_dir(str(tmp_path), 0))
        ok, detail = recovery.verify_checkpoint(str(tmp_path), 0)
        assert ok is False
        assert "mismatch" in detail or "missing" in detail

    def test_corrupt_latest_falls_back_to_previous(self, tmp_path):
        """The truncated latest epoch is quarantined (step dir and
        manifest moved aside), the previous one restored, and a re-save
        of the quarantined epoch writes afresh and verifies."""
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.save(1, _payload(2.0))
        ckpt.close()
        _truncate_largest_file(recovery.find_step_dir(str(tmp_path), 1))
        ckpt2 = Checkpointer(str(tmp_path), async_save=False)
        epoch, payload = ckpt2.restore_latest_verified()
        assert epoch == 0
        assert torch.equal(payload["state"]["w"], torch.full((4,), 1.0))
        assert recovery.find_step_dir(str(tmp_path), 1) is None
        assert not os.path.exists(recovery.manifest_path(str(tmp_path), 1))
        assert os.path.isdir(tmp_path / "quarantine" / "1")
        ckpt2.save(1, _payload(5.0))
        ckpt2.close()
        ok, detail = recovery.verify_checkpoint(str(tmp_path), 1)
        assert ok is True, detail
        ckpt3 = Checkpointer(str(tmp_path))
        epoch, payload = ckpt3.restore_latest_verified()
        ckpt3.close()
        assert epoch == 1
        assert torch.equal(payload["state"]["w"], torch.full((4,), 5.0))

    def test_intact_latest_restores_latest(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.save(1, _payload(2.0))
        epoch, payload = ckpt.restore_latest_verified()
        ckpt.close()
        assert epoch == 1
        assert torch.equal(payload["state"]["w"], torch.full((4,), 2.0))

    def test_empty_dir_returns_none(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.restore_latest_verified() == (None, None)
        ckpt.close()

    def test_legacy_checkpoint_without_manifest_still_restores(
            self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(3.0))
        ckpt.close()
        os.unlink(recovery.manifest_path(str(tmp_path), 0))
        ckpt2 = Checkpointer(str(tmp_path))
        epoch, payload = ckpt2.restore_latest_verified()
        ckpt2.close()
        assert epoch == 0
        assert torch.equal(payload["state"]["w"], torch.full((4,), 3.0))

    def test_unloadable_without_manifest_falls_back(self, tmp_path):
        """No manifest to prove it corrupt: the restore itself fails, the
        previous epoch restores, and nothing is quarantined."""
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.save(1, _payload(2.0))
        ckpt.close()
        for epoch in (0, 1):
            os.unlink(recovery.manifest_path(str(tmp_path), epoch))
        _truncate_largest_file(recovery.find_step_dir(str(tmp_path), 1))
        ckpt2 = Checkpointer(str(tmp_path))
        epoch, _ = ckpt2.restore_latest_verified()
        ckpt2.close()
        assert epoch == 0
        assert recovery.find_step_dir(str(tmp_path), 1) is not None
        assert not os.path.exists(tmp_path / "quarantine")

    def test_manifests_pruned_with_max_to_keep(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), max_to_keep=2, async_save=False)
        for e in range(4):
            ckpt.save(e, _payload(float(e)))
        ckpt.close()
        names = sorted(os.listdir(tmp_path))
        assert [n for n in names if n.startswith("manifest_")] == [
            "manifest_2.json", "manifest_3.json"]
        assert [n for n in names if n.isdigit()] == ["2", "3"]
        assert recovery.latest_manifest_epoch(str(tmp_path)) == 3

    def test_fault_plan_truncate_action(self, tmp_path):
        """The plan truncates epoch 1 after its manifest was written, so
        the next verified restore falls back to epoch 0."""
        faults.install([{"site": "checkpoint", "epoch": 1,
                         "action": "truncate"}])
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(0, _payload(1.0))
        ckpt.save(1, _payload(2.0))
        ckpt.close()
        faults.clear()
        ckpt2 = Checkpointer(str(tmp_path))
        epoch, payload = ckpt2.restore_latest_verified()
        ckpt2.close()
        assert epoch == 0
        assert torch.equal(payload["state"]["w"], torch.full((4,), 1.0))

    def test_fault_raise_at_checkpoint_never_kills_the_worker(self, tmp_path,
                                                              capfd):
        faults.install([{"site": "checkpoint", "epoch": 0}])
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(0, _payload(1.0))
        ckpt.save(1, _payload(2.0))
        ckpt.close()  # drains both manifests: the worker lived on
        assert "manifest worker: FaultInjected" in capfd.readouterr().err
        for epoch in (0, 1):
            assert recovery.verify_checkpoint(str(tmp_path), epoch)[0]


# -- the rule: resume past a corrupt latest, the crash marker -----------------


def _config(tmp_path, **kw):
    return dataclasses.replace(TinyResNet.default_config(),
                               snapshot_dir=str(tmp_path), **kw)


def test_rule_resume_falls_back_past_corrupt_latest(tmp_path):
    rule = BSP().init(device="cpu", modelfile="test_torch_resilience",
                      modelclass="TinyResNet",
                      config=_config(tmp_path, n_epochs=2))
    rule.wait()
    ckpt_dir = os.path.join(str(tmp_path), rule.model.name)
    epochs = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    assert epochs == [0, 1]
    _truncate_largest_file(recovery.find_step_dir(ckpt_dir, 1))
    rule2 = BSP().init(device="cpu", modelfile="test_torch_resilience",
                       modelclass="TinyResNet", config=_config(tmp_path),
                       resume=True)
    res = rule2.wait()
    assert math.isfinite(res["val"]["loss"])
    assert res["epochs_run"] == 2
    assert res["checkpoint"]["restore"]["epoch"] == 0
    # the quarantined epoch was saved again by the resumed run
    ok, detail = recovery.verify_checkpoint(ckpt_dir, 1)
    assert ok is True, detail
    assert os.listdir(os.path.join(ckpt_dir, "quarantine")) == ["1"]
    assert [r["epoch"] for r in res["records"]] == [0, 1, 2]


def test_crash_marker_written_with_monitoring(tmp_path, monkeypatch):
    mondir = tmp_path / "mon"
    monkeypatch.setenv(monitor.ENV_VAR, str(mondir))
    rule = BSP().init(device="cpu", modelfile="test_torch_resilience",
                      modelclass="CrashOnceResNet",
                      config=_config(tmp_path / "snap"))
    with pytest.raises(RuntimeError, match="crash on purpose"):
        rule.wait()
    markers = [p for p in os.listdir(mondir)
               if p.startswith("resilience_crash_")]
    assert markers, os.listdir(mondir)
    with open(mondir / markers[0]) as f:
        marker = json.load(f)
    assert marker["rule"] == "BSP"
    assert "crash on purpose" in marker["error"]
    # epoch 0's checkpoint landed before the crash in epoch 1
    assert marker["latest_manifest_epoch"] == 0
    assert marker["checkpoint_dir"].endswith(os.path.join("snap",
                                                          "resnet50"))


def test_fault_injected_at_a_save_is_not_fatal_to_the_session(tmp_path):
    faults.install([{"site": "checkpoint", "epoch": 0, "action": "raise"}])
    res = BSP().init(device="cpu", modelfile="test_torch_resilience",
                     modelclass="TinyResNet",
                     config=_config(tmp_path, n_epochs=1)).wait()
    assert res["epochs_run"] == 1
    assert faults.enabled()  # the plan fired in the manifest worker


# -- the launcher: stop and resume, fallback, auto-resume ---------------------


@pytest.fixture
def workers_import_this_file(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", TESTS)


def launch(argv, timeout=150):
    """``launcher.main(argv)`` in a thread; fails the test if it outlives
    ``timeout``."""
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=launcher.main(argv)),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"launcher still running after {timeout} s"
    return out["rc"]


def run(tmp_path, name, *extra, model="TinyResNet"):
    """One launcher run on the CPU; returns (rc, result or None)."""
    out = tmp_path / f"{name}.json"
    rc = launch(["BSP", "-D", "1", "--platform", "cpu", "-m",
                 "test_torch_resilience", "-c", model, "--snapshot-dir",
                 str(tmp_path / "snap"), "--result-json", str(out), *extra])
    return rc, (json.loads(out.read_text()) if out.exists() else None)


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """Three unbroken epochs: the reference state."""
    tmp = tmp_path_factory.mktemp("unbroken")
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", TESTS)
    try:
        rc, res = run(tmp, "unbroken")
    finally:
        mp.undo()
    assert rc == 0
    assert res["epochs_run"] == 3 and len(res["state_digests"]) == 1
    return res


def test_stopped_and_resumed_run_matches_unbroken(tmp_path, unbroken,
                                                  workers_import_this_file,
                                                  capfd):
    rc, first = run(tmp_path, "first", "--epochs", "2")
    assert rc == 0 and first["epochs_run"] == 2
    assert first["state_digests"] != unbroken["state_digests"]
    rc, res = run(tmp_path, "resumed", "--resume", "--epochs", "1")
    assert rc == 0, capfd.readouterr().err[-3000:]
    assert res["epochs_run"] == 1
    restore = res["checkpoint"]["restore"]
    assert restore["epoch"] == 1
    assert restore["digest_restored"] == restore["digest_at_save"]
    assert res["state_digests"] == unbroken["state_digests"]
    assert res["param_digests"] == unbroken["param_digests"]
    with open(tmp_path / "snap" / "record_rank0.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    assert [r["epoch"] for r in res["records"]] == [0, 1, 2]


def test_corrupted_latest_resumes_through_the_fallback(
        tmp_path, unbroken, workers_import_this_file, capfd):
    rc, first = run(tmp_path, "first", "--epochs", "2", "--fault-plan",
                    '[{"site": "checkpoint", "epoch": 1, '
                    '"action": "truncate"}]')
    assert rc == 0
    rc, res = run(tmp_path, "resumed", "--resume", "--epochs", "2")
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert "is CORRUPT" in err and "FALLBACK epoch 0" in err
    assert res["checkpoint"]["restore"]["epoch"] == 0
    assert res["epochs_run"] == 2
    assert [r["epoch"] for r in res["records"]] == [0, 1, 2]
    assert res["state_digests"] == unbroken["state_digests"]
    ckpt_dir = tmp_path / "snap" / "resnet50"
    assert os.listdir(ckpt_dir / "quarantine") == ["1"]
    assert recovery.verify_checkpoint(str(ckpt_dir), 1)[0] is True


def test_crashed_run_auto_resumes(tmp_path, unbroken,
                                  workers_import_this_file, capfd):
    rc, res = run(tmp_path, "auto", "--max-restarts", "1",
                  model="CrashOnceResNet")
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert "crash on purpose" in err
    assert "auto-resume 1/1 from the latest verified checkpoint" in err
    assert res["checkpoint"]["restore"]["epoch"] == 0
    assert res["epochs_run"] == 2
    assert [r["epoch"] for r in res["records"]] == [0, 1, 2]
    assert res["state_digests"] == unbroken["state_digests"]


#: the rest of the BSP step through ``--set``: the bf16 wire with error
#: feedback over 4 overlapped buckets, LARS, accumulation of 2
EF_SETS = ["--set", "exchange_dtype=bf16", "--set",
           "exchange_error_feedback=true", "--set", "exchange_buckets=4",
           "--set", "optimizer=lars", "--set", "grad_accum_steps=2",
           "--set", "n_epochs=2"]


def test_error_feedback_run_resumes_to_the_unbroken_state(
        tmp_path, workers_import_this_file, capfd):
    """Two gloo ranks, error feedback on: a run stopped after epoch 0
    and resumed ends with the unbroken run's state digests, residual
    included; the checkpoint holds every rank's residual in JAX's
    ``(n_ranks, *shape)`` layout."""
    def ef_run(name, *extra):
        out = tmp_path / f"{name}.json"
        rc = launch(["BSP", "-D", "2", "--platform", "cpu", "-m",
                     "test_torch_resilience", "-c", "TinyResNetEF",
                     "--snapshot-dir", str(tmp_path / name.split("-")[0]),
                     "--result-json", str(out), *EF_SETS, *extra],
                    timeout=240)
        assert rc == 0, capfd.readouterr().err[-3000:]
        return json.loads(out.read_text())

    unbroken = ef_run("unbroken")
    assert unbroken["epochs_run"] == 2
    assert len(set(unbroken["state_digests"])) == 1    # ranks agree
    first = ef_run("resumed-first", "--epochs", "1")
    assert first["state_digests"] != unbroken["state_digests"]
    res = ef_run("resumed", "--resume", "--epochs", "1")
    assert res["checkpoint"]["restore"]["epoch"] == 0
    assert res["state_digests"] == unbroken["state_digests"]
    for rec in unbroken["records"]:
        assert rec["train_steps"] == 4 and math.isfinite(rec["train_loss"])
    ck = Checkpointer(str(tmp_path / "resumed" / "resnet50"),
                      read_only=True)
    payload = ck.restore(0)
    ck.close()
    model = TinyResNetEF(device="cpu")
    residual = payload["exchange_residual"]
    names = [n for n, _ in model.module.named_parameters()]
    assert list(residual) == names
    for n, p in model.module.named_parameters():
        assert residual[n].shape == (2,) + tuple(p.shape)
        assert residual[n].dtype == torch.float32
    assert any(not torch.equal(r[0], r[1]) for r in residual.values())


def test_payload_without_error_feedback_is_unchanged(tmp_path):
    """A run without error feedback writes the payload keys it wrote
    before the residual existed."""
    res = BSP().init(device="cpu", modelfile="test_torch_resilience",
                     modelclass="TinyResNet",
                     config=_config(tmp_path, n_epochs=1)).wait()
    assert res["epochs_run"] == 1
    ck = Checkpointer(str(tmp_path / "resnet50"), read_only=True)
    payload = ck.restore(0)
    ck.close()
    assert set(payload) == {"params", "model_state", "opt_state", "step",
                            "epoch"}


def test_crash_without_restarts_exits_nonzero(tmp_path,
                                              workers_import_this_file,
                                              capfd):
    rc, res = run(tmp_path, "dead", "--max-restarts", "0",
                  model="CrashOnceResNet")
    err = capfd.readouterr().err
    assert rc != 0 and res is None
    assert "crash on purpose" in err and "auto-resume" not in err
