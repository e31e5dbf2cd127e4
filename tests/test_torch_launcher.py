"""``python -m theanompi_tpu_torch.launcher BSP`` on the CPU (gloo).

A 2-process run of a tiny AlexNet (full layer widths, 67-pixel crops,
10 classes, a synthetic pool of 4 images) writes its result JSON, every
loss is finite, and the two ranks end with equal parameters; the
TransformerLM trains at its default dims through the same command; a worker
that fails stops its sibling and the launcher exits non-zero; two ranks
stopped and resumed end as two unbroken ranks; ``--multihost`` joins two
launchers of one rank each into one world; the four mesh degrees
(``--seq/--model/--pipe/--expert-parallel``) run the LM family on two
ranks and the async rules refuse them; ``SERVE --decode`` serves a tiny
TransformerLM export over TCP on the CPU, and ``SERVE --decode
--disaggregate`` brings up a prefill and a decode child on the CPU
behind the router; ``--compilation-cache-dir``,
the one option still unported, exits non-zero naming its ROADMAP item;
the front door's options (``--disaggregate``, ``--prefill-replicas``,
``--autoscale``, ``--scale-max``, ``--slo-p99-ms``,
``--decode-fleet-cache``) parse with JAX's defaults, and
``--disaggregate`` without ``--decode`` exits with JAX's message.

This file imports no JAX: it is also the model module the launched
workers import (``-m test_torch_launcher -c TinyAlexNet``).  Every
launch runs under a hard ``timeout``.
"""

import dataclasses
import json
import math
import os
import threading

import pytest
import torch

from theanompi_tpu_torch import launcher
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.alex_net import AlexNet

TESTS = os.path.dirname(os.path.abspath(__file__))


class TinyAlexNet(AlexNet):
    """AlexNet at full widths on 67-pixel crops (67 -> 15 -> 7 -> 3 -> 1
    through conv1 and the pools), f32, 10 classes, 16 training images."""

    def __init__(self, config=None, device="cuda"):
        torch.set_num_threads(1)
        data = ImageNet_data(crop=67, seed=0, synthetic_n=16,
                             synthetic_pool=4, synthetic_store=72,
                             n_classes=10)
        data.n_val = 8          # 2 validation batches per rank
        super().__init__(config, device, n_classes=10, crop=67, data=data)

    @classmethod
    def default_config(cls):
        return dataclasses.replace(
            AlexNet.default_config(), batch_size=2, n_epochs=1,
            compute_dtype="float32", print_freq=2)


class FailingAlexNet(TinyAlexNet):
    """Rank 1 fails while building its model; rank 0 then waits in its
    first collective until the launcher stops it."""

    def __init__(self, config=None, device="cuda"):
        if os.environ.get("RANK") == "1":
            raise RuntimeError("rank 1 fails on purpose")
        super().__init__(config, device)


@pytest.fixture
def workers_import_this_file(monkeypatch):
    """The launched workers find this module (and the port, which the
    launcher puts on their path itself)."""
    monkeypatch.setenv("PYTHONPATH", TESTS)


def _launch(argv, timeout):
    """``launcher.main(argv)`` in a thread, its workers' output captured
    by pytest (``capfd``); fails the test if it outlives ``timeout``."""
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=launcher.main(argv)),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"launcher still running after {timeout} s"
    return out["rc"]


def test_two_process_gloo_bsp_run(tmp_path, workers_import_this_file, capfd):
    out = tmp_path / "result.json"
    rc = _launch(["BSP", "-D", "2", "--platform", "cpu", "-m",
                  "test_torch_launcher", "-c", "TinyAlexNet",
                  "--snapshot-dir", str(tmp_path), "--lr", "0.001",
                  "--result-json", str(out)], timeout=150)
    stdout, stderr = capfd.readouterr()
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["world_size"] == 2 and res["device"] == "cpu"
    assert res["epochs_run"] == 1
    rec = res["records"][0]
    # 16 images, global batch 2 x 2 ranks: 4 steps; 8 validation
    # images, 2 per rank per batch: 2 batches
    assert rec["train_steps"] == 4 and rec["val_batches"] == 2
    for key in ("train_loss", "val_loss"):
        assert math.isfinite(rec[key]), rec
    assert all(math.isfinite(v) for v in res["val"].values())
    # the replicas ended identical
    assert len(set(res["param_digests"])) == 1
    # CPU tensors take the plain versions: no kernel launched
    assert not any(rec["launches"]["train"].values())
    assert "final val" in stdout


def test_transformer_lm_at_default_dims(tmp_path, monkeypatch, capfd):
    """The launcher reaches the LM: ``-m theanompi_tpu_torch.models.
    transformer -c TransformerLM`` at its default dims (2 layers, d_model
    128, 4 heads, seq 128, vocab 256, the default 4096-sequence synthetic
    set) for one epoch of batch-64 steps on one CPU worker.  The epoch
    record carries every K4 count at 0 (CPU tensors take the plain
    versions) and a finite loss that fell below its start (ln 256)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = tmp_path / "result.json"
    rc = _launch(["BSP", "--platform", "cpu", "-D", "1", "-m",
                  "theanompi_tpu_torch.models.transformer", "-c",
                  "TransformerLM", "--epochs", "1", "--set", "batch_size=64",
                  "--snapshot-dir", str(tmp_path), "--result-json",
                  str(out)], timeout=240)
    stdout, stderr = capfd.readouterr()
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["world_size"] == 1 and res["device"] == "cpu"
    rec = res["records"][0]
    assert rec["train_steps"] == 4096 // 64 and rec["val_batches"] == 512 // 64
    for part in ("train", "val"):
        counts = rec["launches"][part]
        assert {k: counts[k] for k in ("attention", "attention_bwd_dq",
                                       "attention_bwd_dkdv")} == {
            "attention": 0, "attention_bwd_dq": 0, "attention_bwd_dkdv": 0}
        assert not any(counts.values())
    assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["val_loss"])
    assert rec["val_loss"] < math.log(256)


def test_a_failing_worker_stops_the_run(tmp_path, workers_import_this_file,
                                        capfd):
    rc = _launch(["BSP", "-D", "2", "--platform", "cpu", "-m",
                  "test_torch_launcher", "-c", "FailingAlexNet",
                  "--snapshot-dir", str(tmp_path)], timeout=120)
    stderr = capfd.readouterr().err
    assert rc != 0
    assert "rank 1 fails on purpose" in stderr
    assert "stopping the others" in stderr


@pytest.mark.parametrize("argv,item", [
    (["GOSGD", "--compilation-cache-dir", "d"], 22),
    (["SERVE", "--export-dir", "d", "--decode", "--disaggregate",
      "--compilation-cache-dir", "d"], 22),
    (["BSP", "--compilation-cache-dir=d"], 22)])
def test_unported_rules_and_options_name_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit, match=rf"not ported yet \(ROADMAP.md "
                                         rf"section A, item {item}\)"):
        launcher.main(argv + ["-m", "x", "-c", "y"])


def test_only_the_compilation_cache_stays_unported():
    assert launcher.UNPORTED_OPTIONS == {"--compilation-cache-dir": 22}
    assert all(item is None for item in launcher.RULES.values())


@pytest.mark.parametrize("rule", ["SERVE", "EASGD"])
def test_disaggregate_without_decode_exits_with_jax_message(rule):
    argv = [rule, "--export-dir", "d", "--disaggregate"]
    if rule == "SERVE":
        with pytest.raises(SystemExit, match=r"^--disaggregate requires "
                           r"--decode \(tmlocal SERVE --decode "
                           r"--disaggregate \.\.\.\)$"):
            launcher.main(argv)
    else:
        # JAX reads --disaggregate only under SERVE; a training rule
        # without -m/-c is refused for that instead
        with pytest.raises(SystemExit, match="needs -m/--modelfile"):
            launcher.main(argv)


def test_front_door_options_parse_with_jax_defaults():
    from theanompi_tpu_torch.serving.server import decode_opts_from_args

    base = ["SERVE", "--export-dir", "d", "--decode"]
    args = launcher.parse_args(base)
    assert (args.disaggregate, args.prefill_replicas, args.autoscale,
            args.scale_max, args.slo_p99_ms, args.decode_fleet_cache) \
        == (False, 1, False, 4, None, None)
    assert args.max_restarts == 2
    assert "fleet_cache" not in decode_opts_from_args(args)
    args = launcher.parse_args(base + ["--disaggregate"])
    assert args.max_restarts == 1   # JAX's front-door default
    args = launcher.parse_args(base + [
        "--disaggregate", "--prefill-replicas", "2", "--autoscale",
        "--scale-max", "3", "--slo-p99-ms", "40", "--max-restarts", "0",
        "--decode-fleet-cache", "h:1"])
    assert (args.disaggregate, args.prefill_replicas, args.autoscale,
            args.scale_max, args.slo_p99_ms, args.max_restarts) \
        == (True, 2, True, 3, 40.0, 0)
    assert decode_opts_from_args(args)["fleet_cache"] == "h:1"


@pytest.mark.parametrize("flag,cls", [
    ("--seq-parallel", "TransformerLM"), ("--model-parallel", "TransformerLM_TP"),
    ("--pipe-parallel", "TransformerLM_PP"),
    ("--expert-parallel", "TransformerLM_MoE")])
def test_bsp_mesh_degree_on_two_gloo_ranks(tmp_path, monkeypatch, capfd,
                                           flag, cls):
    """``BSP -D 2 --<axis>-parallel 2`` at the tests' tiny LM
    (tests/_torch_lm_ranks.py): the launcher builds the mesh, one epoch
    runs, every loss is finite, and the two ranks' checkpoint payloads
    (the whole tree, gathered from the shards) are the same."""
    monkeypatch.setenv("PYTHONPATH", TESTS)
    out = tmp_path / "result.json"
    rc = _launch(["BSP", "-D", "2", "--platform", "cpu", flag, "2", "-m",
                  "_torch_lm_ranks", "-c", cls, "--snapshot-dir",
                  str(tmp_path), "--result-json", str(out)], timeout=150)
    stdout, stderr = capfd.readouterr()
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["world_size"] == 2 and res["epochs_run"] == 1
    rec = res["records"][0]
    assert rec["train_steps"] > 0
    assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["val_loss"])
    assert len(set(res["state_digests"])) == 1


@pytest.mark.parametrize("rule", ["EASGD", "ASGD", "GOSGD"])
def test_async_rules_refuse_a_mesh_degree(rule):
    with pytest.raises(SystemExit, match="are BSP options \\(async rules "
                                         "are data-parallel per worker\\)"):
        launcher.main([rule, "--pipe-parallel", "2", "-m", "x", "-c", "y"])


@pytest.mark.parametrize("modelfile,cls", [
    ("test_torch_launcher", "TinyAlexNet"),
    ("theanompi_tpu_torch.models.cifar10", "Cifar10_model")])
def test_a_mesh_degree_needs_an_lm(tmp_path, workers_import_this_file, capfd,
                                   modelfile, cls):
    """A model that sets no ``batch_partition`` (the zoo) refuses the
    degrees by name, whether it has its own constructor (TinyAlexNet) or
    the base's, which takes ``mesh=`` (Cifar10_model)."""
    rc = _launch(["BSP", "-D", "2", "--platform", "cpu", "--seq-parallel",
                  "2", "-m", modelfile, "-c", cls,
                  "--snapshot-dir", str(tmp_path)], timeout=120)
    assert rc != 0
    assert f"{cls} trains on the data axis alone" in capfd.readouterr().err


def _resilience_run(tmp_path, name, *extra, devices="2"):
    """One ``test_torch_resilience.TinyResNet`` run of ``devices`` gloo
    ranks at 8 images a rank; returns its result JSON."""
    out = tmp_path / f"{name}.json"
    rc = _launch(["BSP", "-D", devices, "--platform", "cpu", "-m",
                  "test_torch_resilience", "-c", "TinyResNet", "--set",
                  "batch_size=8", "--snapshot-dir", str(tmp_path / name),
                  "--result-json", str(out), *extra], timeout=150)
    assert rc == 0
    return json.loads(out.read_text())


def test_two_process_gloo_run_resumed(tmp_path, workers_import_this_file):
    """Two ranks stopped after 2 of 3 epochs and resumed (rank 0 restores
    first, then rank 1, both the same epoch) end as two unbroken ranks
    do: every rank's state digest equal, to each other and to the
    unbroken run's."""
    whole = _resilience_run(tmp_path, "whole")
    first = _resilience_run(tmp_path, "parts", "--epochs", "2")
    assert first["epochs_run"] == 2
    res = _resilience_run(tmp_path, "parts", "--resume", "--sync-type",
                          "avg")
    assert res["world_size"] == 2 and res["epochs_run"] == 1
    assert res["checkpoint"]["restore"]["epoch"] == 1
    assert len(set(res["state_digests"])) == 1
    assert res["state_digests"] == whole["state_digests"]
    assert [r["train_steps"] for r in res["records"]] == [3, 3, 3]


def _two_hosts(tmp_path, name: str, snap: dict[int, str],
               *extra: str) -> dict:
    """One ``--multihost`` session of two launchers of one rank each
    (hosts 0 and 1 on localhost), host ``h`` with snapshot directory
    ``snap[h]``; returns host 0's result (host 1 writes none)."""
    port = str(launcher._free_port())
    outs = {}
    argv = ["BSP", "--multihost", "--coordinator", f"localhost:{port}",
            "--nhosts", "2", "-D", "1", "--platform", "cpu", "-m",
            "test_torch_resilience", "-c", "TinyResNet", "--set",
            "batch_size=8", *extra]
    threads = [threading.Thread(target=lambda h=h: outs.update({
        h: launcher.main(argv + ["--host-id", str(h), "--snapshot-dir",
                                 snap[h], "--result-json",
                                 str(tmp_path / f"{name}{h}.json")])}),
        daemon=True) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
        assert not t.is_alive(), "a host's launcher still running"
    assert outs == {0: 0, 1: 0}
    assert not (tmp_path / f"{name}1.json").exists()
    return json.loads((tmp_path / f"{name}0.json").read_text())


def test_multihost_options_two_hosts_of_one_rank(tmp_path,
                                                 workers_import_this_file):
    """``--multihost`` on two launchers of one rank each: one world of
    two ranks; host 0's rank 0 writes the result."""
    res = _two_hosts(tmp_path, "host", {h: str(tmp_path / f"host{h}")
                                        for h in (0, 1)}, "--epochs", "1")
    assert res["world_size"] == 2 and res["epochs_run"] == 1
    assert len(set(res["state_digests"])) == 1
    assert res["records"][0]["train_steps"] == 3   # 48 images / (2 x 8)


def test_multihost_resume_from_a_shared_snapshot_dir(
        tmp_path, workers_import_this_file):
    """Two hosts that share one snapshot directory: one epoch, then
    ``--resume`` for one more (host 1 reads what host 0's rank 0 wrote)
    ends in the state of two unbroken epochs."""
    whole = _two_hosts(tmp_path, "whole", {h: str(tmp_path / "a")
                                           for h in (0, 1)},
                       "--epochs", "2")
    shared = {h: str(tmp_path / "b") for h in (0, 1)}
    _two_hosts(tmp_path, "first", shared, "--epochs", "1")
    res = _two_hosts(tmp_path, "resumed", shared, "--resume", "--epochs", "1")
    assert res["epochs_run"] == 1
    assert res["checkpoint"]["restore"]["epoch"] == 0
    assert [r["epoch"] for r in res["records"]] == [0, 1]
    assert res["state_digests"] == whole["state_digests"]
    assert len(set(res["state_digests"])) == 1


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="unrecognized"):
        launcher.main(["BSP", "-m", "x", "-c", "y", "--bogus"])
    with pytest.raises(SystemExit, match="unknown rule"):
        launcher.main(["FOO", "-m", "x", "-c", "y"])
    with pytest.raises(SystemExit, match="unknown ModelConfig field"):
        launcher.model_config(launcher.parse_args(
            ["BSP", "-m", "test_torch_launcher", "-c", "TinyAlexNet",
             "--set", "bogus=1"]))
    for argv, what in ((["--multihost", "--nhosts", "2"], "needs"),
                       (["--host-id", "1"], "need --multihost"),
                       (["--multihost", "--coordinator", "h", "--nhosts",
                         "2", "--host-id", "0"], "HOST:PORT"),
                       (["--multihost", "--coordinator", "h:1", "--nhosts",
                         "2", "--host-id", "2"], "not in"),
                       (["--max-restarts", "-1"], ">= 0")):
        with pytest.raises(SystemExit, match=what):
            launcher.main(["BSP", "-m", "x", "-c", "y", *argv])
    if not torch.cuda.is_available():
        # the launcher never picks the CPU by itself
        with pytest.raises(SystemExit, match="--platform cpu"):
            launcher.main(["BSP", "-m", "test_torch_launcher", "-c",
                           "TinyAlexNet"])


def test_serve_refusals():
    """SERVE needs --export-dir and one host, --decode is a SERVE
    option, and the training rules still need -m/-c."""
    for argv, what in ((["SERVE"], "requires --export-dir"),
                       (["BSP", "--decode", "-m", "x", "-c", "y"],
                        "SERVE option"),
                       (["BSP"], "needs -m/--modelfile"),
                       (["SERVE", "--export-dir", "d", "--multihost",
                         "--coordinator", "h:1", "--nhosts", "2",
                         "--host-id", "0"], "single-host")):
        with pytest.raises(SystemExit, match=what):
            launcher.main(argv)
    args = launcher.parse_args(["SERVE", "--export-dir", "d", "--decode"])
    assert args.max_restarts == 2 and args.decode_page_size == 16
    assert (args.decode_pages_per_seq, args.decode_max_seqs,
            args.decode_speculate_k, args.decode_prefill_batch) == (8, 8, 4, 8)
    assert launcher.parse_args(["BSP", "-m", "x", "-c", "y"]).max_restarts == 0


def test_serve_decode_over_tcp_on_the_cpu(tmp_path, monkeypatch):
    """``SERVE --decode --platform cpu``: a tiny TransformerLM export
    served over TCP; two ``generate`` calls give the same greedy tokens
    as the in-process ``DecodeSession``, ``stats`` counts them, and the
    ``shutdown`` op ends the launcher with 0."""
    import socket

    import numpy as np

    from theanompi_tpu_torch.decode import DecodeSession
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.serving import InferenceClient, export_model

    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "launcher-serve-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    model = TransformerLM(config=ModelConfig(batch_size=4,
                                             compute_dtype="float32"),
                          device="cpu", vocab=32, seq_len=16, n_layers=2,
                          d_model=32, n_heads=4)
    export_dir = str(tmp_path / "export")
    export_model(model, export_dir, version=0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=launcher.main([
        "SERVE", "--export-dir", export_dir, "--decode", "--platform",
        "cpu", "--port", str(port), "--serve-host", "127.0.0.1",
        "--reload-poll-s", "0", "--decode-prefill-buckets", "8,16"])),
        daemon=True)
    t.start()
    prompt = np.arange(5, dtype=np.int32)
    sess = DecodeSession(model, page_size=4, pages_per_seq=4,
                         prefill_buckets=(8, 16))
    seq, logits = sess.admit(prompt)
    want = [int(np.argmax(logits))]
    for _ in range(5):
        want.append(int(np.argmax(sess.decode(
            [seq], np.asarray([want[-1]]))[0])))
    client = None
    try:
        for _ in range(300):
            try:
                client = InferenceClient(f"127.0.0.1:{port}")
                break
            except OSError:
                t.join(0.1)
        assert client is not None, "the SERVE launcher never listened"
        for _ in range(2):
            got = client.generate(prompt, max_new=6)
            assert got.tolist() == want
        stats = client.stats()
        assert stats["decode"] and stats["tokens"] == 12
        client.shutdown()
    finally:
        if client is not None:
            client.close()
    t.join(60)
    assert not t.is_alive() and out["rc"] == 0


def test_serve_disaggregated_fleet_on_the_cpu(tmp_path, monkeypatch):
    """``SERVE --decode --disaggregate --platform cpu`` as a process: the
    launcher brings up one prefill and one decode child, each a
    ``theanompi_tpu_torch`` module on ``--device cpu``, and its router
    answers ``RouterClient.generate`` with the in-process
    ``DecodeSession``'s greedy tokens; an interrupt stops the fleet and
    the launcher exits 0."""
    import signal
    import socket
    import subprocess
    import sys

    import numpy as np

    from theanompi_tpu_torch.decode import DecodeSession
    from theanompi_tpu_torch.frontdoor import RouterClient
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.serving import export_model

    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "launcher-front-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    model = TransformerLM(config=ModelConfig(batch_size=4,
                                             compute_dtype="float32"),
                          device="cpu", vocab=32, seq_len=16, n_layers=2,
                          d_model=32, n_heads=4)
    export_dir = str(tmp_path / "export")
    export_model(model, export_dir, version=0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher", "SERVE",
         "--export-dir", export_dir, "--decode", "--disaggregate",
         "--platform", "cpu", "--port", str(port), "--serve-host",
         "127.0.0.1", "--decode-page-size", "4", "--decode-pages-per-seq",
         "4", "--decode-prefill-buckets", "8,16"],
        cwd=os.path.dirname(TESTS), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    prompt = np.arange(5, dtype=np.int32)
    sess = DecodeSession(model, page_size=4, pages_per_seq=4,
                         prefill_buckets=(8, 16))
    seq, logits = sess.admit(prompt)
    want = [int(np.argmax(logits))]
    for _ in range(5):
        want.append(int(np.argmax(sess.decode(
            [seq], np.asarray([want[-1]]))[0])))
    client = None
    try:
        for _ in range(1200):
            try:
                client = RouterClient(f"127.0.0.1:{port}")
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                threading.Event().wait(0.1)
        assert client is not None, "the router never listened"
        assert client.generate(prompt, max_new=6).tolist() == want
        st = client.stats()
        assert st["streams"] == 1 and st["shed"] == 0
        assert [len(st["backends"][r]) for r in ("prefill", "decode")] \
            == [1, 1]
    finally:
        if client is not None:
            client.close()
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=60)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    assert proc.returncode == 0, out[-3000:]
    assert "[frontdoor] PREFILL" in out and "device=cpu" in out
    assert "[serving] DECODE" in out and "device=cpu" in out
    assert "1 prefill / 1 decode on cpu" in out


def test_config_overrides():
    args = launcher.parse_args(
        ["BSP", "-m", "test_torch_launcher", "-c", "TinyAlexNet",
         "--batch-size", "4", "--lr", "0.5", "--set", "weight_decay=0.001",
         "--set", "lr_decay_epochs=3,5", "--set", "track_top5=false"])
    cls, cfg = launcher.model_config(args)
    assert cls is TinyAlexNet
    assert (cfg.batch_size, cfg.learning_rate, cfg.weight_decay,
            cfg.lr_decay_epochs, cfg.track_top5) == (4, 0.5, 0.001, (3, 5),
                                                     False)
    # the recipe's other fields stay
    assert cfg.momentum == 0.9 and cfg.compute_dtype == "float32"
    assert launcher.model_config(launcher.parse_args(
        ["BSP", "-m", "test_torch_launcher", "-c", "TinyAlexNet"]))[1] is None
