"""The served slice on ``device="cpu"``: the port's ``export_model`` ->
``InferenceServer`` -> ``DynamicBatcher`` -> ``InferenceSession`` ->
ResNet, against the JAX package's eval transform plus forward.

The JAX answer for uint8 36x36x3 rows is computed directly:
``make_device_augment(32, IMAGENET_MEAN, IMAGENET_STD)(x, None, False)``
then ``module.apply(..., train=False)`` with both Pallas kernels on
(interpret mode).  Tolerance as in test_torch_resnet.py: f32 logits
within ``rtol=1e-4, atol=1e-5`` (convolution summation order).
"""

import dataclasses
import os
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_resnet import TINY, random_variables, two_torch_threads  # noqa: F401
from theanompi_tpu.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from theanompi_tpu.models.resnet50 import ResNet as JaxResNet
from theanompi_tpu.ops.augment import make_device_augment
from theanompi_tpu_torch.models.bridge import state_dict_from_flax
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.resilience import faults
from theanompi_tpu_torch.serving import (
    BatchPolicy,
    IncompatibleExport,
    InferenceServer,
    Overloaded,
    export_model,
    load_export,
)

N_ROWS = 24


@pytest.fixture(scope="module")
def ref():
    """Two weight sets (v0, v1), request rows, and JAX's answers."""
    jmod = JaxResNet(**TINY, dtype=jnp.float32, bn_act_impl="pallas",
                     pool_impl="pallas")
    v0, v1 = random_variables(jmod, seed=11), random_variables(jmod, seed=12)
    rows = np.random.default_rng(4).integers(0, 256, (N_ROWS, 36, 36, 3),
                                             dtype=np.uint8)
    x = make_device_augment(32, IMAGENET_MEAN, IMAGENET_STD)(
        jnp.asarray(rows), None, False)
    return SimpleNamespace(
        v0=v0, v1=v1, rows=rows,
        want0=np.asarray(jmod.apply(v0, x, train=False)),
        want1=np.asarray(jmod.apply(v1, x, train=False)))


def port_model(variables, n_classes: int = 10) -> ResNet50:
    cfg = dataclasses.replace(ResNet50.default_config(),
                              compute_dtype="float32")
    model = ResNet50(config=cfg, device="cpu", stage_sizes=(1, 1, 1, 1),
                     width=8, n_classes=n_classes, crop=32)
    if variables is not None:
        model.module.load_state_dict(state_dict_from_flax(
            model.module, variables["params"], variables["batch_stats"]))
    return model


def close(got, want) -> bool:
    return np.allclose(got, want, rtol=1e-4, atol=1e-5)


def run_threads(target, n: int, timeout: float = 120.0) -> None:
    """Run ``target(i)`` in ``n`` daemon threads: a client that hangs
    fails the assert below and cannot keep the worker process alive."""
    threads = [threading.Thread(target=target, args=(i,), name=f"client-{i}",
                                daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_submits_match_jax_and_coalesce(ref, tmp_path):
    export_model(port_model(ref.v0), str(tmp_path), version=0)
    server = InferenceServer(str(tmp_path), replicas=2, device="cpu",
                             reload_poll_s=0,
                             policy=BatchPolicy(max_batch=4,
                                                max_delay_ms=50.0))
    server.start()
    barrier = threading.Barrier(8)
    got, errors = {}, []

    def client(i):
        try:
            barrier.wait(timeout=30)
            # rows [3i, 3i+3) as a 1-row and a 2-row request
            for lo, hi in ((3 * i, 3 * i + 1), (3 * i + 1, 3 * i + 3)):
                got[lo] = (lo, server.submit(ref.rows[lo:hi]))
        except Exception as e:
            errors.append(e)

    try:
        run_threads(client, 8)
        stats = server.stats()
    finally:
        server.stop()
    assert not errors, errors
    for lo, out in got.values():
        assert out.dtype == np.float32
        assert close(out, ref.want0[lo:lo + len(out)])
    assert stats["max_occupancy"] > 1, stats
    assert stats["rows"] == sum(len(o) for _, o in got.values())
    assert stats["version"] == 0 and stats["live_replicas"] == 2


def test_hot_reload_follows_new_export_without_failed_requests(ref,
                                                               tmp_path):
    d = str(tmp_path)
    export_model(port_model(ref.v0), d, version=0)
    server = InferenceServer(d, replicas=2, device="cpu", reload_poll_s=0,
                             policy=BatchPolicy(max_batch=4,
                                                max_delay_ms=2.0))
    server.start()
    stop = threading.Event()
    seen, errors = [], []

    def storm(i):
        k = 0
        while not stop.is_set():
            r = (i * 5 + k) % N_ROWS
            k += 1
            try:
                seen.append((r, server.submit(ref.rows[r:r + 1])[0]))
            except Exception as e:
                errors.append(e)

    threads = [threading.Thread(target=storm, args=(i,), name=f"storm-{i}",
                                daemon=True)
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        export_model(port_model(ref.v1), d, version=1)
        assert server.check_reload() == 1
        stop.set()
        for t in threads:
            t.join(60)
        after = server.submit(ref.rows[:4])
        stats = server.stats()
    finally:
        stop.set()
        server.stop()
    assert not errors, errors
    assert seen
    for r, out in seen:
        assert close(out, ref.want0[r]) or close(out, ref.want1[r])
    assert close(after, ref.want1[:4])
    assert stats["version"] == 1
    assert all(rep["version"] == 1 for rep in stats["replicas"])


def test_corrupt_and_incompatible_exports_keep_serving(ref, tmp_path):
    d = str(tmp_path)
    export_model(port_model(ref.v0), d, version=0)
    server = InferenceServer(d, replicas=1, device="cpu", reload_poll_s=0,
                             policy=BatchPolicy(max_batch=4))
    server.start()
    try:
        # v1 published, then its payload rots: verification fails, the
        # load falls back, and the server keeps serving v0
        export_model(port_model(ref.v1), d, version=1)
        path = os.path.join(d, "1", "state.pt")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\xff" * 64)
        assert server.check_reload() == 0
        assert load_export(d).version == 0
        assert close(server.submit(ref.rows[:2]), ref.want0[:2])
        # a strictly newer good version is taken
        export_model(port_model(ref.v1), d, version=2)
        assert server.check_reload() == 2
        assert close(server.submit(ref.rows[:2]), ref.want1[:2])
        # other net dims are refused, every time, and serving goes on
        export_model(port_model(None, n_classes=12), d, version=3)
        for _ in range(2):
            with pytest.raises(IncompatibleExport, match="net dims"):
                server.check_reload()
        assert server.stats()["version"] == 2
        assert close(server.submit(ref.rows[2:4]), ref.want1[2:4])
    finally:
        server.stop()


def test_flood_yields_typed_overloaded(ref, tmp_path):
    export_model(port_model(ref.v0), str(tmp_path), version=0)
    server = InferenceServer(str(tmp_path), replicas=1, device="cpu",
                             reload_poll_s=0,
                             policy=BatchPolicy(max_batch=1, max_queue=1,
                                                max_delay_ms=0.0))
    server.start()
    faults.install([{"site": "serve_step", "action": "delay",
                     "delay_s": 0.05, "times": -1}])
    barrier = threading.Barrier(12)
    ok, rejected, errors = [], [], []

    def client(i):
        barrier.wait(timeout=30)
        try:
            ok.append((i, server.submit(ref.rows[i:i + 1])))
        except Overloaded:
            rejected.append(i)
        except Exception as e:
            errors.append(e)

    try:
        run_threads(client, 12)
        stats = server.stats()
    finally:
        faults.clear()
        server.stop()
    assert not errors, errors
    assert rejected and ok
    assert stats["overloaded"] == len(rejected)
    for i, out in ok:
        assert close(out, ref.want0[i:i + 1])


def test_entry_point_guards(ref, tmp_path):
    d = str(tmp_path)
    model = port_model(ref.v0)
    with pytest.raises(ValueError, match="not ported"):
        export_model(model, d, version=0, weight_dtype="int8")
    export_model(model, d, version=0)
    with pytest.raises(ValueError, match="immutable"):
        export_model(model, d, version=0)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceServer(d)                     # default device, no card
    with pytest.raises(NotImplementedError, match="decode"):
        InferenceServer(d, device="cpu", decode=True)
    meta = load_export(d).meta
    assert meta["modelfile"] == "theanompi_tpu_torch.models.resnet50"
    assert meta["sample_shape"] == [32, 32, 3]
    assert meta["sample_dtype"] == "uint8"
    assert meta["net"] == {"stage_sizes": [1, 1, 1, 1], "width": 8,
                           "n_classes": 10, "crop": 32}


def test_serving_metrics_reach_the_monitor_only_when_enabled(ref, tmp_path):
    import json

    from theanompi_tpu_torch import monitor

    d = str(tmp_path / "export")
    export_model(port_model(ref.v0), d, version=0)

    def serve_two_rows():
        server = InferenceServer(d, device="cpu", reload_poll_s=0).start()
        try:
            server.submit(ref.rows[:2])
        finally:
            server.stop()

    writes = monitor.registry().write_count
    serve_two_rows()
    assert monitor.registry().write_count == writes   # off: no writes
    run_dir = tmp_path / "monitor"
    with monitor.session(str(run_dir), name="serve") as live:
        assert live
        serve_two_rows()
    with open(run_dir / "metrics_serve.jsonl") as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"serving/batches_total", "serving/request_ms",
            "serving/model_version"} <= names


def test_failed_warmup_stops_the_server(ref, tmp_path):
    """Warmup runs on each replica's own thread at start(); if one fails,
    start() raises and stops the replicas that did start."""
    export_model(port_model(ref.v0), str(tmp_path), version=0)
    server = InferenceServer(str(tmp_path), replicas=2, device="cpu",
                             reload_poll_s=0)

    def boom():
        raise RuntimeError("warmup failed")

    server.replicas[1].batcher._warmup = boom
    with pytest.raises(RuntimeError, match="warmup failed"):
        server.start()
    assert not any(r.alive for r in server.replicas)
