"""The port's exchange bench (``theanompi_tpu_torch/tools/bench_exchange.py``)
against the JAX tool (``tools/bench_exchange.py``).

* The trees: ``resnet50_like_tree`` and ``lattice_tree`` give arrays
  byte-identical to the JAX tool's at seeds 0 and 1.
* The byte accounting of every (protocol, compression, dtype) mode equals
  the JAX tool's on the same request (its ``_pickle_len`` and JAX's
  ``wire.encode_frame``), on a ~1e5-parameter tree, both for the JAX
  tool's dict request and for the port's list request; and it equals the
  bytes the port's client and service put on the socket, read back from
  the monitor's ``service/wire_bytes_post``.
* Every gate exits 1 on a planted miss and 0 on a passing document; the
  JAX tool's flag-conflict matrix exits 2.
* The B=4 against B=1 train-step bit-identity on 2 gloo ranks.
* The stage split runs every stage of an exchange on a small tree.
The full ``--smoke`` legs belong to the preflight.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest

from theanompi_tpu.parallel import wire as jwire
from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.tools import _bench
from theanompi_tpu_torch.tools import bench_exchange as bx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    """A JAX tool module from ``tools/`` (it imports its ``_bootstrap``
    sibling)."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbx():
    return _jax_tool("bench_exchange")


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "bench-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    yield
    monitor.reset_for_tests()


def small_tree(target: int = 100_000) -> dict:
    """The first leaves of the ResNet-50-like tree, up to ``target``
    parameters: its leaf mix at a test's size."""
    out, n = {}, 0
    for k, v in bx.resnet50_like_tree(target).items():
        if n + v.size > target:
            continue
        out[k] = v
        n += v.size
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_trees_byte_equal_to_jax(jbx, seed):
    for name in ("resnet50_like_tree", "lattice_tree"):
        port = getattr(bx, name)(1e5, seed=seed)
        ref = getattr(jbx, name)(1e5, seed=seed)
        assert list(port) == list(ref)
        for k in ref:
            assert port[k].dtype == ref[k].dtype and \
                port[k].tobytes() == ref[k].tobytes(), (name, k)
    assert bx.tree_params(port) == jbx.tree_params(ref)


def _jax_accounting(jbx, request, reply, protocol, compression, dtype):
    """The JAX tool's ``measure_mode`` accounting (its lines for bytes),
    on a request of our choosing."""
    opts = jwire.WireOptions(compression=compression, dtype=dtype)
    if protocol == "v2":
        _, _, st_req = jwire.encode_frame(request, opts)
        _, _, st_rep = jwire.encode_frame(reply, opts)
        return st_req.post_bytes, st_rep.post_bytes, st_req.pre_bytes
    sent = jbx._pickle_len(request)
    return sent, jbx._pickle_len(reply), sent


@pytest.mark.parametrize("protocol,compression,dtype", bx.MODES)
def test_bytes_per_exchange_equal_jax_accounting(jbx, protocol,
                                                 compression, dtype):
    tree = small_tree()
    assert 90_000 < bx.tree_params(tree) <= 100_000
    sid = f"bench-{protocol}-{compression}-{dtype}"
    for request, reply in (
            (("easgd_exchange", sid, tree), ("ok", tree)),  # JAX's
            (("easgd_exchange", sid, bx.tree_leaves(tree)),  # the port's
             ("ok", bx.tree_leaves(tree)))):
        got = bx.exchange_bytes(request, reply, protocol, compression,
                                dtype)
        sent, recv, pre = _jax_accounting(jbx, request, reply, protocol,
                                          compression, dtype)
        assert (got["bytes_sent_per_exchange"],
                got["bytes_recv_per_exchange"], got["pre_bytes"]) == \
            (sent, recv, pre)
        assert got["bytes_per_exchange"] == sent + recv


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_accounting_is_what_the_socket_carries(tmp_path, monkeypatch,
                                               dtype):
    """One v2 exchange through the port's service: the monitor's
    ``service/wire_bytes_post`` sent by the client and the service
    equals the accounting's request + reply bytes."""
    from theanompi_tpu_torch.parallel.service import serve

    monkeypatch.setenv("THEANOMPI_TPU_MONITOR", str(tmp_path))
    tree = small_tree()
    port = _bench.free_port()
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=serve, args=("127.0.0.1", port, ready,
                                              stop),
                          kwargs=dict(device="cpu"), daemon=True)
    th.start()
    assert ready.wait(10)
    try:
        with monitor.session(stall_after=float("inf")):
            r = bx.measure_mode(f"127.0.0.1:{port}", "v2", "none", dtype,
                                tree, 1, "cpu")
            reg = monitor.registry()
            before = reg.value("service/wire_bytes_post", dir="send")
            r = bx.measure_mode(f"127.0.0.1:{port}", "v2", "none", dtype,
                                tree, 1, "cpu")
    finally:
        stop.set()
        th.join(timeout=10)
    # the second call's init ships the tree once more (its reply is None)
    init_bytes = bx.exchange_bytes(
        ("easgd_init", bx.tree_leaves(tree), 0.5, f"bench-v2-none-{dtype}"),
        ("ok", None), "v2", "none", dtype)["bytes_per_exchange"]
    sent = reg.value("service/wire_bytes_post", dir="send") - before
    assert sent == init_bytes + r["bytes_per_exchange"], (sent, init_bytes,
                                                          r)


def test_stage_split_runs_every_stage():
    tree = small_tree(20_000)
    split = bx.stage_split(tree, "cpu", rounds=1)
    assert list(split["stages"]) == [
        "worker_d2h", "encode_request", "socket_request", "server_decode",
        "server_pinned_copy", "server_h2d", "merge", "reply_cpu",
        "encode_reply", "socket_reply", "client_decode",
        "client_pinned_copy", "client_h2d"]
    assert all(s["ms_mean"] >= 0 for s in split["stages"].values())
    assert split["tree_bytes"] == bx.tree_nbytes(tree)
    assert split["sum_ms"] > 0 and 0 <= split["device_copy_share"] <= 1


@pytest.mark.parametrize("argv", [
    ["--shm-compare", "--shards", "2"], ["--shm-compare", "--buckets", "4"],
    ["--buckets", "4", "--shards", "2"],
    ["--local-workers", "4", "--buckets", "4"], ["--local-workers", "0"]])
def test_flag_conflicts_exit_2(argv, jbx):
    with pytest.raises(SystemExit) as port_exit:
        bx.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jbx.main(argv)
    assert port_exit.value.code == jax_exit.value.code == 2


def _jsonl(path, names):
    with open(path, "w") as f:
        for name, labels, extra in names:
            f.write(json.dumps({"name": name, "labels": labels,
                                **extra}) + "\n")
    return str(path)


def test_default_gate_exits_1_on_a_planted_miss(tmp_path):
    def doc(v1=100, zlib=90, cut=0.5):
        modes = [{"protocol": "v1", "compression": "none", "dtype": "f32",
                  "bytes_per_exchange": v1},
                 {"protocol": "v2", "compression": "zlib", "dtype": "f32",
                  "bytes_per_exchange": zlib}]
        return {"modes": modes, "v2_bf16_vs_v1_byte_cut": cut}
    good = _jsonl(tmp_path / "g.jsonl",
                  [("service/wire_compression_ratio", {}, {"value": 0.9})])
    bad = _jsonl(tmp_path / "b.jsonl", [("service/clients", {}, {})])
    assert bx.smoke_verdict_default(doc(), good) == 0
    assert bx.smoke_verdict_default(doc(zlib=100), good) == 1
    assert bx.smoke_verdict_default(doc(cut=0.44), good) == 1
    assert bx.smoke_verdict_default(doc(), bad) == 1


def test_bucket_gate_exits_1_on_a_planted_miss(tmp_path):
    def doc(bf16=True, pair=True, launched=4):
        return {"step_equivalence": {
                    "buckets": 4, "per_rank": {},
                    "promised": bf16 and pair, "f32_all_ranks": False},
                "modes": [{"dtype": "f32", "buckets": 4, "plan_buckets": 4,
                           "collectives_per_exchange": [launched]}]}
    good = _jsonl(tmp_path / "g.jsonl",
                  [("bsp/exchange_buckets", {"plane": "bsp"},
                    {"value": 4})])
    assert bx.smoke_verdict_buckets(doc(), good) == 0
    assert bx.smoke_verdict_buckets(doc(bf16=False), good) == 1
    assert bx.smoke_verdict_buckets(doc(pair=False), good) == 1
    assert bx.smoke_verdict_buckets(doc(launched=1), good) == 1
    assert bx.smoke_verdict_buckets(doc(), str(tmp_path / "none")) == 1


def test_shard_gate_exits_1_on_a_planted_miss(tmp_path):
    def doc(improve=0.2, killed=True, lane=False):
        return {"modes": [{"shards": 1, "wall_ms_mean": 10},
                          {"shards": 2, "wall_ms_mean": 8}],
                "aggregate_wall_improvement_vs_k1": improve,
                "kill_recovered": killed, "shm_lane_on": lane}
    series = [("span_ms", {"span": "shard_exchange", "worker": "0"},
               {"count": 3}),
              ("span_ms", {"span": "shard_exchange", "worker": "1"},
               {"count": 3}),
              ("service/client_reconnects_total", {}, {"value": 1}),
              ("service/shard_restarts_total", {}, {"value": 1})]
    good = _jsonl(tmp_path / "g.jsonl", series)
    lane = _jsonl(tmp_path / "l.jsonl", series + [
        ("shm/grants_total", {}, {"value": 2}),
        ("shm/oob_bytes_total", {}, {"value": 1e6})])
    one_shard = _jsonl(tmp_path / "o.jsonl", series[:1] + series[2:])
    assert bx.smoke_verdict_sharded(doc(), 2, good) == 0
    assert bx.smoke_verdict_sharded(doc(lane=True), 2, lane) == 0
    assert bx.smoke_verdict_sharded(doc(improve=-0.01), 2, good) == 1
    assert bx.smoke_verdict_sharded(doc(killed=False), 2, good) == 1
    assert bx.smoke_verdict_sharded(doc(), 2, one_shard) == 1
    assert bx.smoke_verdict_sharded(doc(lane=True), 2, good) == 1
    assert bx.smoke_verdict_sharded(doc(), 1, good) == 1


def test_hierarchy_gate_exits_1_on_a_planted_miss(tmp_path):
    def doc(x=4.0, closed=0.0, asgd=True, hier=25, direct=100):
        return {"modes": [{"shards": 2, "local_workers": 4,
                           "wire_byte_reduction_x": x,
                           "hierarchical": {"wire_bytes_per_period": hier},
                           "direct": {"wire_bytes_per_period": direct},
                           "easgd_closed_form_max_abs_diff": closed}],
                "asgd_delta_sum_byte_identical": asgd}
    good = _jsonl(tmp_path / "g.jsonl", [
        ("aggregate/fan_in", {"rule": "easgd"}, {"value": 4.0}),
        ("span_ms", {"span": "local_aggregate", "rule": "easgd"},
         {"count": 2})])
    no_spans = _jsonl(tmp_path / "n.jsonl", [
        ("aggregate/fan_in", {"rule": "easgd"}, {"value": 4.0})])
    assert bx.smoke_verdict_hierarchy(doc(), 4, 2, good) == 0
    assert bx.smoke_verdict_hierarchy(doc(x=3.8), 4, 2, good) == 1
    assert bx.smoke_verdict_hierarchy(doc(closed=2.0**-10), 4, 2, good) == 1
    assert bx.smoke_verdict_hierarchy(doc(asgd=None), 4, 2, good) == 1
    assert bx.smoke_verdict_hierarchy(doc(hier=100), 4, 2, good) == 1
    assert bx.smoke_verdict_hierarchy(doc(), 4, 2, no_spans) == 1


def test_shm_gate_exits_1_on_a_planted_miss():
    def doc(**miss):
        d = {"planes": {
            "exchange": {"byte_identical": True,
                         "wall_cut_shm_vs_in_band": 0.3,
                         "legs": {"shm": {"shm_grants": 1, "oob_bytes": 10,
                                          "oob_tail_growth": 0},
                                  "in_band": {"shm_grants": 0,
                                              "oob_bytes": 0}},
                         "kill_leg": {"leased_at_kill": 1,
                                      "leaked_after_sweep": 0}},
            "ingest": {"byte_identical": True,
                       "img_s_ratio_shm_over_in_band": 1.5},
            "serving": {"byte_identical": True,
                        "legs": {"shm": {"oob_bytes_recv": 5}}}},
             "leaked_segments_final": 0}
        for path, v in miss.items():
            node = d
            *head, last = path.split("__")
            for h in head:
                node = node[h]
            node[last] = v
        return d
    assert bx.smoke_verdict_shm(doc()) == 0
    for miss in ({"planes__exchange__wall_cut_shm_vs_in_band": 0.2},
                 {"planes__exchange__byte_identical": False},
                 {"planes__exchange__legs__shm__oob_tail_growth": 4},
                 {"planes__exchange__kill_leg__leaked_after_sweep": 1},
                 {"planes__ingest__img_s_ratio_shm_over_in_band": 1.2},
                 {"planes__serving__byte_identical": False},
                 {"leaked_segments_final": 1}):
        assert bx.smoke_verdict_shm(doc(**miss)) == 1, miss


_RANK = """
import sys, json
import torch.distributed as dist
from theanompi_tpu_torch.tools import bench_exchange as bx
r, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=r)
print(json.dumps(bx.step_equivalences(4, r, 2, "cpu")))
dist.destroy_process_group()
"""


def test_bucketed_step_bit_identical_on_two_gloo_ranks():
    from theanompi_tpu_torch.parallel.shards import child_env

    port = str(_bench.free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port],
                              env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        got = json.loads(out.strip().splitlines()[-1])
        assert got == {"bf16": True, "f32": True, "f32_two_ranks": True}
