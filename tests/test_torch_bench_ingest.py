"""The port's ingest bench (``theanompi_tpu_torch/tools/bench_ingest.py``)
against the JAX tool (``tools/bench_ingest.py``).

* ``build_tree`` writes the JAX tool's shard tree byte for byte.
* A small run of the bench over real reader and trainer processes: the
  N=1 and N=2 fleets deliver the identical byte total and every reader of
  the N=2 fleet serves.
* The smoke gate (the JAX tool's ``smoke_verdict``) exits 1 on each
  planted miss and 0 on a passing document.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
from types import SimpleNamespace

import pytest

from theanompi_tpu_torch.tools import bench_ingest as bi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("THEANOMPI_TPU_SERVICE_KEY", "bench-ingest-test")
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "0")
    monkeypatch.setenv("THEANOMPI_TPU_MONITOR", str(tmp_path / "mon"))


def _jax_tool():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_ingest", os.path.join(tools, "bench_ingest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shard_tree_is_the_jax_tools():
    port, ref = bi.build_tree(3000, 8, 512), _jax_tool().build_tree(3000, 8,
                                                                     512)
    try:
        names = sorted(os.listdir(ref))
        assert sorted(os.listdir(port)) == names and len(names) > 4
        for n in names:
            with open(os.path.join(port, n), "rb") as a, \
                    open(os.path.join(ref, n), "rb") as b:
                assert a.read() == b.read(), n
    finally:
        shutil.rmtree(port)
        shutil.rmtree(ref)


def test_small_fleet_run(tmp_path):
    out = tmp_path / "ingest.json"
    assert bi.main(["--device", "cpu", "--samples", "1024", "--store", "8",
                    "--batch", "32", "--trainers", "1", "--readers", "2",
                    "--shard-size", "128", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [m["readers"] for m in doc["modes"]] == [1, 2]
    assert doc["identical_total_bytes"]
    assert doc["modes"][0]["images"] == 1024
    assert all(s > 0 for s in doc["modes"][1]["served_per_reader"])


def _snapshot(path, readers=("a", "b"), counters=True, shm=False):
    recs = [{"name": "span_ms", "labels": {"span": "ingest_pull",
                                           "reader": r}, "count": 3}
            for r in readers]
    if counters:
        recs += [{"name": "ingest/reader_failovers_total", "labels": {},
                  "value": 1.0},
                 {"name": "ingest/reader_restarts_total", "labels": {},
                  "value": 1.0}]
    if shm:
        recs += [{"name": "shm/grants_total", "labels": {}, "value": 1.0},
                 {"name": "shm/oob_bytes_total", "labels": {},
                  "value": 1e6}]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _doc(scaling=1.8, same=True, recovered=True, served=(5, 4)):
    return {"identical_total_bytes": same,
            "aggregate_scaling_vs_n1": scaling,
            "kill_leg": {"recovered": recovered},
            "modes": [{"readers": 1}, {"readers": 2,
                                      "served_per_reader": list(served)}]}


def test_smoke_gate_exits_1_on_a_planted_miss(tmp_path, monkeypatch):
    args = SimpleNamespace(readers=2, scale_bar=1.7)
    good = _snapshot(tmp_path / "metrics_rank0.jsonl")
    assert bi.smoke_verdict(_doc(), args, good) == 0
    for miss in ({"scaling": 1.69}, {"same": False}, {"recovered": False},
                 {"served": (5, 0)}):
        assert bi.smoke_verdict(_doc(**miss), args, good) == 1, miss
    one = _snapshot(tmp_path / "one.jsonl", readers=("a",))
    assert bi.smoke_verdict(_doc(), args, one) == 1
    bare = _snapshot(tmp_path / "bare.jsonl", counters=False)
    assert bi.smoke_verdict(_doc(), args, bare) == 1
    assert bi.smoke_verdict(_doc(), SimpleNamespace(readers=1,
                                                    scale_bar=1.7),
                            good) == 1
    # with the lane on, the readers' files must show it carried pixels
    monkeypatch.setenv("THEANOMPI_TPU_WIRE_SHM", "1")
    lane_dir = tmp_path / "lane"
    lane_dir.mkdir()
    with_lane = _snapshot(lane_dir / "metrics_rank0.jsonl", shm=True)
    assert bi.smoke_verdict(_doc(), args, with_lane) == 0
    assert bi.smoke_verdict(_doc(), args, good) == 1
