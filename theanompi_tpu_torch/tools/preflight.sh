#!/bin/bash
# Preflight gate of the PyTorch/CUDA port, all on the CPU (the counterpart
# of tools/preflight.sh's steps for the JAX package): the port's static
# checker suite, its tests with the slow ones, the entry points on
# four gloo ranks, the monitor, collector, resilience, serving, decode
# and front-door smokes through the port's launcher and CLIs, and the
# host planes' bench smokes in JAX's order and with its arguments plus
# --device cpu: the exchange, bucketed, shard and hierarchy smokes
# (theanompi_tpu_torch/tools/bench_exchange.py), the rpc soak, the ingest
# smoke and the rpc smoke (bench_rpc.py, bench_ingest.py beside it).
#
# Usage:  bash theanompi_tpu_torch/tools/preflight.sh [LOG]
# Exit 0 = green.  Writes the whole output to LOG (default
# build/preflight_torch.log).  Run from anywhere; about 30-40 minutes.
set -u
cd "$(dirname "$0")/../.."
LOG="${1:-build/preflight_torch.log}"
mkdir -p "$(dirname "$LOG")"
export PYTHONPATH="$PWD:$PWD/tests${PYTHONPATH:+:$PYTHONPATH}"
export THEANOMPI_TPU_SERVICE_KEY="${THEANOMPI_TPU_SERVICE_KEY:-preflight-$$}"
LAUNCH="python -m theanompi_tpu_torch.launcher"
# The shm lane must have carried payload in a same-host smoke: a grant
# landed and out-of-band bytes flowed, in the monitor JSONL the smoke
# wrote (a silent fallback everywhere would keep the smoke green).
shm_lane_evidence() {  # $1 = monitor dir, $2 = plane label
  python - "$1" "$2" <<'PYEOF'
import glob, json, os, sys
mondir, label = sys.argv[1], sys.argv[2]
grants = oob = 0.0
for path in glob.glob(os.path.join(mondir, "**", "*.jsonl"),
                      recursive=True):
    for line in open(path):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        series = [rec] if "name" in rec else rec.get("snapshot") or []
        for s in series:
            if s.get("name") == "shm/grants_total":
                grants = max(grants, s.get("value") or 0.0)
            elif s.get("name") == "shm/oob_bytes_total":
                oob = max(oob, s.get("value") or 0.0)
if grants < 1 or oob <= 0:
    print(f"shm lane evidence MISSING for {label}: "
          f"grants={grants:.0f} oob_bytes={oob:.0f}")
    sys.exit(1)
print(f"shm lane evidence ({label}): grants>={grants:.0f}, "
      f"{oob/1e6:.3f} MB out-of-band")
PYEOF
}
# A free TCP port on the loopback.
free_port() {
  python -c 'import socket; s = socket.socket(); s.bind(("127.0.0.1", 0)); print(s.getsockname()[1])'
}
{
  echo "# preflight (port) $(date -u +%Y-%m-%dT%H:%M:%SZ) HEAD=$(git rev-parse --short HEAD 2>/dev/null)"
  echo "## tmlint --gate (the port's static checker suite)"
  python theanompi_tpu_torch/tools/tmlint.py --gate
  TMLINT_RC=$?
  echo "tmlint rc=$TMLINT_RC"
  echo "## pytest slow-subset gate (-m gate) over the port's tests"
  # rc 5: no port test carries the gate marker yet
  python -m pytest tests/test_torch_*.py --runslow -q -m gate
  GATE_RC=$?
  [ "$GATE_RC" -eq 5 ] && GATE_RC=0
  echo "gate subset rc=$GATE_RC"
  echo "## pytest --runslow (-m 'not gate') over the port's tests"
  python -m pytest tests/test_torch_*.py --runslow -q -m 'not gate'
  PYTEST_RC=$?
  echo "pytest rc=$PYTEST_RC"
  echo "## entry.py (entry() forward, dryrun_multichip(4) on gloo)"
  python -m theanompi_tpu_torch.entry --device cpu -n 4
  ENTRY_RC=$?
  echo "entry rc=$ENTRY_RC"
  echo "## monitor smoke (launcher BSP on the CPU with --monitor-dir)"
  # the snapshot JSONL parses and carries the core series, one step_ms
  # observation a step, and the heartbeat is fresh
  MONDIR="$(mktemp -d)"
  $LAUNCH BSP -D 1 --platform cpu -m test_torch_launcher -c TinyAlexNet \
    --snapshot-dir "$MONDIR/snap" --monitor-dir "$MONDIR" \
    > "$MONDIR/launcher.out" 2>&1 \
  && python - "$MONDIR" <<'PYEOF'
import json, os, sys, time
mondir = sys.argv[1]
recs = [json.loads(l)
        for l in open(os.path.join(mondir, "metrics_rank0.jsonl"))]
names = {r["name"] for r in recs}
missing = {"step_ms", "span_ms", "recorder/section_ms"} - names
assert not missing, f"snapshot missing core series: {missing}"
steps = [r for r in recs if r["name"] == "step_ms"][-1]
assert steps["count"] == 8, f"expected 8 step observations: {steps}"
hb = json.load(open(os.path.join(mondir, "heartbeat_rank0.json")))
assert time.time() - hb["written"] < 120, f"stale heartbeat: {hb}"
assert hb["stalled"] is False
print(f"monitor smoke OK: {len(names)} series, step p50 "
      f"{steps['p50']:.1f}ms, heartbeat fresh")
PYEOF
  MONITOR_RC=$?
  [ "$MONITOR_RC" -ne 0 ] && tail -20 "$MONDIR/launcher.out"
  rm -rf "$MONDIR"
  echo "monitor smoke rc=$MONITOR_RC"
  echo "## collector smoke (launcher EASGD over a 2-shard fleet with --collector)"
  # one fleet.jsonl: an exchange trace spans >= 3 processes (the trainer
  # and both shards) with 0 orphans; tools/traces.py prints its critical
  # path and runs the idle-gap detector; tools/tmtop.py renders a frame;
  # the shard exchange rode the shm lane
  COLDIR="$(mktemp -d)"
  $LAUNCH EASGD -D 2 --platform cpu -m test_torch_async_rules -c TinyCifar \
    --tau 2 --epochs 1 --shards 2 --collector --monitor-dir "$COLDIR" \
    --snapshot-dir "$COLDIR/snap" --set batch_size=8 \
    > "$COLDIR/launcher.out" 2>&1
  COLLECTOR_RC=$?
  if [ "$COLLECTOR_RC" -eq 0 ]; then
    python tools/traces.py "$COLDIR" --require-procs 3 --gap-ms 5000 \
      > "$COLDIR/traces.out" 2>&1
    COLLECTOR_RC=$?
    grep -q "critical path" "$COLDIR/traces.out" || COLLECTOR_RC=1
    grep -q "idle-all-workers gaps" "$COLDIR/traces.out" || COLLECTOR_RC=1
    sed -n '1,8p' "$COLDIR/traces.out"
    python tools/tmtop.py "$COLDIR" --once || COLLECTOR_RC=1
    shm_lane_evidence "$COLDIR" "shard exchange" || COLLECTOR_RC=1
  else
    tail -20 "$COLDIR/launcher.out"
  fi
  rm -rf "$COLDIR"
  echo "collector smoke rc=$COLLECTOR_RC"
  echo "## resilience smoke (launcher EASGD, worker 1 killed at step 3)"
  # the supervised worker restarts from the center, the run exits 0,
  # and the recovery lands in the monitor JSONL
  FAULTDIR="$(mktemp -d)"
  $LAUNCH EASGD -D 2 --platform cpu -m test_torch_async_rules -c TinyCifar \
    --tau 4 --epochs 1 --max-restarts 1 --monitor-dir "$FAULTDIR" \
    --snapshot-dir "$FAULTDIR/snap" --set batch_size=8 \
    --fault-plan '[{"site": "worker_step", "rule": "easgd", "worker": 1, "step": 3}]' \
    --result-json "$FAULTDIR/result.json" > "$FAULTDIR/launcher.out" 2>&1 \
  && python - "$FAULTDIR" <<'PYEOF'
import json, math, os, sys
mondir = sys.argv[1]
res = json.load(open(os.path.join(mondir, "result.json")))
assert res["restarts"] == {"1": 1}, res.get("restarts")
assert res["lost_workers"] == [], res.get("lost_workers")
assert all(math.isfinite(v) for v in res["val"].values()), res["val"]
names = {json.loads(l)["name"]
         for l in open(os.path.join(mondir, "metrics_rank0.jsonl"))}
assert "resilience/worker_restarts_total" in names, sorted(names)
assert "resilience/faults_injected_total" in names
print("resilience smoke OK: worker 1 killed at step 3, restarted from "
      "the center, recovery in the monitor JSONL")
PYEOF
  RESILIENCE_RC=$?
  [ "$RESILIENCE_RC" -ne 0 ] && tail -20 "$FAULTDIR/launcher.out"
  rm -rf "$FAULTDIR"
  echo "resilience smoke rc=$RESILIENCE_RC"
  echo "## serving smoke (export -> launcher SERVE -> concurrent clients)"
  # a multi-request batch forms and the request-latency histogram lands
  # in the monitor JSONL
  SERVEDIR="$(mktemp -d)"
  python - "$SERVEDIR" "$(free_port)" <<'PYEOF'
import glob, json, os, subprocess, sys, threading, time
import numpy as np
from theanompi_tpu_torch.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.serving import InferenceClient, export_model

mondir, port = sys.argv[1], sys.argv[2]
model = ResNet50(config=ModelConfig(batch_size=4, compute_dtype="float32"),
                 device="cpu", stage_sizes=(1, 1, 1, 1), width=8,
                 n_classes=10, crop=32,
                 data=ImageNet_data(crop=32, synthetic_n=16,
                                    synthetic_pool=4, synthetic_store=36,
                                    n_classes=10))
export_dir = os.path.join(mondir, "export")
export_model(model, export_dir, version=0)
proc = subprocess.Popen(
    [sys.executable, "-m", "theanompi_tpu_torch.launcher", "SERVE",
     "--export-dir", export_dir, "--platform", "cpu", "--port", port,
     "--serve-host", "127.0.0.1", "--max-batch", "4", "--max-delay-ms",
     "50", "--serve-buckets", "4", "--monitor-dir", mondir],
    stdout=open(os.path.join(mondir, "serve.out"), "w"),
    stderr=subprocess.STDOUT)
try:
    for _ in range(600):
        try:
            InferenceClient(f"127.0.0.1:{port}").close()
            break
        except OSError:
            assert proc.poll() is None, open(
                os.path.join(mondir, "serve.out")).read()
            time.sleep(0.1)
    x = np.random.default_rng(0).integers(0, 256, (8, 36, 36, 3),
                                          dtype=np.uint8)
    clients = [InferenceClient(f"127.0.0.1:{port}") for _ in range(8)]
    outs = [None] * 8
    ths = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, clients[i].infer(x[i:i + 1]))) for i in range(8)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(120)
    st = clients[0].stats()
    assert st["max_occupancy"] > 1, f"no dynamic batch formed: {st}"
    assert all(o is not None and o.shape == (1, 10) for o in outs), outs
    clients[0].shutdown()
    for c in clients:
        c.close()
    proc.wait(60)
finally:
    if proc.poll() is None:
        proc.kill()
        proc.wait()
(path,) = glob.glob(os.path.join(mondir, "metrics_serve*.jsonl"))
recs = [json.loads(l) for l in open(path)]
names = {r["name"] for r in recs}
missing = {"serving/request_ms", "serving/batch_occupancy",
           "serving/requests_total"} - names
assert not missing, f"snapshot missing serving series: {missing}"
lat = [r for r in recs if r["name"] == "serving/request_ms"][-1]
assert lat["count"] == 8 and "p99" in lat, lat
print(f"serving smoke OK: occupancy_max={st['max_occupancy']}, "
      f"{st['batches']} batches / {st['rows']} rows, request p99 "
      f"{lat['p99']:.1f}ms in monitor JSONL")
PYEOF
  SERVING_RC=$?
  rm -rf "$SERVEDIR"
  echo "serving smoke rc=$SERVING_RC"
  echo "## decode smoke (LM + bf16 draft -> launcher SERVE --decode -> shared-prefix streams)"
  # a warm stream, then two concurrent streams sharing its page-aligned
  # prefix: every stream equals the in-process DecodeSession's greedy
  # tokens, speculation accepts a draft token, the prefix cache hits,
  # and the decode series land in the monitor JSONL
  DECODEDIR="$(mktemp -d)"
  python - "$DECODEDIR" "$(free_port)" <<'PYEOF'
import glob, json, os, subprocess, sys, threading, time
import numpy as np
from theanompi_tpu_torch.decode import DecodeSession
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.serving import InferenceClient, export_model

mondir, port = sys.argv[1], sys.argv[2]
model = TransformerLM(config=ModelConfig(batch_size=4,
                                         compute_dtype="float32"),
                      device="cpu", vocab=32, seq_len=16, n_layers=2,
                      d_model=16, n_heads=2)
export_dir = os.path.join(mondir, "export")
draft_dir = os.path.join(mondir, "draft")
export_model(model, export_dir, version=0)
export_model(model, draft_dir, version=0, weight_dtype="bf16")
sess = DecodeSession(model, page_size=4, pages_per_seq=8,
                     prefill_buckets=(8,))


def oracle(prompt, n):
    seq, logits = sess.admit(prompt)
    out = [int(np.argmax(logits))]
    while len(out) < n:
        out.append(int(np.argmax(sess.decode([seq],
                                             np.asarray([out[-1]]))[0])))
    sess.release(seq)
    return out


proc = subprocess.Popen(
    [sys.executable, "-m", "theanompi_tpu_torch.launcher", "SERVE",
     "--export-dir", export_dir, "--decode", "--platform", "cpu",
     "--port", port, "--serve-host", "127.0.0.1",
     "--decode-page-size", "4", "--decode-pages-per-seq", "8",
     "--decode-max-seqs", "4", "--decode-prefill-buckets", "8",
     "--decode-draft-export-dir", draft_dir, "--decode-speculate-k", "3",
     "--monitor-dir", mondir],
    stdout=open(os.path.join(mondir, "serve.out"), "w"),
    stderr=subprocess.STDOUT)
try:
    for _ in range(600):
        try:
            InferenceClient(f"127.0.0.1:{port}").close()
            break
        except OSError:
            assert proc.poll() is None, open(
                os.path.join(mondir, "serve.out")).read()
            time.sleep(0.1)
    rng = np.random.default_rng(0)
    warm = rng.integers(0, 32, 6).astype(np.int32)
    prompts = [np.concatenate([warm[:4], rng.integers(0, 32, 2)]).astype(
        np.int32) for _ in range(2)]
    clients = [InferenceClient(f"127.0.0.1:{port}") for _ in range(2)]
    assert list(clients[0].generate(warm, 10)) == oracle(warm, 10)
    outs = [None] * 2
    ths = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, clients[i].generate(prompts[i], 10))) for i in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(120)
    for p, o in zip(prompts, outs):
        assert o is not None and list(o) == oracle(p, 10), (o, p)
    st = clients[0].stats()
    assert st["decode"] is True
    assert st["accept_rate"] and st["accept_rate"] > 0, \
        f"speculation accepted nothing: {st}"
    assert st["prefix_cache_hits"] >= 1, f"no prefix hit: {st}"
    clients[0].shutdown()
    for c in clients:
        c.close()
    proc.wait(60)
finally:
    if proc.poll() is None:
        proc.kill()
        proc.wait()
(path,) = glob.glob(os.path.join(mondir, "metrics_serve*.jsonl"))
recs = [json.loads(l) for l in open(path)]
names = {r["name"] for r in recs}
missing = {"decode/intertoken_ms", "decode/tokens_total",
           "decode/steps_total", "decode/accept_rate",
           "decode/draft_tokens_total",
           "decode/prefix_cache_hits_total"} - names
assert not missing, f"snapshot missing decode series: {missing}"
itl = [r for r in recs if r["name"] == "decode/intertoken_ms"][-1]
print(f"decode smoke OK: {st['tokens']} tokens / {st['steps']} steps, "
      f"accept_rate {st['accept_rate']:.2f}, prefix hits "
      f"{st['prefix_cache_hits']}, intertoken p99 {itl['p99']:.1f}ms in "
      "monitor JSONL")
PYEOF
  DECODE_RC=$?
  rm -rf "$DECODEDIR"
  echo "decode smoke rc=$DECODE_RC"
  echo "## frontdoor smoke (launcher SERVE --decode --disaggregate: router + 2 prefill + 1 decode processes)"
  # three concurrent streams through the router equal the in-process
  # greedy tokens, none is shed, and the KV pages crossed the shm lane
  # (the toy model's pages are far under the lane's 64 KB floor: the
  # smoke lowers it to 256 bytes)
  FRONTDIR="$(mktemp -d)"
  THEANOMPI_TPU_SHM_MIN_BYTES=256 python - "$FRONTDIR" "$(free_port)" <<'PYEOF'
import os, signal, subprocess, sys, threading, time
import numpy as np
from theanompi_tpu_torch.decode import DecodeSession
from theanompi_tpu_torch.frontdoor import RouterClient
from theanompi_tpu_torch.models.base import ModelConfig
from theanompi_tpu_torch.models.transformer import TransformerLM
from theanompi_tpu_torch.serving import export_model

mondir, port = sys.argv[1], sys.argv[2]
model = TransformerLM(config=ModelConfig(batch_size=4,
                                         compute_dtype="float32"),
                      device="cpu", vocab=32, seq_len=32, n_layers=2,
                      d_model=16, n_heads=2)
export_dir = os.path.join(mondir, "export")
export_model(model, export_dir, version=0)
sess = DecodeSession(model, page_size=4, pages_per_seq=8,
                     prefill_buckets=(8,))
rng = np.random.default_rng(0)
prompts = [rng.integers(0, 32, 5).astype(np.int32) for _ in range(2)]
prompts.append(prompts[0].copy())
want = []
for p in prompts:
    seq, logits = sess.admit(p)
    toks = [int(np.argmax(logits))]
    while len(toks) < 6:
        toks.append(int(np.argmax(sess.decode([seq],
                                              np.asarray([toks[-1]]))[0])))
    sess.release(seq)
    want.append(toks)
proc = subprocess.Popen(
    [sys.executable, "-m", "theanompi_tpu_torch.launcher", "SERVE",
     "--export-dir", export_dir, "--decode", "--disaggregate",
     "--prefill-replicas", "2", "--serve-replicas", "1", "--platform",
     "cpu", "--port", port, "--serve-host", "127.0.0.1",
     "--decode-page-size", "4", "--decode-pages-per-seq", "8",
     "--decode-max-seqs", "4", "--decode-prefill-buckets", "8",
     "--monitor-dir", mondir],
    stdout=open(os.path.join(mondir, "serve.out"), "w"),
    stderr=subprocess.STDOUT, start_new_session=True)
try:
    client = None
    for _ in range(1800):
        try:
            client = RouterClient(f"127.0.0.1:{port}")
            break
        except OSError:
            assert proc.poll() is None, open(
                os.path.join(mondir, "serve.out")).read()
            time.sleep(0.1)
    assert client is not None, "the router never listened"
    outs = [None] * 3

    def gen(i):
        c = RouterClient(f"127.0.0.1:{port}")
        try:
            outs[i] = c.generate(prompts[i], 6)
        finally:
            c.close()

    ths = [threading.Thread(target=gen, args=(i,)) for i in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(180)
    assert [None if o is None else list(o) for o in outs] == want, \
        (outs, want)
    st = client.stats()
    client.close()
    assert st["streams"] >= 3 and st["shed"] == 0, st
    assert [len(st["backends"][r]) for r in ("prefill", "decode")] \
        == [2, 1], st
    time.sleep(3.0)  # the children's exporters flush their tails
finally:
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(60)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
print(f"frontdoor smoke OK: {st['streams']} streams through router + 2 "
      "prefill + 1 decode processes, tokens equal to the in-process "
      "session's, 0 shed")
PYEOF
  FRONTDOOR_RC=$?
  if [ "$FRONTDOOR_RC" -eq 0 ]; then
    shm_lane_evidence "$FRONTDIR" "disagg kv pages" || FRONTDOOR_RC=1
  fi
  rm -rf "$FRONTDIR"
  echo "frontdoor smoke rc=$FRONTDOOR_RC"
  BENCH="python -m theanompi_tpu_torch.tools"
  echo "## exchange-bench smoke (wire v1 vs v2 over real sockets, every mode)"
  # the ~25M-parameter tree through the port's service in every protocol
  # x compression x dtype mode: v2 (lossless zlib/f32) beats v1 on bytes,
  # the bf16 cut is >= 45%, the compression-ratio gauge is in the monitor
  # JSONL; then the stage split of one in-band exchange
  EXCHDIR="$(mktemp -d)"
  THEANOMPI_TPU_MONITOR="$EXCHDIR" $BENCH.bench_exchange --device cpu \
    --smoke --out "$EXCHDIR/BENCH_wire_smoke.json"
  EXCHANGE_RC=$?
  rm -rf "$EXCHDIR"
  echo "exchange smoke rc=$EXCHANGE_RC"
  echo "## bucketed-exchange smoke (B=4 against B=1 on 4 gloo ranks)"
  # B collectives launched an exchange, a B=4 train step bit-identical to
  # B=1 over 3 iterations where the exchanger promises it (bf16 on every
  # rank, f32 on a two-rank group), and the bsp/exchange_buckets gauge
  BUCKETDIR="$(mktemp -d)"
  THEANOMPI_TPU_MONITOR="$BUCKETDIR" $BENCH.bench_exchange --device cpu \
    --buckets 4 --smoke --out "$BUCKETDIR/BENCH_bucketed_smoke.json"
  BUCKET_RC=$?
  rm -rf "$BUCKETDIR"
  echo "bucketed-exchange smoke rc=$BUCKET_RC"
  echo "## shard smoke (2-shard EASGD over real sockets + kill-recovery)"
  # two real shard processes and the kill leg: the K=2 aggregate wall
  # beats K=1, both shards' shard_exchange spans and the recovery events
  # are in the monitor JSONL, and the lane carried the exchange
  SHARDDIR="$(mktemp -d)"
  THEANOMPI_TPU_MONITOR="$SHARDDIR" $BENCH.bench_exchange --device cpu \
    --smoke --shards 2 --out "$SHARDDIR/BENCH_shard_smoke.json"
  SHARD_RC=$?
  if [ "$SHARD_RC" -eq 0 ]; then
    shm_lane_evidence "$SHARDDIR" "shard exchange" || SHARD_RC=1
  fi
  rm -rf "$SHARDDIR"
  echo "shard smoke rc=$SHARD_RC"
  echo "## hierarchy smoke (4 local workers -> 1 aggregator -> 2 shard processes)"
  # wire bytes a period >= 3.9x below the direct baseline, the ASGD
  # delta-sum byte identity and the EASGD closed form on the exact
  # lattice, the fan-in gauge at 4 and local_aggregate spans
  HIERDIR="$(mktemp -d)"
  THEANOMPI_TPU_MONITOR="$HIERDIR" $BENCH.bench_exchange --device cpu \
    --local-workers 4 --shards 2 --smoke \
    --out "$HIERDIR/BENCH_hierarchy_smoke.json"
  HIER_RC=$?
  rm -rf "$HIERDIR"
  echo "hierarchy smoke rc=$HIER_RC"
  echo "## rpc soak (mux byte-identity under sustained load)"
  # muxed streams hammer identity-checked center reads while large gossip
  # frames interleave on the same sockets, on the selector loop
  SOAKDIR="$(mktemp -d)"
  $BENCH.bench_rpc --device cpu --soak --dur 4 --payload-kb 64 \
    --out "$SOAKDIR/BENCH_rpc_soak.json"
  SOAK_RC=$?
  rm -rf "$SOAKDIR"
  echo "rpc soak rc=$SOAK_RC"
  echo "## ingest smoke (2-reader fleet over real sockets + kill-recovery)"
  # N=2 aggregate img/s >= 1.7x N=1 at identical bytes, both readers
  # served, reader 0 SIGKILLed mid-epoch and the stream completed, the
  # recovery counters in the monitor JSONL, batches over the lane
  INGESTDIR="$(mktemp -d)"
  THEANOMPI_TPU_MONITOR="$INGESTDIR" $BENCH.bench_ingest --device cpu \
    --smoke --out "$INGESTDIR/BENCH_ingest_smoke.json"
  INGEST_RC=$?
  if [ "$INGEST_RC" -eq 0 ]; then
    shm_lane_evidence "$INGESTDIR" "ingest batches" || INGEST_RC=1
  fi
  rm -rf "$INGESTDIR"
  echo "ingest smoke rc=$INGEST_RC"
  echo "## rpc smoke (concurrent-connection scaling on the selector loop)"
  # a real service process pinned to one core: flat per-connection p99
  # from 8 to 200 connections, the convoy bar, and rpc/connections_total
  # and service/requests_total from the server's JSONL
  RPCDIR="$(mktemp -d)"
  $BENCH.bench_rpc --device cpu --smoke --conns 8,200 --dur 3 \
    --out "$RPCDIR/BENCH_rpc_smoke.json"
  RPC_RC=$?
  rm -rf "$RPCDIR"
  echo "rpc smoke rc=$RPC_RC"
  if [ "$TMLINT_RC" -ne 0 ] || [ "$GATE_RC" -ne 0 ] || [ "$PYTEST_RC" -ne 0 ] || [ "$ENTRY_RC" -ne 0 ] || [ "$MONITOR_RC" -ne 0 ] || [ "$COLLECTOR_RC" -ne 0 ] || [ "$RESILIENCE_RC" -ne 0 ] || [ "$SERVING_RC" -ne 0 ] || [ "$DECODE_RC" -ne 0 ] || [ "$FRONTDOOR_RC" -ne 0 ] || [ "$EXCHANGE_RC" -ne 0 ] || [ "$BUCKET_RC" -ne 0 ] || [ "$SHARD_RC" -ne 0 ] || [ "$HIER_RC" -ne 0 ] || [ "$SOAK_RC" -ne 0 ] || [ "$INGEST_RC" -ne 0 ] || [ "$RPC_RC" -ne 0 ]; then
    echo "PREFLIGHT (port): FAIL"
    [ "$TMLINT_RC" -ne 0 ] && echo "PREFLIGHT (port): tmlint --gate found NEW findings — fix them or baseline them with a reason"
    exit 1
  fi
  echo "PREFLIGHT (port): GREEN"
} 2>&1 | tee "$LOG"
exit "${PIPESTATUS[0]}"
