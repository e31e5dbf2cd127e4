"""Distributed-ingest benchmark of the port — a real N-reader fleet over
sockets; the counterpart of ``tools/bench_ingest.py``.

T trainer processes, each a ``RemoteBatchSource`` (the client the rules
use) that puts every batch on ``--device``, pull one epoch stream each
from an ``IngestProcessGroup`` of N reader processes serving a shard tree
written by the port's ``prepare_imagenet_shards``.  N=1 and N=2 consume
the identical batch set (same tree, epoch permutation and trainer count;
the byte totals are cross-checked), so their ratio isolates what the
fleet adds.

``--smoke`` is the JAX tool's gate (exit 1 on any miss): N=2 delivers at
least ``--scale-bar`` (1.7) x the images/s of N=1 at identical total
bytes; every reader served its range (served counters and per-reader
``ingest_pull`` spans); the kill leg holds — reader 0 is SIGKILLed
mid-epoch, the client fails over and completes the stream, the fleet
relaunches the reader, and ``ingest/reader_failovers_total`` and
``ingest/reader_restarts_total`` are in the monitor JSONL; and, with the
shared-memory lane on, the readers granted it and shipped pixels out of
band.  ``--shm-compare`` is the lane's leg: in-band against the lane over
the identical stream, sha256-checked.

Usage:
    python -m theanompi_tpu_torch.tools.bench_ingest --device cpu --smoke
    python -m theanompi_tpu_torch.tools.bench_ingest --device cpu \\
        --shm-compare --smoke
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from theanompi_tpu_torch.tools import _bench


def _log(msg: str) -> None:
    print(f"[bench_ingest] {msg}", flush=True)


def _fail(msg: str) -> None:
    print(f"[bench_ingest] FAIL: {msg}", file=sys.stderr, flush=True)


def build_tree(n_samples: int, store: int, shard_size: int,
               seed: int = 0) -> str:
    """A shard tree of random uint8 images in a temporary directory,
    written in slabs so the whole set is never in memory at once."""
    from theanompi_tpu_torch.data.imagenet import prepare_imagenet_shards

    d = tempfile.mkdtemp(prefix="bench_ingest_")
    rng = np.random.default_rng(seed)
    slab = max(shard_size, 2048)
    offset = 0
    while offset < n_samples:
        n = min(slab, n_samples - offset)
        imgs = rng.integers(0, 255, size=(n, store, store, 3),
                            dtype=np.uint8)
        labels = rng.integers(0, 1000, size=n).astype(np.int64)
        prepare_imagenet_shards(imgs, labels, d,
                                prefix=f"train_{offset:07d}",
                                shard_size=shard_size)
        offset += n
    return d


def _dataset(data_dir: str, store: int):
    from theanompi_tpu_torch.data.imagenet import ImageNet_data

    return ImageNet_data(data_dir=data_dir, crop=store, seed=0,
                         augment_on_device=True)


def trainer_worker(args) -> int:
    """One trainer process of :func:`drive_trainers`: a warm pass, READY,
    wait for GO on stdin (so every worker's timed window overlaps), a
    timed pass, one JSON line."""
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.ingest.client import RemoteBatchSource

    device = resolve_device(args.device)
    ds = _dataset(args.data_dir, args.store)
    addrs = args.worker_addrs.split(",")

    def one_pass():
        n = imgs = nbytes = 0
        t0 = time.monotonic()
        with RemoteBatchSource(addrs, data=ds, epoch=0,
                               global_batch=args.batch,
                               rank=args.worker_rank,
                               size=args.worker_size,
                               depth=args.depth) as src:
            for x, y in src:
                torch.from_numpy(x).to(device, non_blocking=True)
                n += 1
                imgs += len(y)
                nbytes += x.nbytes + y.nbytes
        _bench.sync(device)
        return {"batches": n, "images": imgs, "bytes": nbytes,
                "wall_s": time.monotonic() - t0}

    one_pass()  # warm: page cache and code paths
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        return 1
    print(json.dumps(one_pass()), flush=True)
    return 0


def drive_trainers(addrs: list[str], data_dir: str, t_count: int,
                   batch: int, store: int, depth: int,
                   device: str = "cpu") -> dict:
    """T trainer PROCESSES over their epoch streams at once (a ready/go
    barrier); aggregate img/s = total images / the longest worker's
    wall."""
    from theanompi_tpu_torch.parallel.shards import child_env

    procs = []
    for t in range(t_count):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "theanompi_tpu_torch.tools.bench_ingest",
             "--worker-rank", str(t), "--worker-size", str(t_count),
             "--worker-addrs", ",".join(addrs), "--data-dir", data_dir,
             "--batch", str(batch), "--store", str(store),
             "--depth", str(depth), "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=child_env()))
    try:
        for p in procs:
            line = p.stdout.readline().strip()
            if line != "READY":
                raise RuntimeError(f"trainer worker failed before READY: "
                                   f"{line!r} (rc={p.poll()})")
        for p in procs:
            p.stdin.write("GO\n")
            p.stdin.flush()
        outs = []
        for p in procs:
            outs.append(json.loads(p.stdout.readline()))
            p.stdin.close()
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = max(o["wall_s"] for o in outs)
    images = sum(o["images"] for o in outs)
    return {"wall_s": round(wall, 3),
            "batches": sum(o["batches"] for o in outs), "images": images,
            "bytes": sum(o["bytes"] for o in outs),
            "agg_img_s": round(images / wall, 1)}


def reader_served(addrs: list[str]) -> list[int]:
    """Each reader's served-batch counter, from the reader processes."""
    from theanompi_tpu_torch.parallel.service import ServiceClient

    out = []
    for addr in addrs:
        c = ServiceClient(addr)
        try:
            out.append(int(c.call("stats")["served"]))
        finally:
            c.close()
    return out


def kill_leg(group, ds, args) -> dict:
    """Mid-epoch reader death: SIGKILL reader 0; the stream must complete
    over the survivor while the watcher relaunches the dead reader."""
    from theanompi_tpu_torch.ingest.client import RemoteBatchSource

    expected = ds.n_train_batches_for(1, args.batch, 0, 1)
    got = 0
    with RemoteBatchSource(group.reader_addresses, data=ds, epoch=1,
                           global_batch=args.batch,
                           depth=args.depth) as src:
        it = iter(src)
        for _ in range(3):
            next(it)
            got += 1
        group.kill_reader(0)
        _log("kill leg: reader 0 SIGKILLed mid-epoch")
        for _ in it:
            got += 1
    group.wait_restarted(0)
    restarts = group.restart_counts().get(0, 0)
    out = {"expected_batches": expected, "completed_batches": got,
           "reader0_restarts": restarts,
           "recovered": got == expected and restarts >= 1}
    _log(f"kill leg: {out}")
    return out


def smoke_verdict(doc: dict, args, snapshot_path: str | None,
                  since: float = 0.0) -> int:
    """The JAX tool's ``smoke_verdict``."""
    from theanompi_tpu_torch.parallel import shm

    ok = True
    if args.readers < 2:
        _fail("smoke needs --readers >= 2")
        ok = False
    if not doc["identical_total_bytes"]:
        _fail("fleet sizes consumed different byte totals — the comparison "
              "is not like-for-like")
        ok = False
    if doc["aggregate_scaling_vs_n1"] < args.scale_bar:
        _fail(f"N={args.readers} aggregate "
              f"{doc['aggregate_scaling_vs_n1']:.2f}x N=1 < "
              f"{args.scale_bar}x bar")
        ok = False
    if not (doc["kill_leg"] or {}).get("recovered"):
        _fail("the kill-one-reader leg did not recover")
        ok = False
    nk = doc["modes"][-1]
    if not all(s > 0 for s in nk.get("served_per_reader", [])):
        _fail(f"a reader of the N={nk['readers']} fleet served nothing "
              f"({nk.get('served_per_reader')})")
        ok = False
    recs = _bench.jsonl_records(snapshot_path)
    names = {r.get("name") for r in recs}
    served = _bench.span_labels(recs, "ingest_pull", "reader")
    if len(served) < args.readers:
        _fail(f"ingest_pull spans name only {len(served)} reader(s) "
              f"({sorted(served)}) in the monitor JSONL ({snapshot_path}); "
              f"expected {args.readers}")
        ok = False
    for needed in ("ingest/reader_failovers_total",
                   "ingest/reader_restarts_total"):
        if needed not in names:
            _fail(f"{needed} missing from the monitor JSONL "
                  f"({snapshot_path})")
            ok = False
    if shm.enabled() and shm.available():
        # the trainer workers run no monitor session: the lane's proof is
        # in the reader processes' files beside the caller's
        mon_dir = (os.path.dirname(snapshot_path) if snapshot_path
                   else os.environ.get("THEANOMPI_TPU_MONITOR"))
        ev = _bench.shm_evidence(mon_dir, since=since)
        if ev["grants"] < 1 or ev["oob_bytes"] <= 0:
            _fail(f"no shm-lane evidence in the monitor dir ({mon_dir}): "
                  f"{ev} — same-host readers should have granted the lane "
                  "and shipped batches out of band")
            ok = False
    _log(f"smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def shm_compare_leg(samples: int = 8192, store: int = 96,
                    shard_size: int = 512, batch: int = 256,
                    depth: int = 4) -> dict:
    """Ingest plane of the lane comparison: in-band against the lane over
    the same tree, permutation and batch schedule, a fresh reader process
    a leg, the delivered stream sha256-checked across legs.  The caller
    owns the monitor session (the client-side lane counters land in its
    registry)."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.ingest.client import RemoteBatchSource
    from theanompi_tpu_torch.ingest.fleet import IngestProcessGroup
    from theanompi_tpu_torch.parallel import shm

    data_dir = build_tree(samples, store, shard_size)
    pre_segments = set(shm.segment_names())

    def val(name, **lb):
        return monitor.registry().value(name, **lb) or 0.0

    legs: dict[str, dict] = {}
    try:
        dataset = _dataset(data_dir, store)

        def hash_pass(addrs) -> str:
            digest = hashlib.sha256()
            with RemoteBatchSource(addrs, data=dataset, epoch=1,
                                   global_batch=batch, depth=depth) as src:
                for x, y in src:
                    digest.update(x.tobytes())
                    digest.update(y.tobytes())
            return digest.hexdigest()

        def timed_pass(addrs) -> dict:
            images = nbytes = batches = checksum = 0
            t0 = time.monotonic()
            with RemoteBatchSource(addrs, data=dataset, epoch=1,
                                   global_batch=batch, depth=depth) as src:
                for x, y in src:
                    checksum += int(x.sum(dtype=np.int64))
                    checksum += int(y.sum(dtype=np.int64))
                    batches += 1
                    images += len(y)
                    nbytes += x.nbytes + y.nbytes
            wall = time.monotonic() - t0
            return {"wall_s": round(wall, 3), "batches": batches,
                    "images": images, "bytes": nbytes,
                    "img_s": round(images / wall, 1), "checksum": checksum}

        for name, lane in (("in_band", "0"), ("shm", "1")):
            oob0 = val("shm/oob_bytes_total", dir="recv")
            grants0 = val("shm/grants_total", role="client")
            # the reader inherits the switch; the client reads it at
            # hello time, so both ends of a leg agree
            with _bench.env(THEANOMPI_TPU_WIRE_SHM=lane):
                group = IngestProcessGroup(1, data_dir, seed=0,
                                           coordinator=False,
                                           max_restarts=1)
                try:
                    addrs = group.reader_addresses
                    sha = hash_pass(addrs)  # the warm pass, the identity
                    r = timed_pass(addrs)
                    r["sha256"] = sha
                finally:
                    group.stop()
            r["oob_bytes_recv"] = int(val("shm/oob_bytes_total", dir="recv")
                                      - oob0)
            r["shm_grants"] = int(val("shm/grants_total", role="client")
                                  - grants0)
            legs[name] = r
            _log(f"shm-compare {name}: {r['img_s']:.0f} img/s, "
                 f"{r['oob_bytes_recv']/1e6:.1f} MB out-of-band")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    shm.sweep_orphans()
    leaked = [n for n in shm.segment_names() if n not in pre_segments]
    ratio = legs["shm"]["img_s"] / legs["in_band"]["img_s"]
    return {"plane": "ingest", "samples": samples, "store_px": store,
            "batch": batch, "depth": depth, "legs": legs,
            "img_s_ratio_shm_over_in_band": round(ratio, 3),
            "byte_identical": (legs["shm"]["sha256"]
                               == legs["in_band"]["sha256"]
                               and legs["shm"]["checksum"]
                               == legs["in_band"]["checksum"]),
            "socket_bytes_saved": legs["shm"]["oob_bytes_recv"],
            "leaked_segments": len(leaked)}


def run_shm_compare(args) -> int:
    """``--shm-compare``: the standalone ingest lane leg; ``--smoke``
    asserts the ``--shm-bar`` img/s lift, byte identity, lane traffic
    only where it is on, and no leaked segment."""
    from theanompi_tpu_torch import monitor

    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-ingest")
    os.environ.setdefault("THEANOMPI_TPU_MONITOR",
                          _bench.build_path("bench_ingest_monitor"))
    n_samples = args.samples or (8192 if args.smoke else 16384)
    # the lane's target is payload-dominated batches
    batch = max(args.batch, 256)
    with monitor.session(stall_after=float("inf")):
        doc = shm_compare_leg(n_samples, args.store, args.shard_size, batch,
                              args.depth)
    path = _bench.write_json(
        args.out or _bench.build_path(
            f"BENCH_{args.tag or 'ingest_shm'}.json"),
        {"bench": "ingest_shm_lane", "device": args.device, **doc})
    _log(f"wrote {path} (shm {doc['img_s_ratio_shm_over_in_band']:.2f}x "
         "in-band img/s)")
    if not args.smoke:
        return 0
    checks = [
        (doc["byte_identical"],
         "shm leg delivered different bytes than the in-band leg"),
        (doc["img_s_ratio_shm_over_in_band"] >= args.shm_bar,
         f"shm img/s {doc['img_s_ratio_shm_over_in_band']:.2f}x in-band < "
         f"{args.shm_bar}x bar"),
        (doc["legs"]["shm"]["oob_bytes_recv"] > 0
         and doc["legs"]["shm"]["shm_grants"] >= 1,
         f"shm leg shows no lane traffic ({doc['legs']['shm']})"),
        (doc["legs"]["in_band"]["oob_bytes_recv"] == 0,
         f"in-band leg leaked lane traffic ({doc['legs']['in_band']})"),
        (not doc["leaked_segments"],
         f"{doc['leaked_segments']} shm segment(s) leaked after the legs")]
    ok = True
    for good, msg in checks:
        if not good:
            _fail(msg)
            ok = False
    _log(f"shm-compare {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.tools.bench_ingest",
        description=__doc__.split("\n")[0])
    ap.add_argument("--readers", type=int, default=2, metavar="N")
    ap.add_argument("--trainers", type=int, default=4, metavar="T",
                    help="trainer PROCESSES; demand must exceed one "
                         "reader's capacity or N=1 against N=2 compares "
                         "two idle fleets")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--store", type=int, default=None,
                    help="stored image side (uint8 HxWx3); default 64, "
                         "96 under --shm-compare")
    ap.add_argument("--samples", type=int, default=None,
                    help="dataset size (default 65536; 32768 in --smoke)")
    ap.add_argument("--shard-size", type=int, default=512)
    ap.add_argument("--depth", type=int, default=6,
                    help="per-trainer pipelined pulls")
    ap.add_argument("--data-dir", default=None,
                    help="an existing shard tree (default: a synthetic one "
                         "in a temporary directory)")
    ap.add_argument("--scale-bar", type=float, default=1.7,
                    help="--smoke: required N=2/N=1 aggregate ratio")
    _bench.add_device_arg(ap)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--shm-compare", action="store_true",
                    help="the shared-memory-lane leg: in-band against the "
                         "lane over the identical stream, a fresh reader a "
                         "leg; with --smoke asserts the --shm-bar lift, "
                         "lane evidence and no leaked segment")
    ap.add_argument("--shm-bar", type=float, default=1.3)
    ap.add_argument("--smoke", action="store_true",
                    help="preflight gate: the scaling bar, the kill leg and "
                         "the monitor evidence; exit 1 on any miss")
    ap.add_argument("--worker-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-size", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-addrs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.store is None:
        args.store = 96 if args.shm_compare else 64
    if args.worker_rank is not None:
        return trainer_worker(args)
    from theanompi_tpu_torch._device import resolve_device

    resolve_device(args.device)
    if args.shm_compare:
        return run_shm_compare(args)

    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.ingest.fleet import IngestProcessGroup

    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-ingest")
    os.environ.setdefault("THEANOMPI_TPU_MONITOR",
                          _bench.build_path("bench_ingest_monitor"))
    n_samples = args.samples or (32768 if args.smoke else 65536)
    own_tree = args.data_dir is None
    data_dir = args.data_dir or build_tree(n_samples, args.store,
                                           args.shard_size)
    modes, kill = [], None
    t_start = time.time()
    try:
        dataset = _dataset(data_dir, args.store)
        _log(f"tree: {dataset.n_train} samples x {args.store}px uint8, "
             f"{len(dataset.train_files)} files; {args.trainers} trainer "
             f"process(es), batch {args.batch}, depth {args.depth}, "
             f"device {args.device}")
        with monitor.session(stall_after=float("inf")):
            for n_readers in ([1, args.readers] if args.readers > 1
                              else [1]):
                group = IngestProcessGroup(n_readers, data_dir, seed=0,
                                           coordinator=False,
                                           max_restarts=2)
                try:
                    addrs = group.reader_addresses
                    r = drive_trainers(addrs, data_dir, args.trainers,
                                       args.batch, args.store, args.depth,
                                       args.device)
                    r["readers"] = n_readers
                    r["served_per_reader"] = reader_served(addrs)
                    modes.append(r)
                    _log(f"N={n_readers}: {r['agg_img_s']:.0f} img/s "
                         f"aggregate, {r['bytes']/1e6:.1f} MB in "
                         f"{r['wall_s']:.2f}s")
                    if args.smoke and n_readers > 1:
                        kill = kill_leg(group, dataset, args)
                finally:
                    group.stop()
            snapshot_path = monitor.flush()
    finally:
        if own_tree:
            shutil.rmtree(data_dir, ignore_errors=True)
    n1, nk = modes[0], modes[-1]
    scaling = nk["agg_img_s"] / n1["agg_img_s"] if nk is not n1 else 1.0
    doc = {"bench": "ingest_fleet", "device": args.device,
           "n_samples": dataset.n_train, "store_px": args.store,
           "batch": args.batch, "trainers": args.trainers,
           "depth": args.depth, "modes": modes,
           "aggregate_scaling_vs_n1": round(scaling, 3),
           "identical_total_bytes": n1["bytes"] == nk["bytes"],
           "kill_leg": kill}
    tag = args.tag or ("smoke" if args.smoke
                       else f"n{args.readers}t{args.trainers}")
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_ingest_{tag}.json"), doc)
    _log(f"wrote {path} (N={nk['readers']} aggregate {scaling:.2f}x N=1)")
    if not args.smoke:
        return 0
    return smoke_verdict(doc, args, snapshot_path, since=t_start)


if __name__ == "__main__":
    raise SystemExit(main())
