"""Exchange benchmark of the port's host planes — the counterpart of
``tools/bench_exchange.py``, over real sockets, with its legs in the JAX
tool's order.

* **default** — a ResNet-50-sized (~25.5M parameter) tree through the
  port's parameter service (``parallel/service.py``, served in this
  process) in every (protocol, compression, dtype) mode: exact bytes an
  exchange (the frames the client sends, encoded again; v1 measured by
  ``ForkingPickler`` as ``Connection.send`` pickles) and the client's
  wall ms an exchange.  Then the **stage split** of one f32 in-band
  exchange, each stage fenced by a synchronize: the worker's D2H copy
  (``host_arrays``), encode, the socket each way, the server's decode,
  its copy into pinned memory and H2D (``to_tensors``), the elastic
  merge, the reply's ``.cpu()`` (``_np_out``), and the client's decode,
  pinned copy and H2D.  With ``--device cuda`` the worker's tree and the
  service's stores are on the card.
* ``--buckets B`` — the BSP exchange (``parallel/exchanger.py``) on
  ``--ranks`` process-group ranks (gloo on the CPU, NCCL on cards) for
  B in {1, B}: collectives launched a step (B, counted at
  ``torch.distributed``'s entry points, where JAX counts its lowered
  program's), each bucket's wire bytes, wall ms; and a B-bucket train
  step (the overlapped ``BucketedBackward``) bit-identical to B=1 over 3
  iterations.
* ``--shards K`` — K real shard processes (``parallel/shards.py``)
  against K=1: per-shard bytes and probe walls, aggregate wall; with
  ``--smoke`` shard 0 is SIGKILLed, relaunched and rejoined.
* ``--local-workers N`` — N workers behind one ``LocalAggregator``
  (``parallel/aggregate.py``) against N direct exchanges, over
  ``--shards`` K shard processes: wire bytes a period and the ASGD
  byte-identity / EASGD closed-form trajectory pins on the exact f32
  lattice.
* ``--shm-compare`` — the shared-memory lane against in-band frames on
  the exchange, ingest and KV-page planes (fresh servers, sha256
  identity, a mid-run force-disable, a SIGKILL-mid-lease sweep).

``--smoke`` makes each leg the JAX tool's gate (exit 1 on any miss).
Output JSON and monitor snapshots go under ``build/``.

Usage:
    python -m theanompi_tpu_torch.tools.bench_exchange --device cpu --smoke
    python -m theanompi_tpu_torch.tools.bench_exchange --device cpu \\
        --buckets 4 --smoke
    python -m theanompi_tpu_torch.tools.bench_exchange --params 61e6
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from theanompi_tpu_torch.tools import _bench

#: (protocol, compression, dtype) — v1 has no negotiated options
MODES = (
    ("v1", "none", "f32"),
    ("v2", "none", "f32"),
    ("v2", "zlib", "f32"),
    ("v2", "none", "bf16"),
    ("v2", "zlib", "bf16"),
)

def _log(msg: str) -> None:
    print(f"[bench_exchange] {msg}", flush=True)


def _fail(msg: str) -> None:
    print(f"[bench_exchange] FAIL: {msg}", file=sys.stderr, flush=True)


class FlagConflict(SystemExit):
    """Typed refusal for mutually exclusive legs (the JAX tool's matrix):
    exits 2 like an argparse usage error."""

    def __init__(self, msg: str):
        print(f"[bench_exchange] ERROR: {msg}", file=sys.stderr)
        super().__init__(2)


# -- the trees (copies of the JAX tool's; byte-identical at one seed) -------


def resnet50_like_tree(target_params: int, seed: int = 0) -> dict:
    """A parameter tree with ResNet-50's leaf-size distribution (conv
    kernels from (7,7,3,64) up to (1,1,1024,2048), BN vectors, one big
    FC) scaled to ~``target_params`` by repeating leaves."""
    rng = np.random.default_rng(seed)
    shapes: list[tuple[int, ...]] = [(7, 7, 3, 64)]
    stages = ((64, 64, 3), (256, 128, 4), (512, 256, 6), (1024, 512, 3))
    for c_in, c_mid, reps in stages:
        for r in range(reps):
            cin = c_in if r == 0 else c_mid * 4
            shapes += [(1, 1, cin, c_mid), (3, 3, c_mid, c_mid),
                       (1, 1, c_mid, c_mid * 4)]
            for width in (c_mid, c_mid, c_mid * 4):
                shapes += [(width,)] * 4      # BN scale/bias/mean/var
    shapes.append((2048, 1000))
    shapes.append((1000,))
    base_total = sum(int(np.prod(s)) for s in shapes)
    scale = max(1, round(target_params / base_total))
    tree = {}
    for i, s in enumerate(shapes):
        for k in range(scale if len(s) > 1 else 1):
            tree[f"leaf_{i:03d}_{k}"] = rng.standard_normal(
                s).astype(np.float32) * 0.05
    return tree


def lattice_tree(target_params: int, seed: int = 0,
                 grid_bits: int = 10) -> dict:
    """``resnet50_like_tree`` snapped to the exact f32 lattice (integer
    multiples of 2**-grid_bits), so every sum and elastic pull of the
    hierarchy leg is exact and its pins compare bitwise; ``+ 0.0`` turns
    the ``-0.0`` that ``np.round`` makes into ``+0.0``."""
    grid = float(1 << grid_bits)
    return {k: (np.round(v * grid) / grid + 0.0).astype(np.float32)
            for k, v in resnet50_like_tree(target_params, seed).items()}


def tree_leaves(tree: dict) -> list[np.ndarray]:
    """The tree's arrays in JAX's flatten order (sorted keys): the list
    the port's clients exchange."""
    return [tree[k] for k in sorted(tree)]


def tree_tensors(tree: dict, device) -> list[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in tree_leaves(tree)]


def tree_params(tree: dict) -> int:
    return sum(int(v.size) for v in tree.values())


def tree_nbytes(tree: dict) -> int:
    return sum(int(v.nbytes) for v in tree.values())


# -- byte accounting --------------------------------------------------------


def _pickle_len(obj) -> int:
    """Bytes ``Connection.send`` writes for ``obj`` (the v1 wire)."""
    import io
    from multiprocessing.reduction import ForkingPickler

    buf = io.BytesIO()
    ForkingPickler(buf, -1).dump(obj)
    return buf.getbuffer().nbytes


def exchange_bytes(request, reply, protocol: str, compression: str,
                   dtype: str) -> dict:
    """Exact bytes of one exchange's request and reply frames, as the JAX
    tool counts them: v2 encodes the frames again (``encode_frame`` is
    deterministic), v1 pickles them."""
    from theanompi_tpu_torch.parallel import wire

    if protocol == "v2":
        opts = wire.WireOptions(compression=compression, dtype=dtype)
        _, _, st_req = wire.encode_frame(request, opts)
        _, _, st_rep = wire.encode_frame(reply, opts)
        sent, recv, pre = st_req.post_bytes, st_rep.post_bytes, \
            st_req.pre_bytes
    else:
        sent, recv = _pickle_len(request), _pickle_len(reply)
        pre = sent
    return {"bytes_sent_per_exchange": sent,
            "bytes_recv_per_exchange": recv,
            "bytes_per_exchange": sent + recv, "pre_bytes": pre,
            "wire_ratio": round((sent + recv) / (2 * pre), 4)}


def _monitor_env() -> str:
    return os.environ.setdefault("THEANOMPI_TPU_MONITOR",
                                 _bench.build_path("bench_exchange_monitor"))


# -- the default leg ---------------------------------------------------------


def measure_mode(addr: str, protocol: str, compression: str, dtype: str,
                 tree: dict, n_exchanges: int, device) -> dict:
    """One (protocol, compression, dtype) mode through the service at
    ``addr``: exact bytes and the client's wall an exchange (the reply's
    tensors on ``device`` included)."""
    from theanompi_tpu_torch.parallel.service import RemoteEASGD

    sid = f"bench-{protocol}-{compression}-{dtype}"
    params = tree_tensors(tree, device)
    t0 = time.monotonic()
    with _bench.env(THEANOMPI_TPU_WIRE_PROTOCOL=protocol,
              THEANOMPI_TPU_WIRE_COMPRESSION=compression,
              THEANOMPI_TPU_WIRE_DTYPE=dtype):
        srv = RemoteEASGD(addr, params, alpha=0.5, session_id=sid)
    init_s = time.monotonic() - t0
    try:
        assert srv.wire_protocol == protocol, (srv.wire_protocol, protocol)
        leaves = tree_leaves(tree)
        acct = exchange_bytes(("easgd_exchange", sid, leaves),
                              ("ok", leaves), protocol, compression, dtype)
        walls = []
        for _ in range(n_exchanges):
            t0 = time.monotonic()
            out = srv.exchange(params)
            _bench.sync(device)
            walls.append((time.monotonic() - t0) * 1e3)
        assert all(bool(torch.isfinite(t).all()) for t in out[:3])
    finally:
        srv.close()
    return {"protocol": protocol, "compression": compression,
            "dtype": dtype, **acct, "n_exchanges": n_exchanges,
            "wall_ms_mean": round(float(np.mean(walls)), 2),
            "wall_ms_min": round(float(np.min(walls)), 2),
            "init_s": round(init_s, 3)}


class _Loopback:
    """One loopback ``multiprocessing.connection`` pair with a receiver
    thread: :meth:`ship` sends a frame's chunks one way and returns the
    received chunks and the seconds from the first send to the last
    receive."""

    def __init__(self):
        from multiprocessing.connection import Client, Listener

        self._listener = Listener(("127.0.0.1", 0))
        self._a = Client(self._listener.address)
        self._b = self._listener.accept()

    def ship(self, head: bytes, bufs: list, forward: bool = True):
        tx, rx = (self._a, self._b) if forward else (self._b, self._a)
        got: dict = {}

        def receive():
            chunks = [rx.recv_bytes() for _ in range(1 + len(bufs))]
            got["t"] = time.perf_counter()
            got["chunks"] = chunks

        th = threading.Thread(target=receive, daemon=True)
        th.start()
        t0 = time.perf_counter()
        tx.send_bytes(head)
        for b in bufs:
            tx.send_bytes(b)
        th.join()
        return got["chunks"][0], got["chunks"][1:], got["t"] - t0

    def close(self) -> None:
        for c in (self._a, self._b):
            c.close()
        self._listener.close()


def stage_split(tree: dict, device, rounds: int = 3) -> dict:
    """The stages of one f32 in-band exchange, in the order the real one
    runs them, each fenced by a synchronize and timed alone: the same
    functions the client (``RemoteEASGD.exchange``) and the service
    (``ParamService.handle``) call, over a real loopback socket.  Per
    stage: the mean and min ms over ``rounds`` (after one warm round) and
    GB/s of the tree's f32 bytes."""
    from theanompi_tpu_torch.parallel import service, wire
    from theanompi_tpu_torch.parallel.server import EASGDServer

    device = torch.device(device)
    pin = device.type == "cuda"
    nbytes = tree_nbytes(tree)
    opts = wire.WireOptions(compression="none", dtype="f32")
    params = tree_tensors(tree, device)
    store = EASGDServer(service.to_tensors(service.host_arrays(params),
                                           device), alpha=0.5)
    link = _Loopback()
    times: dict[str, list[float]] = {}

    def timed(name, fn):
        _bench.sync(device)
        t0 = time.perf_counter()
        out = fn()
        _bench.sync(device)
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def h2d(hosts):
        return [h.to(device, non_blocking=True) if pin else h
                for h in hosts]

    try:
        for r in range(rounds + 1):
            host = timed("worker_d2h", lambda: service.host_arrays(params))
            head, bufs, _ = timed("encode_request", lambda: wire.encode_frame(
                ("easgd_exchange", "split", host), opts))
            rhead, rbufs, dt = link.ship(head, bufs, forward=True)
            times.setdefault("socket_request", []).append(dt)
            _, _, leaves = timed("server_decode",
                                 lambda: wire.decode_frame(rhead, rbufs,
                                                           opts))
            hosts = timed("server_pinned_copy", lambda: [
                service.host_tensor(np.asarray(a), pin) for a in leaves])
            dev = timed("server_h2d", lambda: h2d(hosts))
            new = timed("merge", lambda: store.exchange(dev))
            out_np = timed("reply_cpu", lambda: service._np_out(new))
            head, bufs, _ = timed("encode_reply", lambda: wire.encode_frame(
                ("ok", out_np), opts))
            rhead, rbufs, dt = link.ship(head, bufs, forward=False)
            times.setdefault("socket_reply", []).append(dt)
            _, reply = timed("client_decode",
                             lambda: wire.decode_frame(rhead, rbufs, opts))
            hosts = timed("client_pinned_copy", lambda: [
                service.host_tensor(np.asarray(a), pin) for a in reply])
            timed("client_h2d", lambda: h2d(hosts))
            if r == 0:  # the warm round: allocators, first launches
                times.clear()
    finally:
        link.close()
    stages = {}
    for name, ts in times.items():
        mean = float(np.mean(ts))
        stages[name] = {"ms_mean": round(mean * 1e3, 3),
                        "ms_min": round(float(np.min(ts)) * 1e3, 3),
                        "gb_s": round(nbytes / mean / 1e9, 3)}
    total = sum(s["ms_mean"] for s in stages.values())
    device_copies = sum(stages[k]["ms_mean"] for k in (
        "worker_d2h", "server_h2d", "client_h2d"))
    return {"rounds": rounds, "tree_bytes": nbytes, "stages": stages,
            "sum_ms": round(total, 3),
            "device_copy_share": round(device_copies / total, 4)}


def run_default(args) -> int:
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel.service import serve

    device = resolve_device(args.device)
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-exchange")
    _monitor_env()
    if args.smoke:
        args.exchanges = 1
    tree = resnet50_like_tree(int(args.params))
    n_params = tree_params(tree)
    _log(f"tree: {n_params/1e6:.1f}M params, {len(tree)} leaves, "
         f"{tree_nbytes(tree)/1e6:.1f} MB f32, device {device}")
    port = _bench.free_port()
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=serve, args=("127.0.0.1", port, ready,
                                              stop),
                          kwargs=dict(device=device), daemon=True)
    th.start()
    if not ready.wait(30):
        _fail("service never came up")
        return 1
    addr = f"127.0.0.1:{port}"
    results = []
    try:
        with monitor.session(stall_after=float("inf")):
            for protocol, compression, dtype in MODES:
                r = measure_mode(addr, protocol, compression, dtype, tree,
                                 args.exchanges, device)
                _log(f"{protocol}/{compression}/{dtype}: "
                     f"{r['bytes_per_exchange']/1e6:.1f} MB/exchange, "
                     f"{r['wall_ms_mean']:.0f} ms mean")
                results.append(r)
            # the whole exchange in-band (the lane off at both ends), the
            # wall the stage split below adds up to
            with _bench.env(THEANOMPI_TPU_WIRE_SHM="0"):
                in_band = measure_mode(addr, "v2", "none", "f32", tree,
                                       max(args.exchanges, 3), device)
            snapshot_path = monitor.flush()
    finally:
        stop.set()
        th.join(timeout=10)
    split = stage_split(tree, device, rounds=1 if args.smoke else 3)
    split["in_band_exchange_wall_ms_mean"] = in_band["wall_ms_mean"]
    split["in_band_exchange_wall_ms_min"] = in_band["wall_ms_min"]
    for name, st in split["stages"].items():
        _log(f"stage {name:19s} {st['ms_mean']:9.3f} ms "
             f"{st['gb_s']:8.3f} GB/s")
    _log(f"stages sum {split['sum_ms']:.1f} ms against an in-band exchange "
         f"of {in_band['wall_ms_mean']:.1f} ms; device copies "
         f"{split['device_copy_share']:.1%} of the stages")

    def mode(p, c, d):
        return next(r for r in results if r["protocol"] == p
                    and r["compression"] == c and r["dtype"] == d)
    v1, v2_f32 = mode("v1", "none", "f32"), mode("v2", "none", "f32")
    v2_zlib, v2_bf16 = mode("v2", "zlib", "f32"), mode("v2", "none", "bf16")
    byte_cut = 1.0 - v2_bf16["bytes_per_exchange"] / v1["bytes_per_exchange"]
    doc = {"bench": "wire_exchange", "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "n_params": n_params, "n_leaves": len(tree),
           "tree_mb_f32": round(tree_nbytes(tree) / 1e6, 2),
           "modes": results, "stage_split": split,
           "v2_bf16_vs_v1_byte_cut": round(byte_cut, 4),
           "v2_f32_vs_v1_byte_overhead": round(
               v2_f32["bytes_per_exchange"] / v1["bytes_per_exchange"]
               - 1.0, 4)}
    tag = args.tag or ("smoke" if args.smoke else device.type)
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_wire_{tag}.json"), doc)
    _log(f"wrote {path} (v2+bf16 cuts {byte_cut:.1%} of v1 bytes)")
    if not args.smoke:
        return 0
    return smoke_verdict_default(doc, snapshot_path)


def smoke_verdict_default(doc: dict, snapshot_path: str | None) -> int:
    """The JAX tool's gate: lossless v2 (zlib/f32) beats v1 on bytes, the
    bf16 cut is at least 45%, and the wire's compression-ratio gauge is in
    the monitor JSONL."""
    ok = True
    modes = {(r["protocol"], r["compression"], r["dtype"]): r
             for r in doc["modes"]}
    if modes[("v2", "zlib", "f32")]["bytes_per_exchange"] >= \
            modes[("v1", "none", "f32")]["bytes_per_exchange"]:
        _fail("v2-framed (zlib/f32, lossless) does not beat v1-pickle on "
              "bytes/exchange")
        ok = False
    if doc["v2_bf16_vs_v1_byte_cut"] < 0.45:
        _fail(f"v2+bf16 byte cut {doc['v2_bf16_vs_v1_byte_cut']:.1%} "
              "< 45%")
        ok = False
    names = {r.get("name") for r in _bench.jsonl_records(snapshot_path)}
    if "service/wire_compression_ratio" not in names:
        _fail("service/wire_compression_ratio gauge missing from the "
              f"monitor JSONL ({snapshot_path})")
        ok = False
    _log(f"smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


# -- --buckets: the BSP exchange on process-group ranks ---------------------


@contextlib.contextmanager
def count_collectives():
    """Count the collectives launched in the block at
    ``torch.distributed``'s entry points the exchanger calls."""
    import torch.distributed as dist

    counts = {"n": 0}
    names = ("all_reduce", "all_gather_into_tensor")
    saved = {n: getattr(dist, n) for n in names}

    def counted(fn):
        def call(*a, **kw):
            counts["n"] += 1
            return fn(*a, **kw)
        return call
    for n in names:
        setattr(dist, n, counted(saved[n]))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, saved[n])


def bucket_step_equivalence(buckets: int, rank: int, ranks: list,
                            device, wire: str = "f32",
                            group=None) -> bool:
    """A real bucketed train step (the overlapped ``BucketedBackward``
    when B > 1) against the B=1 step over 3 iterations, on the ``wire``
    exchange over the process group ``group`` of the global ``ranks``:
    True when every parameter is bit-identical (bucketing is scheduling,
    never numerics).  The JAX tool's two-layer net and 32-row batch, this
    rank's rows of it."""
    from theanompi_tpu_torch.parallel.bsp import TrainState, make_bsp_train_step
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger

    rng = np.random.default_rng(0)
    init = {"w1": rng.standard_normal((6, 9)) * 0.3, "b1": np.zeros(9),
            "w2": rng.standard_normal((9, 2)) * 0.3, "b2": np.zeros(2)}
    data = np.random.default_rng(5)
    x = data.standard_normal((32, 6)).astype(np.float32)
    y = data.standard_normal((32, 2)).astype(np.float32)
    per, pos = 32 // len(ranks), ranks.index(rank)
    batch = (torch.from_numpy(x[pos * per:(pos + 1) * per]).to(device),
             torch.from_numpy(y[pos * per:(pos + 1) * per]).to(device))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in init.items():
                setattr(self, k, torch.nn.Parameter(torch.from_numpy(
                    v.astype(np.float32)).to(device)))

        def forward(self, xb):
            return torch.tanh(xb @ self.w1 + self.b1) @ self.w2 + self.b2

    def loss(module, b, _rng):
        out = ((module(b[0]) - b[1]) ** 2).mean()
        return out, {"loss": out.detach()}

    def run(b):
        net = Net()
        opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9)
        step = make_bsp_train_step(loss, BSP_Exchanger(
            exchange_buckets=b, avg=True, group=group,
            exchange_dtype=None if wire == "f32" else "bf16"))
        state = TrainState(net, opt)
        for _ in range(3):
            step(state, batch, None)
        return [p.detach().cpu().numpy().tobytes()
                for p in net.parameters()]

    return run(1) == run(buckets)


def step_equivalences(buckets: int, rank: int, world: int,
                      device) -> dict:
    """The step bit-identity where the port's exchanger promises it
    (``parallel/exchanger.py``): the bf16 wire on every rank (each rank
    sums the gathered values in rank order), and the f32 wire on a group
    of at most two ranks, where a sum of one element has one order.  At
    more ranks the f32 all-reduce's order follows the bucket cut (gloo's
    and NCCL's rings), so that case is measured and reported, not
    promised."""
    import torch.distributed as dist

    every = list(range(world))
    out = {"bf16": bucket_step_equivalence(buckets, rank, every, device,
                                           "bf16"),
           "f32": bucket_step_equivalence(buckets, rank, every, device)}
    if world > 2:
        pair = dist.new_group([0, 1])  # every rank takes part in the call
        out["f32_two_ranks"] = (bucket_step_equivalence(
            buckets, rank, [0, 1], device, group=pair) if rank < 2
            else None)
    else:
        out["f32_two_ranks"] = out["f32"]
    return out


def bucket_rank_main(args) -> int:
    """One rank of the ``--buckets`` leg (started by :func:`run_buckets`):
    writes ``rank<r>.json`` into the leg's directory."""
    import torch.distributed as dist

    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel.exchanger import (
        BSP_Exchanger,
        bucket_ranges,
    )

    rank, world = args.bucket_rank, args.ranks
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{args.bucket_port}",
        world_size=world, rank=rank)
    try:
        bucket_list = sorted({1} | {int(b) for b in
                                     str(args.buckets).split(",")})
        tree = resnet50_like_tree(int(args.params))
        base = tree_tensors(tree, device)
        sizes = [t.numel() * t.element_size() for t in base]
        dtypes = ("f32",) if args.smoke else ("f32", "bf16")
        modes = []
        with monitor.session(rank=rank, stall_after=float("inf")) \
                if rank == 0 else \
                contextlib.nullcontext():
            for dtype in dtypes:
                for b in bucket_list:
                    ex = BSP_Exchanger(
                        exchange_dtype=None if dtype == "f32" else "bf16",
                        exchange_buckets=b, avg=True)
                    ex.emit_gauges(base)
                    walls, launches = [], []
                    for i in range(args.exchanges + 1):
                        work = [t.clone() for t in base]
                        _bench.sync(device)
                        dist.barrier()
                        t0 = time.monotonic()
                        with count_collectives() as n:
                            ex.exchange(work)
                        _bench.sync(device)
                        if i:  # the first is a warm exchange
                            walls.append((time.monotonic() - t0) * 1e3)
                            launches.append(n["n"])
                    plan = bucket_ranges(sizes, b)
                    per_elem = 2 if dtype == "bf16" else 4
                    per_bucket = [{
                        "bucket": i, "n_leaves": hi - lo,
                        "wire_bytes": per_elem * sum(
                            t.numel() for t in base[lo:hi])}
                        for i, (lo, hi) in enumerate(plan)]
                    modes.append({
                        "dtype": dtype, "buckets": b,
                        "plan_buckets": len(plan),
                        "collectives_per_exchange": sorted(set(launches)),
                        "n_exchanges": args.exchanges,
                        "wall_ms_mean": round(float(np.mean(walls)), 2),
                        "wall_ms_min": round(float(np.min(walls)), 2),
                        "wire_bytes_total": sum(p["wire_bytes"]
                                                for p in per_bucket),
                        "per_bucket": per_bucket})
            equiv = step_equivalences(max(bucket_list), rank, world,
                                      device)
            snapshot = monitor.flush() if rank == 0 else None
        _bench.write_json(os.path.join(args.bucket_dir, f"rank{rank}.json"),
                          {"rank": rank, "modes": modes,
                           "step_equivalence": equiv,
                           "snapshot": snapshot})
    finally:
        dist.destroy_process_group()
    return 0


def run_buckets(args) -> int:
    import json
    import tempfile

    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel.shards import child_env

    device = resolve_device(args.device)
    if device.type == "cuda" and args.ranks > torch.cuda.device_count():
        raise FlagConflict(
            f"--buckets on cards needs a card per rank: --ranks "
            f"{args.ranks} > {torch.cuda.device_count()} visible")
    if 32 % args.ranks:
        raise FlagConflict(f"--ranks must divide the 32-row step batch, "
                           f"got {args.ranks}")
    _monitor_env()
    bucket_list = sorted({1} | {int(b) for b in
                                 str(args.buckets).split(",")})
    smoke_b = max(bucket_list)
    tree = resnet50_like_tree(int(args.params))
    _log(f"bucket mode: {tree_params(tree)/1e6:.1f}M params, {len(tree)} "
         f"leaves, {tree_nbytes(tree)/1e6:.1f} MB f32, B in {bucket_list}, "
         f"{args.ranks} {'nccl' if device.type == 'cuda' else 'gloo'} ranks")
    port = _bench.free_port()
    with tempfile.TemporaryDirectory(prefix="bench_buckets_") as td:
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.tools.bench_exchange",
               "--buckets", str(args.buckets), "--params", str(args.params),
               "--exchanges", str(args.exchanges), "--ranks",
               str(args.ranks), "--device", args.device,
               "--bucket-port", str(port), "--bucket-dir", td]
        if args.smoke:
            cmd.append("--smoke")
        procs = [subprocess.Popen(cmd + ["--bucket-rank", str(r)],
                                  env=child_env())
                 for r in range(args.ranks)]
        try:
            rcs = [p.wait(timeout=1800) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            _fail(f"a bucket rank failed (exit codes {rcs})")
            return 1
        ranks = []
        for r in range(args.ranks):
            with open(os.path.join(td, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    modes = ranks[0]["modes"]
    for m in modes:
        _log(f"{m['dtype']} B={m['buckets']}: {m['wall_ms_mean']:.0f} ms "
             f"mean, {m['collectives_per_exchange']} collectives launched")
    per_rank = [r["step_equivalence"] for r in ranks]
    equiv = {wire: [e[wire] for e in per_rank]
             for wire in ("bf16", "f32_two_ranks", "f32")}
    delta = {}
    for dtype in sorted({m["dtype"] for m in modes}):
        b1 = next(m for m in modes if m["dtype"] == dtype
                  and m["buckets"] == 1)
        delta[dtype] = {str(m["buckets"]): round(
            1.0 - m["wall_ms_mean"] / b1["wall_ms_mean"], 4)
            for m in modes if m["dtype"] == dtype and m["buckets"] != 1}
    doc = {"bench": "bucketed_exchange", "device": str(device),
           "ranks": args.ranks, "n_params": tree_params(tree),
           "n_leaves": len(tree),
           "tree_mb_f32": round(tree_nbytes(tree) / 1e6, 2),
           "modes": modes, "aggregate_wall_delta_vs_b1": delta,
           "step_equivalence": {"buckets": smoke_b, "per_rank": equiv,
                                "promised": all(
                                    e is not False for e in
                                    equiv["bf16"] + equiv["f32_two_ranks"]),
                                "f32_all_ranks": all(equiv["f32"])}}
    _log(f"B={smoke_b} step against B=1, bit-identical per rank: "
         f"{equiv}")
    tag = args.tag or ("bucketed_smoke" if args.smoke
                       else f"bucketed_b{smoke_b}")
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_{tag}.json"), doc)
    _log(f"wrote {path}")
    if not args.smoke:
        return 0
    return smoke_verdict_buckets(doc, ranks[0]["snapshot"])


def smoke_verdict_buckets(doc: dict, snapshot_path: str | None) -> int:
    """The JAX tool's gate: the B-bucket step bit-identical to B=1 (where
    the port's exchanger promises it: :func:`step_equivalences`) and the
    ``bsp/exchange_buckets`` gauge in the monitor JSONL; and here, in
    place of the lowered program's collective count, each exchange
    launched exactly its plan's B collectives."""
    ok = True
    eq = doc["step_equivalence"]
    if not eq["promised"]:
        _fail(f"B={eq['buckets']} train step is not bit-identical to B=1 "
              f"(per rank {eq['per_rank']})")
        ok = False
    for m in doc["modes"]:
        if m["collectives_per_exchange"] != [m["plan_buckets"]]:
            _fail(f"{m['dtype']} B={m['buckets']}: collectives launched "
                  f"{m['collectives_per_exchange']}, plan has "
                  f"{m['plan_buckets']} buckets")
            ok = False
    names = {r.get("name") for r in _bench.jsonl_records(snapshot_path)}
    if "bsp/exchange_buckets" not in names:
        _fail("bsp/exchange_buckets gauge missing from the monitor JSONL "
              f"({snapshot_path})")
        ok = False
    _log(f"bucket smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


# -- --shards K --------------------------------------------------------------


def run_sharded(args) -> int:
    """``--shards K``: the tree against K real shard processes and K=1;
    ``--smoke`` also kills shard 0 and proves the recovery (the JAX
    tool's ``run_sharded``)."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel import shm, wire
    from theanompi_tpu_torch.parallel.service import host_arrays
    from theanompi_tpu_torch.parallel.shards import (
        ShardedEASGD,
        ShardProcessGroup,
    )

    device = resolve_device(args.device)
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-exchange")
    _monitor_env()
    k = int(args.shards)
    n_exchanges = max(3, args.exchanges)
    tree = resnet50_like_tree(int(args.params))
    params = tree_tensors(tree, device)
    _log(f"shard mode: {tree_params(tree)/1e6:.1f}M params, {len(tree)} "
         f"leaves, {tree_nbytes(tree)/1e6:.1f} MB f32, K in (1, {k})")
    opts = wire.WireOptions.from_env()
    modes = []
    kill_recovered = None
    with monitor.session(stall_after=float("inf")):
        for n_shards in ([1, k] if k > 1 else [1]):
            group = ShardProcessGroup(n_shards, max_restarts=2,
                                      device=args.device)
            try:
                sid = f"bench-shards-{n_shards}"
                srv = ShardedEASGD(group.addresses, params, alpha=0.5,
                                   session_id=sid)
                flat = host_arrays(params)
                per_shard = []
                for i, (lo, hi) in enumerate(srv._plan.ranges):
                    sub = flat[lo:hi]
                    _, _, st_req = wire.encode_frame(
                        ("shard_exchange", sid, sub, "cid", 1), opts)
                    _, _, st_rep = wire.encode_frame(("ok", sub), opts)
                    per_shard.append({
                        "shard": i, "n_leaves": hi - lo,
                        "bytes_sent_per_exchange": st_req.post_bytes,
                        "bytes_recv_per_exchange": st_rep.post_bytes})
                # each shard timed alone, after one untimed warm round
                probe_rounds = max(5, n_exchanges)
                probes = [[] for _ in srv._plan.ranges]
                for r in range(probe_rounds + 1):
                    seq = srv._next_seq()
                    for i, (lo, hi) in enumerate(srv._plan.ranges):
                        t0 = time.monotonic()
                        srv._shard_clients[i].exchange_tagged(
                            flat[lo:hi], srv._client_id, seq)
                        if r > 0:
                            probes[i].append((time.monotonic() - t0) * 1e3)
                for i, ws in enumerate(probes):
                    per_shard[i].update(
                        probe_wall_ms=round(ws[0], 2),
                        probe_wall_p50_ms=round(float(np.percentile(ws, 50)),
                                                2),
                        probe_wall_p99_ms=round(float(np.percentile(ws, 99)),
                                                2),
                        probe_rounds=probe_rounds)
                walls = []
                for _ in range(n_exchanges):
                    t0 = time.monotonic()
                    out = srv.exchange(params)
                    _bench.sync(device)
                    walls.append((time.monotonic() - t0) * 1e3)
                assert bool(torch.isfinite(out[0]).all())
                if args.smoke and n_shards > 1:
                    group.kill_shard(0)
                    group.wait_restarted(0)
                    out = srv.exchange(params)
                    kill_recovered = bool(
                        torch.isfinite(out[0]).all()
                        and group.restart_counts().get(0) == 1)
                    _log(f"shard-0 kill recovered: {kill_recovered}")
                srv.close()
                modes.append({
                    "shards": n_shards, "n_exchanges": n_exchanges,
                    "wall_ms_mean": round(float(np.mean(walls)), 2),
                    "wall_ms_min": round(float(np.min(walls)), 2),
                    "bytes_per_exchange": sum(
                        p["bytes_sent_per_exchange"]
                        + p["bytes_recv_per_exchange"] for p in per_shard),
                    "per_shard": per_shard})
                _log(f"K={n_shards}: {modes[-1]['wall_ms_mean']:.0f} ms "
                     f"mean, {modes[-1]['bytes_per_exchange']/1e6:.1f} "
                     "MB/exchange")
            finally:
                group.stop()
        snapshot_path = monitor.flush()
    k1 = next(m for m in modes if m["shards"] == 1)
    kk = next(m for m in modes if m["shards"] == k)
    improvement = 1.0 - kk["wall_ms_mean"] / k1["wall_ms_mean"]
    doc = {"bench": "shard_exchange", "device": str(device),
           "n_params": tree_params(tree), "n_leaves": len(tree),
           "tree_mb_f32": round(tree_nbytes(tree) / 1e6, 2),
           "wire": {"compression": opts.compression, "dtype": opts.dtype},
           "modes": modes,
           "aggregate_wall_improvement_vs_k1": round(improvement, 4),
           "kill_recovered": kill_recovered,
           "shm_lane_on": shm.enabled() and shm.available()}
    tag = args.tag or ("shard_smoke" if args.smoke else f"shard_k{k}")
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_{tag}.json"), doc)
    _log(f"wrote {path} (K={k} aggregate wall {improvement:+.1%} vs K=1)")
    if not args.smoke:
        return 0
    return smoke_verdict_sharded(doc, k, snapshot_path)


def smoke_verdict_sharded(doc: dict, k: int,
                          snapshot_path: str | None) -> int:
    """The JAX tool's 2-shard gate: K beats K=1 on aggregate wall, the
    kill recovered, every shard's ``shard_exchange`` spans and the
    recovery counters are in the monitor JSONL, and a same-host fleet
    granted the shm lane and shipped bytes out of band."""
    ok = True
    if k < 2:
        _fail("shard smoke needs --shards >= 2")
        ok = False
    modes = {m["shards"]: m for m in doc["modes"]}
    if doc["aggregate_wall_improvement_vs_k1"] <= 0:
        _fail(f"K={k} aggregate wall ({modes[k]['wall_ms_mean']} ms) does "
              f"not improve on K=1 ({modes[1]['wall_ms_mean']} ms)")
        ok = False
    if doc["kill_recovered"] is not True:
        _fail("shard-0 kill did not recover")
        ok = False
    recs = _bench.jsonl_records(snapshot_path)
    names = {r.get("name") for r in recs}
    served = _bench.span_labels(recs, "shard_exchange", "worker")
    missing = {str(i) for i in range(k)} - served
    if missing:
        _fail(f"no shard_exchange spans for shard(s) {sorted(missing)} in "
              f"the monitor JSONL ({snapshot_path})")
        ok = False
    for needed in ("service/client_reconnects_total",
                   "service/shard_restarts_total"):
        if needed not in names:
            _fail(f"{needed} missing from the monitor JSONL "
                  f"({snapshot_path})")
            ok = False
    if doc["shm_lane_on"]:
        oob = max((float(r.get("value") or 0.0) for r in recs
                   if r.get("name") == "shm/oob_bytes_total"), default=0.0)
        if "shm/grants_total" not in names or oob <= 0:
            _fail(f"no shm-lane evidence in the monitor JSONL "
                  f"({snapshot_path}): grants "
                  f"{'present' if 'shm/grants_total' in names else 'missing'}"
                  f", oob_bytes {oob:.0f}")
            ok = False
    _log(f"shard smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


# -- --local-workers N ---------------------------------------------------------


def run_hierarchy(args) -> int:
    """``--local-workers N``: N workers behind one aggregator against N
    direct exchanges, over K real shard processes (the JAX tool's
    ``run_hierarchy``): wire bytes a period and the trajectory pins."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel import wire
    from theanompi_tpu_torch.parallel.aggregate import (
        AggregatedExchange,
        LocalAggregator,
    )
    from theanompi_tpu_torch.parallel.service import host_arrays
    from theanompi_tpu_torch.parallel.shards import (
        ShardedASGD,
        ShardedEASGD,
        ShardProcessGroup,
    )

    device = resolve_device(args.device)
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-exchange")
    _monitor_env()
    n_workers = int(args.local_workers)
    k = int(args.shards or 1)
    periods = 2 if args.smoke else max(3, args.exchanges)
    alpha = 0.25  # N * alpha <= 1 at N = 4
    base_np = tree_leaves(lattice_tree(int(args.params)))
    rng = np.random.default_rng(3)
    drifts_np = [[(rng.integers(-64, 65, v.shape) * 2.0**-10)
                  .astype(np.float32) for v in base_np]
                 for _ in range(n_workers)]
    n_params = sum(int(v.size) for v in base_np)
    _log(f"hierarchy mode: {n_params/1e6:.1f}M params, {len(base_np)} "
         f"leaves, {sum(v.nbytes for v in base_np)/1e6:.1f} MB f32, N in "
         f"(1, {n_workers}), K in (1, {k})")
    opts = wire.WireOptions.from_env()

    def tensors(arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    base = tensors(base_np)
    drifts = [tensors(d) for d in drifts_np]

    def frame_bytes(msg) -> int:
        return wire.encode_frame(msg, opts)[2].post_bytes

    def shard_subs(client):
        flat = host_arrays(base)
        return [flat[lo:hi] for lo, hi in client._plan.ranges]

    def worker_start(i):
        return [b + d for b, d in zip(base, drifts[i])]

    def concurrent(fns) -> tuple[list, float]:
        outs = [None] * len(fns)
        ths = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, fns[i]())) for i in range(len(fns))]
        t0 = time.monotonic()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        _bench.sync(device)
        return outs, (time.monotonic() - t0) * 1e3

    def run_leg(n_shards, n_local, hierarchical):
        group = ShardProcessGroup(n_shards, max_restarts=1,
                                  device=args.device)
        sid = (f"hier-{n_shards}-{n_local}" if hierarchical
               else f"direct-{n_shards}-{n_local}")
        srv = ShardedEASGD(group.addresses, base, alpha=alpha,
                           session_id=sid)
        try:
            workers = [worker_start(i) for i in range(n_local)]
            walls = []
            if hierarchical:
                agg = LocalAggregator("easgd", srv, alpha=alpha)
                ports = [AggregatedExchange(
                    agg, i, lambda: ShardedEASGD(
                        group.addresses, None, alpha=alpha,
                        session_id=sid)) for i in range(n_local)]
                for _ in range(periods):
                    outs, wall = concurrent([
                        (lambda i=i: ports[i].exchange(workers[i]))
                        for i in range(n_local)])
                    walls.append(wall)
                    workers = [[o + d for o, d in zip(outs[i], drifts[i])]
                               for i in range(n_local)]
                for p in ports:
                    p.close()
                # ONE tagged aggregate sub-exchange a shard a period
                per_period = sum(
                    frame_bytes(("shard_exchange", sid, sub, "cid", 1,
                                 n_local)) + frame_bytes(("ok", sub))
                    for sub in shard_subs(srv))
            else:
                clients = [srv] + [
                    ShardedEASGD(group.addresses, None, alpha=alpha,
                                 session_id=sid)
                    for _ in range(n_local - 1)]
                for _ in range(periods):
                    outs, wall = concurrent([
                        (lambda i=i: clients[i].exchange(workers[i]))
                        for i in range(n_local)])
                    walls.append(wall)
                    workers = [[o + d for o, d in zip(outs[i], drifts[i])]
                               for i in range(n_local)]
                for c in clients[1:]:
                    c.close()
                # N full scatters: each worker's tree out and back
                per_period = n_local * sum(
                    frame_bytes(("shard_exchange", sid, sub, "cid", 1))
                    + frame_bytes(("ok", sub)) for sub in shard_subs(srv))
            center = [t.cpu().numpy() for t in srv.get_center()]
            return {"wall_ms_mean": round(float(np.mean(walls)), 2),
                    "wall_ms_min": round(float(np.min(walls)), 2),
                    "wire_bytes_per_period": per_period}, center
        finally:
            srv.close()
            group.stop()

    def easgd_closed_form():
        """N same-version exchanges a period, composed on the host in
        numpy f32: the aggregated leg's reference."""
        c = [v.copy() for v in base_np]
        workers = [[b + d for b, d in zip(base_np, drifts_np[i])]
                   for i in range(n_workers)]
        a = np.float32(alpha)
        for _ in range(periods):
            new_c = [c[j] + a * sum(w[j] - c[j] for w in workers)
                     for j in range(len(c))]
            workers = [[(w[j] - a * (w[j] - c[j])) + drifts_np[i][j]
                        for j in range(len(c))]
                       for i, w in enumerate(workers)]
            c = new_c
        return c

    def max_abs_diff(t1, t2) -> float:
        return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                   for a, b in zip(t1, t2))

    def asgd_pin(n_shards):
        """N direct same-version plain-SGD pushes against ONE aggregated
        delta-sum push, on the lattice: byte-identical centers (None when
        an at-least-once re-send shifted the update count)."""
        small_np = tree_leaves(lattice_tree(int(min(args.params, 2e5)),
                                            seed=5))
        small = tensors(small_np)
        grads = [tensors([(np.random.default_rng(50 + i)
                           .integers(-8, 9, v.shape) * 2.0**-10)
                          .astype(np.float32) for v in small_np])
                 for i in range(n_workers)]
        opt_cfg = dict(learning_rate=0.125, optimizer="sgd")
        finals = []
        for mode in ("direct", "hier"):
            group = ShardProcessGroup(n_shards, max_restarts=1,
                                      device=args.device)
            srv = ShardedASGD(group.addresses, small, opt_cfg,
                              session_id=f"asgd-pin-{mode}-{n_shards}")
            try:
                for _ in range(periods):
                    if mode == "direct":
                        for g in grads:
                            srv.push_pull(g)
                    else:
                        gsum = [torch.stack([g[j] for g in grads]).sum(0)
                                for j in range(len(small))]
                        srv.push_pull_n(gsum, n_workers)
                finals.append(([t.cpu().numpy() for t in srv.get_center()],
                               srv.n_updates))
            finally:
                srv.close()
                group.stop()
        (c_direct, n_direct), (c_hier, n_hier) = finals
        expect = periods * n_workers
        if n_direct != expect or n_hier != expect:
            print(f"[bench_exchange] asgd pin saw a transport re-send "
                  f"(updates direct={n_direct} hier={n_hier}, expected "
                  f"{expect}); pin inconclusive this run", file=sys.stderr)
            return None
        bad = [j for j in range(len(small_np))
               if c_direct[j].tobytes() != c_hier[j].tobytes()]
        if bad:
            _log(f"asgd pin mismatch on {len(bad)}/{len(small_np)} leaves "
                 f"(max abs diff "
                 f"{max_abs_diff([c_direct[j] for j in bad], [c_hier[j] for j in bad])})")
        return not bad

    combos = ([(k, n_workers)] if args.smoke else
              [(s, n) for s in sorted({1, k}) for n in sorted({1, n_workers})])
    modes = []
    with monitor.session(stall_after=float("inf")):
        for n_shards, n_local in combos:
            direct, d_center = run_leg(n_shards, n_local, False)
            hier, h_center = run_leg(n_shards, n_local, True)
            row = {"shards": n_shards, "local_workers": n_local,
                   "periods": periods, "direct": direct,
                   "hierarchical": hier,
                   "wire_byte_reduction_x": round(
                       direct["wire_bytes_per_period"]
                       / hier["wire_bytes_per_period"], 4),
                   "wall_delta_vs_direct": round(
                       1.0 - hier["wall_ms_mean"] / direct["wall_ms_mean"],
                       4),
                   "easgd_direct_vs_hier_center_max_abs_diff":
                       max_abs_diff(d_center, h_center)}
            if n_local == n_workers:
                row["easgd_closed_form_max_abs_diff"] = max_abs_diff(
                    h_center, easgd_closed_form())
            modes.append(row)
            _log(f"K={n_shards} N={n_local}: {row['wire_byte_reduction_x']}x "
                 f"fewer wire bytes/period "
                 f"({direct['wire_bytes_per_period']/1e6:.1f} -> "
                 f"{hier['wire_bytes_per_period']/1e6:.1f} MB), wall "
                 f"{direct['wall_ms_mean']:.0f} -> "
                 f"{hier['wall_ms_mean']:.0f} ms")
        asgd_identical = asgd_pin(k)
        if asgd_identical is None:  # a transport re-send: one more try
            asgd_identical = asgd_pin(k)
        snapshot_path = monitor.flush()
    top = next(m for m in modes
               if m["shards"] == k and m["local_workers"] == n_workers)
    doc = {"bench": "hierarchical_exchange", "device": str(device),
           "n_params": n_params, "n_leaves": len(base_np),
           "tree_mb_f32": round(sum(v.nbytes for v in base_np) / 1e6, 2),
           "alpha": alpha,
           "wire": {"compression": opts.compression, "dtype": opts.dtype},
           "modes": modes, "asgd_delta_sum_byte_identical": asgd_identical}
    tag = args.tag or "hierarchy_smoke"
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_{tag}.json"), doc)
    _log(f"wrote {path} (N={n_workers} K={k}: "
         f"{top['wire_byte_reduction_x']}x fewer wire bytes/period)")
    if not args.smoke:
        return 0
    return smoke_verdict_hierarchy(doc, n_workers, k, snapshot_path)


def smoke_verdict_hierarchy(doc: dict, n_workers: int, k: int,
                            snapshot_path: str | None) -> int:
    """The JAX tool's gate: >= 3.9x fewer wire bytes a period at N=4,
    the EASGD closed form exact, the ASGD delta sum byte-identical, and
    the fan-in gauge and ``local_aggregate`` spans in the monitor
    JSONL."""
    ok = True
    top = next(m for m in doc["modes"]
               if m["shards"] == k and m["local_workers"] == n_workers)
    if top["wire_byte_reduction_x"] < 3.9 and n_workers >= 4:
        _fail(f"wire-byte reduction {top['wire_byte_reduction_x']}x < 3.9x "
              f"at N={n_workers}")
        ok = False
    if top["hierarchical"]["wire_bytes_per_period"] >= \
            top["direct"]["wire_bytes_per_period"]:
        _fail("hierarchical wire bytes/period not below the direct "
              "baseline")
        ok = False
    if top.get("easgd_closed_form_max_abs_diff", 1.0) != 0.0:
        _fail(f"EASGD aggregate deviates from the closed form on the exact "
              f"lattice (max abs diff "
              f"{top.get('easgd_closed_form_max_abs_diff')})")
        ok = False
    if doc["asgd_delta_sum_byte_identical"] is not True:
        _fail("ASGD delta-sum not byte-identical to N direct same-version "
              "pushes")
        ok = False
    recs = _bench.jsonl_records(snapshot_path)
    fan_in = next((r.get("value") for r in reversed(recs)
                   if r.get("name") == "aggregate/fan_in"), None)
    if fan_in != float(n_workers):
        _fail(f"aggregate/fan_in gauge is {fan_in}, expected {n_workers} "
              f"(monitor JSONL {snapshot_path})")
        ok = False
    if not _bench.span_labels(recs, "local_aggregate", "rule"):
        _fail(f"no local_aggregate spans in the monitor JSONL "
              f"({snapshot_path})")
        ok = False
    _log(f"hierarchy smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


# -- --shm-compare ---------------------------------------------------------


def run_shm_compare(args) -> int:
    """``--shm-compare``: the lane against in-band frames on the
    exchange plane (one shard process a leg, every merged tree
    sha256-checked, a mid-run force-disable whose tail must ship in
    band, a SIGKILL-mid-lease leg whose segments must sweep to zero),
    the ingest plane (``bench_ingest.shm_compare_leg``) and the KV-page
    plane (:func:`kv_pages_leg`)."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch._device import resolve_device
    from theanompi_tpu_torch.parallel import shm, wire
    from theanompi_tpu_torch.parallel.shards import (
        ShardedEASGD,
        ShardProcessGroup,
    )
    from theanompi_tpu_torch.tools import bench_ingest

    device = resolve_device(args.device)
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "bench-exchange")
    _monitor_env()
    if not (shm.enabled() and shm.available()):
        _fail("the shm lane is disabled or /dev/shm is unavailable here")
        return 1
    tree = resnet50_like_tree(int(args.params))
    params = tree_tensors(tree, device)
    n_exchanges = max(3, args.exchanges)
    tail = 2  # exchanges after the force-disable (the fallback proof)
    _log(f"shm-compare: {tree_params(tree)/1e6:.1f}M params, {len(tree)} "
         f"leaves, {tree_nbytes(tree)/1e6:.1f} MB f32, {n_exchanges} timed "
         f"+ {tail} fallback exchanges/leg")
    opts = wire.WireOptions.from_env()
    flat = tree_leaves(tree)
    _, _, st_req = wire.encode_frame(
        ("shard_exchange", "bench-shm", flat, "cid", 1), opts)
    _, _, st_rep = wire.encode_frame(("ok", flat), opts)
    wire_bytes = st_req.post_bytes + st_rep.post_bytes

    def digest(out) -> str:
        h = hashlib.sha256()
        for t in out:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def val(name, **lb):
        return monitor.registry().value(name, **lb) or 0.0

    def oob_total():
        return (val("shm/oob_bytes_total", dir="send")
                + val("shm/oob_bytes_total", dir="recv"))

    pre_segments = set(shm.segment_names())

    def exchange_leg(lane: str) -> dict:
        with _bench.env(THEANOMPI_TPU_WIRE_SHM=lane):
            grants0, oob0 = val("shm/grants_total", role="client"), \
                oob_total()
            digests, walls = [], []
            group = ShardProcessGroup(1, max_restarts=1, device=args.device)
            try:
                srv = ShardedEASGD(group.addresses, params, alpha=0.5,
                                   session_id=f"bench-shm-{lane}")
                try:
                    digests.append(digest(srv.exchange(params)))  # warm
                    for _ in range(n_exchanges):
                        t0 = time.monotonic()
                        out = srv.exchange(params)
                        _bench.sync(device)
                        walls.append((time.monotonic() - t0) * 1e3)
                        digests.append(digest(out))
                    oob_tail0 = oob_total()
                    if lane == "1":
                        # force-disable on the LIVE client: the path a
                        # typed refusal takes (drop the lane, reconnect
                        # without an offer)
                        for c in srv._shard_clients:
                            c._disable_shm()
                            if getattr(c, "_transport", None) is None:
                                try:
                                    c._conn.close()
                                except OSError:
                                    pass
                        for t in srv._transports or ():
                            t.disable_shm()
                    for _ in range(tail):
                        digests.append(digest(srv.exchange(params)))
                    oob_tail_growth = oob_total() - oob_tail0
                finally:
                    srv.close()
            finally:
                group.stop()
        oob = oob_total() - oob0
        leg = {"wall_ms_mean": round(float(np.mean(walls)), 2),
               "wall_ms_min": round(float(np.min(walls)), 2),
               "n_exchanges": n_exchanges, "digests": digests,
               "shm_grants": int(val("shm/grants_total", role="client")
                                 - grants0),
               "oob_bytes": int(oob),
               "oob_bytes_per_exchange": int(oob / (n_exchanges + 1)),
               "oob_tail_growth": int(oob_tail_growth)}
        _log(f"shm-compare {'shm' if lane == '1' else 'in_band'}: "
             f"{leg['wall_ms_mean']:.0f} ms/exchange mean, "
             f"{leg['oob_bytes']/1e6:.1f} MB out-of-band")
        return leg

    def kill_leg() -> dict:
        """SIGKILL the server while its reply segments are leased (the
        ack rides the client's next frame, which never comes), then
        sweep the dead peer's segments."""
        with _bench.env(THEANOMPI_TPU_WIRE_SHM="1"):
            group = ShardProcessGroup(1, max_restarts=0, device=args.device)
            try:
                srv = ShardedEASGD(group.addresses, params, alpha=0.5,
                                   session_id="bench-shm-kill")
                try:
                    srv.exchange(params)
                    srv.exchange(params)
                    leased = len([n for n in shm.segment_names()
                                  if n not in pre_segments])
                    group.kill_shard(0)
                finally:
                    try:
                        srv.close()
                    except Exception:
                        pass
            finally:
                group.stop()
        shm.release_all()
        swept = shm.sweep_orphans()
        leaked = [n for n in shm.segment_names() if n not in pre_segments]
        out = {"leased_at_kill": leased, "swept": int(swept or 0),
               "leaked_after_sweep": len(leaked)}
        _log(f"shm-compare kill leg: {out}")
        return out

    planes: dict[str, dict] = {}
    with monitor.session(stall_after=float("inf")):
        in_band = exchange_leg("0")
        lane = exchange_leg("1")
        kill = kill_leg()
        wall_cut = 1.0 - lane["wall_ms_mean"] / in_band["wall_ms_mean"]
        planes["exchange"] = {
            "plane": "exchange", "n_params": tree_params(tree),
            "wire_bytes_per_exchange_in_band": wire_bytes,
            "legs": {"in_band": in_band, "shm": lane},
            "wall_cut_shm_vs_in_band": round(wall_cut, 4),
            "byte_identical": in_band["digests"] == lane["digests"],
            "socket_bytes_saved_per_exchange":
                lane["oob_bytes_per_exchange"],
            "kill_leg": kill}
        _log(f"exchange plane: shm cuts {wall_cut:.1%} of the in-band wall")
        planes["ingest"] = bench_ingest.shm_compare_leg(
            samples=4096 if args.smoke else 8192)
        _log(f"ingest plane: shm "
             f"{planes['ingest']['img_s_ratio_shm_over_in_band']:.2f}x "
             "in-band img/s")
        planes["serving"] = kv_pages_leg(args.device)
        _log(f"KV-page plane: shm wall delta "
             f"{planes['serving']['wall_delta_pct']:+.1f}%")
    leaked_final = [n for n in shm.segment_names() if n not in pre_segments]
    for leg in planes["exchange"]["legs"].values():
        leg.pop("digests", None)
    doc = {"bench": "shm_lane", "device": str(device),
           "n_params": tree_params(tree), "n_leaves": len(tree),
           "tree_mb_f32": round(tree_nbytes(tree) / 1e6, 2),
           "planes": planes, "leaked_segments_final": len(leaked_final)}
    path = _bench.write_json(
        args.out or _bench.build_path(f"BENCH_{args.tag or 'shm_smoke'}.json"),
        doc)
    _log(f"wrote {path}")
    if not args.smoke:
        return 0
    return smoke_verdict_shm(doc)


def smoke_verdict_shm(doc: dict) -> int:
    """The JAX tool's gate: >= 25% exchange wall cut, byte identity on
    every plane, lane traffic where it was on and none where it was off
    or after the force-disable, the kill leg leased and swept, >= 1.3x
    ingest img/s, and no segment left."""
    ok = True
    ex = doc["planes"]["exchange"]
    legs = ex["legs"]
    checks = [
        (ex["byte_identical"],
         "shm exchange leg diverged from the in-band leg (byte identity)"),
        (ex["wall_cut_shm_vs_in_band"] >= 0.25,
         f"shm wall cut {ex['wall_cut_shm_vs_in_band']:.1%} < 25%"),
        (legs["shm"]["shm_grants"] >= 1 and legs["shm"]["oob_bytes"] > 0,
         f"shm leg shows no lane traffic ({legs['shm']})"),
        (legs["in_band"]["oob_bytes"] == 0
         and legs["in_band"]["shm_grants"] == 0,
         f"in-band leg negotiated the lane ({legs['in_band']})"),
        (legs["shm"]["oob_tail_growth"] == 0,
         "out-of-band bytes grew after the mid-run force-disable"),
        (ex["kill_leg"]["leased_at_kill"] >= 1,
         "kill leg found no leased segment at SIGKILL time"),
        (ex["kill_leg"]["leaked_after_sweep"] == 0,
         f"{ex['kill_leg']}: the dead peer's segments survived the sweep"),
        (doc["planes"]["ingest"]["byte_identical"],
         "ingest shm leg delivered different bytes"),
        (doc["planes"]["ingest"]["img_s_ratio_shm_over_in_band"] >= 1.3,
         f"ingest shm img/s "
         f"{doc['planes']['ingest']['img_s_ratio_shm_over_in_band']:.2f}x "
         "< 1.3x"),
        (doc["planes"]["serving"]["byte_identical"],
         "KV-page shm leg delivered different page bytes"),
        (doc["planes"]["serving"]["legs"]["shm"]["oob_bytes_recv"] > 0,
         "KV-page shm leg shows no lane traffic"),
        (doc["leaked_segments_final"] == 0,
         f"{doc['leaked_segments_final']} shm segment(s) leaked after all "
         "legs")]
    for good, msg in checks:
        if not good:
            _fail(msg)
            ok = False
    _log(f"shm-compare smoke {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def kv_pages_leg(device: str, rounds: int = 10) -> dict:
    """KV-page plane of the lane comparison (the JAX tool's
    ``bench_serving.shm_compare_leg``): a prefill replica (a fresh
    process a leg) ships a tiny LM's KV pages for one prompt set, in band
    and over the lane, the page bytes sha256-checked across legs."""
    import tempfile

    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.frontdoor.prefill import PrefillClient
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.parallel import shm
    from theanompi_tpu_torch.parallel.shards import child_env
    from theanompi_tpu_torch.serving import export_model

    rng = np.random.default_rng(20)
    prompts = [(rng.integers(0, 62, 24).astype(np.int32) + 1)
               for _ in range(4)]
    pre_segments = set(shm.segment_names())

    def val(name, **lb):
        return monitor.registry().value(name, **lb) or 0.0

    legs: dict[str, dict] = {}
    with tempfile.TemporaryDirectory(prefix="bench_kv_") as td:
        torch.manual_seed(0)
        model = TransformerLM(
            config=ModelConfig(batch_size=4, compute_dtype="float32"),
            device="cpu", vocab=64, seq_len=64, n_layers=2, d_model=64,
            n_heads=4)
        export_dir = os.path.join(td, "export")
        export_model(model, export_dir, version=0)
        for name, lane in (("in_band", "0"), ("shm", "1")):
            # the tiny net's pages are tens of KB, under the lane's 64 KiB
            # floor: both legs run the same lowered floor
            with _bench.env(THEANOMPI_TPU_WIRE_SHM=lane,
                      THEANOMPI_TPU_SHM_MIN_BYTES="1024"):
                port = _bench.free_port()
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "theanompi_tpu_torch.frontdoor.prefill",
                     "--export-dir", export_dir, "--host", "127.0.0.1",
                     "--port", str(port), "--page-size", "16",
                     "--pages-per-seq", "4", "--max-seqs", "8",
                     "--max-pending", "8", "--prefill-batch", "1",
                     "--prefill-delay-ms", "0", "--device", device],
                    env=child_env())
                c = None
                try:
                    deadline = time.monotonic() + 180
                    while c is None:
                        try:
                            c = PrefillClient(f"127.0.0.1:{port}")
                            c.ping()
                        except Exception:
                            if c is not None:
                                c.close()
                            c = None
                            if proc.poll() is not None or \
                                    time.monotonic() > deadline:
                                raise RuntimeError(
                                    "prefill replica never came up "
                                    f"(rc={proc.poll()})")
                            time.sleep(0.3)
                    oob0 = val("shm/oob_bytes_total", dir="recv")
                    grants0 = val("shm/grants_total", role="client")
                    h = hashlib.sha256()
                    page_bytes = 0
                    for p in prompts:  # warm
                        c.prefill(p)
                    t0 = time.monotonic()
                    for _ in range(rounds):
                        for p in prompts:
                            _, k, v = c.prefill(p)
                            h.update(np.asarray(k).tobytes())
                            h.update(np.asarray(v).tobytes())
                            page_bytes += k.nbytes + v.nbytes
                    wall = time.monotonic() - t0
                finally:
                    if c is not None:
                        try:
                            c.shutdown()
                        except Exception:
                            pass
                        c.close()
                    try:
                        proc.wait(timeout=20)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=10)
                n = rounds * len(prompts)
                legs[name] = {
                    "prefills": n, "wall_s": round(wall, 3),
                    "prefill_ms_mean": round(wall / n * 1e3, 2),
                    "page_bytes": page_bytes, "sha256": h.hexdigest(),
                    "oob_bytes_recv": int(
                        val("shm/oob_bytes_total", dir="recv") - oob0),
                    "shm_grants": int(val("shm/grants_total", role="client")
                                      - grants0)}
                _log(f"KV-page {name}: {legs[name]['prefill_ms_mean']:.1f} "
                     f"ms/prefill, {legs[name]['oob_bytes_recv']/1e6:.2f} MB "
                     "out-of-band")
    shm.sweep_orphans()
    leaked = [n for n in shm.segment_names() if n not in pre_segments]
    return {"plane": "serving_kv", "rounds": rounds, "prompts": len(prompts),
            "legs": legs,
            "byte_identical": legs["shm"]["sha256"]
            == legs["in_band"]["sha256"],
            "wall_delta_pct": round(100.0 * (
                1.0 - legs["shm"]["wall_s"] / legs["in_band"]["wall_s"]), 1),
            "socket_bytes_saved": legs["shm"]["oob_bytes_recv"],
            "leaked_segments": len(leaked)}


# -- main ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.tools.bench_exchange",
        description=__doc__.split("\n")[0])
    ap.add_argument("--params", type=float, default=25.5e6,
                    help="target parameter count (~ResNet-50)")
    ap.add_argument("--exchanges", type=int, default=3,
                    help="timed exchanges per mode")
    ap.add_argument("--out", default=None,
                    help="output JSON (default build/BENCH_<leg>_<tag>.json)")
    ap.add_argument("--tag", default=None, help="output tag")
    _bench.add_device_arg(ap)
    ap.add_argument("--buckets", default=None, metavar="B[,B...]",
                    help="bucket mode: the BSP exchange on --ranks "
                         "process-group ranks over the given bucket counts "
                         "(B=1 always added) x {f32,bf16}; with --smoke "
                         "asserts the B-vs-1 step bit-identity, B launches "
                         "an exchange and the bucket gauge.  Mutually "
                         "exclusive with --shards")
    ap.add_argument("--ranks", type=int, default=4,
                    help="--buckets: process-group ranks (gloo on the CPU, "
                         "NCCL on cards, one a card)")
    ap.add_argument("--shards", type=int, default=None, metavar="K",
                    help="shard mode: K real shard processes against K=1; "
                         "with --smoke also kills and recovers shard 0")
    ap.add_argument("--local-workers", type=int, default=None, metavar="N",
                    help="hierarchy mode: N workers behind one aggregator "
                         "against N direct exchanges over --shards K shard "
                         "processes (default 1); with --smoke asserts the "
                         ">=3.9x byte reduction, the trajectory pins and "
                         "the fan-in gauge and local_aggregate spans.  "
                         "Mutually exclusive with --buckets (BSP refuses "
                         "hierarchical aggregation)")
    ap.add_argument("--shm-compare", action="store_true",
                    help="shared-memory-lane mode: in-band against the "
                         "lane on the exchange, ingest and KV-page planes; "
                         "with --smoke asserts the >=25%% exchange wall "
                         "cut, the >=1.3x ingest lift and no leaked "
                         "segment.  Mutually exclusive with the other legs")
    ap.add_argument("--smoke", action="store_true",
                    help="preflight gate: 1 exchange a mode, the JAX tool's "
                         "assertions, exit 1 on a miss")
    # one rank of the --buckets leg (started by the leg itself)
    ap.add_argument("--bucket-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bucket-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bucket-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.bucket_rank is not None:
        return bucket_rank_main(args)
    if args.shm_compare and (args.buckets is not None
                             or args.shards is not None
                             or args.local_workers is not None):
        raise FlagConflict(
            "--shm-compare is its own multi-plane leg (exchange + ingest + "
            "KV pages vs the shm lane) and drives its own fleet sizes — "
            "run --buckets/--shards/--local-workers separately")
    if args.buckets is not None and args.shards is not None:
        raise FlagConflict(
            "--buckets and --shards are mutually exclusive legs: the bucket "
            "leg measures BSP's in-step exchange over the process group, "
            "the shard leg the wire exchange against real shard processes "
            "— run them separately")
    if args.local_workers is not None and args.buckets is not None:
        raise FlagConflict(
            "--local-workers and --buckets are mutually exclusive: "
            "hierarchical aggregation is an async-rules (EASGD/ASGD) wire "
            "plane, while the bucket leg measures BSP's in-step exchange — "
            "BSP (like GOSGD) refuses hierarchical aggregation")
    if args.local_workers is not None and args.local_workers < 1:
        raise FlagConflict(
            f"--local-workers must be >= 1, got {args.local_workers}")
    if args.shm_compare:
        return run_shm_compare(args)
    if args.local_workers is not None:
        return run_hierarchy(args)
    if args.buckets is not None:
        return run_buckets(args)
    if args.shards is not None:
        return run_sharded(args)
    return run_default(args)


if __name__ == "__main__":
    raise SystemExit(main())
