"""Connection-scaling benchmark of the port's RPC substrate — the
counterpart of ``tools/bench_rpc.py``.

Every leg runs against a real server process, ``python -m
theanompi_tpu_torch.parallel.service``, pinned to one core:

* **connscale** — P client processes, each pipelining one in-flight pull
  on each of its C authenticated connections from one thread (1 to 1000
  connections in all, every one with a request in flight), against the
  port's one event plane, the selector loop.  Aggregate pulls/s and the
  per-connection p50/p99 a point.
* **convoy** — N logical pullers in ONE client process pinned to one core
  beside a GIL-holding compute thread: N dedicated sockets with N
  blocking threads against ONE multiplexed socket with one pipelined
  thread (``rpc.MuxConnection``), in the same run.
* ``--soak`` — multiplexed streams hammer ``easgd_get_center``, every
  reply checked bitwise against the seeded tree, while writer streams
  interleave large gossip push/drain frames on the same sockets.

``--smoke`` is the JAX tool's gate (exit 1 on a miss): flat
per-connection p99 across the points (the top point within 3x of the
lowest, per connection), >= 1000 pulls/s at the top point, the convoy's
multiplexed leg at >= 10x the JAX tool's committed baseline, and
``rpc/connections_total`` and ``service/requests_total`` in the server's
monitor JSONL.  JAX's thread-per-connection loop (its
``THEANOMPI_TPU_RPC_LOOP=threaded``) is not ported; ``--loops`` takes
``selector`` only.

Usage:
    python -m theanompi_tpu_torch.tools.bench_rpc --device cpu --smoke
    python -m theanompi_tpu_torch.tools.bench_rpc --device cpu --soak \\
        --dur 4 --payload-kb 64
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from theanompi_tpu_torch.tools import _bench

#: the JAX tool's convoy gate (``tools/bench_rpc.py``): the reference
#: tool's committed baseline, ~40 pulls/s at 12 blocking recv threads on
#: its one-core host.  It is the reference tool's bar, not a rate
#: measured on the port; the smoke asks the multiplexed leg for 10x it.
CONVOY_BASELINE_PULLS_S = 40.0

SESSION = "bench-rpc"

#: the only event plane the port serves on
LOOPS = ("selector",)


def _log(msg: str) -> None:
    print(f"[bench_rpc] {msg}", flush=True)


def _pin(pid: int, cores: set[int] | None) -> None:
    if cores:
        try:
            os.sched_setaffinity(pid, cores)
        except (AttributeError, OSError):
            pass


def _center(out) -> np.ndarray:
    """The seeded leaf of an ``easgd_get_center`` reply: a list of leaves
    from the port's service, a dict from JAX's."""
    return np.asarray(out["w"] if isinstance(out, dict) else out[0])


# -- server lifecycle --------------------------------------------------------


def start_server(payload_floats: int, server_cores: set[int] | None,
                 monitor_dir: str | None, device: str = "cpu"):
    """One real service process, seeded with the payload tree; returns
    (port, Popen, init_client)."""
    from theanompi_tpu_torch.parallel.service import RemoteEASGD, _authkey
    from theanompi_tpu_torch.parallel.shards import child_env

    _authkey(generate=True)  # one key for the server and every worker
    port = _bench.free_port()
    env = child_env()
    if monitor_dir:
        env["THEANOMPI_TPU_MONITOR"] = monitor_dir
    srv = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.service",
         "--host", "127.0.0.1", "--port", str(port), "--device", device],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    tree = [torch.from_numpy(np.random.default_rng(0).random(
        payload_floats).astype(np.float32))]
    deadline = time.monotonic() + 120
    init = None
    while init is None:
        try:
            init = RemoteEASGD(f"127.0.0.1:{port}", tree, alpha=0.5,
                               session_id=SESSION)
        except Exception:
            if srv.poll() is not None or time.monotonic() > deadline:
                srv.kill()
                srv.wait()
                raise RuntimeError(
                    f"the service never came up (rc={srv.poll()})")
            time.sleep(0.2)
    _pin(srv.pid, server_cores)
    return port, srv, init


def stop_server(port: int, srv, init) -> None:
    from theanompi_tpu_torch.parallel.service import ServiceClient

    init.close()
    try:
        c = ServiceClient(f"127.0.0.1:{port}")
        c.call("shutdown")
        c.close()
    except Exception:
        srv.terminate()
    try:
        srv.wait(timeout=30)
    except subprocess.TimeoutExpired:
        srv.kill()
        srv.wait()


# -- connscale ---------------------------------------------------------------


def worker_main(args) -> int:
    """One client process: C authenticated connections, one pull in
    flight on each, collected from ONE thread (no client-side convoy:
    the client measures the server)."""
    from multiprocessing.connection import wait as conn_wait

    from theanompi_tpu_torch.parallel import rpc, wire
    from theanompi_tpu_torch.parallel.service import _authkey

    opts = wire.WireOptions()
    conns = []
    for _ in range(args.worker_conns):
        c = rpc.connect_client(("127.0.0.1", args.worker_port), _authkey())
        c.send((wire.HELLO_OP, wire.hello_payload(opts)))
        status, _ = rpc.recv_deadline(c)
        assert status == "ok", "wire negotiation failed"
        conns.append(c)
    print("READY", flush=True)
    sys.stdin.readline()  # the go barrier
    req = ("easgd_get_center", SESSION)
    count, lat, sent = 0, [], {}
    stop = time.monotonic() + args.worker_dur
    for c in conns:
        wire.send_msg(c, req, opts)
        sent[c] = time.monotonic()
    while time.monotonic() < stop:
        for c in conn_wait(list(sent), timeout=0.2):
            status, _ = wire.recv_msg(c, opts)
            assert status == "ok"
            lat.append(time.monotonic() - sent.pop(c))
            count += 1
            wire.send_msg(c, req, opts)
            sent[c] = time.monotonic()
    lat.sort()
    out = {"count": count,
           "p50_ms": lat[len(lat) // 2] * 1e3 if lat else 0.0,
           "p99_ms": lat[int(len(lat) * 0.99)] * 1e3 if lat else 0.0}
    for c in conns:
        c.close()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def connscale_point(total_conns: int, procs: int, dur_s: float,
                    payload_floats: int, server_cores: set[int] | None,
                    monitor_dir: str | None = None,
                    device: str = "cpu") -> dict:
    from theanompi_tpu_torch.parallel.shards import child_env

    procs = min(procs, total_conns)
    port, srv, init = start_server(payload_floats, server_cores,
                                   monitor_dir, device)
    ps = []
    try:
        per, extra = divmod(total_conns, procs)
        for i in range(procs):
            ps.append(subprocess.Popen(
                [sys.executable, "-m", "theanompi_tpu_torch.tools.bench_rpc",
                 "--worker-port", str(port), "--worker-conns",
                 str(per + (1 if i < extra else 0)),
                 "--worker-dur", str(dur_s)],
                env=child_env(), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True))
        for p in ps:
            line = p.stdout.readline().strip()
            assert line == "READY", f"worker said {line!r}"
        t0 = time.monotonic()
        for p in ps:  # every connection exists before any pull
            p.stdin.write("go\n")
            p.stdin.flush()
        results = []
        for p in ps:
            for line in p.stdout:
                if line.startswith("RESULT "):
                    results.append(json.loads(line[7:]))
                    break
            p.wait(timeout=60)
        wall = time.monotonic() - t0
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
        stop_server(port, srv, init)
    return {"loop": "selector", "conns": total_conns, "procs": procs,
            "pulls_s": round(sum(r["count"] for r in results) / wall, 1),
            "p50_ms": round(max(r["p50_ms"] for r in results), 2),
            "p99_ms": round(max(r["p99_ms"] for r in results), 2)}


# -- convoy --------------------------------------------------------------------


def convoy_point(port: int, n: int, dur_s: float,
                 client_core: set[int] | None) -> dict:
    """N dedicated sockets with N blocking threads against ONE mux
    socket with one pipelined thread, beside a GIL-holding compute
    thread, all in this process (pinned to one core when asked)."""
    from theanompi_tpu_torch.parallel import rpc, wire
    from theanompi_tpu_torch.parallel.service import ServiceClient

    before = (os.sched_getaffinity(0)
              if hasattr(os, "sched_getaffinity") else None)
    _pin(0, client_core)
    stop_compute = threading.Event()

    def compute():
        x = np.random.rand(64, 64)
        while not stop_compute.is_set():
            for _ in range(50):
                (x @ x).sum()
            sum(i * i for i in range(2000))

    ct = threading.Thread(target=compute, daemon=True,
                          name="bench-rpc-compute")
    ct.start()
    req = ("easgd_get_center", SESSION)

    def stats(count, lat, wall):
        lat.sort()
        return {"pulls_s": round(count / wall, 1),
                "p50_ms": round(lat[len(lat) // 2] * 1e3, 2),
                "p99_ms": round(lat[int(len(lat) * 0.99)] * 1e3, 2)}

    def drive_threads() -> dict:
        clients = [ServiceClient(f"127.0.0.1:{port}") for _ in range(n)]
        counts = [0] * n
        lat: list[float] = []
        llock = threading.Lock()
        stop_t = time.monotonic() + dur_s

        def run(i):
            while time.monotonic() < stop_t:
                t0 = time.monotonic()
                clients[i].call(*req)
                with llock:
                    lat.append(time.monotonic() - t0)
                counts[i] += 1

        ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        t0 = time.monotonic()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        wall = time.monotonic() - t0
        for c in clients:
            c.close()
        return stats(sum(counts), lat, wall)

    def drive_mux() -> dict:
        mc = rpc.MuxConnection(f"127.0.0.1:{port}")
        streams = [mc.connect_stream() for _ in range(n)]
        omap = dict(streams)
        count, lat, inflight = 0, [], {}
        stop_t = time.monotonic() + dur_s
        t0 = time.monotonic()
        for s, o in streams:
            wire.send_msg(s, req, o)
            inflight[s] = time.monotonic()
        while time.monotonic() < stop_t:
            for s in rpc.wait_readable(list(inflight), 0.05):
                wire.recv_msg(s, omap[s])
                lat.append(time.monotonic() - inflight.pop(s))
                count += 1
                wire.send_msg(s, req, omap[s])
                inflight[s] = time.monotonic()
        wall = time.monotonic() - t0
        for s, _ in streams:
            s.close()
        mc.close()
        return stats(count, lat, wall)

    try:
        old = drive_threads()
        new = drive_mux()
    finally:
        stop_compute.set()
        ct.join(timeout=5)
        if before is not None:
            _pin(0, before)
    return {"n_clients": n, "dedicated_sockets": old,
            "mux_pipelined": new,
            "mux_over_dedicated": round(new["pulls_s"]
                                        / max(old["pulls_s"], 1e-9), 2),
            "reference_convoy_baseline_pulls_s": CONVOY_BASELINE_PULLS_S,
            "recovery_vs_reference_baseline": round(
                new["pulls_s"] / CONVOY_BASELINE_PULLS_S, 1)}


# -- soak ----------------------------------------------------------------------


def soak_against(addr: str, dur_s: float, payload_floats: int,
                 n_transports: int = 3, streams_per: int = 4) -> dict:
    """The mux byte-identity soak against the service at ``addr`` (seeded
    with ``SESSION``'s tree of ``payload_floats`` f32 from seed 0): reader
    streams on ``n_transports`` ``MuxConnection`` sockets compare every
    ``easgd_get_center`` reply bitwise to the tree while one gossip writer
    a transport pushes and drains large frames on the same sockets.  A
    server that grants no mux (JAX's threaded loop) gets dedicated
    sockets from the same client code, which must hold identity too."""
    from theanompi_tpu_torch.parallel import rpc
    from theanompi_tpu_torch.parallel.service import (
        RemoteGossipHub,
        ServiceClient,
    )

    ref = np.random.default_rng(0).random(payload_floats).astype(np.float32)
    ref_bytes = ref.tobytes()
    stop_t = time.monotonic() + dur_s
    counts = {"reads": 0, "writes": 0}
    errors: list[str] = []
    mismatches = [0]
    lock = threading.Lock()
    transports = [rpc.MuxConnection(addr) for _ in range(n_transports)]
    readers = [ServiceClient(addr, transport=t)
               for t in transports for _ in range(streams_per)]
    hubs = [RemoteGossipHub(addr, 2, session_id=SESSION + "-soak",
                            transport=t) for t in transports]

    def read_loop(c):
        n = 0
        try:
            while time.monotonic() < stop_t:
                out = c.call("easgd_get_center", SESSION)
                if _center(out).tobytes() != ref_bytes:
                    with lock:
                        mismatches[0] += 1
                n += 1
        except Exception as e:
            with lock:
                errors.append(f"reader: {type(e).__name__}: {e}")
        with lock:
            counts["reads"] += n

    def write_loop(hub):
        n = 0
        tree = [torch.from_numpy(ref[: payload_floats // 4])]
        try:
            while time.monotonic() < stop_t:
                hub.push(1, tree, 0.01)
                hub.drain(1)
                n += 1
        except Exception as e:
            with lock:
                errors.append(f"writer: {type(e).__name__}: {e}")
        with lock:
            counts["writes"] += n

    ths = ([threading.Thread(target=read_loop, args=(c,), daemon=True)
            for c in readers]
           + [threading.Thread(target=write_loop, args=(h,), daemon=True)
              for h in hubs])
    t0 = time.monotonic()
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    finally:
        wall = time.monotonic() - t0
        muxed = any(t.mux for t in transports)
        for c in readers + hubs:
            c.close()
        for t in transports:
            t.close()
    return {"reads": counts["reads"], "writes": counts["writes"],
            "reads_per_s": round(counts["reads"] / wall, 1),
            "byte_mismatches": mismatches[0], "errors": errors[:5],
            "mux_granted": muxed,
            "streams": n_transports * (streams_per + 1),
            "dur_s": round(wall, 1)}


def soak_failures(results: dict) -> list[str]:
    """The JAX tool's soak gate: no mismatch, no transport error,
    sustained reads and writes, and the selector loop granted mux."""
    failures = []
    for loop, r in results.items():
        if r["byte_mismatches"]:
            failures.append(f"{loop}: {r['byte_mismatches']} byte "
                            "mismatches")
        if r["errors"]:
            failures.append(f"{loop}: transport errors {r['errors']}")
        if not r["reads"] or not r["writes"]:
            failures.append(f"{loop}: no sustained load "
                            f"(reads={r['reads']}, writes={r['writes']})")
    if "selector" in results and not results["selector"]["mux_granted"]:
        failures.append("selector loop did not grant mux — the soak never "
                        "exercised stream multiplexing")
    return failures


def run_soak(args) -> int:
    payload_floats = args.payload_kb * 256
    results = {}
    for loop in args.loops.split(","):
        port, srv, init = start_server(payload_floats, None, None,
                                       args.device)
        try:
            results[loop] = soak_against(f"127.0.0.1:{port}", args.dur,
                                         payload_floats)
        finally:
            stop_server(port, srv, init)
        r = results[loop]
        _log(f"soak loop={loop}: {r['reads']} identity-checked reads "
             f"({r['reads_per_s']}/s), {r['writes']} interleaved "
             f"push/drain rounds, mux_granted={r['mux_granted']}, "
             f"mismatches={r['byte_mismatches']}, "
             f"errors={len(r['errors'])}")
    failures = soak_failures(results)
    out = _bench.write_json(
        args.out or _bench.build_path("BENCH_rpc_soak.json"),
        {"bench": "rpc_soak", "payload_kb": args.payload_kb,
         "loops": results, "failures": failures, "ok": not failures})
    for f in failures:
        print(f"[bench_rpc] FAIL: {f}", file=sys.stderr, flush=True)
    _log(f"soak {'PASS' if not failures else 'FAIL'} -> {out}")
    return 0 if not failures else 1


# -- the smoke verdict -----------------------------------------------------------


def monitor_evidence(mon_dir: str) -> dict:
    """``rpc/connections_total``, ``service/requests_total`` and the
    server-side p99 of ``easgd_get_center`` from the server's JSONL."""
    evidence: dict = {}
    for fn in sorted(os.listdir(mon_dir)):
        if not (fn.startswith("metrics_") and fn.endswith(".jsonl")):
            continue
        for r in _bench.jsonl_records(os.path.join(mon_dir, fn)):
            labels = r.get("labels", {})
            if r["name"] == "rpc/connections_total":
                evidence["rpc_connections_total"] = \
                    evidence.get("rpc_connections_total", 0) + r["value"]
            if (r["name"] == "service/requests_total"
                    and labels.get("op") == "easgd_get_center"):
                evidence["requests_total"] = \
                    evidence.get("requests_total", 0) + r["value"]
            if (r["name"] == "service/rpc_ms"
                    and labels.get("op") == "easgd_get_center"):
                evidence["server_rpc_p99_ms"] = r.get("p99")
    return evidence


def smoke_failures(result: dict, min_top: int) -> list[str]:
    """The JAX tool's ``--smoke`` gate over a result document."""
    failures = []
    sel = {r["conns"]: r for r in result["connscale"]
           if r["loop"] == "selector"}
    top, lo = max(sel), min(sel)
    if top < min_top:
        failures.append(f"top selector point is {top} conns; the smoke "
                        f"bar is {min_top}")
    if sel[top]["pulls_s"] < 1000:
        failures.append(f"selector at {top} conns: {sel[top]['pulls_s']} "
                        "pulls/s < 1000")
    flat = ((sel[top]["p99_ms"] / top)
            / max(sel[lo]["p99_ms"] / lo, 1e-9))
    result["p99_per_conn_flatness"] = round(flat, 2)
    if flat > 3.0:
        failures.append(f"p99-per-connection not flat: {top}-conn point is "
                        f"{flat:.1f}x the {lo}-conn point (bar 3x)")
    new = result["convoy"]["mux_pipelined"]["pulls_s"]
    if new < 10 * CONVOY_BASELINE_PULLS_S:
        failures.append(f"convoy recovery {new} pulls/s < 10x the committed "
                        f"{CONVOY_BASELINE_PULLS_S} baseline")
    ev = result.get("monitor_evidence", {})
    if ev.get("rpc_connections_total", 0) < top:
        failures.append("monitor evidence missing: rpc/connections_total = "
                        f"{ev.get('rpc_connections_total')} < {top}")
    if not ev.get("requests_total"):
        failures.append("monitor evidence missing: service/requests_total")
    return failures


def smoke_verdict(result: dict, min_top: int) -> int:
    """Exit code of the ``--smoke`` gate over a result document (its
    failures recorded under ``result['smoke']``)."""
    failures = smoke_failures(result, min_top)
    result["smoke"] = {"failures": failures, "ok": not failures}
    for f in failures:
        print(f"[bench_rpc] FAIL: {f}", file=sys.stderr, flush=True)
    _log(f"smoke {'GREEN' if not failures else 'FAIL'}")
    return 0 if not failures else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.tools.bench_rpc",
        description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="preflight gate: flat-p99 + convoy recovery "
                         "assertions, exit 1 on any miss")
    ap.add_argument("--soak", action="store_true",
                    help="mux byte-identity soak for --dur seconds, exit 1 "
                         "on any mismatch")
    ap.add_argument("--conns", default=None,
                    help="comma-separated connscale points (default smoke: "
                         "8,1000; full: 1,8,48,200,600,1000)")
    ap.add_argument("--loops", default="selector",
                    help="event planes to drive: the port serves on its "
                         "selector loop only")
    ap.add_argument("--procs", type=int, default=4,
                    help="client worker processes per point")
    ap.add_argument("--dur", type=float, default=5.0,
                    help="seconds per measured point")
    ap.add_argument("--payload-kb", type=int, default=256,
                    help="pull payload (f32 tree) for connscale; the convoy "
                         "leg always pulls 1024 KB")
    ap.add_argument("--convoy-clients", type=int, default=12)
    ap.add_argument("--server-core", type=int, default=None,
                    help="pin the server to ONE core (default: the highest "
                         "available; -1 disables pinning)")
    _bench.add_device_arg(ap)
    ap.add_argument("--out", default=None,
                    help="result JSON (default build/BENCH_rpc_smoke.json "
                         "with --smoke)")
    ap.add_argument("--worker-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-conns", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-dur", type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker_port is not None:
        return worker_main(args)
    bad = [lp for lp in args.loops.split(",") if lp not in LOOPS]
    if bad:
        print(f"[bench_rpc] ERROR: --loops {','.join(bad)}: the port serves "
              "on its selector loop only; JAX's thread-per-connection loop "
              "(THEANOMPI_TPU_RPC_LOOP=threaded) is not ported",
              file=sys.stderr)
        return 2
    from theanompi_tpu_torch._device import resolve_device

    resolve_device(args.device)
    if args.soak:
        return run_soak(args)
    ncpu = os.cpu_count() or 1
    if args.server_core == -1:
        server_cores = client_core = None
    else:
        core = args.server_core if args.server_core is not None else ncpu - 1
        server_cores = {core}
        client_core = {0} if ncpu > 1 else None
    points = [int(x) for x in (args.conns or (
        "8,1000" if args.smoke else "1,8,48,200,600,1000")).split(",")]
    payload_floats = args.payload_kb * 256
    result = {"host": {"cpus": ncpu, "server_cores": sorted(server_cores)
                       if server_cores else "unpinned"},
              "device": args.device, "payload_kb": args.payload_kb,
              "connscale": [], "convoy": None,
              "reference_convoy_baseline_pulls_s": CONVOY_BASELINE_PULLS_S}
    mon_dir = tempfile.mkdtemp(prefix="bench_rpc_mon_")
    try:
        for conns in points:
            r = connscale_point(conns, args.procs, args.dur, payload_floats,
                                server_cores,
                                mon_dir if conns == max(points) else None,
                                args.device)
            result["connscale"].append(r)
            _log(f"connscale conns={conns:5d} {r['pulls_s']:9.1f} pulls/s "
                 f"p50={r['p50_ms']:8.1f}ms p99={r['p99_ms']:8.1f}ms")
        port, srv, init = start_server(262144, server_cores, None,
                                       args.device)
        try:
            result["convoy"] = convoy_point(port, args.convoy_clients,
                                            args.dur, client_core)
        finally:
            stop_server(port, srv, init)
        cv = result["convoy"]
        _log(f"convoy n={cv['n_clients']} dedicated sockets: "
             f"{cv['dedicated_sockets']['pulls_s']} pulls/s | mux 1-thread: "
             f"{cv['mux_pipelined']['pulls_s']} pulls/s "
             f"({cv['mux_over_dedicated']}x the dedicated sockets; "
             f"{cv['recovery_vs_reference_baseline']}x the JAX tool's committed "
             f"{CONVOY_BASELINE_PULLS_S:.0f} pulls/s baseline)")
        result["monitor_evidence"] = monitor_evidence(mon_dir)
        # the committed full run carries 1000 connections; an explicit
        # --conns (the preflight's 200-connection leg) lowers that floor,
        # not the flatness or convoy bars
        rc = (smoke_verdict(result, 1000 if args.conns is None else 200)
              if args.smoke else 0)
    finally:
        shutil.rmtree(mon_dir, ignore_errors=True)
    out = args.out or (_bench.build_path("BENCH_rpc_smoke.json")
                       if args.smoke else None)
    if out:
        _log(f"wrote {_bench.write_json(out, result)}")
    else:
        print(json.dumps(result, indent=2))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
