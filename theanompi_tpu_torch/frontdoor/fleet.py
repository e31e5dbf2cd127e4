"""Disaggregated serving fleet: spawn the roles, run the front door.

Counterpart of ``theanompi_tpu/frontdoor/fleet.py``.
:class:`DisaggregatedFleet` is what ``python -m
theanompi_tpu_torch.launcher SERVE --decode --disaggregate`` (and this
module's CLI) runs: it spawns the PREFILL fleet (``python -m
theanompi_tpu_torch.frontdoor.prefill`` per replica) and the DECODE
fleet (``python -m theanompi_tpu_torch.serving.server --decode`` per
replica, the server a single-role deployment runs, answering the
``adopt`` op) as supervised
:class:`~theanompi_tpu_torch.frontdoor.autoscale.RoleGroup` process
groups, runs the :class:`~theanompi_tpu_torch.frontdoor.router.Router`
in this process behind the RPC substrate, and optionally the
:class:`~theanompi_tpu_torch.frontdoor.autoscale.Autoscaler` over both
roles.

Every child gets ``--device`` (default ``cuda``: each child makes its
own CUDA context; ``cpu`` for a fleet without a card).  This process
holds no model and never touches a device.  Every child inherits the
environment, so the shared ``THEANOMPI_TPU_SERVICE_KEY``, the monitor
dir and a collector address reach every role, and one ``tools/traces.py``
run stitches client, router, prefill and decode spans from the
collector's file.

Both roles must agree on page geometry (page size, pages per sequence;
the dtype follows the export): the router ships prefilled pages
verbatim, and a decode replica refuses mismatched pages with the typed
``IncompatiblePages``.  The fleet passes one set of knobs to both sides,
so a deployment cannot disagree with itself.  The first prefill replica
spawned is the fleet prefix cache's authority (``decode/fleetcache.py``);
every later replica, prefill or decode, points at it.  The authority
starts alone; every other child then starts at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys
import threading
import time

from theanompi_tpu_torch import monitor
from theanompi_tpu_torch.frontdoor import router as router_mod
from theanompi_tpu_torch.frontdoor.autoscale import (
    Autoscaler,
    HysteresisController,
    RoleGroup,
    _free_port,
)
from theanompi_tpu_torch.frontdoor.router import Router


class DisaggregatedFleet:
    """Prefill fleet, decode fleet, in-process router (and autoscaler)."""

    def __init__(self, export_dir: str, prefill: int = 1,
                 decode: int = 1, host: str = "127.0.0.1",
                 router_host: str = "0.0.0.0",
                 router_port: int | None = None,
                 max_streams: int = 64, failover_attempts: int = 2,
                 page_size: int = 16, pages_per_seq: int = 8,
                 max_seqs: int = 8,
                 prefill_buckets: tuple[int, ...] | None = None,
                 prefill_max_pending: int = 8,
                 decode_max_pending: int = 32,
                 prefix_cache: bool = True,
                 prefill_batch: int = 8,
                 prefill_delay_ms: float = 2.0,
                 fleet_cache: bool = True,
                 draft_export_dir: str | None = None,
                 speculate_k: int = 4, autoscale: bool = False,
                 scale_min: int = 1, scale_max: int = 4,
                 scale_poll_s: float = 1.0,
                 slo_p99_ms: float | None = None,
                 max_restarts: int = 1,
                 ready_timeout_s: float = 180.0,
                 device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r} (want cuda|cpu)")
        self.export_dir = os.path.abspath(export_dir)
        self.host = host
        self.device = device
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.max_seqs = int(max_seqs)
        self.prefill_buckets = prefill_buckets
        self.prefill_max_pending = int(prefill_max_pending)
        self.decode_max_pending = int(decode_max_pending)
        self.prefix_cache = bool(prefix_cache)
        self.prefill_batch = int(prefill_batch)
        self.prefill_delay_ms = float(prefill_delay_ms)
        #: fleet-wide prefix cache: the FIRST prefill replica spawned is
        #: the authority; every later replica points at it.  Best effort:
        #: losing the authority degrades to local misses.  Needs the
        #: local prefix cache (the authority keeps entries in its own).
        self.fleet_cache = bool(fleet_cache) and self.prefix_cache
        self._authority_addr: str | None = None
        self.draft_export_dir = draft_export_dir
        self.speculate_k = int(speculate_k)

        # the first prefill replica (the cache authority) comes up alone:
        # the others connect to it as they start.  Then its peers start
        # beside the decode role (port-only: JAX starts every child one
        # after another)
        self.prefill_group = RoleGroup(
            "prefill", self._prefill_argv, initial=min(1, int(prefill)),
            host=host, max_restarts=max_restarts,
            ready_timeout_s=ready_timeout_s)
        decode_group = None
        try:
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                peers = pool.submit(self.prefill_group.grow_many,
                                    int(prefill) - 1)
                try:
                    decode_group = RoleGroup(
                        "decode", self._decode_argv, initial=int(decode),
                        host=host, max_restarts=max_restarts,
                        ready_timeout_s=ready_timeout_s)
                finally:
                    peers.result()
        except BaseException:
            if decode_group is not None:
                decode_group.stop()
            self.prefill_group.stop()
            raise
        self.decode_group = decode_group

        self.router = Router(prefill=self.prefill_group.addresses(),
                             decode=self.decode_group.addresses(),
                             max_streams=max_streams,
                             failover_attempts=failover_attempts)
        self.router_host = router_host
        self.router_port = int(router_port or _free_port())
        self._stop_serve = threading.Event()
        self.autoscaler: Autoscaler | None = None
        ready = threading.Event()
        self._serve_thread = threading.Thread(
            target=router_mod.serve, daemon=True,
            name="frontdoor-router",
            kwargs=dict(router=self.router, host=router_host,
                        port=self.router_port, ready_event=ready,
                        stop_event=self._stop_serve))
        self._serve_thread.start()
        if not ready.wait(timeout=30):
            self.stop()
            raise RuntimeError("frontdoor router never bound its port")

        if autoscale:
            groups = {"prefill": self.prefill_group,
                      "decode": self.decode_group}
            controllers = {
                role: HysteresisController(min_size=int(scale_min),
                                           max_size=int(scale_max))
                for role in groups
            }
            self.autoscaler = Autoscaler(
                self.router, groups, controllers,
                poll_s=scale_poll_s, slo_p99_ms=slo_p99_ms).start()

    # -- child argv -----------------------------------------------------

    def _prefill_argv(self, port: int) -> list[str]:
        cmd = [sys.executable, "-m",
               "theanompi_tpu_torch.frontdoor.prefill",
               "--export-dir", self.export_dir, "--host", self.host,
               "--port", str(port), "--device", self.device,
               "--page-size", str(self.page_size),
               "--pages-per-seq", str(self.pages_per_seq),
               "--max-seqs", str(self.max_seqs),
               "--max-pending", str(self.prefill_max_pending),
               "--prefill-batch", str(self.prefill_batch),
               "--prefill-delay-ms", str(self.prefill_delay_ms)]
        if self.prefill_buckets:
            cmd += ["--prefill-buckets",
                    ",".join(str(b) for b in self.prefill_buckets)]
        if not self.prefix_cache:
            cmd += ["--no-prefix-cache"]
        if self.fleet_cache:
            if self._authority_addr is None:
                # the first prefill replica spawned is the cache
                # authority (it serves cache_lookup/register/decref and
                # needs no client of its own)
                self._authority_addr = f"{self.host}:{port}"
            elif self._authority_addr != f"{self.host}:{port}":
                cmd += ["--fleet-cache", self._authority_addr]
        return cmd

    def _decode_argv(self, port: int) -> list[str]:
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.serving.server",
               "--export-dir", self.export_dir, "--host", self.host,
               "--port", str(port), "--device", self.device,
               "--replicas", "1", "--decode",
               "--decode-page-size", str(self.page_size),
               "--decode-pages-per-seq", str(self.pages_per_seq),
               "--decode-max-seqs", str(self.max_seqs),
               "--decode-max-pending", str(self.decode_max_pending),
               "--decode-prefill-batch", str(self.prefill_batch),
               "--decode-prefill-delay-ms",
               str(self.prefill_delay_ms)]
        if self.fleet_cache and self._authority_addr is not None:
            cmd += ["--decode-fleet-cache", self._authority_addr]
        if self.prefill_buckets:
            cmd += ["--decode-prefill-buckets",
                    ",".join(str(b) for b in self.prefill_buckets)]
        if self.draft_export_dir:
            cmd += ["--decode-draft-export-dir", self.draft_export_dir,
                    "--decode-speculate-k", str(self.speculate_k)]
        if not self.prefix_cache:
            cmd += ["--decode-no-prefix-cache"]
        return cmd

    # -- surface --------------------------------------------------------

    @property
    def router_addr(self) -> str:
        host = ("127.0.0.1" if self.router_host == "0.0.0.0"
                else self.router_host)
        return f"{host}:{self.router_port}"

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self._stop_serve.set()
        if self._serve_thread.is_alive():
            self._serve_thread.join(timeout=10)
        self.router.close()
        self.decode_group.stop()
        self.prefill_group.stop()

    def __enter__(self) -> "DisaggregatedFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def run_foreground(**fleet_kwargs) -> int:
    """Build a fleet and serve until interrupted: the shared body of this
    module's CLI and ``launcher SERVE --decode --disaggregate``."""
    with monitor.session(stall_after=float("inf"),
                         name=f"router{os.getpid()}"):
        monitor.progress(phase="frontdoor")
        fleet = DisaggregatedFleet(**fleet_kwargs)
        print(f"[frontdoor] fleet up — router at {fleet.router_addr} "
              f"({len(fleet.prefill_group)} prefill / "
              f"{len(fleet.decode_group)} decode on {fleet.device}, "
              f"autoscale="
              f"{'on' if fleet.autoscaler is not None else 'off'})",
              flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            fleet.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.frontdoor.fleet",
        description="disaggregated serving fleet (PyTorch port): prefill "
                    "replicas, decode replicas and the front-door router")
    ap.add_argument("--export-dir", required=True)
    ap.add_argument("--prefill", type=int, default=1, metavar="N",
                    help="initial prefill replica count")
    ap.add_argument("--decode", type=int, default=1, metavar="N",
                    help="initial decode replica count")
    ap.add_argument("--host", default="127.0.0.1",
                    help="backend bind/connect host")
    ap.add_argument("--router-host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=router_mod.DEFAULT_PORT,
                    help="router listen port (the client-facing one)")
    ap.add_argument("--max-streams", type=int, default=64)
    ap.add_argument("--failover-attempts", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-seq", type=int, default=8)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--prefill-buckets", default=None, metavar="N,N,...")
    ap.add_argument("--prefill-max-pending", type=int, default=8)
    ap.add_argument("--decode-max-pending", type=int, default=32)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefill-batch", type=int, default=8,
                    help="max prompts coalesced into ONE batched "
                         "prefill call, both roles (1 = serial prefill)")
    ap.add_argument("--prefill-delay-ms", type=float, default=2.0,
                    help="oldest-prompt coalescing deadline for "
                         "batched prefill")
    ap.add_argument("--no-fleet-cache", action="store_true",
                    help="disable the fleet-wide prefix cache (prefill "
                         "replica 0 as authority)")
    ap.add_argument("--draft-export-dir", default=None, metavar="DIR",
                    help="speculative decoding on the decode fleet")
    ap.add_argument("--speculate-k", type=int, default=4)
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink both roles from load signals "
                         "(frontdoor/autoscale.py)")
    ap.add_argument("--scale-min", type=int, default=1)
    ap.add_argument("--scale-max", type=int, default=4,
                    help="max replicas per role (the fleet budget)")
    ap.add_argument("--scale-poll-s", type=float, default=1.0)
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="intertoken p99 target feeding the decode "
                         "role's scale signal")
    ap.add_argument("--max-restarts", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the CHILD processes (each passed "
                         "--device); the router holds no model")
    args = ap.parse_args(argv)
    buckets = (tuple(int(b) for b in args.prefill_buckets.split(","))
               if args.prefill_buckets else None)
    return run_foreground(
        export_dir=args.export_dir, prefill=args.prefill,
        decode=args.decode, host=args.host,
        router_host=args.router_host, router_port=args.port,
        max_streams=args.max_streams,
        failover_attempts=args.failover_attempts,
        page_size=args.page_size, pages_per_seq=args.pages_per_seq,
        max_seqs=args.max_seqs, prefill_buckets=buckets,
        prefill_max_pending=args.prefill_max_pending,
        decode_max_pending=args.decode_max_pending,
        prefix_cache=not args.no_prefix_cache,
        prefill_batch=args.prefill_batch,
        prefill_delay_ms=args.prefill_delay_ms,
        fleet_cache=not args.no_fleet_cache,
        draft_export_dir=args.draft_export_dir,
        speculate_k=args.speculate_k, autoscale=args.autoscale,
        scale_min=args.scale_min, scale_max=args.scale_max,
        scale_poll_s=args.scale_poll_s, slo_p99_ms=args.slo_p99_ms,
        max_restarts=args.max_restarts, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
