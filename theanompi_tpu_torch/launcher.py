"""``tmlocal`` for the port: BSP one process per card, the async
rules (EASGD, ASGD, GOSGD) in one process, and the SERVE rule.

Counterpart of ``theanompi_tpu/launcher.py``::

    python -m theanompi_tpu_torch.launcher BSP -D 1 \\
        -m theanompi_tpu_torch.models.alex_net -c AlexNet --epochs 1
    python -m theanompi_tpu_torch.launcher EASGD -D 2 --tau 4 \\
        -m theanompi_tpu_torch.models.alex_net -c AlexNet --epochs 1
    python -m theanompi_tpu_torch.launcher SERVE --export-dir D \\
        [--port 45900] [--decode [--decode-draft-export-dir D2]]

SERVE runs the inference server in this process (no workers, no
``-m``/``-c``: the export's meta names the model) behind its TCP front
(serving/server.py ``serve_main``) until a ``shutdown`` op: ``--port``,
``--serve-host``, ``--serve-replicas``, ``--max-batch``,
``--max-delay-ms``, ``--serve-buckets``, ``--max-queue``,
``--reload-poll-s``, ``--max-restarts`` (per-replica
restart-from-export budget, default 2) and the ``--decode*`` options
(decode/: paged KV cache, continuous batching, prefix cache,
speculative decode, ``--decode-fleet-cache``), on the card unless
``--platform cpu``.  ``SERVE --decode --disaggregate`` runs the front
door instead (``frontdoor/fleet.py``): ``--prefill-replicas`` prefill
children and ``--serve-replicas`` decode children, each on
``--platform``, behind a router in this process on ``--port`` (default
46000); ``--autoscale``, ``--scale-max``, ``--slo-p99-ms``;
``--max-restarts`` is each child's relaunch budget (default 1).

The JAX launcher runs one SPMD program over every local chip; the port
runs one process per card, as the reference's ``mpirun`` did.  The
launcher spawns ``-D N`` workers (default: every visible card; one on
``--platform cpu``), each with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (a free localhost port).  A worker
joins the default process group (NCCL on ``cuda``, gloo on ``cpu``),
also when it is the only rank, so one card runs the same collectives as
eight, and drives ``BSP().init(...).wait()`` on card ``LOCAL_RANK``.
Rank 0 writes ``--result-json``: the session result (validation metrics,
epoch records with their kernel launches, the checkpoint timings), the
world size, every rank's parameter digest, every rank's state digest
(parameters, buffers, optimizer state and step: equal digests, equal
training states) and every rank's ``state_bytes`` (what it keeps of the
parameters, the optimizer state and the residual).

Checkpoints are on (``<snapshot-dir>/<model name>/``, one per epoch);
``--resume`` goes on from the newest one that verifies.  ``--set K=V``
reaches every ``ModelConfig`` field, the BSP step's knobs among them:
the wire (``exchange_dtype=bf16`` or ``exchange_strategy=nccl16``),
``exchange_error_feedback=true`` (its per-rank residual rides the
checkpoints), ``exchange_buckets=B`` (overlapped with the backward),
``exchange_what=params``, ``optimizer=adam|rmsprop|lars``, and
``steps_per_call=k`` or ``grad_accum_steps=a``; for example
``--set exchange_dtype=bf16 --set exchange_error_feedback=true --set
exchange_buckets=4 --set optimizer=lars --set grad_accum_steps=2``;
``sync_bn=true``; ``zero_sharding=true`` (ZeRO-1: the optimizer state
1/N a rank) or ``fsdp_sharding=true`` (the parameters too), with JAX's
refusals (LARS under ZeRO, the bf16 wire under FSDP, both together).  A
ZeRO checkpoint resumes only under its own ``exchange_buckets`` and
world size.  The JAX options with their semantics:

* ``--sync-type avg|cdd``: average or sum the exchanged gradients;
* ``--monitor-dir DIR``: exported to the workers as
  ``THEANOMPI_TPU_MONITOR`` (metrics snapshot and Prometheus dump,
  heartbeat, postmortem, crash markers);
* ``--collector`` (needs ``--monitor-dir``; single host): starts and
  supervises a telemetry collector (``monitor/collector.py``) before the
  workers and stops it after them; every process of the run (workers,
  shards, their children) ships its span and metric events to ONE
  ``fleet.jsonl`` under the monitor dir (``THEANOMPI_TPU_COLLECTOR``),
  with tracing on (``THEANOMPI_TPU_TRACE=1`` unless set);
* ``--ingest ADDR[,ADDR...]``: the training batches come from a reader
  fleet (``python -m theanompi_tpu_torch.ingest.fleet``): one
  coordinator address or a comma-separated list of readers, exported
  as ``THEANOMPI_TPU_INGEST`` and read by each epoch's ``begin_epoch``;
  refused with ``SERVE``, ``--multihost``, a malformed or ``unix:``
  address, and BSP over more than one process (each rank of a group
  feeds its own block of every global batch);
* ``--fault-plan PATH|JSON``: exported as ``THEANOMPI_TPU_FAULTS``,
  which each worker's ``resilience.faults`` installs when imported (so
  afresh in every life of the group);
* ``--max-restarts N``: a rank that dies leaves its peers blocked in
  their collectives, so the launcher stops the whole group and starts
  it again with ``--resume`` and a fresh ``MASTER_PORT``, up to N times
  (``THEANOMPI_TPU_RESTART`` tells the workers which life they are);
* ``--multihost --coordinator HOST:PORT --nhosts H --host-id I``: the
  same command on every host, each starting its ``-D L`` local ranks
  as global ranks ``I * L + r`` of ``H * L``, the coordinator as
  ``MASTER_ADDR``/``MASTER_PORT``.  A multi-host run never restarts.
  Its ``--resume`` needs a ``--snapshot-dir`` that every host sees
  (a shared file system): rank 0 alone writes checkpoints, and every
  other rank restores from that directory on its own host.

The async rules run in ONE worker process with no process group
(``rules/async_rules.py``): ``-D N`` is N worker threads over cards
0..N-1 (fewer visible cards than N is refused; default every card), and
``--platform cpu -D N`` N CPU workers (default 1).  Their options, with
JAX's refusal matrix: ``--tau``, ``--alpha`` (EASGD), ``--p-push``,
``--merge-momentum`` (GOSGD), ``--overlap-exchange`` (EASGD, ASGD) and
``--min-workers``; ``--max-restarts N`` supervises the worker threads
(a failed EASGD/ASGD worker restarts from the center) and restarts the
session with ``--resume`` up to N times.  Their remote paths:
``--server-addr HOST:PORT`` points the session at a parameter service
(``python -m theanompi_tpu_torch.parallel.service``), a comma-separated
list at a shard fleet; ``--shards K`` (EASGD, ASGD; single host) starts
and supervises K shard processes for the session (on the CPU) and
points it at them; ``--session-id`` scopes the service's store (the
same id on every host of one session); ``--local-aggregation`` (EASGD,
ASGD) makes one aggregate exchange a period for this process's workers;
GOSGD's ``--n-total-workers`` and ``--rank-offset`` place this
process's workers among every process's on one shared hub.  A GOSGD
run with ``--server-addr`` and a pinned ``--session-id`` is not
auto-resumed (the hub keeps its deactivated ranks).  ``--wire-protocol``,
``--wire-compression`` and ``--wire-dtype`` are exported to the
workers as ``THEANOMPI_TPU_WIRE_PROTOCOL``, ``_COMPRESSION`` and
``_DTYPE``, which every service client reads.  Their result JSON holds the
session result (``val``, the counts ``n_exchanges`` (EASGD) or
``n_updates`` (ASGD), GOSGD's ``weights``, ``iterations`` (over all
workers), ``train_s`` (until the last worker thread ended),
``val_batches``, and ``launches``: each kernel's launches over the
session), the rule, the devices and each worker's parameter digest.

The launcher never picks the CPU by itself: ``--platform`` defaults to
``cuda`` and fails without a card.  A worker that fails terminates its
siblings and the launcher exits non-zero.  The JAX launcher's other
option ``--compilation-cache-dir`` exits non-zero with the ROADMAP item
that will port it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

#: rules of the JAX launcher -> the ROADMAP.md section A item porting
#: each (None: ported)
RULES = {"BSP": None, "EASGD": None, "ASGD": None, "GOSGD": None,
         "SERVE": None}
#: the rules that run in one process, one worker thread per device
ASYNC_RULES = ("EASGD", "ASGD", "GOSGD")
#: options of the JAX launcher this one does not take yet -> the ROADMAP
#: item porting each
UNPORTED_OPTIONS = {"--compilation-cache-dir": 22}
#: tells a worker which life of the group it is (0: the first)
RESTART_ENV = "THEANOMPI_TPU_RESTART"


def _not_ported(what: str, item: int) -> SystemExit:
    return SystemExit(f"{what} is not ported yet (ROADMAP.md section A, "
                      f"item {item})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.launcher",
        description="tmlocal for the PyTorch port: one process per card",
        allow_abbrev=False)
    p.add_argument("rule", help="training rule (BSP, EASGD, ASGD, GOSGD) "
                                "or SERVE")
    p.add_argument("-m", "--modelfile", default=None,
                   help="model module path (training rules)")
    p.add_argument("-c", "--modelclass", default=None,
                   help="model class name (training rules)")
    p.add_argument("-D", "--devices", type=int, default=None,
                   help="BSP: processes, one per card; async rules: "
                        "worker threads, one per card (default: every "
                        "visible card; 1 on --platform cpu)")
    p.add_argument("--epochs", type=int, default=None,
                   help="cap the number of epochs")
    for axis, what in (("model", "tensor"), ("seq", "sequence"),
                       ("pipe", "pipeline"), ("expert", "expert")):
        p.add_argument(f"--{axis}-parallel", type=int, default=1,
                       help=f"BSP: {what}-parallel degree (ranks on the "
                            f"mesh's '{axis}' axis; the rest go to 'data')")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="config_sets",
                   help="override any ModelConfig field, repeatable")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; NCCL) or cpu (gloo)")
    p.add_argument("--result-json", default=None, metavar="PATH",
                   help="rank 0 writes the session result here as JSON")
    p.add_argument("--resume", action="store_true",
                   help="go on from the newest checkpoint that verifies")
    p.add_argument("--sync-type", default="avg", choices=("avg", "cdd"),
                   help="average (avg) or sum (cdd) the exchanged gradients")
    p.add_argument("--monitor-dir", default=None, metavar="DIR",
                   help="telemetry and crash markers under DIR (exported "
                        "to the workers as THEANOMPI_TPU_MONITOR)")
    p.add_argument("--collector", action="store_true",
                   help="start a telemetry collector for this run: every "
                        "process ships its span and metric events to ONE "
                        "fleet.jsonl under --monitor-dir (required); "
                        "turns tracing on (THEANOMPI_TPU_TRACE=1 unless "
                        "set); read it with tools/traces.py")
    p.add_argument("--ingest", default=None, metavar="ADDR[,ADDR...]",
                   help="feed the training batches from an ingest fleet: "
                        "one coordinator host:port or a comma-separated "
                        "reader list (exported as THEANOMPI_TPU_INGEST)")
    p.add_argument("--fault-plan", default=None, metavar="PATH|JSON",
                   help="deterministic fault injection (exported to the "
                        "workers as THEANOMPI_TPU_FAULTS)")
    p.add_argument("--max-restarts", type=int, default=None, metavar="N",
                   help="restart a group whose worker died, from its "
                        "latest verified checkpoint, up to N times "
                        "(single host only; default 0); async rules also "
                        "restart a failed worker thread from the center "
                        "up to N times; SERVE: each replica's "
                        "restart-from-export budget (default 2)")
    p.add_argument("--min-workers", type=int, default=None, metavar="N",
                   help="async rules under --max-restarts: abort when "
                        "fewer than N workers are left (default 1)")
    p.add_argument("--tau", type=int, default=None,
                   help="EASGD: iterations between exchanges (default 10)")
    p.add_argument("--alpha", type=float, default=None,
                   help="EASGD: elastic coefficient (default 0.5)")
    p.add_argument("--p-push", type=float, default=None,
                   help="GOSGD: per-iteration push probability "
                        "(default 0.1)")
    p.add_argument("--merge-momentum", default=None,
                   choices=("scale", "keep"),
                   help="GOSGD: scale the receiver's first moments by its "
                        "share of each merge (default) or keep them")
    p.add_argument("--overlap-exchange", action="store_true",
                   help="EASGD/ASGD: run each worker's exchange on a "
                        "thread of its own while it computes on "
                        "(bounded staleness 1)")
    p.add_argument("--server-addr", default=None, metavar="HOST:PORT[,...]",
                   help="async rules: the parameter service's address; a "
                        "comma-separated list names a shard fleet")
    p.add_argument("--shards", type=int, default=None, metavar="K",
                   help="EASGD/ASGD, single host: start and supervise K "
                        "shard processes and split the center across them")
    p.add_argument("--session-id", default=None,
                   help="async rules: the id scoping the service's store; "
                        "every host of one session passes the same "
                        "(default: a fresh id per session)")
    p.add_argument("--local-aggregation", action="store_true",
                   help="EASGD/ASGD: one aggregate exchange a period for "
                        "this process's workers")
    p.add_argument("--n-total-workers", type=int, default=None,
                   help="GOSGD: the workers of every process sharing one "
                        "--server-addr hub")
    p.add_argument("--rank-offset", type=int, default=None,
                   help="GOSGD: this process's first global worker rank "
                        "(default 0)")
    p.add_argument("--wire-protocol", default=None, choices=("v1", "v2"),
                   help="service transport: v2 framed (default) or v1 "
                        "pickle (THEANOMPI_TPU_WIRE_PROTOCOL)")
    p.add_argument("--wire-compression", default=None,
                   choices=("none", "zlib"),
                   help="v2 payload compression "
                        "(THEANOMPI_TPU_WIRE_COMPRESSION)")
    p.add_argument("--wire-dtype", default=None, choices=("f32", "bf16"),
                   help="v2 wire dtype: bf16 halves the f32 bytes on the "
                        "wire (THEANOMPI_TPU_WIRE_DTYPE)")
    p.add_argument("--multihost", action="store_true",
                   help="one launcher per host; needs --coordinator, "
                        "--nhosts and --host-id")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="host 0's address (MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--nhosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    p.add_argument("--export-dir", default=None, metavar="DIR",
                   help="SERVE: versioned model-export directory (required; "
                        "watched for new versions to hot-reload)")
    p.add_argument("--port", type=int, default=None,
                   help="SERVE: listen port (default 45900; the "
                        "router's 46000 with --disaggregate)")
    p.add_argument("--serve-host", default="0.0.0.0",
                   help="SERVE: listen address")
    p.add_argument("--serve-replicas", type=int, default=1,
                   help="SERVE: inference replicas (each with its own "
                        "queue and batcher)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="SERVE: max rows per coalesced batch")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="SERVE: max wait for a batch to fill")
    p.add_argument("--serve-buckets", default=None, metavar="N,N,...",
                   help="SERVE: padded batch sizes (default powers of two "
                        "up to --max-batch)")
    p.add_argument("--max-queue", type=int, default=32,
                   help="SERVE: admission bound; pending requests beyond "
                        "it are rejected with Overloaded")
    p.add_argument("--reload-poll-s", type=float, default=1.0,
                   help="SERVE: export-dir poll interval for hot reload "
                        "(0 disables the watcher)")
    from theanompi_tpu_torch.serving.server import add_decode_args

    add_decode_args(p)
    p.add_argument("--disaggregate", action="store_true",
                   help="SERVE --decode: split the deployment into a "
                        "prefill fleet + decode fleet behind the "
                        "front-door router (theanompi_tpu_torch/frontdoor); "
                        "--serve-replicas sizes the decode fleet, every "
                        "child runs on --platform")
    p.add_argument("--prefill-replicas", type=int, default=1,
                   help="SERVE --disaggregate: initial prefill "
                        "replica count")
    p.add_argument("--autoscale", action="store_true",
                   help="SERVE --disaggregate: grow/shrink both roles "
                        "from load signals (frontdoor/autoscale.py)")
    p.add_argument("--scale-max", type=int, default=4,
                   help="SERVE --disaggregate --autoscale: max "
                        "replicas per role (the fleet budget)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="SERVE --disaggregate --autoscale: intertoken "
                        "p99 target feeding the decode scale signal")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p


def parse_args(argv: list[str]) -> argparse.Namespace:
    """Parse ``argv``; an unported rule or option exits non-zero naming
    its ROADMAP item."""
    args, extra = build_parser().parse_known_args(argv)
    if args.ingest and args.rule == "SERVE":
        raise SystemExit("--ingest feeds TRAINING batches; the SERVE rule "
                         "has no train loader")
    if args.rule not in RULES:
        raise SystemExit(f"unknown rule {args.rule!r} (want one of "
                         f"{', '.join(RULES)})")
    if RULES[args.rule] is not None:
        raise _not_ported(f"rule {args.rule}", RULES[args.rule])
    for tok in extra:
        name = tok.split("=", 1)[0]
        if name in UNPORTED_OPTIONS:
            raise _not_ported(f"option {name}", UNPORTED_OPTIONS[name])
    if extra:
        raise SystemExit(f"unrecognized arguments: {' '.join(extra)}")
    _check_serve(args)
    if args.max_restarts is None:
        args.max_restarts = ((1 if args.disaggregate else 2)
                             if args.rule == "SERVE" else 0)
    if args.devices is not None and args.devices < 1:
        raise SystemExit("-D must be >= 1")
    if args.max_restarts < 0:
        raise SystemExit("--max-restarts must be >= 0")
    degrees = (args.model_parallel, args.seq_parallel, args.pipe_parallel,
               args.expert_parallel)
    if min(degrees) < 1:
        raise SystemExit("--model/--seq/--pipe/--expert-parallel must be "
                         ">= 1")
    if args.rule != "BSP" and max(degrees) > 1:
        raise SystemExit("--model-parallel/--seq-parallel/--pipe-parallel/"
                         "--expert-parallel are BSP options (async rules "
                         "are data-parallel per worker)")
    _check_rule_options(args)
    _check_telemetry_and_ingest(args)
    hosts = (args.coordinator, args.nhosts, args.host_id)
    if args.multihost:
        if None in hosts:
            raise SystemExit("--multihost needs --coordinator HOST:PORT, "
                             "--nhosts and --host-id")
        host, _, port = args.coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"--coordinator expects HOST:PORT, got "
                             f"{args.coordinator!r}")
        if not 0 <= args.host_id < args.nhosts:
            raise SystemExit(f"--host-id {args.host_id} is not in "
                             f"[0, {args.nhosts})")
    elif hosts != (None, None, None):
        raise SystemExit("--coordinator, --nhosts and --host-id need "
                         "--multihost")
    return args


def _check_serve(args: argparse.Namespace) -> None:
    """SERVE needs ``--export-dir`` and one host; ``--decode`` is a
    SERVE option; the training rules need ``-m``/``-c``."""
    if args.decode and args.rule != "SERVE":
        raise SystemExit("--decode is a SERVE option "
                         "(launcher SERVE --decode ...)")
    if args.rule != "SERVE":
        if not (args.modelfile and args.modelclass):
            raise SystemExit(f"{args.rule} needs -m/--modelfile and "
                             "-c/--modelclass")
        return
    if args.multihost:
        raise SystemExit("SERVE is single-host (run one server per host "
                         "behind your load balancer)")
    if not args.export_dir:
        raise SystemExit("SERVE requires --export-dir (see "
                         "serving/export.py export_model)")
    if args.disaggregate and not args.decode:
        # prefill/decode disaggregation exists only on the decode plane:
        # the eval server has no KV pages
        raise SystemExit("--disaggregate requires --decode "
                         "(tmlocal SERVE --decode "
                         "--disaggregate ...)")


def run_serve(args: argparse.Namespace) -> int:
    """The SERVE rule: the inference server in this process."""
    from theanompi_tpu_torch.serving.server import (
        DEFAULT_PORT,
        decode_opts_from_args,
        serve_main,
    )

    buckets = (tuple(int(b) for b in args.serve_buckets.split(","))
               if args.serve_buckets else None)
    if args.monitor_dir:
        os.environ["THEANOMPI_TPU_MONITOR"] = args.monitor_dir
    if args.fault_plan:
        os.environ["THEANOMPI_TPU_FAULTS"] = args.fault_plan
        from theanompi_tpu_torch.resilience import faults

        faults.install_from_env()
    if args.disaggregate:
        from theanompi_tpu_torch.frontdoor import fleet as frontdoor_fleet
        from theanompi_tpu_torch.frontdoor.router import (
            DEFAULT_PORT as ROUTER_PORT,
        )

        pb = (tuple(int(b) for b in args.decode_prefill_buckets.split(","))
              if args.decode_prefill_buckets else None)
        return frontdoor_fleet.run_foreground(
            export_dir=args.export_dir,
            prefill=args.prefill_replicas,
            decode=args.serve_replicas,
            router_host=args.serve_host,
            router_port=(args.port if args.port is not None
                         else ROUTER_PORT),
            page_size=args.decode_page_size,
            pages_per_seq=args.decode_pages_per_seq,
            max_seqs=args.decode_max_seqs,
            prefill_buckets=pb,
            decode_max_pending=args.decode_max_pending,
            prefix_cache=not args.decode_no_prefix_cache,
            prefill_batch=args.decode_prefill_batch,
            prefill_delay_ms=args.decode_prefill_delay_ms,
            draft_export_dir=args.decode_draft_export_dir,
            speculate_k=args.decode_speculate_k,
            autoscale=args.autoscale, scale_max=args.scale_max,
            slo_p99_ms=args.slo_p99_ms,
            max_restarts=args.max_restarts, device=args.platform)
    return serve_main(
        args.export_dir, host=args.serve_host,
        port=args.port if args.port is not None else DEFAULT_PORT,
        replicas=args.serve_replicas, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, buckets=buckets,
        max_queue=args.max_queue, max_restarts=args.max_restarts,
        reload_poll_s=args.reload_poll_s, decode=args.decode,
        decode_opts=decode_opts_from_args(args), device=args.platform)


#: option -> the rules that take it (else refused, as JAX's matrix does)
_RULE_OPTIONS = {"tau": ("EASGD",), "alpha": ("EASGD",),
                 "p_push": ("GOSGD",), "merge_momentum": ("GOSGD",),
                 "n_total_workers": ("GOSGD",), "rank_offset": ("GOSGD",),
                 "overlap_exchange": ("EASGD", "ASGD"),
                 "min_workers": ASYNC_RULES, "server_addr": ASYNC_RULES,
                 "session_id": ASYNC_RULES}
#: the options' environment variables (read by every service client)
WIRE_ENV = {"wire_protocol": "THEANOMPI_TPU_WIRE_PROTOCOL",
            "wire_compression": "THEANOMPI_TPU_WIRE_COMPRESSION",
            "wire_dtype": "THEANOMPI_TPU_WIRE_DTYPE"}


def _check_rule_options(args: argparse.Namespace) -> None:
    """Refuse a rule's option under another rule (a flag silently
    ignored would let the user believe it acts) and the async rules
    across hosts."""
    for opt, rules in _RULE_OPTIONS.items():
        if getattr(args, opt) not in (None, False) and args.rule not in rules:
            flag = "--" + opt.replace("_", "-")
            if opt == "overlap_exchange":
                # BSP overlaps in its step; GOSGD pushes never block
                raise SystemExit(f"{flag} applies to EASGD/ASGD only")
            raise SystemExit(f"{flag} applies to {'/'.join(rules)} only")
    if args.min_workers is not None and args.min_workers < 1:
        raise SystemExit("--min-workers must be >= 1")
    # JAX's refusal matrix for the remote paths
    if args.local_aggregation and args.rule not in ("EASGD", "ASGD"):
        raise SystemExit(
            "--local-aggregation applies to EASGD/ASGD only: GOSGD "
            "gossip pushes whole (params, weight) trees to random "
            "peers and BSP exchanges in-step via collectives")
    if args.shards is not None:
        if args.rule not in ("EASGD", "ASGD"):
            raise SystemExit(
                "--shards applies to EASGD/ASGD only: the GOSGD gossip "
                "hub is unsharded (it rendezvouses whole param trees, "
                "not an accumulating center) and BSP has no parameter "
                "service")
        if args.multihost:
            raise SystemExit(
                "--shards is single-host (the launcher spawns the shard "
                "processes); multi-host runs start the fleet once and "
                "point every host at it with a comma-separated "
                "--server-addr")
        if args.server_addr:
            raise SystemExit(
                "pass either --shards K (spawn a local shard fleet) or "
                "a comma-separated --server-addr (an existing fleet), "
                "not both")
        if args.shards < 1:
            raise SystemExit("--shards must be >= 1")


def _check_telemetry_and_ingest(args: argparse.Namespace) -> None:
    """JAX's refusals of ``--collector`` and ``--ingest``."""
    if args.collector:
        if args.multihost:
            # one collector per RUN, not per host
            raise SystemExit(
                "--collector is single-host (the launcher spawns the "
                "collector process); multi-host runs start one collector "
                "(python -m theanompi_tpu_torch.monitor.collector) and "
                "export THEANOMPI_TPU_COLLECTOR=host:port on every host")
        if not args.monitor_dir:
            raise SystemExit("--collector requires --monitor-dir (the "
                             "merged fleet.jsonl lands there)")
    if args.ingest:
        if args.multihost:
            # silently ignoring the flag would let the user believe the
            # fleet feeds the run when it does not
            raise SystemExit(
                "--ingest is single-host for now (each host feeds its own "
                "slice); run the readers co-located with each host "
                "instead")
        from theanompi_tpu_torch.ingest.protocol import ingest_addresses

        try:
            ingest_addresses(args.ingest)  # fail fast on a bad spec
        except ValueError as e:
            raise SystemExit(f"--ingest: {e}") from None


def _parse_config_sets(pairs: list[str]) -> dict:
    """``--set k=v`` strings -> typed ModelConfig overrides (a copy of
    the JAX launcher's)."""
    from theanompi_tpu_torch.models.base import ModelConfig

    fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    out: dict = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit(f"--set expects K=V, got {pair!r}")
        if key not in fields:
            raise SystemExit(f"--set: unknown ModelConfig field {key!r}; "
                             f"valid: {', '.join(sorted(fields))}")
        default = fields[key].default
        low = raw.lower()
        if low in ("none", "null") and default is None:
            out[key] = None
        elif isinstance(default, bool):
            if low not in ("true", "false", "1", "0"):
                raise SystemExit(f"--set {key}: expected a bool, got {raw!r}")
            out[key] = low in ("true", "1")
        else:
            try:
                if isinstance(default, int):
                    out[key] = int(raw)
                elif isinstance(default, float):
                    out[key] = float(raw)
                elif isinstance(default, tuple):
                    out[key] = tuple(
                        float(x) if "." in x else int(x)
                        for x in raw.split(",") if x != "")
                else:
                    out[key] = raw
            except ValueError:
                raise SystemExit(
                    f"--set {key}: expected a "
                    f"{type(default).__name__}, got {raw!r}") from None
    return out


def model_config(args: argparse.Namespace):
    """The model class and its ``ModelConfig`` with the command line's
    overrides (None when there are none: the model's default)."""
    from theanompi_tpu_torch.rules.base import resolve_model_class

    cls = resolve_model_class(args.modelfile, args.modelclass)
    overrides = {k: v for k, v in (("batch_size", args.batch_size),
                                   ("learning_rate", args.lr),
                                   ("snapshot_dir", args.snapshot_dir))
                 if v is not None}
    overrides.update(_parse_config_sets(args.config_sets))
    if not overrides:
        return cls, None
    return cls, dataclasses.replace(cls.default_config(), **overrides)


def param_digest(module) -> str:
    """sha256 of the module's parameters (f32 bytes, in name order)."""
    h = hashlib.sha256()
    for name, p in sorted(module.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _jsonable(value):
    """The scalars, strings, lists and dicts of a rule result; tensors
    (the center, the consensus) are dropped."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        kept = {k: v for k, v in ((k, _jsonable(v)) for k, v in value.items())
                if v is not None}
        return kept or None
    if isinstance(value, (list, tuple)):
        kept = [_jsonable(v) for v in value]
        return kept if all(v is not None for v in kept) else None
    return None


def run_async(args: argparse.Namespace) -> int:
    """An async rule's session in this process: one worker thread per
    device (``-D``), no process group; writes the result JSON."""
    from theanompi_tpu_torch import rules

    _, config = model_config(args)
    kwargs = dict(devices=args.devices, device=args.platform,
                  modelfile=args.modelfile, modelclass=args.modelclass,
                  config=config, resume=args.resume,
                  sync_type=args.sync_type, max_epochs=args.epochs)
    opts = {"tau": args.tau, "alpha": args.alpha, "p_push": args.p_push,
            "merge_momentum": args.merge_momentum,
            "min_workers": args.min_workers,
            "server_addr": args.server_addr, "session_id": args.session_id,
            "n_total_workers": args.n_total_workers,
            "rank_offset": args.rank_offset}
    kwargs.update({k: v for k, v in opts.items() if v is not None})
    if args.overlap_exchange:
        kwargs["overlap"] = True
    if args.local_aggregation:
        kwargs["local_aggregation"] = True
    if args.max_restarts:
        kwargs["max_restarts"] = args.max_restarts
    rule = getattr(rules, args.rule)().init(**kwargs)
    result = rule.wait()
    print("final val:", {k: round(float(v), 4)
                         for k, v in result.get("val", {}).items()},
          flush=True)
    if args.result_json:
        with open(args.result_json, "w") as f:
            json.dump({**_jsonable(result), "rule": args.rule,
                       "device": args.platform,
                       "devices": [str(d) for d in rule.devices],
                       "param_digests": [param_digest(m.module)
                                         for m in rule.models]}, f)
    return 0


def run_worker(args: argparse.Namespace) -> int:
    """One rank: join the process group from the environment, run the
    BSP session on this rank's device, and (rank 0) write the result;
    an async rule runs its whole session here (:func:`run_async`)."""
    if args.rule in ASYNC_RULES:
        return run_async(args)
    import torch
    import torch.distributed as dist

    from theanompi_tpu_torch.rules.base import rank_device
    from theanompi_tpu_torch.rules.bsp import BSP
    from theanompi_tpu_torch.utils.checkpoint import state_digest

    device = rank_device(args.platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        _, config = model_config(args)
        rule = BSP().init(device=device, modelfile=args.modelfile,
                          modelclass=args.modelclass, config=config,
                          resume=args.resume, sync_type=args.sync_type,
                          max_epochs=args.epochs,
                          model_parallel=args.model_parallel,
                          seq_parallel=args.seq_parallel,
                          pipe_parallel=args.pipe_parallel,
                          expert_parallel=args.expert_parallel)
        result = rule.wait()
        world = dist.get_world_size()
        digests = [None] * world
        with rule.model.full_params():
            dist.all_gather_object(digests, param_digest(rule.model.module))
        states = [None] * world
        dist.all_gather_object(states, state_digest(
            rule.model.checkpoint_payload()))
        held = [None] * world
        dist.all_gather_object(held, rule.model.state_bytes())
        if dist.get_rank() == 0:
            print("final val:", {k: round(float(v), 4)
                                 for k, v in result.get("val", {}).items()},
                  flush=True)
            if args.result_json:
                with open(args.result_json, "w") as f:
                    json.dump({**result, "world_size": world,
                               "device": str(device),
                               "param_digests": digests,
                               "state_digests": states,
                               "state_bytes": held}, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(procs: list[subprocess.Popen], grace_s: float = 10.0) -> None:
    """Terminate every worker still running; kill what outlives the
    grace period."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _run_group(argv: list[str], env: dict, n: int, rank0: int,
               life: int) -> int:
    """One life of the local ranks ``rank0 .. rank0 + n - 1``: start a
    worker per rank and wait; the first to fail stops the others and its
    exit code (1 for a signal) is returned."""
    procs: list[subprocess.Popen] = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "theanompi_tpu_torch.launcher",
                 "--worker", *argv],
                env=dict(env, RANK=str(rank0 + r), LOCAL_RANK=str(r),
                         **{RESTART_ENV: str(life)})))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                print(f"launcher: a worker exited with code {bad[0]}; "
                      "stopping the others", file=sys.stderr, flush=True)
                return bad[0] if bad[0] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        _stop(procs)


def _without_shards(argv: list[str]) -> list[str]:
    """``argv`` without its ``--shards K`` (or ``--shards=K``)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--shards":
            skip = True
        elif not a.startswith("--shards="):
            out.append(a)
    return out


def spawn(args: argparse.Namespace, argv: list[str]) -> int:
    """Start one worker per card (or ``-D`` CPU workers; one process for
    an async rule) and wait; a group whose worker failed is started
    again with ``--resume`` up to ``--max-restarts`` times (single
    host), else the failed worker's exit code is returned.  ``--shards
    K`` starts the shard fleet here, for every life of the group, and
    hands the workers its ``--server-addr``; the shards hold their
    ranges on the workers' ``--platform``.  ``--collector`` starts the
    collector first (every process started after it ships to it) and
    stops it after the last worker's session has flushed."""
    collector = None
    set_trace = False
    if getattr(args, "collector", False):
        from theanompi_tpu_torch.monitor import trace
        from theanompi_tpu_torch.monitor.collector import CollectorProcess

        # exported before the spawn, so the collector's own artifacts
        # land under the run dir too
        os.environ["THEANOMPI_TPU_MONITOR"] = args.monitor_dir
        collector = CollectorProcess(args.monitor_dir)
        # the flag's point is the one-timeline view: tracing on unless
        # the operator pinned it (=0 ships metrics only)
        set_trace = trace.ENV_VAR not in os.environ
        if set_trace:
            os.environ[trace.ENV_VAR] = "1"
    try:
        if args.shards is None:
            return _spawn(args, argv)
        from theanompi_tpu_torch.parallel.shards import ShardProcessGroup

        group = ShardProcessGroup(args.shards, device=args.platform,
                                  max_restarts=args.max_restarts or 1)
        try:
            return _spawn(args, _without_shards(argv)
                          + ["--server-addr", group.server_addr])
        finally:
            group.stop()
    finally:
        if collector is not None:
            collector.stop()
            if set_trace:
                os.environ.pop("THEANOMPI_TPU_TRACE", None)


def _spawn(args: argparse.Namespace, argv: list[str]) -> int:
    import torch

    if args.platform == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--platform cuda (the default) needs an NVIDIA "
                             "card and torch.cuda.is_available() is False; "
                             "pass --platform cpu to train on the CPU")
        n = args.devices or torch.cuda.device_count()
        if n > torch.cuda.device_count():
            raise SystemExit(f"-D {n} but {torch.cuda.device_count()} cards "
                             "are visible")
    else:
        n = args.devices or 1
    if args.rule in ASYNC_RULES:
        n = 1  # one process; its -D worker threads
    elif getattr(args, "ingest", None) and n > 1:
        raise SystemExit(
            f"--ingest feeds one training process; BSP -D {n} runs {n} "
            "ranks, each taking its block of every global batch from its "
            "own loader (run -D 1, or an async rule's worker threads)")
    model_config(args)  # fail here, before any worker starts
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if args.monitor_dir:
        env["THEANOMPI_TPU_MONITOR"] = args.monitor_dir
    if args.fault_plan:
        env["THEANOMPI_TPU_FAULTS"] = args.fault_plan
    if getattr(args, "ingest", None):
        env["THEANOMPI_TPU_INGEST"] = args.ingest
    for opt, var in WIRE_ENV.items():
        if getattr(args, opt):
            env[var] = getattr(args, opt)
    if args.multihost:
        addr, _, port = args.coordinator.rpartition(":")
        env.update(WORLD_SIZE=str(n * args.nhosts), MASTER_ADDR=addr,
                   MASTER_PORT=port)
        rank0 = args.host_id * n
        restarts = 0  # one host cannot rejoin its peers' collectives
        if args.max_restarts:
            print("[resilience] --max-restarts is ignored under "
                  "--multihost: restart every host with --resume",
                  file=sys.stderr, flush=True)
    else:
        env.update(WORLD_SIZE=str(n), MASTER_ADDR="localhost")
        rank0, restarts = 0, args.max_restarts
    life = 0
    while True:
        if not args.multihost:
            env["MASTER_PORT"] = str(_free_port())
        rc = _run_group(argv, env, n, rank0, life)
        if rc == 0 or life >= restarts:
            return rc
        if args.rule == "GOSGD" and args.server_addr and args.session_id:
            # a pinned-session-id gossip hub survives the crash WITH its
            # deactivated ranks and stale in-flight payloads: resuming
            # into it would refuse gossip to restarted ranks and merge
            # pre-crash params
            print("[resilience] NOT auto-resuming GOSGD: the pinned "
                  f"--session-id {args.session_id!r} hub keeps deactivated "
                  "ranks and stale in-flight gossip across a resume; "
                  "restart all hosts with a fresh --session-id",
                  file=sys.stderr, flush=True)
            return rc
        life += 1
        print(f"[resilience] {args.rule} session died (worker exit code "
              f"{rc}); auto-resume {life}/{restarts} from the latest "
              "verified checkpoint", file=sys.stderr, flush=True)
        if "--resume" not in argv:
            argv = [*argv, "--resume"]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.rule == "SERVE":
        return run_serve(args)
    if args.worker:
        return run_worker(args)
    return spawn(args, [a for a in argv if a != "--worker"])


if __name__ == "__main__":
    sys.exit(main())
